// block_bounds: each index block's embedded centroid and covering radius,
// computed from the block-sorted int8 rows in one pass.
//
// Replaces: the JAX package's jitted bounds scans,
//           hsearch_tpu/search/stream.py:_recompute_bounds (the lax.scan
//           after each segment upload) and the bounds half of the IVF
//           build's stage 2, hsearch_tpu/search/ivf.py:_stage2 (the
//           lax.scan at :384).
//
//   for index block j of B, rows i < bs, valid(i) = order[j, i] < n:
//     counts[l, a] = #valid rows with residue a at position l
//     cnt          = max(#valid rows, 1)
//     cent[j, 8l + k] = (sum_a counts[l, a] * coords[a, k]) / cnt
//     tab[l, a]    = sum_k (coords[a, k] - cent[j, 8l + k])^2
//     d2(i)        = sum_l tab[l, row_i[l]]           (l = 0..L-1, in order)
//     rad[j]       = sqrt(max over valid rows of d2(i))
//   a block with no valid row gets rad = -inf and cent = 0.
//
// This is the formula of the plain version
// (hsearch_tpu_torch/ops/cuda_kernels.py:block_bounds_plain): no
// (bs, 8L) embedding is formed, the centroid comes from exact integer
// counts, and a row's squared distance is L lookups of a per-position
// table.  Its float sums run in another order than the plain version's
// matrix product and reductions, so they agree within a few ulps, not
// bitwise (ops/kernel_checks.bounds_agreement states the tolerance); a
// streamed segment and a resident build both go through this kernel and
// so are bounded bitwise alike.
//
// What bounds it on Hopper: bytes.  A 2^21-point segment has about 97k
// blocks of 32 rows of L = 25; per block the pass reads 800 bytes of
// rows and 128 of order and writes 804 bytes of bounds, 0.17 GB in all
// (0.05 ms at 3.35 TB/s); its ~1,000 float operations per position and
// block are about half that time at the float32 rate.
//
// Design: one warp per index block, WARPS warps per CUDA block.  The warp
// stages its block's rows in shared memory with coalesced byte loads,
// counts residues per position with shared-memory integer atomics (exact
// in any order), then spreads the (L, 8) centroid, the (L, 20) table and
// the rows' sums over its lanes; the radius is a warp max.  One launch
// bounds a whole segment: there is no chunk loop on the host.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NAA = 20;
constexpr int DIM = 8;            // embedding coordinates per residue
constexpr int SMEM_DEFAULT = 48 * 1024;

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) / 16 * 16;
}

// shared bytes one warp uses: counts (L, 20) int, centroid (L, 8) f32,
// table (L, 20) f32, rows bs*L bytes, row flags bs bytes
__host__ __device__ __forceinline__ int warp_smem(int bs, int L) {
  return 4 * NAA * L + 4 * DIM * L + 4 * NAA * L + round16(bs * L) +
         round16(bs);
}

__global__ void bounds_kernel(const int8_t* __restrict__ db,
                              const int* __restrict__ order,
                              const float* __restrict__ coords_g, int n,
                              float* __restrict__ cent,
                              float* __restrict__ rad, int B, int bs, int L,
                              int warps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* coords = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < NAA * DIM; i += blockDim.x)
    coords[i] = coords_g[i];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* mine = smem + 4 * NAA * DIM + warp * warp_smem(bs, L);
  int* counts = reinterpret_cast<int*>(mine);
  float* c_sh = reinterpret_cast<float*>(mine + 4 * NAA * L);
  float* tab = reinterpret_cast<float*>(mine + 4 * NAA * L + 4 * DIM * L);
  int8_t* rows = reinterpret_cast<int8_t*>(mine + 8 * NAA * L + 4 * DIM * L);
  unsigned char* valid = mine + 8 * NAA * L + 4 * DIM * L + round16(bs * L);
  __syncthreads();

  const long long j = (long long)blockIdx.x * warps + warp;
  if (j >= B) return;
  const int row_bytes = bs * L;
  const int8_t* src = db + (size_t)j * row_bytes;
  for (int i = lane; i < row_bytes; i += 32) rows[i] = src[i];
  for (int i = lane; i < NAA * L; i += 32) counts[i] = 0;
  int nv = 0;
  for (int r = lane; r < bs; r += 32) {
    const unsigned char v = order[(size_t)j * bs + r] < n;
    valid[r] = v;
    nv += v;
  }
  for (int o = 16; o > 0; o >>= 1) nv += __shfl_xor_sync(0xffffffffu, nv, o);
  __syncwarp();
  for (int r = lane; r < bs; r += 32) {
    if (!valid[r]) continue;
    for (int l = 0; l < L; ++l) atomicAdd(&counts[l * NAA + rows[r * L + l]], 1);
  }
  __syncwarp();

  // centroid: residue counts times the coordinate table over the row count
  const float cnt = (float)(nv > 0 ? nv : 1);
  float* cent_j = cent + (size_t)j * DIM * L;
  for (int i = lane; i < DIM * L; i += 32) {
    const int l = i / DIM, k = i % DIM;
    float acc = 0.f;
    for (int a = 0; a < NAA; ++a)
      acc = fmaf((float)counts[l * NAA + a], coords[a * DIM + k], acc);
    const float c = acc / cnt;
    c_sh[i] = c;
    cent_j[i] = nv > 0 ? c : 0.f;
  }
  __syncwarp();
  // each residue's squared distance to the centroid's position
  for (int i = lane; i < NAA * L; i += 32) {
    const int l = i / NAA, a = i % NAA;
    float s = 0.f;
    for (int k = 0; k < DIM; ++k) {
      const float d = coords[a * DIM + k] - c_sh[l * DIM + k];
      s = fmaf(d, d, s);
    }
    tab[i] = s;
  }
  __syncwarp();
  float m = 0.f;
  for (int r = lane; r < bs; r += 32) {
    if (!valid[r]) continue;
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += tab[l * NAA + rows[r * L + l]];
    m = fmaxf(m, s);
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) rad[j] = nv > 0 ? sqrtf(m) : -INFINITY;
}

}  // namespace

// db (B, bs*L) int8 residues in [0, 20); order (B, bs) int32; coords
// (20, 8) f32; cent (B, 8L) and rad (B,) f32, written on `stream`.
// Returns the CUDA error of the launch, 0 on success.
extern "C" int hs_block_bounds(const int8_t* db, const int* order,
                               const float* coords, int n, float* cent,
                               float* rad, int B, int bs, int L,
                               void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  int warps = 4;
  while (warps > 1 && 4 * NAA * DIM + warps * warp_smem(bs, L) > SMEM_DEFAULT)
    warps /= 2;
  const int smem = 4 * NAA * DIM + warps * warp_smem(bs, L);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        bounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long grid = ((long long)B + warps - 1) / warps;
  bounds_kernel<<<(unsigned)grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      db, order, coords, n, cent, rad, B, bs, L, warps);
  return (int)cudaGetLastError();
}
