// ptable_verify: exact squared distances of the selected blocks' k-mers by
// P-table lookup, read straight from the block-sorted database, with the
// radius test and the per-center hit count fused in.
//
// Replaces: hsearch_tpu/ops/pallas_kernels.py:ptable_verify
//           (kernel body _ptable_verify_kernel), and the candidate gather
//           and hit test around it in hsearch_tpu/search/ivf.py
//           (_search_block) and, at block size 1, in
//           hsearch_tpu/search/motif.py (_probe_verify: the LSH search's
//           deduplicated candidate ids are its blocks, the database rows
//           with order = arange(N+1) its block layout).
//
//   for candidate m = j*bs + i of center c (block j of kb, row i of bs):
//     blk    = blk_ids[c, j], alive iff neg[c, j] is finite
//     d2     = sum_l ptab[c, l, db_sorted[blk, i*L + l]]   (l = 0..L-1)
//     hit    = alive && order[blk, i] < n && d2 <= r2
//     d2m[c, m]  = hit ? d2 : +inf
//   n_hits[c] = #hits of center c
//
// What bounds it on Hopper: bytes.  At the search shapes (C = 1024,
// kb = 128, bs = 32, L = 25) it writes 16.8 MB of d2m and reads the
// selected blocks' rows, 800 + 128 bytes each; a block that many centers
// select is read from the 50 MB L2, which holds the whole 43 MB database.
// The 105 M table lookups are far below the card's operation rate.
//
// Design: grid (center, tile of blocks).  A block copies its center's
// P-table (L*20 floats, 2 KB at L = 25) into shared memory, and stages the
// rows of its alive blocks with 16-byte cp.async copies (byte loads when a
// row is not a multiple of 16 bytes); dead blocks are never read.  Each
// thread sums a candidate's L table entries in order l = 0..L-1 in
// float32 -- the summation order of ops/distance.ptable_distances, so d2
// is bitwise equal to it (there is no multiply, so no FMA contraction can
// change the rounding).  The hit count is a warp ballot and popcount with
// one integer atomic per warp, so n_hits is exact.
//
// Index arithmetic: block ids, row and candidate offsets within a tile
// are int (a block id < 2^31; a tile holds at most 512 candidates); every
// offset into blk_ids, neg, order, db and d2m is size_t, so C*kb*bs and
// B*bs*L may exceed 2^31.  A grid covers at most 65,535 tiles in y, so
// the host launches one grid per 65,535 tiles, each with its first tile
// (tile0): kb may then be as large as B (the exactness retry's last
// rung; B ~ 2^21 blocks at --segment-points 2^26).  C must stay below
// 2^31.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_CAND = 512;   // candidates a block aims to cover
constexpr int NAA = 20;
constexpr int kMaxGridY = 65535;  // the largest grid extent in y

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
verify_kernel(const float* __restrict__ ptab,
              const int8_t* __restrict__ db, const int* __restrict__ order,
              const int64_t* __restrict__ blk_ids,
              const float* __restrict__ neg, float r2, int n,
              float* __restrict__ d2m, int* __restrict__ n_hits, int kb,
              int bs, int L, int tile_blocks, int tile0) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [P-table, L*20 floats | block ids, padded to 16 bytes | rows]
  float* tab = reinterpret_cast<float*>(smem);
  int* s_blk = reinterpret_cast<int*>(smem + 4 * NAA * L);
  int8_t* rows = reinterpret_cast<int8_t*>(
      smem + 4 * NAA * L + (4 * tile_blocks + 15) / 16 * 16);

  const int c = blockIdx.x;
  const int j0 = (tile0 + (int)blockIdx.y) * tile_blocks;
  const int nb = min(tile_blocks, kb - j0);
  const int tid = threadIdx.x;
  const int row_bytes = bs * L;

  // a tile holds up to TILE_CAND blocks (512 at bs = 1), more than THREADS
  for (int j = tid; j < nb; j += THREADS) {
    const size_t k = (size_t)c * kb + j0 + j;
    s_blk[j] = isfinite(neg[k]) ? (int)blk_ids[k] : -1;
  }
  const float* tsrc = ptab + (size_t)c * L * NAA;
  for (int i = tid; i < L * NAA; i += THREADS) tab[i] = tsrc[i];
  __syncthreads();

  if (VEC) {
    const int cpr = row_bytes / 16;
    for (int i = tid; i < nb * cpr; i += THREADS) {
      const int j = i / cpr;
      const int blk = s_blk[j];
      const int off = (i - j * cpr) * 16;
      if (blk >= 0)
        cp_async16(rows + j * row_bytes + off,
                   db + (size_t)blk * row_bytes + off);
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    for (int i = tid; i < nb * row_bytes; i += THREADS) {
      const int j = i / row_bytes;
      const int blk = s_blk[j];
      if (blk >= 0)
        rows[i] = db[(size_t)blk * row_bytes + (i - j * row_bytes)];
    }
  }
  __syncthreads();

  const size_t out0 = ((size_t)c * kb + j0) * bs;
  for (int base = 0; base < nb * bs; base += THREADS) {
    const int m = base + tid;
    bool hit = false;
    if (m < nb * bs) {
      const int j = m / bs;
      const int i = m - j * bs;
      const int blk = s_blk[j];
      float out = INFINITY;
      if (blk >= 0) {
        const int8_t* mine = rows + j * row_bytes + i * L;
        float acc = 0.0f;
        for (int l = 0; l < L; ++l) acc += tab[l * NAA + mine[l]];
        hit = order[(size_t)blk * bs + i] < n && acc <= r2;
        if (hit) out = acc;
      }
      d2m[out0 + m] = out;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if ((tid & 31) == 0 && mask) atomicAdd(n_hits + c, __popc(mask));
  }
}

// Blocks per tile, and the dynamic shared memory a block needs.
int smem_bytes(int bs, int L, int* tile_blocks) {
  const int tb = bs >= TILE_CAND ? 1 : TILE_CAND / bs;
  *tile_blocks = tb;
  return 4 * NAA * L + (4 * tb + 15) / 16 * 16 + tb * bs * L;
}

}  // namespace

// d2m (C, kb*bs) and n_hits (C,) are written on `stream`.  Returns the
// CUDA error of the launch, 0 on success.
extern "C" int hs_ptable_verify(const float* ptab, const int8_t* db,
                                const int* order, const int64_t* blk_ids,
                                const float* neg, float r2, int n,
                                float* d2m, int* n_hits, int C, int kb,
                                int bs, int L, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(n_hits, 0, sizeof(int) * C, s);
  if (err != cudaSuccess) return (int)err;
  if (C > 0 && kb > 0 && bs > 0) {
    int tb;
    const int smem = smem_bytes(bs, L, &tb);
    const bool vec = (bs * L) % 16 == 0 && (uintptr_t)db % 16 == 0;
    const int tiles = (kb + tb - 1) / tb;
    if (vec) {
      err = cudaFuncSetAttribute(verify_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    } else {
      err = cudaFuncSetAttribute(verify_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    }
    if (err != cudaSuccess) return (int)err;
    for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {
      const dim3 grid(C, tiles - t0 < kMaxGridY ? tiles - t0 : kMaxGridY);
      if (vec)
        verify_kernel<true><<<grid, THREADS, smem, s>>>(
            ptab, db, order, blk_ids, neg, r2, n, d2m, n_hits, kb, bs, L, tb,
            t0);
      else
        verify_kernel<false><<<grid, THREADS, smem, s>>>(
            ptab, db, order, blk_ids, neg, r2, n, d2m, n_hits, kb, bs, L, tb,
            t0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}
