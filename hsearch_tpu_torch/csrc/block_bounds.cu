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
// so are bounded bitwise alike.  The float order is fixed:
//   acc = fmaf(count_a, coords[a, k], acc) over a = 0..19, then acc / cnt;
//   s = fmaf(d, d, s) over k = 0..7;  s += tab[l, row[l]] over l = 0..L-1.
// A residue with count 0 adds fmaf(0, x, acc) = acc exactly (acc is never
// -0), so it is skipped, and a table entry no valid row reads is never
// formed; the results are the same bits as with every residue visited.
//
// What bounds it on Hopper: bytes.  A 2^21-point segment has about 97k
// blocks of 32 rows of L = 25; per block the pass reads 800 bytes of
// rows and 128 of order and writes 804 bytes of bounds, 0.17 GB in all
// (0.05 ms at 3.35 TB/s); its ~800 float operations per position and
// block (the centroid, the table and the row sums) are about 0.03 ms at
// the float32 rate.  Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 8, device time), the kernel takes 0.23 ms there,
// 4.5 times the bound, with 48 warps resident per SM and no spills;
// what holds it there (the issue rate on the per-residue counting and
// summing, or shared memory) is not measured.
//
// Design: a CUDA block of `threads` threads takes tiles of `tile`
// consecutive index blocks in a grid-stride (persistent) loop.  A tile's
// rows are one contiguous span of db and its order entries another; both
// are copied into shared memory with 16-byte cp.async and double
// buffered, so the next tile's copy is in flight while this one is
// computed (`stages` = 2).  Where two tiles of one block do not fit (a
// block of thousands of rows), one tile is staged at a time and order is
// read from global memory (`stages` = 1).  Then, with no atomics:
//   * a warp per (block, 32 rows) ballots order < n into a row mask;
//   * one thread per (block, position) column walks the valid rows of its
//     column and counts residues in counts that only it touches (20
//     shared words laid out [residue][thread], so a warp never hits one
//     bank twice; no per-row test where every row is valid), then forms
//     the column's 8 centroid coordinates from the residues present and
//     writes them as two 16-byte stores (a warp writes a contiguous
//     span); after a barrier the thread writes its column's table entries
//     for those residues (rows of stride 21: conflict-free reads).  Where
//     a tile has more columns than threads (L > threads), the threads
//     take them in rounds of `threads`, and the counts get bytes of their
//     own; else the table reuses the counts' bytes;
//   * each thread sums the L table entries of its rows and keeps their
//     maximum (one row per thread where a tile holds several blocks:
//     tile * bs <= threads);
//   * a warp per block takes the max of its threads' maxima: the radius.
// One launch bounds a whole segment: there is no chunk loop on the host.
// The launch geometry (tile, stages, threads, grid) and the shared-memory
// layout come from ops/cuda_kernels.py:bounds_launch_geometry, the grid
// no larger than the blocks the SMs hold at once
// (hs_block_bounds_occupancy): a block left over would walk its tiles
// alone after the others finish.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NAA = 20;
constexpr int DIM = 8;            // embedding coordinates per residue
constexpr int TSTRIDE = 21;       // table row stride (odd: no bank conflict)
constexpr int MAX_THREADS = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;

// shared memory offsets (bytes) of one CUDA block, in the order of
// ops/cuda_kernels.py:BOUNDS_LAYOUT: valid-row masks, per-thread row-sum
// maxima, the (column, 21) table, the (20, ncp) counts (at tab where they
// share its bytes), two or one staged tiles of stage_bytes (rows_cap of
// rows, then order where staged), and the total
struct Layout {
  int vmask, rsum, tab, cnt, ncp, stage0, rows_cap, stage_bytes, stages,
      total;
};

__device__ __forceinline__ size_t zmin(size_t a, size_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// bytes [s, e) of src (total bytes long) into dst, byte s landing at
// dst + (s & 15): the 16-byte chunks that cover the span, by cp.async
// where src is 16-byte aligned and the chunk lies inside src, else by
// byte loads
__device__ __forceinline__ void stage_span(unsigned char* dst,
                                           const unsigned char* src,
                                           size_t s, size_t e, size_t total,
                                           bool aligned) {
  const size_t a0 = s & ~(size_t)15;
  const int chunks = (int)((((e + 15) & ~(size_t)15) - a0) / 16);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const size_t g = a0 + (size_t)i * 16;
    if (aligned && g + 16 <= total) {
      cp_async16(dst + 16 * i, src + g);
    } else {
      for (int k = 0; k < 16; ++k)
        if (g + k < total) dst[16 * i + k] = src[g + k];
    }
  }
}

// tile t's rows (and its order entries where staged) into stage buffer sb
__device__ __forceinline__ void stage_tile(unsigned char* sb,
                                           const Layout& lay,
                                           const int8_t* db, const int* order,
                                           int t, int tile, int B, int bs,
                                           int L, bool aligned) {
  const size_t row_bytes = (size_t)bs * L, ord_bytes = (size_t)bs * 4;
  const size_t j0 = (size_t)t * tile, j1 = zmin((size_t)B, j0 + tile);
  stage_span(sb, reinterpret_cast<const unsigned char*>(db), j0 * row_bytes,
             j1 * row_bytes, B * row_bytes, aligned);
  if (lay.stages == 2)
    stage_span(sb + lay.rows_cap,
               reinterpret_cast<const unsigned char*>(order),
               j0 * ord_bytes, j1 * ord_bytes, B * ord_bytes, aligned);
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(MAX_THREADS)
    bounds_kernel(const int8_t* __restrict__ db,
                  const int* __restrict__ order,
                  const float* __restrict__ coords_g, int n,
                  float* __restrict__ cent, float* __restrict__ rad, int B,
                  int bs, int L, int tile, Layout lay, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  float* coords = reinterpret_cast<float*>(smem);
  unsigned* vmask = reinterpret_cast<unsigned*>(smem + lay.vmask);
  float* rsum = reinterpret_cast<float*>(smem + lay.rsum);
  float* tab = reinterpret_cast<float*>(smem + lay.tab);
  unsigned* cnt = reinterpret_cast<unsigned*>(smem + lay.cnt) + tid;
  const int W = (bs + 31) / 32;                  // mask words per block
  const size_t row_bytes = (size_t)bs * L, ord_bytes = (size_t)bs * 4;
  const int ntiles = (B + tile - 1) / tile;
  for (int i = tid; i < NAA * DIM; i += T) coords[i] = coords_g[i];

  int t = blockIdx.x, buf = 0;
  if (t < ntiles)
    stage_tile(smem + lay.stage0, lay, db, order, t, tile, B, bs, L, aligned);
  for (; t < ntiles; t += gridDim.x) {
    const int tn = t + gridDim.x;
    if (lay.stages == 2 && tn < ntiles) {
      // the next tile's copy goes into the other buffer, which the
      // previous iteration finished reading before its closing barrier
      stage_tile(smem + lay.stage0 + (buf ^ 1) * lay.stage_bytes, lay, db,
                 order, tn, tile, B, bs, L, aligned);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    const size_t j0 = (size_t)t * tile;
    const int nb = (int)zmin((size_t)tile, (size_t)B - j0);
    const unsigned char* sb = smem + lay.stage0 + buf * lay.stage_bytes;
    const int8_t* rows =
        reinterpret_cast<const int8_t*>(sb + ((j0 * row_bytes) & 15));
    const int* ord =
        lay.stages == 2
            ? reinterpret_cast<const int*>(sb + lay.rows_cap +
                                           ((j0 * ord_bytes) & 15))
            : order + j0 * bs;

    // valid-row masks: a warp per (block, 32 rows)
    for (int w = warp; w < nb * W; w += nwarps) {
      const int j = w / W, r = (w - j * W) * 32 + lane;
      const unsigned m = __ballot_sync(0xffffffffu, r < bs && ord[j * bs + r] < n);
      if (lane == 0) vmask[w] = m;
    }
    __syncthreads();

    // columns, in rounds of T (one round unless L > T): the valid rows'
    // residues counted into the thread's counts; then the centroid; after
    // a barrier (the table may reuse the counts' bytes) the table entries
    for (int c0 = 0; c0 < tile * L; c0 += T) {
      const int c = c0 + tid;
      const bool mine = c < nb * L;
      unsigned present = 0u;
      float cc[DIM];
#pragma unroll
      for (int k = 0; k < DIM; ++k) cc[k] = 0.f;
      if (mine) {
        const int j = c / L, l = c - j * L;
        for (int a = 0; a < NAA; ++a) cnt[a * lay.ncp] = 0u;
        const int8_t* col = rows + (size_t)j * row_bytes + l;
        int nv = 0;
        for (int w = 0; w < W; ++w) {
          unsigned m = vmask[j * W + w];
          nv += __popc(m);
          const int in_word = min(32, bs - 32 * w);
          const int8_t* p = col + (size_t)(32 * w) * L;
          if (m == (in_word == 32 ? 0xffffffffu : (1u << in_word) - 1u)) {
            // every row valid (all but a segment's last blocks): no tests
#pragma unroll 4
            for (int r = 0; r < in_word; ++r, p += L) {
              const int v = *p;
              cnt[v * lay.ncp] += 1u;
              present |= 1u << v;
            }
          } else {
            for (; m; m &= m - 1) {
              const int v = p[(__ffs(m) - 1) * L];
              cnt[v * lay.ncp] += 1u;
              present |= 1u << v;
            }
          }
        }
        const float nf = (float)(nv > 0 ? nv : 1);
        float acc[DIM];
#pragma unroll
        for (int k = 0; k < DIM; ++k) acc[k] = 0.f;
        for (unsigned p = present; p; p &= p - 1) {
          const int a = __ffs(p) - 1;
          const float ca = (float)cnt[a * lay.ncp];
          const float4 x0 = *reinterpret_cast<const float4*>(coords + a * DIM);
          const float4 x1 =
              *reinterpret_cast<const float4*>(coords + a * DIM + 4);
          acc[0] = fmaf(ca, x0.x, acc[0]);
          acc[1] = fmaf(ca, x0.y, acc[1]);
          acc[2] = fmaf(ca, x0.z, acc[2]);
          acc[3] = fmaf(ca, x0.w, acc[3]);
          acc[4] = fmaf(ca, x1.x, acc[4]);
          acc[5] = fmaf(ca, x1.y, acc[5]);
          acc[6] = fmaf(ca, x1.z, acc[6]);
          acc[7] = fmaf(ca, x1.w, acc[7]);
        }
#pragma unroll
        for (int k = 0; k < DIM; ++k) cc[k] = acc[k] / nf;
        float4* dst =
            reinterpret_cast<float4*>(cent + ((j0 + j) * L + l) * DIM);
        dst[0] = nv > 0 ? make_float4(cc[0], cc[1], cc[2], cc[3])
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        dst[1] = nv > 0 ? make_float4(cc[4], cc[5], cc[6], cc[7])
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();   // every count is read: the bytes become the table

      // the column's table entries for the residues present
      if (mine) {
        for (unsigned p = present; p; p &= p - 1) {
          const int a = __ffs(p) - 1;
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            const float d = coords[a * DIM + k] - cc[k];
            s = fmaf(d, d, s);
          }
          tab[c * TSTRIDE + a] = s;
        }
      }
      __syncthreads();
    }

    // rows: the max of the thread's valid rows' L-term sums (0 for none,
    // below any sum); the thread's rows all lie in block tid / bs (one
    // row where tile > 1) or, where tile = 1, in block 0
    {
      float m = 0.f;
      for (int q = tid; q < nb * bs; q += T) {
        const int j = q / bs, r = q - j * bs;
        if ((vmask[j * W + (r >> 5)] >> (r & 31)) & 1u) {
          const int8_t* row = rows + (size_t)q * L;
          const float* tj = tab + j * L * TSTRIDE;
          float s = 0.f;
          for (int l = 0; l < L; ++l) s += tj[l * TSTRIDE + row[l]];
          m = fmaxf(m, s);
        }
      }
      rsum[tid] = m;
    }
    __syncthreads();

    // radius: a warp per block, over the maxima of the block's threads
    for (int j = warp; j < nb; j += nwarps) {
      float m = 0.f;
      for (int r = lane; r < min(bs, T); r += 32)
        m = fmaxf(m, rsum[j * bs + r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) {
        int nv = 0;
        for (int w = 0; w < W; ++w) nv += __popc(vmask[j * W + w]);
        rad[j0 + j] = nv > 0 ? sqrtf(m) : -INFINITY;
      }
    }
    __syncthreads();
    if (lay.stages == 2) {
      buf ^= 1;
    } else if (tn < ntiles) {
      stage_tile(smem + lay.stage0, lay, db, order, tn, tile, B, bs, L,
                 aligned);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

int allow_smem(int smem) {
  if (smem <= SMEM_DEFAULT) return 0;
  return (int)cudaFuncSetAttribute(
      bounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

bool aligned16(int x) { return x >= 0 && x % 16 == 0; }

// the checks a layout must pass: every region 16-byte aligned, in order,
// and inside the total
bool layout_ok(const Layout& o, int tile, int bs, int L, int threads) {
  const int cols = tile * L;
  const bool shared = o.cnt == o.tab;
  return aligned16(o.vmask) && aligned16(o.rsum) && aligned16(o.tab) &&
         aligned16(o.cnt) && aligned16(o.stage0) && aligned16(o.rows_cap) &&
         aligned16(o.stage_bytes) && (o.stages == 1 || o.stages == 2) &&
         o.vmask >= 4 * NAA * DIM &&
         o.rsum >= o.vmask + 4 * tile * ((bs + 31) / 32) &&
         o.tab >= o.rsum + 4 * threads &&
         o.ncp % 32 == 0 && o.ncp >= (shared ? cols : threads) &&
         (shared ? cols <= threads &&
                      o.stage0 >= o.tab + 4 * max(NAA * o.ncp, TSTRIDE * cols)
                 : (cols > threads && o.cnt >= o.tab + 4 * TSTRIDE * cols &&
                    o.stage0 >= o.cnt + 4 * NAA * o.ncp)) &&
         o.rows_cap >= tile * bs * L + 30 &&
         o.stage_bytes >= o.rows_cap +
                              (o.stages == 2 ? 4 * tile * bs + 30 : 0) &&
         o.total >= o.stage0 + o.stages * o.stage_bytes;
}

}  // namespace

// db (B, bs*L) int8 residues in [0, 20); order (B, bs) int32; coords
// (20, 8) f32; cent (B, 8L) and rad (B,) f32, written on `stream`; tile,
// threads, grid and the 10 ints of the shared-memory layout (its last the
// dynamic shared bytes) from bounds_launch_geometry.  Returns the CUDA
// error of the launch, 0 on success (cudaErrorInvalidValue for a
// geometry the kernel cannot take).
extern "C" int hs_block_bounds(const int8_t* db, const int* order,
                               const float* coords, int n, float* cent,
                               float* rad, int B, int bs, int L, int tile,
                               int threads, int grid, const int* layout,
                               void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  Layout lay;
  memcpy(&lay, layout, sizeof lay);
  if (bs < 1 || L < 1 || tile < 1 || grid < 1 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 ||
      (tile > 1 && (tile * L > threads || tile * bs > threads)) ||
      !layout_ok(lay, tile, bs, L, threads) || (uintptr_t)cent % 16)
    return (int)cudaErrorInvalidValue;
  const int err = allow_smem(lay.total);
  if (err) return err;
  const bool aligned = (uintptr_t)db % 16 == 0 &&
                       (lay.stages == 1 || (uintptr_t)order % 16 == 0);
  bounds_kernel<<<(unsigned)grid, threads, lay.total, (cudaStream_t)stream>>>(
      db, order, coords, n, cent, rad, B, bs, L, tile, lay, aligned);
  return (int)cudaGetLastError();
}

// CUDA blocks of `threads` threads and `smem` dynamic shared bytes that one
// SM holds at once, into *blocks.  Returns the CUDA error, 0 on success.
extern "C" int hs_block_bounds_occupancy(int threads, int smem, int* blocks) {
  const int err = allow_smem(smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, bounds_kernel, threads, smem);
}
