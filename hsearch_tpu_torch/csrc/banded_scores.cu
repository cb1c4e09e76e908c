// banded_scores: the --gapped refinement's banded affine-gap score scan,
// one warp per window pair, the whole row loop inside the kernel, exact
// in int32.
//
// Replaces: hsearch_tpu/align/gapped_device.py:banded_scores (the
//           lax.scan over query rows, :114), which the port's plain
//           version (hsearch_tpu_torch/align/gapped_device.py:
//           banded_scores_plain) runs as a host loop of about 20 torch
//           ops per row.
//
//   per pair, lanes jj = 0 .. w-1 (w = 2*band+1) on the diagonal band,
//   row i's lane jj at column j = i - band + jj:
//     row 0   : H = 0 at j = 0, -(go + (j-1) ge) for 0 < j <= dlen, else
//               NEG; F = NEG
//     row i   : F[jj]  = max(H'[jj+1] - go, F'[jj+1] - ge, NEG)
//               (H', F' the previous row; NEG past the last lane)
//               D[jj]  = H'[jj] + sub[q[i-1], d[j-1]] if j > 0 and
//                        H'[jj] > NEG/2, else NEG
//               A[jj]  = max(D, F) in the band (0 <= j <= dlen), else NEG
//               M[jj]  = max(A - go, NEG) + jj ge
//               E[jj]  = max(max(M[0..jj-1]) - (jj-1) ge, NEG) for
//                        jj > 0 and j > 0, else NEG
//               H[jj]  = max(A, E) in the band, else NEG
//     best    : the first lane of the row maximum, if it beats the best
//               so far strictly (row-major first occurrence); the pair
//               is dead after a row i > 1 in which no lane reaches
//               best - drop, and a dead pair never updates again.
//
// This is the plain version's arithmetic, in its order and with its
// clamps at NEG, so the results are bitwise its results.  The wrapper
// keeps the penalties (< 2^20) and |drop| (<= 2^30) where no
// intermediate value can leave int32, as in the plain version.  The scan
// stops at the pair's own qlen (later rows are out of the band) or at
// the row it dies in: past either, the plain version never changes the
// result.
//
// Layout: lanes are split into contiguous chunks of C = ceil(w/32) per
// thread (lane jj on thread jj / C).  F's shift by one lane crosses chunk
// boundaries through __shfl_down_sync; E's exclusive prefix maximum is a
// thread-local prefix maximum plus a warp scan of the chunk maxima
// (__shfl_up_sync); the row maximum is __reduce_max_sync, its first lane
// the lowest thread of a ballot; "alive" is __any_sync.  sub21 sits in
// shared memory, the residues are read through L1 (a row's window is
// the previous row's shifted by one).
//
// What bounds it on Hopper: operations, and the row chain.  A batch of
// 65,536 windows of about 120 x 120 residues moves some 60 MB of
// residues (0.02 ms) but needs about 24 int32 operations per lane and
// row, some 10^10 in all (0.7 ms at the card's int32 rate); and each row
// depends on the one before it, through registers and about 15 warp
// shuffles, so a pair also costs its rows in latency.  The design keeps
// every row in registers and shuffles (no shared-memory round trip and
// no block barrier), stops each pair as early as the plain version's
// result allows, and keeps enough warps resident to hide one row's
// latency behind others.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int DEAD_LIM = NEG / 2;
constexpr int NSUB = 21;          // 20 amino acids + unknown
constexpr int WARPS = 4;          // pairs per block
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int* q;
  const int* qlen;
  const int* d;
  const int* dlen;
  int lq, ld;
  const int* sub;
  int go, ge, drop, band;
  int* best;
  int* bi;
  int* bj;
  int P;
};

__device__ __forceinline__ int aa(int v) {
  return v < 0 ? 0 : (v > 20 ? 20 : v);
}

template <int C>
__global__ void __launch_bounds__(WARPS * 32)
    banded_kernel(const Args a) {
  __shared__ int sub[NSUB * NSUB];
  for (int i = threadIdx.x; i < NSUB * NSUB; i += WARPS * 32)
    sub[i] = a.sub[i];
  __syncthreads();
  const int pair = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= a.P) return;          // the whole warp leaves together
  const int t = threadIdx.x & 31;
  const int w = 2 * a.band + 1;
  const int go = a.go, ge = a.ge;
  const int* q = a.q + (long long)pair * a.lq;
  const int* d = a.d + (long long)pair * a.ld;
  const int dlen = a.dlen[pair];
  const int rows = min(a.qlen[pair], a.lq);
  const int lane0 = t * C;

  // row 0: gaps in d from the origin; lanes past w hold NEG throughout
  int h[C], f[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int lane = lane0 + k;
    const int j0 = lane - a.band;
    int v = NEG;
    if (lane < w && j0 >= 0 && j0 <= dlen)
      v = j0 == 0 ? 0 : -(go + (j0 - 1) * ge);
    h[k] = v;
    f[k] = NEG;
  }

  int best = 0, bi = 0, bj = -a.band;
  for (int i = 1; i <= rows; ++i) {
    // (i-1, jj+1) for the chunk's last lane: the next thread's first
    const int h_next = __shfl_down_sync(FULL, h[0], 1);
    const int f_next = __shfl_down_sync(FULL, f[0], 1);
    const int* srow = sub + aa(q[i - 1]) * NSUB;
    int av[C], pl[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int lane = lane0 + k;
      const int j = i - a.band + lane;
      int hu = NEG, fu = NEG;
      if (k + 1 < C) {
        hu = h[k + 1];
        fu = f[k + 1];
      } else if (t < 31) {
        hu = h_next;
        fu = f_next;
      }
      const int fv = max(max(hu - go, fu - ge), NEG);
      int am = NEG;
      if (lane < w && j >= 0 && j <= dlen) {
        int jd = j - 1;
        jd = jd < 0 ? 0 : (jd > a.ld ? a.ld : jd);
        const int dc = jd == a.ld ? 20 : aa(d[jd]);
        const int diag = (j > 0 && h[k] > DEAD_LIM) ? h[k] + srow[dc] : NEG;
        am = max(diag, fv);
      }
      av[k] = am;
      f[k] = lane < w ? fv : NEG;
      // M, and its prefix maximum within the chunk
      const int m = max(am - go, NEG) + lane * ge;
      pl[k] = k == 0 ? m : max(pl[k - 1], m);
    }
    // inclusive warp scan of the chunk maxima, then the exclusive one
    int incl = pl[C - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (t >= off) incl = max(incl, y);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (t == 0) excl = INT_MIN;

    int rmax = INT_MIN, rarg = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int lane = lane0 + k;
      const int j = i - a.band + lane;
      const bool live = lane < w && j >= 0 && j <= dlen;
      int e = NEG;
      if (lane > 0 && j > 0) {
        const int prev = k == 0 ? excl : max(excl, pl[k - 1]);
        e = max(prev - max(lane * ge - ge, 0), NEG);
      }
      const int hv = live ? max(av[k], e) : NEG;
      h[k] = hv;
      if (lane < w && hv > rmax) {
        rmax = hv;
        rarg = lane;
      }
    }
    const int row_max = __reduce_max_sync(FULL, rmax);
    if (row_max > best) {
      // the lowest thread holding the maximum holds its first lane
      const unsigned holders = __ballot_sync(FULL, rmax == row_max);
      const int first = __shfl_sync(FULL, rarg, __ffs(holders) - 1);
      best = row_max;
      bi = i;
      bj = (i - a.band) + first;
    }
    const int floor_ = best - a.drop;
    bool reach = false;
#pragma unroll
    for (int k = 0; k < C; ++k)
      reach |= lane0 + k < w && h[k] >= floor_;
    if (i > 1 && !__any_sync(FULL, reach)) break;
  }
  if (t == 0) {
    a.best[pair] = best;
    a.bi[pair] = bi;
    a.bj[pair] = bj;
  }
}

template <int C>
void launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.P + WARPS - 1) / WARPS;
  banded_kernel<C><<<blocks, WARPS * 32, 0, stream>>>(a);
}

}  // namespace

// q (P, lq) and d (P, ld) int32 residues, qlen / dlen (P,) int32, sub
// (21*21,) int32, all contiguous; go, ge, drop, band as the wrapper
// checked them (band <= 127); best / bi / bj (P,) int32, written on
// `stream`.  Returns the CUDA error of the launch, 0 on success.
extern "C" int hs_banded_scores(const int* q, const int* qlen, const int* d,
                                const int* dlen, int lq, int ld,
                                const int* sub, int go, int ge, int drop,
                                int band, int* best, int* bi, int* bj,
                                int P, void* stream) {
  const int chunk = (2 * band + 1 + 31) / 32;
  if (P <= 0) return 0;
  if (band < 0 || chunk > 8) return (int)cudaErrorInvalidValue;
  const Args a{q, qlen, d, dlen, lq, ld, sub, go, ge, drop, band, best,
               bi, bj, P};
  cudaStream_t s = (cudaStream_t)stream;
  switch (chunk) {
    case 1: launch<1>(a, s); break;
    case 2: launch<2>(a, s); break;
    case 3: launch<3>(a, s); break;
    case 4: launch<4>(a, s); break;
    case 5: launch<5>(a, s); break;
    case 6: launch<6>(a, s); break;
    case 7: launch<7>(a, s); break;
    default: launch<8>(a, s); break;
  }
  return (int)cudaGetLastError();
}
