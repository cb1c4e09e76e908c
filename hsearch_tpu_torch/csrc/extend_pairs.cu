// extend_pairs: the aligner's ungapped seed-extend, a warp per seed pair
// extending G = 32 residues per step, exact in int32.
//
// Replaces: hsearch_tpu/align/extend.py:extend_pairs and
//           extend_pairs_packed (the chunked lax.while_loop phases
//           _greedy_phase and _xdrop_phase), and the window-dense
//           extend_pairs_windowed, which equals them wherever it is
//           valid; the reference's scalar loops are
//           hash_search.cpp:528-588 (seed + greedy) and AlignFwd /
//           AlignBwd :661-716 (x-drop).
//
//   per lane j with (qpos, dpos, qlo, qhi, dlo, dhi) = six[:, j]:
//     aa(x)    = min(x, 20)                  (>= 20: unknown residue)
//     seed     : score, match over seed_len residues from (qpos, dpos)
//     greedy   : forward from the seed end, then backward from
//                seed start - 1, while the murphy10 groups are equal and
//                known (group < 10), within [lo, hi); each residue adds
//                its full BLOSUM62 score
//     x-drop   : forward from the greedy region's end, then backward from
//                its start - 1, both from the post-greedy (gate) score.
//                Each step adds the pair's score (-10^6 past the bound),
//                the running maximum (seeded with the gate score; the
//                first maximum wins) is updated, then the step stops the
//                scan if s < MINSCORE or s < max - drop.  A lane whose
//                gate score is below MINSCORE does not extend.
//     out[:, j] = (score, match, gate_score, gate_match,
//                  q_beg, q_end, d_beg, d_end)          (PACK_KEYS)
//
// This is the algorithm of the port's chunked form
// (hsearch_tpu_torch/align/extend.py:extend_pairs) at chunk width G, so
// the result is bitwise its result for every protein length: integer
// arithmetic has no rounding, and a chunk's width does not change the
// answer of "accumulate, update the maximum, test the stop" (the chunked
// form's cumsum / cummax / first-violation).  Sequence reads are clamped
// to [0, S - 1] as that form's windows are.
//
// What bounds it on Hopper: neither bytes nor operations but latency.
// A batch of 8,192 lanes moves 0.46 MB of seeds and results and reads a
// few MB of residues (from the 50 MB L2); its few million int32
// operations take microseconds at the card's rate.  A lane's extension
// is a chain of dependent steps up to the protein's length long; here a
// step covers G residues, so the chain is length / G steps.  Measured on
// an H100 80GB HBM3 at 700 W (chip_smoke.py phase 9, device time), an
// 8,192-lane call takes 0.012 ms on 120-residue proteins and 0.036 ms
// on 600-residue ones, with 48 warps resident per SM; at 120 residues
// the host's launch (0.026-0.041 ms a call) takes longer than the
// kernel.
//
// Design: the warp's thread t reads the residue pair at offset t of
// the step (G consecutive words of each sequence: one coalesced load) and
// looks its score and murphy10 groups up in shared tables; so a step
// costs one load latency for G residues instead of G:
//   * seed: the warp sums seed_len pairs in parallel;
//   * greedy: a ballot of "in range, groups equal and known" gives the
//     first failure (__ffs); the threads before it add their pair to
//     their own partial sums, reduced once at the end;
//   * x-drop: an inclusive shuffle scan of the step's scores, added to the
//     carried score; an inclusive max scan that keeps the position of the
//     first maximum (ties go to the earlier position); every thread tests
//     s < MINSCORE || s < max(carried max, scan) - drop, and a ballot
//     finds the first violation; the best extension and its match count
//     (a popcount of the match ballot) come from the scan at the stop.
// 8,192 lanes are 8,192 warps, so the card is full where one thread per
// lane left about 2 warps per SM.  The kernel has no window limit: one
// launch extends a batch of any protein length, with no host round-trip
// between steps.  The grid comes from
// ops/cuda_kernels.py:extend_launch_geometry; the entry checks it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 32;             // threads per lane: a warp
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NSUB = 21;          // 20 amino acids + unknown
constexpr int MINSCORE = -20;     // paras.hpp:13
constexpr int OUT_OF_RANGE = -1000000;  // the chunked form's past-bound score

struct Seqs {
  const int* q;
  long long lq;
  const int* d;
  long long ld;
};

__device__ __forceinline__ int aa_at(const int* s, long long len,
                                     long long i) {
  i = i < 0 ? 0 : (i >= len ? len - 1 : i);
  const int v = s[i];
  return v < 0 ? 0 : (v > 20 ? 20 : v);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// lanes 0..k of the warp (k < 32)
__device__ __forceinline__ unsigned upto(int k) { return (2u << k) - 1u; }

// greedy extension from (q0, d0) in direction sign while the murphy10
// groups are equal and known; returns ext (the same on every thread) and
// adds this thread's pairs to *score / *match
__device__ __forceinline__ int greedy(int t, const Seqs& sq, long long q0,
                                      long long d0, int limit, int sign,
                                      const int* sub, const int* grp,
                                      int* score, int* match) {
  int ext = 0;
  for (;;) {
    const int i = ext + t;
    const int a = aa_at(sq.q, sq.lq, q0 + (long long)sign * i);
    const int b = aa_at(sq.d, sq.ld, d0 + (long long)sign * i);
    const int ga = grp[a];
    const unsigned fail =
        __ballot_sync(FULL, !(i < limit && ga == grp[b] && ga < 10));
    const int run = fail ? __ffs(fail) - 1 : G;
    if (t < run) {
      *score += sub[a * NSUB + b];
      *match += (a == b && a < 20);
    }
    ext += run;
    if (run < G) return ext;
  }
}

// x-drop extension from (q0, d0) in direction sign from score0; returns
// the best score's gain over score0 and writes the best extension and its
// match count (the same on every thread)
__device__ __forceinline__ int xdrop(int t, const Seqs& sq, long long q0,
                                     long long d0, int limit, int sign,
                                     int score0, int drop, const int* sub,
                                     int* best_ext, int* best_match) {
  *best_ext = 0;
  *best_match = 0;
  if (score0 < MINSCORE) return 0;
  int s = score0, maxs = score0, m_tot = 0, l_tot = 0;
  for (;;) {
    const int i = l_tot + t;
    const bool in = i < limit;
    const int a = aa_at(sq.q, sq.lq, q0 + (long long)sign * i);
    const int b = aa_at(sq.d, sq.ld, d0 + (long long)sign * i);
    const unsigned mb = __ballot_sync(FULL, in && a == b && a < 20);
    // inclusive scan of the step's scores, from the carried score
    int sc = in ? sub[a * NSUB + b] : OUT_OF_RANGE;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      const int u = __shfl_up_sync(FULL, sc, o);
      if (t >= o) sc += u;
    }
    sc += s;
    // inclusive max scan with the first maximum's rank
    int mx = sc, arg = t;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      const int um = __shfl_up_sync(FULL, mx, o);
      const int ua = __shfl_up_sync(FULL, arg, o);
      if (t >= o && um >= mx) {
        mx = um;
        arg = ua;
      }
    }
    const bool viol = sc < MINSCORE || sc < max(maxs, mx) - drop;
    const unsigned vb = __ballot_sync(FULL, viol);
    const int stop = vb ? __ffs(vb) - 1 : G - 1;
    const int cmax = __shfl_sync(FULL, mx, stop);
    const int carg = __shfl_sync(FULL, arg, stop);
    if (cmax > maxs) {
      maxs = cmax;
      *best_ext = l_tot + carg + 1;
      *best_match = m_tot + __popc(mb & upto(carg));
    }
    s = __shfl_sync(FULL, sc, stop);
    m_tot += __popc(mb & upto(stop));
    l_tot += stop + 1;
    if (vb) return maxs - score0;
  }
}

__global__ void __launch_bounds__(THREADS)
    extend_kernel(Seqs sq, const int* __restrict__ six, long long ld_in,
                  const int* __restrict__ sub_g, const int* __restrict__ grp_g,
                  int drop, int seed_len, int* __restrict__ out, int B) {
  __shared__ int sub[NSUB * NSUB];
  __shared__ int grp[NSUB];
  for (int i = threadIdx.x; i < NSUB * NSUB; i += THREADS) sub[i] = sub_g[i];
  if (threadIdx.x < NSUB) grp[threadIdx.x] = grp_g[threadIdx.x];
  __syncthreads();
  const int t = threadIdx.x & (G - 1);
  const long long j = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
  if (j >= B) return;                 // the whole warp leaves together
  const int qpos = six[j], dpos = six[ld_in + j];
  const int qlo = six[2 * ld_in + j], qhi = six[3 * ld_in + j];
  const int dlo = six[4 * ld_in + j], dhi = six[5 * ld_in + j];

  // seed score and match (hash_search.cpp:551-558), then greedy forward
  // from the seed end and backward from seed start - 1: partial sums per
  // thread, reduced once
  int score = 0, match = 0;
  for (int i = t; i < seed_len; i += G) {
    const int a = aa_at(sq.q, sq.lq, (long long)qpos + i);
    const int b = aa_at(sq.d, sq.ld, (long long)dpos + i);
    score += sub[a * NSUB + b];
    match += (a == b && a < 20);
  }
  const int fwd = max(0, min(qhi - (qpos + seed_len), dhi - (dpos + seed_len)));
  const int gf = greedy(t, sq, (long long)qpos + seed_len,
                        (long long)dpos + seed_len, fwd, 1, sub, grp, &score,
                        &match);
  const int bwd = max(0, min(qpos - qlo, dpos - dlo));
  const int gb = greedy(t, sq, (long long)qpos - 1, (long long)dpos - 1, bwd,
                        -1, sub, grp, &score, &match);
  score = warp_sum(score);
  match = warp_sum(match);
  const int local = seed_len + gf + gb;
  const int q_seed = qpos - gb, d_seed = dpos - gb;

  // x-drop forward from the greedy region's end, backward from its start
  int xf_ext, xf_m, xb_ext, xb_m;
  const int xf_lim = max(0, min(qhi - (q_seed + local), dhi - (d_seed + local)));
  const int xf_s = xdrop(t, sq, (long long)q_seed + local,
                         (long long)d_seed + local, xf_lim, 1, score, drop,
                         sub, &xf_ext, &xf_m);
  const int xb_lim = max(0, min(q_seed - qlo, d_seed - dlo));
  const int xb_s = xdrop(t, sq, (long long)q_seed - 1, (long long)d_seed - 1,
                         xb_lim, -1, score, drop, sub, &xb_ext, &xb_m);

  // thread t < 8 writes field t (a select chain: no local array)
  const int v = t == 0 ? score + xf_s + xb_s
              : t == 1 ? match + xf_m + xb_m
              : t == 2 ? score
              : t == 3 ? match
              : t == 4 ? q_seed - xb_ext
              : t == 5 ? q_seed + local + xf_ext
              : t == 6 ? d_seed - xb_ext
                       : d_seed + local + xf_ext;
  if (t < 8) out[(size_t)t * B + j] = v;
}

}  // namespace

// six: (6, B) int32 rows with row stride ld_in (elements; the lanes of a
// row contiguous); qseq (lq,), dseq (ld,) int32 residues; sub (21*21,)
// and grp (21,) int32 tables; out (8, B) int32 contiguous, written on
// `stream`; threads and grid from extend_launch_geometry.  Returns the
// CUDA error of the launch, 0 on success (cudaErrorInvalidValue for a
// geometry the kernel cannot take).
extern "C" int hs_extend_pairs(const int* qseq, long long lq,
                               const int* dseq, long long ld, const int* six,
                               long long ld_in, const int* sub,
                               const int* grp, int drop, int seed_len,
                               int* out, int B, int threads, int grid,
                               void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (threads != THREADS || grid < 1 ||
      (long long)grid * (THREADS / G) < B)
    return (int)cudaErrorInvalidValue;
  extend_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      Seqs{qseq, lq, dseq, ld}, six, ld_in, sub, grp, drop, seed_len, out, B);
  return (int)cudaGetLastError();
}

// CUDA blocks of `threads` threads that one SM holds at once, into
// *blocks.  Returns the CUDA error, 0 on success.
extern "C" int hs_extend_pairs_occupancy(int threads, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, extend_kernel, threads, 0);
}
