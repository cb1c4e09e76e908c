// extend_pairs: the aligner's ungapped seed-extend, one thread per seed
// pair, sequential and exact in int32.
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
// (hsearch_tpu_torch/align/extend.py:extend_pairs), step for step, so the
// result is bitwise its result: integer arithmetic has no rounding, and
// the order "accumulate, update the maximum, test the stop" is the
// chunked form's cumsum / cummax / first-violation order.  Sequence
// reads are clamped to [0, S - 1] as that form's windows are.
//
// What bounds it on Hopper: neither bytes nor operations but latency.
// A batch of 8,192 lanes moves 0.46 MB of seeds and results and reads a
// few MB of residues (from the 50 MB L2); its few million int32
// operations take microseconds at the card's rate.  Each lane's scan is
// a chain of dependent steps (a residue pair, one table lookup, a
// running sum), up to the protein's length long, so a lane costs its
// extension's length in dependent loads.  The design keeps each step
// cheap: the 21x21 substitution table and the 21-entry group table sit
// in shared memory, the residues stream through L1 (neighbouring steps
// read neighbouring words), and the lanes of a warp run in lock-step
// with no synchronisation, so the warp costs its longest lane.  The
// kernel has no window limit: one launch extends a batch of any
// protein length, with no host round-trip between steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;       // 128 blocks for an 8,192-lane batch
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

// greedy extension from (q0, d0) in direction sign while the murphy10
// groups are equal and known; returns ext, adds to score / match
__device__ __forceinline__ int greedy(const Seqs& sq, long long q0,
                                      long long d0, int limit, int sign,
                                      const int* sub, const int* grp,
                                      int* score, int* match) {
  int ext = 0;
  while (ext < limit) {
    const int a = aa_at(sq.q, sq.lq, q0 + (long long)sign * ext);
    const int b = aa_at(sq.d, sq.ld, d0 + (long long)sign * ext);
    const int ga = grp[a];
    if (ga != grp[b] || ga >= 10) break;
    *score += sub[a * NSUB + b];
    *match += (a == b && a < 20);
    ++ext;
  }
  return ext;
}

// x-drop extension from (q0, d0) in direction sign from score0; returns
// the best score's gain over score0 and writes the best extension and its
// match count
__device__ __forceinline__ int xdrop(const Seqs& sq, long long q0,
                                     long long d0, int limit, int sign,
                                     int score0, int drop, const int* sub,
                                     int* best_ext, int* best_match) {
  *best_ext = 0;
  *best_match = 0;
  if (score0 < MINSCORE) return 0;
  int s = score0, maxs = score0, m = 0;
  for (int i = 0;; ++i) {
    if (i < limit) {
      const int a = aa_at(sq.q, sq.lq, q0 + (long long)sign * i);
      const int b = aa_at(sq.d, sq.ld, d0 + (long long)sign * i);
      s += sub[a * NSUB + b];
      m += (a == b && a < 20);
    } else {
      s += OUT_OF_RANGE;
    }
    if (s > maxs) {
      maxs = s;
      *best_ext = i + 1;
      *best_match = m;
    }
    if (s < MINSCORE || s < maxs - drop) break;
  }
  return maxs - score0;
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
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= B) return;
  const int qpos = six[j], dpos = six[ld_in + j];
  const int qlo = six[2 * ld_in + j], qhi = six[3 * ld_in + j];
  const int dlo = six[4 * ld_in + j], dhi = six[5 * ld_in + j];

  // seed score and match (hash_search.cpp:551-558)
  int score = 0, match = 0;
  for (int i = 0; i < seed_len; ++i) {
    const int a = aa_at(sq.q, sq.lq, (long long)qpos + i);
    const int b = aa_at(sq.d, sq.ld, (long long)dpos + i);
    score += sub[a * NSUB + b];
    match += (a == b && a < 20);
  }
  // greedy forward from the seed end, then backward from seed start - 1
  const int fwd = max(0, min(qhi - (qpos + seed_len), dhi - (dpos + seed_len)));
  const int gf = greedy(sq, (long long)qpos + seed_len,
                        (long long)dpos + seed_len, fwd, 1, sub, grp, &score,
                        &match);
  const int bwd = max(0, min(qpos - qlo, dpos - dlo));
  const int gb = greedy(sq, (long long)qpos - 1, (long long)dpos - 1, bwd, -1,
                        sub, grp, &score, &match);
  const int local = seed_len + gf + gb;
  const int q_seed = qpos - gb, d_seed = dpos - gb;

  // x-drop forward from the greedy region's end, backward from its start
  int xf_ext, xf_m, xb_ext, xb_m;
  const int xf_lim = max(0, min(qhi - (q_seed + local), dhi - (d_seed + local)));
  const int xf_s = xdrop(sq, (long long)q_seed + local,
                         (long long)d_seed + local, xf_lim, 1, score, drop,
                         sub, &xf_ext, &xf_m);
  const int xb_lim = max(0, min(q_seed - qlo, d_seed - dlo));
  const int xb_s = xdrop(sq, (long long)q_seed - 1, (long long)d_seed - 1,
                         xb_lim, -1, score, drop, sub, &xb_ext, &xb_m);

  const size_t b = (size_t)B;
  out[j] = score + xf_s + xb_s;
  out[b + j] = match + xf_m + xb_m;
  out[2 * b + j] = score;
  out[3 * b + j] = match;
  out[4 * b + j] = q_seed - xb_ext;
  out[5 * b + j] = q_seed + local + xf_ext;
  out[6 * b + j] = d_seed - xb_ext;
  out[7 * b + j] = d_seed + local + xf_ext;
}

}  // namespace

// six: (6, B) int32 rows with row stride ld_in (elements; the lanes of a
// row contiguous); qseq (lq,), dseq (ld,) int32 residues; sub (21*21,)
// and grp (21,) int32 tables; out (8, B) int32 contiguous, written on
// `stream`.  Returns the CUDA error of the launch, 0 on success.
extern "C" int hs_extend_pairs(const int* qseq, long long lq,
                               const int* dseq, long long ld, const int* six,
                               long long ld_in, const int* sub,
                               const int* grp, int drop, int seed_len,
                               int* out, int B, void* stream) {
  if (B > 0) {
    const Seqs sq{qseq, lq, dseq, ld};
    extend_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>(sq, six, ld_in, sub, grp, drop,
                                            seed_len, out, B);
  }
  return (int)cudaGetLastError();
}
