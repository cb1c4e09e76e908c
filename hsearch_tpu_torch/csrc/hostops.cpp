// Host passes of hsearch_tpu_torch: OpenMP C++ on the CPU cores, bound with
// ctypes by hsearch_tpu_torch/native_ext.py, which builds this file with
// g++ -fopenmp at first use into hsearch_tpu_torch/_build/.
//
//   * FASTA parsing           (smithlab_os.cpp read_fasta_file equivalent)
//   * suffix-array construction (IGC/shuffle_data/IGC/suffix_array.cpp:
//     exact, not 500-char-capped; prefix doubling)
//   * union-find merging      (pcluster union_find.cpp: smallest root wins)
//   * banded gapped alignment with traceback (hash_search.cpp:718-948's
//     AlignGapped, declared but never called in the reference)
//   * the reference's brute-force motif scan (the wall-clock baseline)
//   * the aligner's seed-index and probe passes: seed codes, stable radix
//     argsorts, searchsorted, the sorted-range probe and the fused pair
//     preparation
//
// Every function is bitwise equal to its numpy twin in
// hsearch_tpu_torch/align/hostops.py (and elsewhere in the package), which
// the tests hold it against.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// ---------------------------------------------------------------------------
// Stable argsort by LSD radix: 8-bit digits, one pass per key byte, a pass
// skipped when one digit holds every key (common: the high bytes of
// (group << 32 | code) keys are mostly zero).  Matches
// np.argsort(keys, kind="stable").  Parallel histogram + chunk-major stable
// scatter.  Key is uint64_t (int64 order; the per-table index sort that
// dominates seed-index builds) or uint32_t (int32 order, n < 2^31: 16
// B/element of temporaries instead of 32, for the giant-group segmented
// build whose one segment holds ~1e9 codes).
// ---------------------------------------------------------------------------
template <typename Key, typename Index>
static void radix_argsort(const Key* keys, int64_t n, Index* order) {
  if (n == 0) return;
  std::vector<Key> kbuf(keys, keys + n), kalt(n);
  std::vector<Index> ibuf(n), ialt(n);
  std::iota(ibuf.begin(), ibuf.end(), (Index)0);
  Key* ksrc = kbuf.data();
  Key* kdst = kalt.data();
  Index* isrc = ibuf.data();
  Index* idst = ialt.data();
  int nthreads = 1;
#ifdef _OPENMP
#pragma omp parallel
  {
#pragma omp single
    nthreads = omp_get_num_threads();
  }
#endif
  const int64_t chunk = (n + nthreads - 1) / nthreads;
  std::vector<int64_t> hist((size_t)nthreads * 256);
  for (int pass = 0; pass < (int)sizeof(Key); ++pass) {
    const int shift = pass * 8;
    std::fill(hist.begin(), hist.end(), 0);
#pragma omp parallel num_threads(nthreads)
    {
#ifdef _OPENMP
      const int t = omp_get_thread_num();
#else
      const int t = 0;
#endif
      int64_t* h = hist.data() + (size_t)t * 256;
      const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      for (int64_t i = lo; i < hi; ++i)
        ++h[(ksrc[i] >> shift) & 0xff];
    }
    bool uniform = false;
    for (int d = 0; d < 256 && !uniform; ++d) {
      int64_t tot = 0;
      for (int t = 0; t < nthreads; ++t) tot += hist[(size_t)t * 256 + d];
      uniform = tot == n;
    }
    if (uniform) continue;
    // exclusive offsets in (digit, thread-chunk) order => stable
    int64_t run = 0;
    for (int d = 0; d < 256; ++d)
      for (int t = 0; t < nthreads; ++t) {
        int64_t* slot = &hist[(size_t)t * 256 + d];
        const int64_t c = *slot;
        *slot = run;
        run += c;
      }
#pragma omp parallel num_threads(nthreads)
    {
#ifdef _OPENMP
      const int t = omp_get_thread_num();
#else
      const int t = 0;
#endif
      int64_t* h = hist.data() + (size_t)t * 256;
      const int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t at = h[(ksrc[i] >> shift) & 0xff]++;
        kdst[at] = ksrc[i];
        idst[at] = isrc[i];
      }
    }
    std::swap(ksrc, kdst);
    std::swap(isrc, idst);
  }
  std::memcpy(order, isrc, (size_t)n * sizeof(Index));
}

extern "C" {

// ---------------------------------------------------------------------------
// Thread-budget pin: cap this process's OpenMP pool.  N cooperating
// processes on one box (the distributed pcluster/hclust2 ranks) each
// default to the FULL core count, and the pools fight.  The Python layer
// calls this once per process with ncores/nproc (HSEARCH_THREADS /
// --threads override).  Returns the effective thread count.
// ---------------------------------------------------------------------------
int64_t hs_set_threads(int64_t n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads((int)n);
  int out = 1;
#pragma omp parallel
  {
#pragma omp single
    out = omp_get_num_threads();
  }
  return out;
#else
  (void)n;
  return 1;
#endif
}

// ---------------------------------------------------------------------------
// FASTA parsing: one pass over the raw bytes; emits AA indices (0..19,
// 20 = unknown) into `seq_out`, per-record start offsets into `starts_out`
// (n_records+1 entries), and name spans into `name_off/name_len`.
// Returns the number of records, or -1 on malformed input.
// Buffers must be caller-allocated: seq_out of len(bytes), starts/name
// arrays of max_records+1.
// ---------------------------------------------------------------------------
int64_t hs_parse_fasta(const char* data, int64_t len, uint8_t* seq_out,
                       int64_t* starts_out, int64_t* name_off,
                       int64_t* name_len, int64_t max_records) {
  static int8_t lut[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) lut[i] = -1;
    const char* aa20 = "ARNDCQEGHILKMFPSTWYV";
    for (int i = 0; i < 20; ++i) {
      lut[(unsigned char)aa20[i]] = (int8_t)i;
      lut[(unsigned char)(aa20[i] + 32)] = (int8_t)i;
    }
    for (int c = 'A'; c <= 'Z'; ++c)
      if (lut[c] < 0) { lut[c] = 20; lut[c + 32] = 20; }
    init = true;
  }
  int64_t n_rec = 0;
  int64_t pos = 0;
  int64_t out = 0;
  starts_out[0] = 0;
  while (pos < len) {
    if (data[pos] == '>') {
      if (n_rec >= max_records) return -1;
      int64_t eol = pos;
      while (eol < len && data[eol] != '\n') ++eol;
      int64_t name_start = pos + 1;
      int64_t name_end = name_start;
      while (name_end < eol && data[name_end] != ' ' &&
             data[name_end] != '\t' && data[name_end] != '\r')
        ++name_end;
      name_off[n_rec] = name_start;
      name_len[n_rec] = name_end - name_start;
      ++n_rec;
      starts_out[n_rec] = out;
      pos = eol + 1;
    } else {
      int64_t eol = pos;
      while (eol < len && data[eol] != '\n') ++eol;
      if (n_rec > 0) {
        for (int64_t i = pos; i < eol; ++i) {
          int8_t v = lut[(unsigned char)data[i]];
          if (v >= 0) seq_out[out++] = (uint8_t)v;
        }
        starts_out[n_rec] = out;
      }
      pos = eol + 1;
    }
  }
  return n_rec;
}

// ---------------------------------------------------------------------------
// Suffix array by prefix doubling with radix-free std::sort on ranks.
// seq: arbitrary int32 symbols; sa_out: caller-allocated length n.
// ---------------------------------------------------------------------------
void hs_suffix_array(const int32_t* seq, int64_t n, int64_t* sa_out) {
  if (n <= 0) return;
  std::vector<int64_t> sa(n), rank(n), tmp(n);
  for (int64_t i = 0; i < n; ++i) { sa[i] = i; rank[i] = seq[i]; }
  for (int64_t k = 1;; k <<= 1) {
    auto cmp = [&](int64_t a, int64_t b) {
      if (rank[a] != rank[b]) return rank[a] < rank[b];
      int64_t ra = a + k < n ? rank[a + k] : -1;
      int64_t rb = b + k < n ? rank[b + k] : -1;
      return ra < rb;
    };
    std::sort(sa.begin(), sa.end(), cmp);
    tmp[sa[0]] = 0;
    for (int64_t i = 1; i < n; ++i)
      tmp[sa[i]] = tmp[sa[i - 1]] + (cmp(sa[i - 1], sa[i]) ? 1 : 0);
    rank = tmp;
    if (rank[sa[n - 1]] == n - 1) break;
  }
  std::memcpy(sa_out, sa.data(), n * sizeof(int64_t));
}

// ---------------------------------------------------------------------------
// Union-find over an edge list; labels_out[i] = smallest reachable root.
// ---------------------------------------------------------------------------
static int64_t uf_find(std::vector<int64_t>& p, int64_t x) {
  while (p[x] != x) { p[x] = p[p[x]]; x = p[x]; }
  return x;
}

void hs_union_find(int64_t n, const int64_t* src, const int64_t* dst,
                   int64_t n_edges, int64_t* labels_out) {
  std::vector<int64_t> p(n);
  std::iota(p.begin(), p.end(), 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t a = uf_find(p, src[e]);
    int64_t b = uf_find(p, dst[e]);
    if (a == b) continue;
    if (a < b) p[b] = a; else p[a] = b;   // smaller root wins
  }
  for (int64_t i = 0; i < n; ++i) labels_out[i] = uf_find(p, i);
}

// ---------------------------------------------------------------------------
// Banded gapped alignment with traceback (the real implementation of the
// reference's declared-but-dead AlignGapped, hash_search.cpp:718-948).
//
// Global-ish alignment of q[0..m) vs d[0..nn) within a diagonal band of
// half-width `band`, affine gaps (gap_open charged on the first gap
// residue, gap_ext after), substitution from a 21x21 matrix (row-major,
// index 20 = unknown).  Early x-drop abandonment when every cell of a row
// falls below best-so-far - drop.
//
// Returns the alignment length (ops written to ops_out: 0=match/mismatch,
// 1=gap-in-d (deletion from q), 2=gap-in-q (insertion)), or -1 if the
// buffers are too small / inputs invalid.  score_out receives the score of
// the best cell; ext1/ext2 the q/d extents of the best-scoring prefix.
// ---------------------------------------------------------------------------
int64_t hs_align_gapped(const int32_t* q, int64_t m, const int32_t* d,
                        int64_t nn, const int32_t* sub21, int32_t gap_open,
                        int32_t gap_ext, int32_t drop, int64_t band,
                        uint8_t* ops_out, int64_t ops_cap,
                        int32_t* score_out, int64_t* ext1, int64_t* ext2) {
  if (m <= 0 || nn <= 0 || band <= 0) return -1;
  const int32_t NEG = -(1 << 28);
  const int64_t w = 2 * band + 1;
  // H/E/F matrices over the band: column j of row i maps to d-index
  // i - band + jj  (jj in [0, w)).
  std::vector<int32_t> H((m + 1) * w, NEG), E((m + 1) * w, NEG),
      F((m + 1) * w, NEG);
  std::vector<uint8_t> bt((m + 1) * w, 255);
  auto idx = [&](int64_t i, int64_t jj) { return i * w + jj; };
  auto dcol = [&](int64_t i, int64_t jj) { return i - band + jj; };
  // row 0: d-gaps from origin
  int32_t best = 0;
  int64_t bi = 0, bj = 0;
  for (int64_t jj = band; jj < w && dcol(0, jj) <= nn; ++jj) {
    int64_t j = dcol(0, jj);
    if (j < 0) continue;
    H[idx(0, jj)] = j == 0 ? 0 : -(gap_open + (int32_t)(j - 1) * gap_ext);
    bt[idx(0, jj)] = j == 0 ? 3 : 2;
  }
  for (int64_t i = 1; i <= m; ++i) {
    bool alive = false;
    for (int64_t jj = 0; jj < w; ++jj) {
      int64_t j = dcol(i, jj);
      if (j < 0 || j > nn) continue;
      int32_t h = NEG, e = NEG, f = NEG;
      uint8_t op = 255;
      // E: gap in q (move along d): from (i, j-1) = (i, jj-1)
      if (jj > 0 && j > 0) {
        int32_t hh = H[idx(i, jj - 1)];
        int32_t ee = E[idx(i, jj - 1)];
        e = std::max(hh - gap_open, ee - gap_ext);
      }
      // F: gap in d (move along q): from (i-1, j) = (i-1, jj+1)
      if (jj + 1 < w) {
        int32_t hh = H[idx(i - 1, jj + 1)];
        int32_t ff = F[idx(i - 1, jj + 1)];
        f = std::max(hh - gap_open, ff - gap_ext);
      }
      // diagonal from (i-1, j-1) = (i-1, jj)
      if (j > 0) {
        int32_t hh = H[idx(i - 1, jj)];
        if (hh > NEG) {
          int32_t s = sub21[q[i - 1] * 21 + d[j - 1]];
          int32_t diag = hh + s;
          if (diag >= e && diag >= f) { h = diag; op = 0; }
        }
      }
      if (op == 255 || e > h || f > h) {
        if (e >= f) { h = e; op = 2; }
        else { h = f; op = 1; }
      }
      E[idx(i, jj)] = e;
      F[idx(i, jj)] = f;
      if (h <= NEG / 2) continue;
      H[idx(i, jj)] = h;
      bt[idx(i, jj)] = op;
      if (h > best) { best = h; bi = i; bj = jj; }
      if (h >= best - drop) alive = true;
    }
    if (!alive && i > 1) break;   // x-drop: the whole row fell away
  }
  *score_out = best;
  *ext1 = bi;
  *ext2 = dcol(bi, bj);
  // traceback from the best cell
  int64_t i = bi, jj = bj;
  int64_t n_ops = 0;
  std::vector<uint8_t> rev;
  rev.reserve(m + nn);
  while (!(i == 0 && dcol(i, jj) == 0)) {
    uint8_t op = bt[idx(i, jj)];
    if (op == 255 || op == 3) break;
    rev.push_back(op);
    if (op == 0) { i -= 1; /* jj unchanged: same column offset */ }
    else if (op == 1) { i -= 1; jj += 1; }
    else { jj -= 1; }
    if ((int64_t)rev.size() > m + nn) return -1;
  }
  n_ops = (int64_t)rev.size();
  if (n_ops > ops_cap) return -1;
  for (int64_t k = 0; k < n_ops; ++k) ops_out[k] = rev[n_ops - 1 - k];
  return n_ops;
}

// ---------------------------------------------------------------------------
// Reference-style brute-force motif search: for every (center, kmer) pair
// sum the per-position squared metric distances (the exact loop of
// motif_both_points_noLSH.cpp:36-56 / PairwiseDistance_square), emitting
// pairs with distance^2 <= r2.  Single-threaded on purpose: this IS the
// reference's baseline algorithm, which examples/bench_scale24.py times
// beside the engines on the card (cpp_qps).
// Returns number of hits written (capped at out_cap).
// ---------------------------------------------------------------------------
int64_t hs_brute_search(const int32_t* centers, int64_t c,
                        const int32_t* kmers, int64_t n, int64_t l,
                        const double* dsq /* 20x20 */, double r2,
                        int64_t* out_ci, int64_t* out_ki, double* out_d2,
                        int64_t out_cap) {
  int64_t hits = 0;
  for (int64_t a = 0; a < c; ++a) {
    const int32_t* ca = centers + a * l;
    for (int64_t b = 0; b < n; ++b) {
      const int32_t* kb = kmers + b * l;
      double d2 = 0.0;
      for (int64_t i = 0; i < l; ++i) d2 += dsq[ca[i] * 20 + kb[i]];
      if (d2 <= r2) {
        if (hits < out_cap) {
          out_ci[hits] = a;
          out_ki[hits] = b;
          out_d2[hits] = d2;
        }
        ++hits;
      }
    }
  }
  return hits;
}

// ---------------------------------------------------------------------------
// Seed-code generation (align/hostops.py host_codes_np + g10_table fused).
// For every position p of the concatenated DB, under the owning sequence's
// end e (starts bracket each sequence) and the murphy10+unknown table
// group21[21]:
//   code    = base-10 6-mer key * 16^3 + 3 suffix nibbles (group, 10 for
//             unknown, 15 past the owning sequence's end)
//   valid6  = all 6 seed residues in-sequence with group < 10
//   valid10 = valid6 and residues 6..9 also in-sequence with group < 10
//   qgrp10  = group of residue p+9 taken from the GLOBAL array (10 past
//             the array) — only read at valid10 positions, where it is
//             in-sequence; global semantics match the numpy twin
//   g10     = group of residue p+9 within the owning sequence, 15 past
//             its end (the "matches anything" probe pass value)
// Parallel over sequences; bit-identical to the numpy implementation at
// every position that any caller reads.
// ---------------------------------------------------------------------------
void hs_seed_codes(const int32_t* seq, int64_t s, const int64_t* starts,
                   int64_t n, const int32_t* group21, uint32_t* code,
                   uint8_t* valid6, uint8_t* valid10, int32_t* qgrp10,
                   int8_t* g10) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t r = 0; r < n; ++r) {
    const int64_t b = starts[r], e = starts[r + 1];
    for (int64_t p = b; p < e; ++p) {
      int64_t key = 0;
      bool v6 = true;
      for (int i = 0; i < 6; ++i) {
        const int64_t q = p + i;
        int32_t gg = 10;
        if (q < s) {
          int32_t v = seq[q];
          gg = group21[v > 20 ? 20 : v];
        }
        key = key * 10 + gg;
        v6 = v6 && gg < 10 && q < e;
      }
      uint32_t c = (uint32_t)key * 4096u;
      for (int i = 0; i < 3; ++i) {
        const int64_t q = p + 6 + i;
        uint32_t nib = 15;
        if (q < e) {
          int32_t v = seq[q];
          nib = (uint32_t)group21[v > 20 ? 20 : v];
        }
        c += nib << (4 * (2 - i));
      }
      bool v10 = v6;
      for (int i = 6; i < 10; ++i) {
        const int64_t q = p + i;
        int32_t gg = 10;
        if (q < s) {
          int32_t v = seq[q];
          gg = group21[v > 20 ? 20 : v];
        }
        v10 = v10 && gg < 10 && q < e;
      }
      code[p] = c;
      valid6[p] = v6;
      valid10[p] = v10;
      const int64_t q9 = p + 9;
      int32_t g9_global = 10;
      if (q9 < s) {
        int32_t v = seq[q9];
        g9_global = group21[v > 20 ? 20 : v];
      }
      qgrp10[p] = g9_global;
      g10[p] = q9 < e ? (int8_t)g9_global : (int8_t)15;
    }
  }
}

void hs_argsort_u64(const uint64_t* keys, int64_t n, int64_t* order) {
  radix_argsort(keys, n, order);
}

void hs_argsort_u32(const uint32_t* keys, int64_t n, int32_t* order) {
  radix_argsort(keys, n, order);
}

// ---------------------------------------------------------------------------
// Parallel searchsorted (side=right) over a sorted int64 array — the
// protein-id-of-position lookups (searchsorted(starts, pos) - 1) run over
// tens of millions of seed-pair positions per table and are
// single-threaded in numpy.
// ---------------------------------------------------------------------------
void hs_searchsorted_right(const int64_t* a, int64_t n, const int64_t* q,
                           int64_t m, int64_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < m; ++i)
    out[i] = std::upper_bound(a, a + n, q[i]) - a;
}

// ---------------------------------------------------------------------------
// Batched sorted-range probe (align/hostops.py probe_sorted).  Two-phase
// protocol so the caller allocates exact-size outputs:
//   hs_probe_count: per query, binary-search the sorted key range, cap at
//     cand_max candidates (first cand_max of the bucket, matching the
//     device probe), count survivors of the 4th-suffix-group filter
//     (g10 == 15 | g10 == qgrp10).  Returns buckets-over-cap count.
//   hs_probe_fill: re-walk the counted candidates, writing survivor
//     (row, dpos) pairs at caller-prefix-summed offsets — ascending
//     (row, bucket order), duplicate-free, exactly the numpy pair order.
// ---------------------------------------------------------------------------
int64_t hs_probe_count(const uint64_t* keys, const int64_t* pos, int64_t p,
                       const uint64_t* qkeys, int64_t nq, const int8_t* g10,
                       const int32_t* qgrp10, int64_t cand_max,
                       int64_t* lo_out, int32_t* cap_out, int32_t* keep_out) {
  int64_t n_over = 0;
#pragma omp parallel for schedule(dynamic, 1024) reduction(+ : n_over)
  for (int64_t i = 0; i < nq; ++i) {
    const uint64_t* lo = std::lower_bound(keys, keys + p, qkeys[i]);
    const uint64_t* hi = std::upper_bound(lo, keys + p, qkeys[i]);
    int64_t cnt = hi - lo;
    if (cnt > cand_max) {
      ++n_over;
      cnt = cand_max;
    }
    const int64_t at = lo - keys;
    int32_t keep = 0;
    for (int64_t j = at; j < at + cnt; ++j) {
      const int8_t g = g10[pos[j]];
      keep += g == 15 || (int32_t)g == qgrp10[i];
    }
    lo_out[i] = at;
    cap_out[i] = (int32_t)cnt;
    keep_out[i] = keep;
  }
  return n_over;
}

// ---------------------------------------------------------------------------
// Fused seed-pair preparation (align/hostops.py pair_prep: search_all's
// probe -> extend glue).  One parallel pass over the probe's (row, dpos) candidate pairs:
//   qpos = qidx[row]                      (probing position of the row)
//   dpid = upper_bound(starts, dpos) - 1  (owning subject protein)
//   drop when starts[dpid+1] - dpos < 10  (subject lacks the full local
//                                          seed, hash_search.cpp:538-540)
//   qpid = upper_bound(starts, qpos) - 1
//   drop when (gids[qpid] << 32 | gids[dpid]) is in the sorted exclude
//     list (pairs an earlier table already aligned)
// then, when tol > 0, the same-diagonal seed-run collapse of
// collapse_diag_runs — sort survivors by (qpid, dpid, diag, qpos) via two
// stable radix passes on the identical composite keys and keep one seed
// per run whose query positions step by <= tol.  Survivors are emitted in
// ascending pair order (the numpy chain's keep.sort() semantics) as the
// extension pipeline's packed layout:
//   six  (6, np) int32 row-major: qpos, dpos, qlo, qhi, dlo, dhi
//   pids (2, np) int32: qpid, dpid
// Returns the survivor count; only [:n_out] of each row is meaningful.
// Bit-identical to the numpy chain (tests/test_torch_native.py).
// ---------------------------------------------------------------------------
int64_t hs_pair_prep(const int64_t* rows, const int64_t* dpos, int64_t np_,
                     const int64_t* qidx,
                     const int64_t* starts, int64_t nprot,
                     const int64_t* gids,
                     const uint64_t* excl, int64_t nexcl,
                     int64_t tol,
                     int32_t* six, int32_t* pids) {
  if (np_ == 0) return 0;
  // phase 1: per-pair pid lookup + filters, survivor flags
  std::vector<int64_t> qpid(np_), dpid(np_);
  std::vector<uint8_t> keep(np_);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < np_; ++i) {
    const int64_t qp = qidx[rows[i]];
    const int64_t dp = dpos[i];
    const int64_t dj = std::upper_bound(starts, starts + nprot + 1, dp)
        - starts - 1;
    const int64_t qj = std::upper_bound(starts, starts + nprot + 1, qp)
        - starts - 1;
    qpid[i] = qj;
    dpid[i] = dj;
    bool ok = starts[dj + 1] - dp >= 10;
    if (ok && nexcl) {
      const uint64_t key = ((uint64_t)gids[qj] << 32) | (uint64_t)gids[dj];
      ok = !std::binary_search(excl, excl + nexcl, key);
    }
    keep[i] = ok;
  }
  // compact survivor indices (stable order)
  std::vector<int64_t> surv;
  surv.reserve(np_);
  for (int64_t i = 0; i < np_; ++i)
    if (keep[i]) surv.push_back(i);
  int64_t ns = (int64_t)surv.size();
  if (ns == 0) return 0;
  if (tol > 0 && ns > 1) {
    // collapse same-diagonal runs: identical composite keys to
    // collapse_diag_runs (k1 multiplier/k2 span need only exceed the
    // max values — ordering, hence the kept set, is unchanged)
    const int64_t s = starts[nprot] + 1;
    std::vector<uint64_t> k1(ns), k2(ns);
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < ns; ++j) {
      const int64_t i = surv[j];
      const int64_t qp = qidx[rows[i]];
      const int64_t diag = qp - dpos[i];
      k1[j] = (uint64_t)qpid[i] * (uint64_t)nprot + (uint64_t)dpid[i];
      k2[j] = (uint64_t)(diag + s) * (uint64_t)s + (uint64_t)qp;
    }
    std::vector<int64_t> o1(ns), o2(ns), order(ns);
    radix_argsort(k2.data(), ns, o1.data());
    std::vector<uint64_t> k1p(ns);
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < ns; ++j) k1p[j] = k1[o1[j]];
    radix_argsort(k1p.data(), ns, o2.data());
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < ns; ++j) order[j] = o1[o2[j]];
    std::vector<uint8_t> run_keep(ns);
    run_keep[0] = 1;
#pragma omp parallel for schedule(static)
    for (int64_t j = 1; j < ns; ++j) {
      const int64_t a = order[j - 1], b = order[j];
      const int64_t ia = surv[a], ib = surv[b];
      const int64_t qa = qidx[rows[ia]], qb = qidx[rows[ib]];
      const bool same = k1[a] == k1[b] &&
          (qa - dpos[ia]) == (qb - dpos[ib]);
      run_keep[j] = !(same && (qb - qa) <= tol);
    }
    std::vector<int64_t> kept;
    kept.reserve(ns);
    for (int64_t j = 0; j < ns; ++j)
      if (run_keep[j]) kept.push_back(surv[order[j]]);
    std::sort(kept.begin(), kept.end());    // ascending pair order
    surv.swap(kept);
    ns = (int64_t)surv.size();
  }
  // phase 2: emit the packed layouts
  int32_t* o_qpos = six;
  int32_t* o_dpos = six + np_;
  int32_t* o_qlo = six + 2 * np_;
  int32_t* o_qhi = six + 3 * np_;
  int32_t* o_dlo = six + 4 * np_;
  int32_t* o_dhi = six + 5 * np_;
  int32_t* o_qpid = pids;
  int32_t* o_dpid = pids + np_;
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < ns; ++j) {
    const int64_t i = surv[j];
    const int64_t qj = qpid[i], dj = dpid[i];
    o_qpos[j] = (int32_t)qidx[rows[i]];
    o_dpos[j] = (int32_t)dpos[i];
    o_qlo[j] = (int32_t)starts[qj];
    o_qhi[j] = (int32_t)starts[qj + 1];
    o_dlo[j] = (int32_t)starts[dj];
    o_dhi[j] = (int32_t)starts[dj + 1];
    o_qpid[j] = (int32_t)qj;
    o_dpid[j] = (int32_t)dj;
  }
  return ns;
}

void hs_probe_fill(const int64_t* pos, const int64_t* lo, const int32_t* cap,
                   const int64_t* offs, int64_t nq, const int8_t* g10,
                   const int32_t* qgrp10, int64_t* rows_out,
                   int64_t* dpos_out) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t i = 0; i < nq; ++i) {
    int64_t out = offs[i];
    const int64_t at = lo[i];
    for (int64_t j = at; j < at + cap[i]; ++j) {
      const int64_t id = pos[j];
      const int8_t g = g10[id];
      if (g == 15 || (int32_t)g == qgrp10[i]) {
        rows_out[out] = i;
        dpos_out[out] = id;
        ++out;
      }
    }
  }
}

}  // extern "C"
