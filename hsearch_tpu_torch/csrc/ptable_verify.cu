// ptable_verify: exact squared distances of gathered candidates by P-table
// lookup.
//
// Replaces: hsearch_tpu/ops/pallas_kernels.py:ptable_verify
//           (kernel body _ptable_verify_kernel).
//
//   d2[c, m] = sum_l ptab[c, l, cand[c, m, l]]      (l = 0 .. L-1, in order)
//
// What bounds it on Hopper: bytes.  At the search shapes (C = 1024,
// M = kb*bs = 4096, L = 25) it reads 105 MB of int8 candidates and writes
// 16.8 MB of float32 for 105 M table lookups, far below the card's
// operation rate.
//
// Design: grid (center, candidate tile).  Each block copies its center's
// P-table (L*20 floats, 2 KB at L = 25) into shared memory and stages its
// tile of candidates, which is one contiguous run of TM*L bytes, into shared
// memory with coalesced byte loads, so every candidate byte leaves device
// memory once.  Each thread then sums its candidate's L table entries in
// order l = 0..L-1 in float32 -- the summation order of the plain version
// (ops/distance.ptable_distances), so the result is bitwise equal to it.
// There is no multiply, so no FMA contraction can change the rounding.
//
// Later work: read candidates straight from the block-sorted database by
// block id instead of a separately gathered (C, M, L) array, and fold the
// d2 <= r^2 test and the per-center hit count into the same pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 256;   // candidates per block, one per thread
constexpr int NAA = 20;

__global__ void __launch_bounds__(TM)
ptable_verify_kernel(const float* __restrict__ ptab,
                     const int8_t* __restrict__ cand, float* __restrict__ out,
                     int M, int L) {
  extern __shared__ unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);                 // L * 20
  int8_t* cs = reinterpret_cast<int8_t*>(smem + sizeof(float) * L * NAA);

  const int c = blockIdx.x;
  const int m0 = blockIdx.y * TM;
  const int t = threadIdx.x;
  const int n_here = min(TM, M - m0);

  const float* tsrc = ptab + (size_t)c * L * NAA;
  for (int i = t; i < L * NAA; i += TM) tab[i] = tsrc[i];
  const int8_t* csrc = cand + ((size_t)c * M + m0) * L;
  const int nbytes = n_here * L;
  for (int i = t; i < nbytes; i += TM) cs[i] = csrc[i];
  __syncthreads();

  if (t < n_here) {
    const int8_t* mine = cs + t * L;
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) acc += tab[l * NAA + mine[l]];
    out[(size_t)c * M + m0 + t] = acc;
  }
}

}  // namespace

extern "C" int hs_ptable_verify(const float* ptab, const int8_t* cand,
                                float* out, int C, int M, int L,
                                void* stream) {
  if (C > 0 && M > 0) {
    dim3 grid(C, (M + TM - 1) / TM);
    const size_t smem = sizeof(float) * L * NAA + TM * L;
    ptable_verify_kernel<<<grid, TM, smem, (cudaStream_t)stream>>>(
        ptab, cand, out, M, L);
  }
  return (int)cudaGetLastError();
}
