// elect: greedy k-mer clustering's first-fit leader election, one block
// per bucket row, one thread per slot, the walk over the row's positions
// inside the kernel.
//
// Replaces: hsearch_tpu/cluster/greedy.py:_elect_device (the lax.scan
//           over bucket positions, :115), which the port's plain version
//           (hsearch_tpu_torch/cluster/greedy.py:_elect_plain) runs as a
//           host loop of about 6 torch ops per position; the reference's
//           walk is hclust2.cpp:107-132.
//
//   per row, slot j: pre_j    = valid_j and state_j == 1
//                    unproc_j = valid_j and state_j == 0
//                    key_j    = j + B (1 - pre_j)   (unique)
//                    avail_j  = pre_j at the start
//   for p = 0 .. B-1 in order, where unproc_p:
//     kmin = min over j of (avail_j and d[p, j] <= r ? key_j : 2B)
//     kmin < 2B : parent[p] = kmin mod B        (absorbed)
//     else      : avail_p = true, parent[p] = -1 (promoted)
//   parent = -1 where the slot is not unprocessed.
//
// A position p that is not unprocessed changes nothing in the plain
// version (its parent is -1 and avail_p keeps its value), so the walk
// visits the unprocessed positions only; the keys are unique, so the
// minimum, and with it the parent, is the plain version's argmin.
//
// Layout: thread j holds pre_j, avail_j, key_j and its parent in
// registers.  A first pass reads, for every unprocessed p, the distance
// d[p, j] (coalesced along j, 32 loads in flight per thread) and keeps
// the test d <= r as one bit of a mask in registers, so the walk touches
// no device memory.  A bit of a position that is not unprocessed is
// never read.  Each step is a warp minimum
// (__reduce_min_sync) and, for rows wider than one warp, a block
// minimum through a double-buffered word per warp in shared memory: one
// __syncthreads() per step, which also makes thread p's update of
// avail_p part of the state that step p+1 reads.
//
// What bounds it on Hopper: the bytes of the distances, once.  A slab
// of 2^20 slots at B = 256 holds 1 GB of them (0.32 ms at 3.35 TB/s)
// against 2^28 distance tests; the walk's B dependent steps per row, a
// reduction and a barrier each, run while other rows' loads stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// NW: 32-bit words of the distance-test mask, ceil(B / 32) rounded up to
// a power of two; blockDim.x = 32 * ceil(B / 32)
template <int NW>
__global__ void __launch_bounds__(NW * 32)
    elect_kernel(const float* __restrict__ d,
                 const uint8_t* __restrict__ state,
                 const uint8_t* __restrict__ valid, float r,
                 long long* __restrict__ parent, int B) {
  __shared__ unsigned umask[NW];        // unprocessed slots of the row
  __shared__ unsigned wmin[2][NW];      // per-warp minima, double-buffered
  const int j = threadIdx.x;
  const int warp = j >> 5, lane = j & 31;
  const int nwarps = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const bool in = j < B;
  const uint8_t st = in ? state[row * B + j] : 2;
  const bool va = in && valid[row * B + j] != 0;
  const bool pre = va && st == 1;
  const bool unproc = va && st == 0;
  const unsigned none = 2u * (unsigned)B;
  const unsigned key = pre ? (unsigned)j : (unsigned)(j + B);
  bool avail = pre;

  const unsigned ballot = __ballot_sync(FULL, unproc);
  if (lane == 0) umask[warp] = ballot;
  for (int w = nwarps + j; w < NW; w += blockDim.x) umask[w] = 0;
  __syncthreads();

  // the distance tests of every unprocessed position, as mask bits; a
  // word's 32 loads are issued before any is tested (+inf where skipped)
  unsigned bits[NW];
  const float* col = d + row * B * B + j;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const unsigned todo = in ? umask[w] : 0u;
    float v[32];
#pragma unroll
    for (int b = 0; b < 32; ++b)
      v[b] = ((todo >> b) & 1u) ? __ldg(col + (long long)(w * 32 + b) * B)
                                : __int_as_float(0x7f800000);
    unsigned x = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b)
      if (v[b] <= r) x |= 1u << b;
    bits[w] = x;
  }

  long long mine = -1;
  int buf = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    unsigned todo = umask[w];
    while (todo) {
      const int b = __ffs(todo) - 1;
      todo &= todo - 1;
      const bool match = avail && ((bits[w] >> b) & 1u);
      unsigned kmin = __reduce_min_sync(FULL, match ? key : none);
      if (nwarps > 1) {
        if (lane == 0) wmin[buf][warp] = kmin;
        __syncthreads();
        kmin = none;
        for (int x = 0; x < nwarps; ++x) kmin = min(kmin, wmin[buf][x]);
        buf ^= 1;
      }
      if (j == w * 32 + b) {
        if (kmin < none)
          mine = kmin < (unsigned)B ? kmin : kmin - B;
        else
          avail = true;
      }
    }
  }
  if (in) parent[row * B + j] = mine;
}

template <int NW>
void launch(const float* d, const uint8_t* state, const uint8_t* valid,
            float r, long long* parent, int NB, int B, cudaStream_t s) {
  elect_kernel<NW><<<NB, 32 * ((B + 31) / 32), 0, s>>>(d, state, valid, r,
                                                       parent, B);
}

}  // namespace

// d (NB, B, B) float32, state (NB, B) uint8, valid (NB, B) bool (one byte
// each), all contiguous; r the radius as float32; parent (NB, B) int64,
// written on `stream`.  B <= 1024.  Returns the CUDA error of the launch,
// 0 on success.
extern "C" int hs_elect(const float* d, const uint8_t* state,
                        const uint8_t* valid, float r, long long* parent,
                        int NB, int B, void* stream) {
  if (NB <= 0) return 0;
  if (B <= 0 || B > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int words = (B + 31) / 32;
  if (words <= 1) launch<1>(d, state, valid, r, parent, NB, B, s);
  else if (words <= 2) launch<2>(d, state, valid, r, parent, NB, B, s);
  else if (words <= 4) launch<4>(d, state, valid, r, parent, NB, B, s);
  else if (words <= 8) launch<8>(d, state, valid, r, parent, NB, B, s);
  else if (words <= 16) launch<16>(d, state, valid, r, parent, NB, B, s);
  else launch<32>(d, state, valid, r, parent, NB, B, s);
  return (int)cudaGetLastError();
}
