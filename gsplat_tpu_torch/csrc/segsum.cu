// K4 — sorted segment sum: out[s, :] = sum of vals[perm[i], :] over the i
// with sids[i] == s.
//
// Replaces the Pallas kernel gsplat_tpu/ops/segment_reduce.py::_segsum_kernel
// (:38-78, launched by segment_sum_sorted :118).  It is the reduction half of
// the gather's adjoint: the backward composite kernel leaves one gradient
// row per (tile, gaussian) instance, and this kernel sums them per gaussian.
//
// What it computes.  vals [I, R] f32, sids [I] i32 sorted ascending, perm [I]
// i64 (optional: row i of the sorted order lives at vals[perm[i]]; without it
// vals is already in sorted order).  Ids outside [0, num_segments) are dropped
// (the pad sentinel sorts to the end and is never read).  Every output row is
// written, zero for a segment with no rows.
//
// Design.  kLanes = 16 threads per output segment: each finds the segment's
// first row by binary search over the sorted ids (all lanes of a segment read
// the same words, one broadcast transaction), then walks the rows while the id
// still matches, lane c summing column c (columns c, c + 16, ... for R > 16),
// so a row is read as one contiguous run of R floats.  Rows are summed in
// index order by one thread per output word: no atomics, and the same bits
// from run to run.  The TPU kernel's one-hot matmul, its float id row and its
// 1e9 pad block are devices of that machine and are not carried over.
//
// Bound on the H100: bytes.  Each kept row is read once (R floats plus its id
// and permutation entry) and each output word written once; there is one add
// per input value.  Through the permutation the rows are 4R-byte runs at
// scattered addresses, so the sectors moved exceed the bytes used.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;     // threads per output segment
constexpr int kThreads = 256;  // threads per block

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ vals, const int* __restrict__ sids,
              const long long* __restrict__ perm, int I, int R,
              int num_segments, float* __restrict__ out) {
  const long long gt =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long seg = gt / kLanes;
  if (seg >= num_segments) return;
  const int s = static_cast<int>(seg);
  const int lane = threadIdx.x % kLanes;

  // first i with sids[i] >= s
  int lo = 0;
  int hi = I;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(sids + mid) < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  for (int c = lane; c < R; c += kLanes) {
    float acc = 0.f;
    for (int i = lo; i < I && __ldg(sids + i) == s; ++i) {
      const long long r = perm ? __ldg(perm + i) : static_cast<long long>(i);
      acc += __ldg(vals + r * R + c);
    }
    out[static_cast<size_t>(s) * R + c] = acc;
  }
}

}  // namespace

extern "C" int gsplat_segment_sum(const void* vals, const void* sids,
                                  const void* perm, int I, int R,
                                  int num_segments, void* out, void* stream) {
  if (num_segments <= 0 || R <= 0) return 0;
  const long long threads = static_cast<long long>(num_segments) * kLanes;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  segsum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(sids),
      static_cast<const long long*>(perm), I, R, num_segments,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
