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
// written, zero for a segment with no rows.  Each output word is summed by
// one thread, in index order, from 0.f: no atomics, and the same bits from
// run to run.
//
// Design.  Two launches behind one C entry.
//   1. Segment bounds, one coalesced pass over the sorted ids and no search:
//      thread i in [0, I] writes seg_start[s] = i for every segment s with
//      sids[i-1] < s <= sids[i] (sids[-1] = -inf, sids[I] = +inf), clipped
//      to [0, num_segments]: seg_start[s] is then the first row of segment s
//      (segment_reduce.py::segment_bounds_plain is this pass in torch).  Two
//      runs are left unwritten and named instead: the thread whose range
//      holds the first kept id writes only that id's start and the id as
//      `head` (the segments before it are empty), the thread whose range
//      reaches num_segments writes only its first segment's start and that
//      segment as `tail` (the empty segments after the last kept id, the
//      model's dead slots among them); the sums clamp s into [head, tail].
//      A range longer than 32 segments inside is written by its whole warp.
//   2. The sums: a warp per 32 consecutive segments, whose rows are one
//      contiguous run [A, B) of the sorted order.  Lane l owns the output
//      words e = l + 32 j (j < R) of the warp's [32, R] block, each summed
//      alone, so all 32 lanes are busy at any R and the stores are
//      contiguous.  The run is walked 32 rows at a time: the warp reads the
//      32 perm entries in one coalesced load and hands each row's out by
//      shuffle, the lanes issue the 32 rows' R loads (R in flight a lane,
//      neighbouring lanes on neighbouring words of a row) into shared
//      memory, and each lane then adds its words' rows of the chunk from
//      there in order.  The next chunk's loads are issued before this
//      chunk's adds, and its perm entries a chunk earlier still, so a long
//      segment costs its adds, not a load latency a row.  R is a template
//      argument up to 16; a wider row is summed in windows of 16 columns.
//   The TPU kernel's one-hot matmul, its float id row and its 1e9 pad block
//   are devices of that machine and are not carried over.
//
// Bound on the H100: bytes.  Each kept row is read once (R floats plus its
// permutation entry), the ids once, each output word written once; there is
// one add per input value.  Through the permutation the rows are 4R-byte runs
// at scattered addresses, so the sectors moved exceed the bytes used.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // threads per block, both launches
constexpr int kWarps = kThreads / 32;
constexpr int kSegs = 32;                // segments a warp sums
constexpr int kMaxCols = 16;             // columns one sum launch takes
constexpr int kLongRun = 32;             // a range longer is the warp's
constexpr unsigned kFull = 0xffffffffu;

// seg_start [num_segments + 3]: the bounds, then head and tail.
__global__ void __launch_bounds__(kThreads)
segment_bounds_kernel(const int* __restrict__ sids, int I, int ns,
                      int* __restrict__ seg_start) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long s0 = 0;  // this thread's segments s0 .. s1 (none if s1 < s0)
  long long s1 = -1;
  if (i <= I) {
    const long long lo =
        i > 0 ? static_cast<long long>(__ldg(sids + i - 1)) : LLONG_MIN / 2;
    const long long hi =
        i < I ? static_cast<long long>(__ldg(sids + i)) : LLONG_MAX / 2;
    int* ends = seg_start + ns + 1;
    if (lo < 0 && hi >= ns) {            // no kept row: every segment empty
      seg_start[0] = static_cast<int>(i);
      ends[0] = 0;
      ends[1] = 0;
    } else if (lo < 0 && hi >= 0) {      // the first kept id: head
      seg_start[hi] = static_cast<int>(i);
      ends[0] = static_cast<int>(hi);
    } else if (lo < ns && hi >= ns) {    // past the last kept id: tail
      seg_start[lo + 1] = static_cast<int>(i);
      ends[1] = static_cast<int>(lo + 1);
    } else if (lo >= 0 && hi < ns) {
      s0 = lo + 1;
      s1 = hi;
    }
  }
  if (s1 - s0 < kLongRun) {
    for (long long s = s0; s <= s1; ++s) seg_start[s] = static_cast<int>(i);
  }
  // the long ranges, each by the whole warp
  unsigned longs = __ballot_sync(kFull, s1 - s0 >= kLongRun);
  while (longs) {
    const int src = __ffs(longs) - 1;
    longs &= longs - 1;
    const int a = __shfl_sync(kFull, static_cast<int>(s0), src);
    const int b = __shfl_sync(kFull, static_cast<int>(s1), src);
    const int v = __shfl_sync(kFull, static_cast<int>(i), src);
    for (int s = a + lane; s <= b; s += 32) seg_start[s] = v;
  }
}

// The 32 rows from `row` (those before `end`) of the sorted order as the
// warp's lanes hold them: lane l's perm entry.
__device__ __forceinline__ long long perm_entry(
    const long long* __restrict__ perm, int row, int end, int lane) {
  const int r = row + lane;
  if (r >= end) return 0;
  return perm != nullptr ? __ldg(perm + r) : static_cast<long long>(r);
}

// Element e = lane + 32 j of the chunk's [32, RT] block (columns c0 ..
// c0 + RT - 1 of its rows), zero past `end`.
template <int RT>
__device__ __forceinline__ void gather_chunk(
    const float* __restrict__ vals, int R, int c0, long long p, int row,
    int end, int lane, float (&v)[RT]) {
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    const int e = lane + 32 * j;
    const int rr = e / RT;
    const long long src = __shfl_sync(kFull, p, rr);
    v[j] = row + rr < end ? __ldg(vals + src * R + c0 + (e - rr * RT)) : 0.f;
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals,
                   const long long* __restrict__ perm,
                   const int* __restrict__ seg_start, int ns, int R, int c0,
                   float* __restrict__ out) {
  __shared__ float s_val[kWarps][kSegs * RT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long sb =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kSegs;
  if (sb >= ns) return;  // the same for the whole warp
  const int head = __ldg(seg_start + ns + 1);
  const int tail = __ldg(seg_start + ns + 2);
  const int nseg = static_cast<int>(min(static_cast<long long>(kSegs),
                                        ns - sb));
  // this lane's segment [a, b); the segments outside [head, tail) are empty
  int a = 0;
  int b = 0;
  if (lane < nseg) {
    const int s = static_cast<int>(sb) + lane;
    a = __ldg(seg_start + min(max(s, head), tail));
    b = __ldg(seg_start + min(max(s + 1, head), tail));
  }
  const int A = __shfl_sync(kFull, a, 0);
  const int B = __shfl_sync(kFull, b, nseg - 1);
  // the rows of each of this lane's words
  float acc[RT];
  int lo[RT], hi[RT];
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    const int seg = (lane + 32 * j) / RT;
    acc[j] = 0.f;
    lo[j] = __shfl_sync(kFull, a, seg);
    hi[j] = __shfl_sync(kFull, b, seg);
  }
  float* sv = s_val[warp];
  float v[RT];
  gather_chunk<RT>(vals, R, c0, perm_entry(perm, A, B, lane), A, B, lane, v);
  long long p_next = perm_entry(perm, A + 32, B, lane);
  for (int c = A; c < B; c += 32) {
    __syncwarp();  // the previous chunk's values have been added
#pragma unroll
    for (int j = 0; j < RT; ++j) sv[lane + 32 * j] = v[j];
    __syncwarp();
    // the next chunk's loads before this chunk's adds
    gather_chunk<RT>(vals, R, c0, p_next, c + 32, B, lane, v);
    p_next = perm_entry(perm, c + 64, B, lane);
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int col = (lane + 32 * j) % RT;
      const int r1 = min(hi[j], c + 32);
      for (int r = max(lo[j], c); r < r1; ++r) {
        acc[j] += sv[(r - c) * RT + col];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    const int e = lane + 32 * j;
    const int seg = e / RT;
    if (seg < nseg) out[(sb + seg) * R + c0 + (e - seg * RT)] = acc[j];
  }
}

template <int RT>
int launch_sum(const float* vals, const long long* perm, const int* bounds,
               int ns, int R, int c0, float* out, cudaStream_t stream) {
  const long long blocks =
      (static_cast<long long>(ns) + kWarps * kSegs - 1) / (kWarps * kSegs);
  segment_sum_kernel<RT><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(vals, perm, bounds, ns, R, c0, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_window(const float* vals, const long long* perm, const int* bounds,
                  int ns, int R, int c0, int width, float* out,
                  cudaStream_t s) {
#define GSPLAT_K4_CASE(W) \
  case W: return launch_sum<W>(vals, perm, bounds, ns, R, c0, out, s)
  switch (width) {
    GSPLAT_K4_CASE(1); GSPLAT_K4_CASE(2); GSPLAT_K4_CASE(3);
    GSPLAT_K4_CASE(4); GSPLAT_K4_CASE(5); GSPLAT_K4_CASE(6);
    GSPLAT_K4_CASE(7); GSPLAT_K4_CASE(8); GSPLAT_K4_CASE(9);
    GSPLAT_K4_CASE(10); GSPLAT_K4_CASE(11); GSPLAT_K4_CASE(12);
    GSPLAT_K4_CASE(13); GSPLAT_K4_CASE(14); GSPLAT_K4_CASE(15);
    GSPLAT_K4_CASE(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSPLAT_K4_CASE
}

}  // namespace

// The int32 words of the scratch gsplat_segment_sum takes for num_segments.
extern "C" int gsplat_segment_sum_scratch(int num_segments) {
  return num_segments + 3;
}

// scratch: gsplat_segment_sum_scratch(num_segments) int32 words, written
// and read by the two launches.
extern "C" int gsplat_segment_sum(const void* vals, const void* sids,
                                  const void* perm, int I, int R,
                                  int num_segments, void* scratch, void* out,
                                  void* stream) {
  if (num_segments <= 0 || R <= 0) return 0;
  if (I < 0 || num_segments > INT_MAX - 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* bounds = static_cast<int*>(scratch);
  const long long bblocks = (static_cast<long long>(I) + kThreads) / kThreads;
  segment_bounds_kernel<<<static_cast<unsigned>(bblocks), kThreads, 0, s>>>(
      static_cast<const int*>(sids), I, num_segments, bounds);
  int err = static_cast<int>(cudaGetLastError());
  for (int c0 = 0; c0 < R && err == 0; c0 += kMaxCols) {
    err = launch_window(static_cast<const float*>(vals),
                        static_cast<const long long*>(perm), bounds,
                        num_segments, R, c0, min(kMaxCols, R - c0),
                        static_cast<float*>(out), s);
  }
  return err;
}
