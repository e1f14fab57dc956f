// K3 — instance expansion for tile binning, in two forms.
//
// Replaces the Pallas kernel gsplat_tpu/ops/binning.py::_expand_kernel
// (:84-153, launched by _expand_pallas :156-217):
// - gsplat_expand is its no-extras form (n_extra = 0), the one every
//   bin_gaussians call runs (cull="none", and stage B of cull="exact");
// - gsplat_expand_extras is its extras form (n_extra > 0, :146-150,
//   :163-176, :213-217), the one stage A of exact-cull binning runs
//   (binning.py:280-282) to forward each gaussian's 8 f32 attributes to
//   its tile rows.
//
// What it computes.  The sources are S runs laid end to end in the instance
// axis (for cull="none": one per gaussian in depth order, tiles_touched
// instances each, one per tile for its alignment pads, and a tail sentinel;
// for stage A: one per gaussian, one slot per tile row, and the tail).
// all_offsets[s] is the first instance of source s (non-decreasing; empty
// sources share an offset).  For every instance slot i in [0, I) the owner
// is the LAST source with offset <= i, exactly as the JAX forward fill
// resolves shared offsets.  With k = i - offset and the owner's packed meta
// word (base | rw | colstep, rw_bits wide as binning.py:426-436 packs it):
//     tile = min(base + (k / rw) * grid_x + (k % rw) * colstep, num_tiles)
// and the owner's gaussian id is copied through; the extras form also
// copies the owner's n_extra f32 attributes, extras[j][s] -> out[j][i].
// tile and gid are int32; the TPU kernel's f32 carrier (needed there for its
// one-hot matmul, which selected rows on the MXU) is gone, and the extras
// are a plain copy, bit-equal to the plain version's gather.
//
// Design of K3: a merge path.  The owner of slot i is the last source whose
// offset is <= i, so the owners come from merging the sorted offsets with
// the slots 0..I-1, sources first on ties: source s then sits at
// s + min(offsets[s], I) in the merge, slot i after every source that owns
// it or an earlier slot.  The merge's S + I items are cut into equal shares
// of kItems = 2044 per CTA of 256 threads:
// - partition: one warp finds where the CTA's two diagonals cross the merge,
//   16 lanes an end, each step probing 16 offsets and keeping the span
//   between the last that lies before the diagonal and the first after it
//   (4 dependent loads at S = 264,087, against the 19 of the binary search
//   each slot ran before); the split gives the CTA its sources [a0, a1) and
//   slots [b0, b1), with a1 - a0 + b1 - b0 <= kItems however the sources are
//   shaped (thousands of empty sources at one offset, one source over many
//   CTAs, offsets past I);
// - the window: the CTA's sources and the one before them (the owner of its
//   first slot when no source of its own takes it; 0 if there is none) are
//   staged in shared memory, coalesced;
// - merge: the last source of each tie group marks its offset in a
//   per-slot array, and a block-wide max-scan from the source before the
//   window forward-fills the owners (sources grow along the merge, so the
//   maximum is the last mark).  A scatter and a scan, not a serial walk per
//   thread: no thread searches for its own start, and the work per thread
//   is the same whatever the sources' lengths;
// - decode and write: the CTA's slots, from the multiple of 4 at or below
//   b0 (so 2044 items fit the scan's 2048 entries), four a thread: one
//   division where one source owns all four, and one 16-byte store per
//   output (a warp writes 512 contiguous bytes).
// A CTA whose share holds no slot (inside a run of empty sources, or the
// sources past I) returns after the partition; one that consumes no source
// (inside one long source, such as the tail sentinel that owns about half of
// the asset's slots) decodes every slot from that one source without the
// scan.
//
// Measured on an H100 against this design (PERF.md), and slower: the
// partition as a launch of its own before the kernel, the whole block
// searching (128 lanes an end, 3 steps), three or four shares per CTA, 4
// items a thread, 4-byte stores; two shares per CTA were 2% faster at the
// asset and no faster on the hand-built sources, not worth their loop.
//
// Bound on the H100 (tools/workload.py::expand_bound): the sources read once
// (12 bytes each) and each slot written once (8 bytes) at 3.35 TB/s.  The
// offsets the partition probes and the merge's integer work are costs of
// this design, not of the function, and stay out of it.
//
// K3x keeps the binary search of the parent design: one thread per slot
// searches all_offsets (upper bound, minus one), neighbouring threads walk
// nearly the same path, so the probes of a warp hit the same lines, and the
// whole offsets array (about 1 MB at the 262k-gaussian scene) stays resident
// in L2.  On the device alone it took 0.0329 to 0.0335 ms at the asset's
// stage-A sources on an H100 (PERF.md), within twice its byte bound.
//
// Under overflow (the padded demand exceeds I, or stage A's rows exceed its
// capacity) offsets may exceed I: every slot in [0, I) still gets its owner
// and nothing is written outside [0, I); the caller reports the overflow
// flag.  Offsets that are not sorted give owners that mean nothing, but no
// access outside the arrays.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxExtra = 13;   // 3 + n_extra <= 16 rows, binning.py:168

// K3's merge: the scan covers kScan slots, 8 a thread; a CTA takes kItems
// merged items, so that its slots, shifted back by up to 3 to a multiple of
// 4, fit the scan; kLanes lanes search each of a CTA's two diagonals
// (binning.py SEARCH_LANES)
constexpr int kScan = kThreads * 8;
constexpr int kItems = kScan - 4;
constexpr int kLanes = 16;

// The tile of slot k of a source whose packed meta word is m.
__device__ __forceinline__ int tile_of(int k, int m, int rw_bits, int grid_x,
                                       int num_tiles) {
  const int colstep = m & 1;
  const int rw = (m >> 1) & ((1 << rw_bits) - 1);
  const int base = m >> (rw_bits + 1);
  const int q = k / rw;
  const int tile = base + q * grid_x + (k - q * rw) * colstep;
  return min(tile, num_tiles);
}

// The tiles of slots k .. k + 3 of one source: one division, then the
// quotient and remainder step (k >= 0; tile_of's truncated quotient
// otherwise).
__device__ __forceinline__ int4 tiles_of_run(int k, int m, int rw_bits,
                                             int grid_x, int num_tiles) {
  if (k < 0) {
    return make_int4(tile_of(k, m, rw_bits, grid_x, num_tiles),
                     tile_of(k + 1, m, rw_bits, grid_x, num_tiles),
                     tile_of(k + 2, m, rw_bits, grid_x, num_tiles),
                     tile_of(k + 3, m, rw_bits, grid_x, num_tiles));
  }
  const int colstep = m & 1;
  const int rw = (m >> 1) & ((1 << rw_bits) - 1);
  const int base = m >> (rw_bits + 1);
  int q = k / rw;
  int r = k - q * rw;
  int t[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    t[e] = min(base + q * grid_x + r * colstep, num_tiles);
    if (++r == rw) {
      r = 0;
      ++q;
    }
  }
  return make_int4(t[0], t[1], t[2], t[3]);
}

// Slots i0 .. i0 + 3 (i0 a multiple of 4) of v that lie in [lo, hi): one
// 16-byte store when all four do.
__device__ __forceinline__ void store4(int* __restrict__ out, int i0, int4 v,
                                       int lo, int hi) {
  if (i0 >= lo && i0 + 4 <= hi) {
    *reinterpret_cast<int4*>(out + i0) = v;
    return;
  }
  if (i0 >= lo && i0 < hi) out[i0] = v.x;
  if (i0 + 1 >= lo && i0 + 1 < hi) out[i0 + 1] = v.y;
  if (i0 + 2 >= lo && i0 + 2 < hi) out[i0 + 2] = v.z;
  if (i0 + 3 >= lo && i0 + 3 < hi) out[i0 + 3] = v.w;
}

// The owning source of slot i: the last s with offsets[s] <= i (0 if none).
__device__ __forceinline__ int owner_of(const int* __restrict__ offsets,
                                        int S, int i) {
  // upper bound: first source with offset > i
  int lo = 0;
  int hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo > 0 ? lo - 1 : 0;
}

// Slot i of source s: its tile from the packed meta word, and the gid.
__device__ __forceinline__ void decode_slot(
    const int* __restrict__ offsets, const int* __restrict__ meta,
    const int* __restrict__ gid_src, int s, int i, int rw_bits, int grid_x,
    int num_tiles, int* __restrict__ tile_out, int* __restrict__ gid_out) {
  const int k = i - __ldg(offsets + s);
  const int m = __ldg(meta + s);
  tile_out[i] = tile_of(k, m, rw_bits, grid_x, num_tiles);
  gid_out[i] = __ldg(gid_src + s);
}

// The number of sources among the first d items of the merge, those with
// s + min(offsets[s], I) < d, found by one half-warp: each step probes
// kLanes evenly spaced sources of the span [lo, hi] that holds the answer
// and keeps the stretch between the last probe before the diagonal and the
// first one after it.  All 32 lanes of the warp call it, each half with its
// own d.
__device__ __forceinline__ int merge_split(const int* __restrict__ offsets,
                                           int S, int I, int d) {
  const int lane = threadIdx.x & 31;
  const int probe = lane & (kLanes - 1);
  const int half = lane & kLanes;
  int lo = max(0, d - I);
  int hi = min(d, S);
  while (__any_sync(0xffffffffu, lo < hi)) {
    const bool active = lo < hi;
    const int step = active ? (hi - lo + kLanes - 1) / kLanes : 0;
    const int s = lo + probe * step;
    const bool before =
        active && s < hi && s + min(__ldg(offsets + s), I) < d;
    const int count =
        __popc((__ballot_sync(0xffffffffu, before) >> half) & 0xffffu);
    if (active) {
      if (count == 0) {
        hi = lo;
      } else {
        const int l = lo;
        lo = l + (count - 1) * step + 1;
        hi = min(hi, l + count * step);
      }
    }
  }
  return lo;
}

// CTA blockIdx.x's partition: its first slot, its first source and the
// owner of its first slot.
__device__ __forceinline__ void record_partition(int* __restrict__ part,
                                                 int b0, int a0, int owner) {
  part[3 * blockIdx.x] = b0;
  part[3 * blockIdx.x + 1] = a0;
  part[3 * blockIdx.x + 2] = owner;
}

// K3: CTA c expands the items [c * kItems, (c + 1) * kItems) of the merge.
// kRecord: thread 0 also writes the CTA's partition to part[3c .. 3c + 2]
// (gsplat_expand_partition, checked against binning.expand_partition_plain).
template <bool kRecord>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ offsets, const int* __restrict__ meta,
              const int* __restrict__ gid_src, int S, int I, int rw_bits,
              int grid_x, int num_tiles, int* __restrict__ tile_out,
              int* __restrict__ gid_out, int* __restrict__ part) {
  __shared__ __align__(16) int s_own[kScan];
  __shared__ int s_off[kItems + 1];
  __shared__ int s_meta[kItems + 1];
  __shared__ int s_gid[kItems + 1];
  __shared__ int s_split[2];
  __shared__ int s_warp[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int d0 = blockIdx.x * kItems;
  const int d1 = min(d0 + kItems, S + I);
  if (tid < 32) {
    const int a = merge_split(offsets, S, I, lane < kLanes ? d0 : d1);
    if ((lane & (kLanes - 1)) == 0) s_split[lane / kLanes] = a;
  }
  __syncthreads();
  // sources [a0, a1) and slots [b0, b1) of this CTA; slot i is s_own[i - g0]
  const int a0 = s_split[0];
  const int a1 = s_split[1];
  const int b0 = d0 - a0;
  const int b1 = min(d1 - a1, b0 + kItems);
  // the last source before the window (0 if there is none)
  const int w0 = max(a0 - 1, 0);
  if (kRecord && tid == 0 && (b1 <= b0 || a1 <= a0)) {
    record_partition(part, b0, a0, w0);
  }
  if (b1 <= b0) return;
  const int g0 = b0 & ~3;
  if (a1 <= a0) {
    // inside one source: every slot is w0's
    const int off = __ldg(offsets + w0);
    const int m = __ldg(meta + w0);
    const int g = __ldg(gid_src + w0);
    for (int i0 = g0 + 4 * tid; i0 < b1; i0 += 4 * kThreads) {
      store4(tile_out, i0, tiles_of_run(i0 - off, m, rw_bits, grid_x,
                                        num_tiles), b0, b1);
      store4(gid_out, i0, make_int4(g, g, g, g), b0, b1);
    }
    return;
  }
  // the window: sources [w0, w0 + nw), at most kItems + 1 of them
  const int nw = min(a1 - w0, kItems + 1);
  for (int j = tid; j < nw; j += kThreads) {
    s_off[j] = __ldg(offsets + w0 + j);
    s_meta[j] = __ldg(meta + w0 + j);
    s_gid[j] = __ldg(gid_src + w0 + j);
  }
  int4* own4 = reinterpret_cast<int4*>(s_own);
  for (int j = tid; j < kScan / 4; j += kThreads) {
    own4[j] = make_int4(-1, -1, -1, -1);
  }
  __syncthreads();
  // the last source of each tie group of the CTA's own marks its offset's
  // slot (a tie group that runs on past the window ends at a slot of a later
  // CTA, so the window's last source is last of its group)
  for (int j = a0 - w0 + tid; j < nw; j += kThreads) {
    const int o = s_off[j];
    if (o >= b0 && o < b1 && (j + 1 == nw || s_off[j + 1] != o)) {
      s_own[o - g0] = w0 + j;
    }
  }
  __syncthreads();
  // forward fill: the max-scan of the marks from w0; thread t holds entries
  // [8t, 8t + 8), then the warps' and the block's carries
  int4 v0 = own4[2 * tid];
  int4 v1 = own4[2 * tid + 1];
  v0.y = max(v0.y, v0.x);
  v0.z = max(v0.z, v0.y);
  v0.w = max(v0.w, v0.z);
  v1.x = max(v1.x, v0.w);
  v1.y = max(v1.y, v1.x);
  v1.z = max(v1.z, v1.y);
  v1.w = max(v1.w, v1.z);
  int incl = v1.w;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  const int prev = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 31) s_warp[tid >> 5] = incl;
  __syncthreads();
  int carry = lane > 0 ? max(w0, prev) : w0;
  for (int w = 0; w < (tid >> 5); ++w) carry = max(carry, s_warp[w]);
  own4[2 * tid] = make_int4(max(carry, v0.x), max(carry, v0.y),
                            max(carry, v0.z), max(carry, v0.w));
  own4[2 * tid + 1] = make_int4(max(carry, v1.x), max(carry, v1.y),
                                max(carry, v1.z), max(carry, v1.w));
  __syncthreads();
  if (kRecord && tid == 0) record_partition(part, b0, a0, s_own[b0 - g0]);
  // decode four slots a thread, 16-byte stores; one division where one
  // source owns all four (owners grow along the slots)
  for (int i0 = g0 + 4 * tid; i0 < b1; i0 += 4 * kThreads) {
    const int4 own = own4[(i0 - g0) >> 2];
    int4 tile;
    int4 gid;
    if (own.x == own.w) {
      const int s = own.x - w0;
      tile = tiles_of_run(i0 - s_off[s], s_meta[s], rw_bits, grid_x,
                          num_tiles);
      gid = make_int4(s_gid[s], s_gid[s], s_gid[s], s_gid[s]);
    } else {
      const int s0 = own.x - w0, s1 = own.y - w0;
      const int s2 = own.z - w0, s3 = own.w - w0;
      tile = make_int4(
          tile_of(i0 - s_off[s0], s_meta[s0], rw_bits, grid_x, num_tiles),
          tile_of(i0 + 1 - s_off[s1], s_meta[s1], rw_bits, grid_x,
                  num_tiles),
          tile_of(i0 + 2 - s_off[s2], s_meta[s2], rw_bits, grid_x,
                  num_tiles),
          tile_of(i0 + 3 - s_off[s3], s_meta[s3], rw_bits, grid_x,
                  num_tiles));
      gid = make_int4(s_gid[s0], s_gid[s1], s_gid[s2], s_gid[s3]);
    }
    store4(tile_out, i0, tile, b0, b1);
    store4(gid_out, i0, gid, b0, b1);
  }
}

// K3x: one thread per slot, the owner by binary search; extras[j * S + s]
// copied to extras_out[j * I + i] for every j < n_extra (row-major
// [n_extra, S] in, [n_extra, I] out).
__global__ void __launch_bounds__(kThreads)
expand_extras_kernel(const int* __restrict__ offsets,
                     const int* __restrict__ meta,
                     const int* __restrict__ gid_src,
                     const float* __restrict__ extras, int S, int I,
                     int rw_bits, int grid_x, int num_tiles, int n_extra,
                     int* __restrict__ tile_out, int* __restrict__ gid_out,
                     float* __restrict__ extras_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= I) return;
  const int s = owner_of(offsets, S, i);
  decode_slot(offsets, meta, gid_src, s, i, rw_bits, grid_x, num_tiles,
              tile_out, gid_out);
  for (int j = 0; j < n_extra; ++j) {
    extras_out[static_cast<size_t>(j) * I + i] =
        __ldg(extras + static_cast<size_t>(j) * S + s);
  }
}

template <bool kRecord>
int launch_expand(const void* offsets, const void* meta, const void* gid_src,
                  int S, int I, int rw_bits, int grid_x, int num_tiles,
                  void* tile_out, void* gid_out, void* part, void* stream) {
  if (I <= 0) return 0;
  // the merge's S + I items are counted in int
  if (S <= 0 || S > INT_MAX - I) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the 16-byte stores
  if (((reinterpret_cast<uintptr_t>(tile_out) |
        reinterpret_cast<uintptr_t>(gid_out)) & 15) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int blocks = static_cast<int>(
      (static_cast<long long>(S) + I + kItems - 1) / kItems);
  expand_kernel<kRecord>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(offsets), static_cast<const int*>(meta),
          static_cast<const int*>(gid_src), S, I, rw_bits, grid_x, num_tiles,
          static_cast<int*>(tile_out), static_cast<int*>(gid_out),
          static_cast<int*>(part));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gsplat_expand(const void* offsets, const void* meta,
                             const void* gid_src, int S, int I, int rw_bits,
                             int grid_x, int num_tiles, void* tile_out,
                             void* gid_out, void* stream) {
  return launch_expand<false>(offsets, meta, gid_src, S, I, rw_bits, grid_x,
                              num_tiles, tile_out, gid_out, nullptr, stream);
}

// gsplat_expand that also writes each CTA's partition, 3 ints a CTA, to part
// ([ceil((S + I) / gsplat_expand_items()), 3]).
extern "C" int gsplat_expand_partition(const void* offsets, const void* meta,
                                       const void* gid_src, int S, int I,
                                       int rw_bits, int grid_x, int num_tiles,
                                       void* tile_out, void* gid_out,
                                       void* part, void* stream) {
  return launch_expand<true>(offsets, meta, gid_src, S, I, rw_bits, grid_x,
                             num_tiles, tile_out, gid_out, part, stream);
}

// The merge items each CTA of K3 takes (binning.expand_partition_plain's
// items).
extern "C" int gsplat_expand_items() { return kItems; }

// CTAs of K3 (n_extra 0) or K3x an SM holds at once (0 on an error).
extern "C" int gsplat_expand_occupancy(int n_extra) {
  int n = 0;
  const cudaError_t err =
      n_extra == 0
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, expand_kernel<false>, kThreads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, expand_extras_kernel, kThreads, 0);
  return err == cudaSuccess ? n : 0;
}

extern "C" int gsplat_expand_extras(const void* offsets, const void* meta,
                                    const void* gid_src, const void* extras,
                                    int S, int I, int rw_bits, int grid_x,
                                    int num_tiles, int n_extra,
                                    void* tile_out, void* gid_out,
                                    void* extras_out, void* stream) {
  if (I <= 0) return 0;
  if (n_extra < 1 || n_extra > kMaxExtra) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (I + kThreads - 1) / kThreads;
  expand_extras_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(meta),
      static_cast<const int*>(gid_src), static_cast<const float*>(extras), S,
      I, rw_bits, grid_x, num_tiles, n_extra, static_cast<int*>(tile_out),
      static_cast<int*>(gid_out), static_cast<float*>(extras_out));
  return static_cast<int>(cudaGetLastError());
}
