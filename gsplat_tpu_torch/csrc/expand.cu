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
// Design.  One thread per slot binary-searches all_offsets (upper bound,
// minus one).  Neighbouring threads walk nearly the same search path, so the
// probes of a warp hit the same lines, and the whole offsets array (about
// 1 MB at the 262k-gaussian scene) stays resident in L2.  The TPU kernel's
// window passes, dominance counts and one-hot selection were there to avoid
// scatters on a machine without cheap gathers; a gather is cheap here.
//
// Bound on the H100.  Bytes: the sources are read once (12 bytes each, plus
// 4 * n_extra for the extras form) and each slot is written once (8 bytes,
// plus 4 * n_extra), so stage A at the 1080p asset moves
// (3 + 8) * 4 * S_A + (2 + 8) * 4 * I_R bytes; the search adds about
// log2(S) dependent L2 probes per thread, which is what the kernel waits
// on.  Writes are fully coalesced: thread i writes element i of every
// output row.
//
// Under overflow (the padded demand exceeds I, or stage A's rows exceed its
// capacity) offsets may exceed I: the search still returns a source for
// every slot in [0, I) and nothing is written outside [0, I); the caller
// reports the overflow flag.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxExtra = 13;   // 3 + n_extra <= 16 rows, binning.py:168

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
  const int colstep = m & 1;
  const int rw = (m >> 1) & ((1 << rw_bits) - 1);
  const int base = m >> (rw_bits + 1);
  const int q = k / rw;
  const int tile = base + q * grid_x + (k - q * rw) * colstep;
  tile_out[i] = min(tile, num_tiles);
  gid_out[i] = __ldg(gid_src + s);
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ offsets, const int* __restrict__ meta,
              const int* __restrict__ gid_src, int S, int I, int rw_bits,
              int grid_x, int num_tiles, int* __restrict__ tile_out,
              int* __restrict__ gid_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= I) return;
  const int s = owner_of(offsets, S, i);
  decode_slot(offsets, meta, gid_src, s, i, rw_bits, grid_x, num_tiles,
              tile_out, gid_out);
}

// The extras form: the same slot, plus extras[j * S + s] copied to
// extras_out[j * I + i] for every j < n_extra (row-major [n_extra, S] in,
// [n_extra, I] out).
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

}  // namespace

extern "C" int gsplat_expand(const void* offsets, const void* meta,
                             const void* gid_src, int S, int I, int rw_bits,
                             int grid_x, int num_tiles, void* tile_out,
                             void* gid_out, void* stream) {
  if (I <= 0) return 0;
  const int blocks = (I + kThreads - 1) / kThreads;
  expand_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(meta),
      static_cast<const int*>(gid_src), S, I, rw_bits, grid_x, num_tiles,
      static_cast<int*>(tile_out), static_cast<int*>(gid_out));
  return static_cast<int>(cudaGetLastError());
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
