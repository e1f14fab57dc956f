// K3 — instance expansion for tile binning.
//
// Replaces the Pallas kernel gsplat_tpu/ops/binning.py::_expand_kernel
// (:84-153, launched by _expand_pallas :156-217) in its no-extras form, the
// one bin_gaussians(cull="none") runs.
//
// What it computes.  The sources are S = P + T + 1 runs laid end to end in
// the instance axis: one per gaussian in depth order (tiles_touched
// instances each), one per tile for its alignment pads, and a tail sentinel.
// all_offsets[s] is the first instance of source s (non-decreasing; empty
// sources share an offset).  For every instance slot i in [0, I) the owner
// is the LAST source with offset <= i, exactly as the JAX forward fill
// resolves shared offsets.  With k = i - offset and the owner's packed meta
// word (base | rw | colstep, rw_bits wide as binning.py:426-436 packs it):
//     tile = min(base + (k / rw) * grid_x + (k % rw) * colstep, num_tiles)
// and the owner's gaussian id is copied through.  Both outputs are int32;
// the TPU kernel's f32 carrier (needed there for its one-hot matmul) is gone.
//
// Design.  One thread per slot binary-searches all_offsets (upper bound,
// minus one).  Neighbouring threads walk nearly the same search path, so the
// probes of a warp hit the same lines, and the whole offsets array (about
// 1 MB at the 262k-gaussian scene) stays resident in L2.  The TPU kernel's
// window passes, dominance counts and one-hot selection were there to avoid
// scatters on a machine without cheap gathers; a gather is cheap here.
//
// Bound on the H100.  Bytes: each slot writes 8 bytes and the sources are
// read once (12 bytes each), so at a few million slots the floor is a few
// microseconds of HBM traffic; the search adds about log2(S) dependent L2
// probes per thread, which is what the kernel waits on.  Writes are fully
// coalesced (thread i writes element i of both outputs).
//
// Under overflow (the padded demand exceeds I) offsets may exceed I: the
// search still returns a source for every slot in [0, I) and nothing is
// written outside [0, I); the caller reports the overflow flag.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ offsets, const int* __restrict__ meta,
              const int* __restrict__ gid_src, int S, int I, int rw_bits,
              int grid_x, int num_tiles, int* __restrict__ tile_out,
              int* __restrict__ gid_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= I) return;
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
  const int s = lo > 0 ? lo - 1 : 0;
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
