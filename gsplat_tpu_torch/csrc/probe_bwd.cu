// P2 — the backward composite K2 under cost-attribution knockouts.
//
// Replaces the Pallas kernels of the backward probes in tools/:
// bench_bwd_attrib.py::_kernel (:49, launched at :205; variants base,
// mxu_moments, exp2, no_alpha, no_moments, no_dfeat) and
// bench_kernels.py::_pallas_bwd_variant (:284, launched at :287) over
// composite_pallas._backward_kernel and _bwd_kernel_B (:170, the
// pixel-moment basis).
//
// What it computes: K2's kernel (composite_bwd.cuh) in one of its variants,
// which that file describes; `base` is K2's own form.  The plain version is
// gsplat_tpu_torch/tools/probes.py::probe_backward_plain.
//
// Compiled for C = 7 (the training path's channels) and for a runtime C, the
// two forms the probes run.
//
// Bound on the H100: operations, as K2's; chip_smoke.py counts each
// variant's own pairs.
#include "composite_bwd.cuh"

namespace {

template <int CT>
int launch_variant(int variant, const float* tb, int P, int C, int Cg,
                   const int* gid, const int* st, const int* ct,
                   int num_tiles, int grid_x, int tile_x, int tile_y,
                   const float* pk, const float* dp, float* o,
                   cudaStream_t s) {
#define GSPLAT_P2_CASE(V)                                                    \
  case V:                                                                    \
    return launch_backward<CT, V>(tb, P, C, Cg, gid, st, ct, num_tiles,      \
                                  grid_x, tile_x, tile_y, pk, dp, o, s)
  switch (variant) {
    GSPLAT_P2_CASE(kBwdBase);
    GSPLAT_P2_CASE(kMomentsBasis);
    GSPLAT_P2_CASE(kExp);
    GSPLAT_P2_CASE(kNoAlpha);
    GSPLAT_P2_CASE(kNoMoments);
    GSPLAT_P2_CASE(kNoDfeat);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSPLAT_P2_CASE
}

}  // namespace

extern "C" int gsplat_probe_backward(
    int variant, const void* table, int P, int C, int Cg,
    const void* gauss_id, const void* starts, const void* counts,
    int num_tiles, int grid_x, int tile_x, int tile_y, const void* packed,
    const void* d_packed, void* d_inst, void* stream) {
  if (variant < 0 || variant >= kNumBwdVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles <= 0) return 0;
  const int npix = tile_x * tile_y;
  if (npix <= 0 || npix > kMaxThreads || npix % 32 != 0 || Cg < 0 || Cg > C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* tb = static_cast<const float*>(table);
  const int* gid = static_cast<const int*>(gauss_id);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const float* pk = static_cast<const float*>(packed);
  const float* dp = static_cast<const float*>(d_packed);
  float* o = static_cast<float*>(d_inst);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 7) {
    return launch_variant<7>(variant, tb, P, C, Cg, gid, st, ct, num_tiles,
                             grid_x, tile_x, tile_y, pk, dp, o, s);
  }
  return launch_variant<0>(variant, tb, P, C, Cg, gid, st, ct, num_tiles,
                           grid_x, tile_x, tile_y, pk, dp, o, s);
}
