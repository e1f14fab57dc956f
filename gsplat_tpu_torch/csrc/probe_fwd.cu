// P1 — the forward composite K1 under cost-attribution knockouts.
//
// Replaces the Pallas kernels of the forward probes in tools/:
// bench_fwd_attrib.py::_kernel (:35, launched at :119; variants base,
// no_cond, no_scan, no_matmul, no_minmax, alpha_only, mxu_alpha) and
// bench_kernels.py::_pallas_fwd_variant (:146, launched at :149) over
// _fwd_kernel_A (:77, quadratic-form power), _fwd_kernel_S (:314,
// stripped), _fwd_kernel_NOEXP (:359, exp as identity) and _fwd_kernel_R
// (:416, trimmed bookkeeping).
//
// What it computes: K1's kernel (composite_fwd.cuh) in one of its first ten
// variants, which that file describes; `base` is K1's own f32 form and
// `quad_power` its kFormQuad form, the two instantiated again here.  The plain
// version is gsplat_tpu_torch/tools/probes.py::probe_forward_plain.
//
// Compiled for C = 7 (the training path's channels) and for a runtime C, the
// two forms the probes run.
//
// Bound on the H100: operations, as K1's (chip_smoke.py counts each
// variant's own walk: pairs tested, passing and composited).
#include "composite_fwd.cuh"

namespace {

template <int CT>
int launch_variant(int variant, const float* tb, int P, int C,
                   const int* gid, const int* st, const int* ct,
                   int num_tiles, int grid_x, int tile_x, int tile_y,
                   float* o, cudaStream_t s) {
#define GSPLAT_P1_CASE(V)                                                    \
  case V:                                                                    \
    return launch_forward<CT, V>(tb, P, C, gid, st, ct, num_tiles, grid_x,   \
                                 tile_x, tile_y, o, s)
  switch (variant) {
    GSPLAT_P1_CASE(kFwdBase);
    GSPLAT_P1_CASE(kNoCond);
    GSPLAT_P1_CASE(kNoScan);
    GSPLAT_P1_CASE(kNoMatmul);
    GSPLAT_P1_CASE(kNoMinmax);
    GSPLAT_P1_CASE(kAlphaOnly);
    case kQuadPower:  // K1's mxu_power form
      return launch_forward<CT, kFwdBase, kFormQuad>(
          tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
    GSPLAT_P1_CASE(kNoExp);
    GSPLAT_P1_CASE(kStripped);
    GSPLAT_P1_CASE(kTrimBookkeeping);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSPLAT_P1_CASE
}

}  // namespace

extern "C" int gsplat_probe_forward(int variant, const void* table, int P,
                                    int C, const void* gauss_id,
                                    const void* starts, const void* counts,
                                    int num_tiles, int grid_x, int tile_x,
                                    int tile_y, void* out, void* stream) {
  if (variant < 0 || variant >= kComputeResident) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles <= 0) return 0;
  const float* tb = static_cast<const float*>(table);
  const int* gid = static_cast<const int*>(gauss_id);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 7) {
    return launch_variant<7>(variant, tb, P, C, gid, st, ct, num_tiles,
                             grid_x, tile_x, tile_y, o, s);
  }
  return launch_variant<0>(variant, tb, P, C, gid, st, ct, num_tiles, grid_x,
                           tile_x, tile_y, o, s);
}
