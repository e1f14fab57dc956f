// K1 — forward alpha composite in its other forms: the C entry that launches
// the kernel of composite_fwd.cuh (its comments say what it computes, its
// design and its bound) with the mxu_power form (kFormQuad), the packed
// features (kFormPacked, with or without the ones channel) or both.
//
// Replaces composite_pallas.py:247 _forward_kernel with mxu_power=True
// and/or fp[0] (feat_precision="bf16").
//
// Compiled for the channel counts the port's paths reach: C = 3 (rgb alone,
// render_only: packed without ones), 5 (rgb, depth, ones) and 7 (with two
// segment channels), each with the ones channel when packed; every other C
// takes the runtime-C form.  The f32 form keeps its own entry
// (composite_fwd.cu).
#include "composite_fwd.cuh"

namespace {

struct Args {
  const float* table;
  int P, C;
  const int* gid;
  const int* st;
  const int* ct;
  int num_tiles, grid_x, tile_x, tile_y;
  float* out;
  cudaStream_t stream;
};

template <int CT, int F>
int launch(const Args& a) {
  return launch_forward<CT, kFwdBase, F>(a.table, a.P, a.C, a.gid, a.st, a.ct,
                                         a.num_tiles, a.grid_x, a.tile_x,
                                         a.tile_y, a.out, a.stream);
}

// The f32 features with the quad power: C = 3, 5, 7 compiled.
int launch_quad(const Args& a) {
  switch (a.C) {
    case 3: return launch<3, kFormQuad>(a);
    case 5: return launch<5, kFormQuad>(a);
    case 7: return launch<7, kFormQuad>(a);
    default: return launch<0, kFormQuad>(a);
  }
}

// The packed features (Q = 0 or kFormQuad): C = 3 without the ones channel,
// 5 and 7 with it, compiled.
template <int Q>
int launch_packed(const Args& a, bool ones) {
  constexpr int kP = kFormPacked | Q;
  constexpr int kPO = kFormPacked | kFormOnes | Q;
  if (!ones && a.C == 3) return launch<3, kP>(a);
  if (ones && a.C == 5) return launch<5, kPO>(a);
  if (ones && a.C == 7) return launch<7, kPO>(a);
  return ones ? launch<0, kPO>(a) : launch<0, kP>(a);
}

}  // namespace

// form: 1 quad, 2 packed, 3 both.  C: the composited channels; Cg: the
// stored features (packed: C - Cg is 1 with the ones channel, else 0;
// unpacked: Cg is C).
extern "C" int gsplat_composite_forward_form(int form, const void* table,
                                             int P, int C, int Cg,
                                             const void* gauss_id,
                                             const void* starts,
                                             const void* counts,
                                             int num_tiles, int grid_x,
                                             int tile_x, int tile_y,
                                             void* out, void* stream) {
  const bool packed = (form & kFormPacked) != 0;
  if (form < 1 || form > (kFormQuad | kFormPacked) || Cg < 1 || Cg > C ||
      C - Cg > (packed ? 1 : 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles <= 0) return 0;
  const Args a{static_cast<const float*>(table), P, C,
               static_cast<const int*>(gauss_id),
               static_cast<const int*>(starts),
               static_cast<const int*>(counts), num_tiles, grid_x, tile_x,
               tile_y, static_cast<float*>(out),
               static_cast<cudaStream_t>(stream)};
  if (!packed) return launch_quad(a);
  return (form & kFormQuad) ? launch_packed<kFormQuad>(a, C > Cg)
                            : launch_packed<0>(a, C > Cg);
}
