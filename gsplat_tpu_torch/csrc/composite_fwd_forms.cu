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
// (composite_fwd.cu).  A second entry says how many CTAs of each an SM
// holds.
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

// The two things done with a form's kernel: launch it, or ask for its CTAs
// per SM.
struct Launch {
  const Args& a;
  template <int CT, int F>
  int run() const {
    return launch_forward<CT, kFwdBase, F>(a.table, a.P, a.C, a.gid, a.st,
                                           a.ct, a.num_tiles, a.grid_x,
                                           a.tile_x, a.tile_y, a.out,
                                           a.stream);
  }
};

struct Occupancy {
  int C, tile_x, tile_y;
  template <int CT, int F>
  int run() const {
    return forward_occupancy<CT, kFwdBase, F>(C, tile_x, tile_y);
  }
};

// The packed features (Q = 0 or kFormQuad): C = 3 without the ones channel,
// 5 and 7 with it, compiled.
template <int Q, typename Op>
int packed_kernel(const Op& op, int C, bool ones) {
  constexpr int kP = kFormPacked | Q;
  constexpr int kPO = kFormPacked | kFormOnes | Q;
  if (!ones && C == 3) return op.template run<3, kP>();
  if (ones && C == 5) return op.template run<5, kPO>();
  if (ones && C == 7) return op.template run<7, kPO>();
  return ones ? op.template run<0, kPO>() : op.template run<0, kP>();
}

// op on the kernel of form, C and the ones channel: the f32 features with
// the quad power at C = 3, 5, 7 compiled, or a packed form.
template <typename Op>
int form_kernel(const Op& op, int form, int C, bool ones) {
  if (!(form & kFormPacked)) {
    switch (C) {
      case 3: return op.template run<3, kFormQuad>();
      case 5: return op.template run<5, kFormQuad>();
      case 7: return op.template run<7, kFormQuad>();
      default: return op.template run<0, kFormQuad>();
    }
  }
  return (form & kFormQuad) ? packed_kernel<kFormQuad>(op, C, ones)
                            : packed_kernel<0>(op, C, ones);
}

bool valid_form(int form, int C, int Cg) {
  const bool packed = (form & kFormPacked) != 0;
  return form >= 1 && form <= (kFormQuad | kFormPacked) && Cg >= 1 &&
         Cg <= C && C - Cg <= (packed ? 1 : 0);
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
  if (!valid_form(form, C, Cg)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles <= 0) return 0;
  const Args a{static_cast<const float*>(table), P, C,
               static_cast<const int*>(gauss_id),
               static_cast<const int*>(starts),
               static_cast<const int*>(counts), num_tiles, grid_x, tile_x,
               tile_y, static_cast<float*>(out),
               static_cast<cudaStream_t>(stream)};
  return form_kernel(Launch{a}, form, C, C > Cg);
}

// CTAs an SM holds at once of the kernel gsplat_composite_forward_form
// launches for form, C, Cg and the tile shape (0 on an error).
extern "C" int gsplat_composite_forward_form_occupancy(int form, int C,
                                                       int Cg, int tile_x,
                                                       int tile_y) {
  if (!valid_form(form, C, Cg)) return 0;
  return form_kernel(Occupancy{C, tile_x, tile_y}, form, C, C > Cg);
}
