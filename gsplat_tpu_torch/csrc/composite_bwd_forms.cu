// K2 — backward alpha composite in its other forms: the C entry that
// launches the kernel of composite_bwd.cuh (its comments say what it
// computes, its design and its bound) with the mxu_power form (kFormQuad),
// the packed features and packed gradient rows (kFormPacked) or both.
//
// Replaces composite_pallas.py:356 _backward_kernel with mxu_power=True
// and/or fp[0] (feat_precision="bf16").
//
// Compiled for C = 3, 5 and 7 (the channel counts the port's paths reach)
// and for a runtime C.  The f32 form keeps its own entry (composite_bwd.cu).
#include "composite_bwd.cuh"

namespace {

struct Args {
  const float* table;
  int P, C, Cg;
  const int* gid;
  const int* st;
  const int* ct;
  int num_tiles, grid_x, tile_x, tile_y;
  const float* packed;
  const float* d_packed;
  float* d_inst;
  cudaStream_t stream;
};

template <int CT, int F>
int launch(const Args& a) {
  return launch_backward<CT, kBwdBase, F>(
      a.table, a.P, a.C, a.Cg, a.gid, a.st, a.ct, a.num_tiles, a.grid_x,
      a.tile_x, a.tile_y, a.packed, a.d_packed, a.d_inst, a.stream);
}

template <int F>
int launch_c(const Args& a) {
  switch (a.C) {
    case 3: return launch<3, F>(a);
    case 5: return launch<5, F>(a);
    case 7: return launch<7, F>(a);
    default: return launch<0, F>(a);
  }
}

}  // namespace

// form: 1 quad, 2 packed, 3 both; the other arguments are
// gsplat_composite_backward's (packed: Cg is the stored features, C - Cg is
// 1 with the ones channel, else 0).
extern "C" int gsplat_composite_backward_form(
    int form, const void* table, int P, int C, int Cg, const void* gauss_id,
    const void* starts, const void* counts, int num_tiles, int grid_x,
    int tile_x, int tile_y, const void* packed, const void* d_packed,
    void* d_inst, void* stream) {
  const int npix = tile_x * tile_y;
  const bool pk = (form & kFormPacked) != 0;
  if (form < 1 || form > (kFormQuad | kFormPacked) || npix <= 0 ||
      npix > kMaxThreads || npix % 32 != 0 || Cg < (pk ? 1 : 0) || Cg > C ||
      (pk && C - Cg > 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_tiles <= 0) return 0;
  const Args a{static_cast<const float*>(table), P, C, Cg,
               static_cast<const int*>(gauss_id),
               static_cast<const int*>(starts),
               static_cast<const int*>(counts), num_tiles, grid_x, tile_x,
               tile_y, static_cast<const float*>(packed),
               static_cast<const float*>(d_packed),
               static_cast<float*>(d_inst),
               static_cast<cudaStream_t>(stream)};
  switch (form) {
    case kFormQuad: return launch_c<kFormQuad>(a);
    case kFormPacked: return launch_c<kFormPacked>(a);
    default: return launch_c<kFormQuad | kFormPacked>(a);
  }
}
