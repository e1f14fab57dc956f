// K2 — backward alpha composite: the C entry, which launches the kernel of
// composite_bwd.cuh (its comments say what it computes, its design and its
// bound) in its production form, kBwdBase, compiled for C = 1..8 and for a
// runtime C; and the CTAs an SM holds of each.
#include "composite_bwd.cuh"

extern "C" int gsplat_composite_backward(
    const void* table, int P, int C, int Cg, const void* gauss_id,
    const void* starts, const void* counts, int num_tiles, int grid_x,
    int tile_x, int tile_y, const void* packed, const void* d_packed,
    void* d_inst, void* stream) {
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
#define GSPLAT_K2_LAUNCH(CT)                                                 \
  return launch_backward<CT, kBwdBase>(tb, P, C, Cg, gid, st, ct, num_tiles, \
                                       grid_x, tile_x, tile_y, pk, dp, o, s)
  switch (C) {
    case 1: GSPLAT_K2_LAUNCH(1);
    case 2: GSPLAT_K2_LAUNCH(2);
    case 3: GSPLAT_K2_LAUNCH(3);
    case 4: GSPLAT_K2_LAUNCH(4);
    case 5: GSPLAT_K2_LAUNCH(5);
    case 6: GSPLAT_K2_LAUNCH(6);
    case 7: GSPLAT_K2_LAUNCH(7);
    case 8: GSPLAT_K2_LAUNCH(8);
    default: GSPLAT_K2_LAUNCH(0);
  }
#undef GSPLAT_K2_LAUNCH
}

// CTAs of gsplat_composite_backward's kernel an SM holds at once for C, Cg
// and the tile shape (0 on an error).
extern "C" int gsplat_composite_backward_occupancy(int C, int Cg, int tile_x,
                                                   int tile_y) {
#define GSPLAT_K2_OCC(CT) \
  return backward_occupancy<CT, kBwdBase>(C, Cg, tile_x, tile_y)
  switch (C) {
    case 1: GSPLAT_K2_OCC(1);
    case 2: GSPLAT_K2_OCC(2);
    case 3: GSPLAT_K2_OCC(3);
    case 4: GSPLAT_K2_OCC(4);
    case 5: GSPLAT_K2_OCC(5);
    case 6: GSPLAT_K2_OCC(6);
    case 7: GSPLAT_K2_OCC(7);
    case 8: GSPLAT_K2_OCC(8);
    default: GSPLAT_K2_OCC(0);
  }
#undef GSPLAT_K2_OCC
}
