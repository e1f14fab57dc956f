// K1 — forward alpha composite: the C entry, which launches the kernel of
// composite_fwd.cuh (its comments say what it computes, its design and its
// bound) in its production form, kFwdBase, compiled for C = 1..8 and for a
// runtime C.
#include "composite_fwd.cuh"

extern "C" int gsplat_composite_forward(const void* table, int P, int C,
                                        const void* gauss_id,
                                        const void* starts,
                                        const void* counts, int num_tiles,
                                        int grid_x, int tile_x, int tile_y,
                                        void* out, void* stream) {
  if (num_tiles <= 0) return 0;
  const float* tb = static_cast<const float*>(table);
  const int* gid = static_cast<const int*>(gauss_id);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GSPLAT_K1_LAUNCH(CT)                                                 \
  return launch_forward<CT, kFwdBase>(tb, P, C, gid, st, ct, num_tiles,      \
                                      grid_x, tile_x, tile_y, o, s)
  switch (C) {
    case 1: GSPLAT_K1_LAUNCH(1);
    case 2: GSPLAT_K1_LAUNCH(2);
    case 3: GSPLAT_K1_LAUNCH(3);
    case 4: GSPLAT_K1_LAUNCH(4);
    case 5: GSPLAT_K1_LAUNCH(5);
    case 6: GSPLAT_K1_LAUNCH(6);
    case 7: GSPLAT_K1_LAUNCH(7);
    case 8: GSPLAT_K1_LAUNCH(8);
    default: GSPLAT_K1_LAUNCH(0);
  }
#undef GSPLAT_K1_LAUNCH
}
