// K1 — forward alpha composite: the C entry, which launches the kernel of
// composite_fwd.cuh (its comments say what it computes, its design and its
// bound) in its production form, kFwdBase, compiled for C = 1..8 and for a
// runtime C; the CTAs an SM holds of each; and a check of the warp map K1
// and K2 share against the boxes their cull bounds.
#include "composite_fwd.cuh"

namespace {

// Per pixel of a tile, the threads of the walk's warp map (thread_pixel0)
// that own it, and in bad[0] the pixels a thread owns outside its warp's
// box (warp_box): the cull drops a warp's instance only where nothing can
// reach that box.
__global__ void warp_map_check_kernel(int tile_x, int tile_y, int* owners,
                                      int* bad) {
  const int npix = tile_x * tile_y;
  const int tid = threadIdx.x;
  const int pix0 = thread_pixel0(tile_x, tile_y, tid);
  int x0, x1, y0, y1;
  warp_box(tid >> 5, warp_blocks(tile_x, tile_y), tile_x, npix, x0, x1, y0,
           y1);
  for (int i = 0; i < kPix; ++i) {
    const int p = pix0 + i;
    if (p >= npix) continue;
    atomicAdd(owners + p, 1);
    const int x = p % tile_x;
    const int y = p / tile_x;
    if (x < x0 || x > x1 || y < y0 || y > y1) atomicAdd(bad, 1);
  }
}

}  // namespace

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

// CTAs of gsplat_composite_forward's kernel an SM holds at once for C and
// the tile shape (0 on an error).
extern "C" int gsplat_composite_forward_occupancy(int C, int tile_x,
                                                  int tile_y) {
#define GSPLAT_K1_OCC(CT) \
  return forward_occupancy<CT, kFwdBase>(C, tile_x, tile_y)
  switch (C) {
    case 1: GSPLAT_K1_OCC(1);
    case 2: GSPLAT_K1_OCC(2);
    case 3: GSPLAT_K1_OCC(3);
    case 4: GSPLAT_K1_OCC(4);
    case 5: GSPLAT_K1_OCC(5);
    case 6: GSPLAT_K1_OCC(6);
    case 7: GSPLAT_K1_OCC(7);
    case 8: GSPLAT_K1_OCC(8);
    default: GSPLAT_K1_OCC(0);
  }
#undef GSPLAT_K1_OCC
}

// The warp map's check at a tile shape: out [npix + 1] int32 on the card,
// zeroed by the caller; afterwards out[0] holds the pixels outside their
// warp's box and out[1 + p] the threads that own pixel p (1 each where the
// map is sound).
extern "C" int gsplat_warp_map_check(int tile_x, int tile_y, void* out,
                                     void* stream) {
  const int npix = tile_x * tile_y;
  if (tile_x <= 0 || tile_y <= 0 || npix > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(out);
  warp_map_check_kernel<<<1, walk_threads(npix), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      tile_x, tile_y, o + 1, o);
  return static_cast<int>(cudaGetLastError());
}
