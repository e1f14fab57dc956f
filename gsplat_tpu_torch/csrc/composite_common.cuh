// Constants and helpers shared by the forward and backward composite kernels
// (composite_fwd.cuh, composite_bwd.cuh): the pixels a thread and a warp
// own and the per-warp cull, so that K1 and K2 walk one warp map and cull
// alike, and the quad power, so that K2 makes K1's decisions.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;  // TILE_X * TILE_Y must not exceed this
constexpr int kGeo = 6;            // mean x, mean y, conic a, b, c, opacity
constexpr int kCoef = 6;           // quad-power coefficients per instance
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kQuadPowerCut = 1e-4f;  // composite_pallas.py:172
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // the H100's opt-in shared memory a block

// The warp map of K1 and K2.  A thread owns kPix consecutive pixels of one
// tile row, and a warp a kBlockX x kBlockY block of them (its lanes four to
// a row) where the tile divides into such blocks; elsewhere a warp owns 32
// kPix pixels in row-major order (a last warp that reaches past the tile
// has pixels that take part in nothing).
constexpr int kPix = 4;            // pixels a thread owns
constexpr int kMaxWalkThreads = kMaxThreads / kPix;
constexpr int kBlockX = 4 * kPix;
constexpr int kBlockY = 32 / 4;

__device__ __forceinline__ bool warp_blocks(int tile_x, int tile_y) {
  return tile_x % kBlockX == 0 && tile_y % kBlockY == 0;
}

// The first of thread tid's pixels (tile-local, row-major); the thread owns
// it and the kPix - 1 after it, those of them inside the tile.
__device__ __forceinline__ int thread_pixel0(int tile_x, int tile_y,
                                             int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int pix0 = tid * kPix;
  if (warp_blocks(tile_x, tile_y)) {
    const int bpr = tile_x / kBlockX;
    pix0 = (warp / bpr * kBlockY + (lane >> 2)) * tile_x +
           warp % bpr * kBlockX + (lane & 3) * kPix;
  }
  return pix0;
}

// The threads of a tile of npix pixels: kPix a thread, in whole warps.
__host__ __device__ inline int walk_threads(int npix) {
  return (npix + 32 * kPix - 1) / (32 * kPix) * 32;
}

// The tile-local box [x0, x1] x [y0, y1] that holds warp w's pixels as
// thread_pixel0 lays them out (blocks: warp_blocks of the tile): its block,
// or, in row-major order, its pixels' rows, whole unless it has one.
__device__ __forceinline__ void warp_box(int w, bool blocks, int tile_x,
                                         int npix, int& x0, int& x1, int& y0,
                                         int& y1) {
  if (blocks) {
    x0 = w % (tile_x / kBlockX) * kBlockX;
    y0 = w / (tile_x / kBlockX) * kBlockY;
    x1 = x0 + kBlockX - 1;
    y1 = y0 + kBlockY - 1;
  } else {
    const int p0 = w * 32 * kPix;
    const int p1 = min(p0 + 32 * kPix, npix) - 1;
    y0 = p0 / tile_x;
    y1 = p1 / tile_x;
    x0 = y0 == y1 ? p0 - y0 * tile_x : 0;
    x1 = y0 == y1 ? p1 - y1 * tile_x : tile_x - 1;
  }
}

// The least of q(x, y) = a x^2 + 2 b x y + c y^2 (positive definite) over the
// box [xl, xh] x [yl, yh]: 0 where the box holds the origin, else the least
// of the four edges' minima (q is convex).
__device__ __forceinline__ float quad_min_box(float a, float b, float c,
                                              float xl, float xh, float yl,
                                              float yh) {
  if (xl <= 0.f && xh >= 0.f && yl <= 0.f && yh >= 0.f) return 0.f;
  float m = INFINITY;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float y = e ? yh : yl;
    const float x = fminf(fmaxf(-b * y / a, xl), xh);
    m = fminf(m, a * x * x + 2.f * b * x * y + c * y * y);
    const float x2 = e ? xh : xl;
    const float y2 = fminf(fmaxf(-b * x2 / c, yl), yh);
    m = fminf(m, a * x2 * x2 + 2.f * b * x2 * y2 + c * y2 * y2);
  }
  return m;
}

// Bit w set where warp w0 + w's pixels may composite a gaussian of mean
// (mx, my), conic (a, b, c) and opacity op in the tile at (ox, oy), for the
// nwarps warps from w0 (K2 asks for all, K1 for a CTA's share): every bit
// unless the gaussian's power, -q/2 of the offset to the nearest pixel of
// the warp's box, stays below the alpha >= 1/255 threshold -ln(255 op) by a
// margin of 0.05 plus 1e-5 of the terms' magnitude (K1's power is that
// exact value up to rounding; the quad form's cancellation is within the
// second part).  A conic that is not positive definite, or values that are
// not finite, keep every bit; an opacity <= 0 (the pad sentinel's zero row
// among them) keeps none.
__device__ __forceinline__ unsigned warps_that_may_composite(
    float mx, float my, float a, float b, float c, float op, int ox, int oy,
    int tile_x, int tile_y, int npix, int nwarps, int w0 = 0) {
  const unsigned all = (1u << nwarps) - 1u;
  if (!(a > 0.f && c > 0.f && a * c - b * b > 0.f && isfinite(mx) &&
        isfinite(my) && isfinite(a) && isfinite(b) && isfinite(c))) {
    return all;
  }
  if (!(op > 0.f)) return op <= 0.f ? 0u : all;  // op <= 0 never passes
  const float xr = mx - static_cast<float>(ox);
  const float yr = my - static_cast<float>(oy);
  const float span = fabsf(xr) + fabsf(yr) + 2.f * (tile_x + tile_y);
  const float limit = 2.f * (logf(255.f * op) + 0.05f +
                             1e-5f * (a + fabsf(b) + c) * span * span);
  const bool blocks = warp_blocks(tile_x, tile_y);
  unsigned may = 0u;
  for (int j = 0; j < nwarps; ++j) {
    int x0, x1, y0, y1;
    warp_box(w0 + j, blocks, tile_x, npix, x0, x1, y0, y1);
    const float q = quad_min_box(a, b, c, xr - x1, xr - x0, yr - y1, yr - y0);
    if (!(q > limit)) may |= 1u << j;
  }
  return may;
}

// The compile-time forms of K1 and K2, bits of their template parameter F
// (the Pallas kernels' static mxu_power and fp, composite_pallas.py:247,
// :356).  0 is the f32 form.
enum Form {
  // mxu_power: the power as per-instance coefficients in tile-relative
  // coordinates times the tile-local pixel basis (1, qx, qy, qx^2, qy^2,
  // qx qy) (:130-151), with the power > 1e-4 skip (:172)
  kFormQuad = 1,
  // feat_precision="bf16": the table is [P, 6 + ceil(Cg/2)], its features
  // RNE bf16 pairs, two per f32 word (:191-204, :718-741); K2 writes its
  // feature-gradient words as RNE pairs again (:214-223)
  kFormPacked = 2,
  // K1's packed form with a last channel of ones made in the kernel, never
  // stored (with_ones); K2 reads it from C > Cg
  kFormOnes = 4,
};

// The quad-power coefficients of a staged row r for the tile at (ox, oy)
// (composite_pallas.py:131-140 with the tile-relative mean xr, yr), and the
// power they give at the tile-local pixel (qx, qy): K1 and K2 evaluate the
// same expressions in the same order, so K2 makes K1's decisions.
__device__ __forceinline__ void quad_coefficients(const float* r, float ox,
                                                  float oy, float* q) {
  const float xr = r[0] - ox;
  const float yr = r[1] - oy;
  const float A = r[2];
  const float B = r[3];
  const float Cc = r[4];
  q[0] = -0.5f * (A * xr * xr + Cc * yr * yr) - B * xr * yr;
  q[1] = A * xr + B * yr;
  q[2] = Cc * yr + B * xr;
  q[3] = -0.5f * A;
  q[4] = -0.5f * Cc;
  q[5] = -B;
}

__device__ __forceinline__ float quad_power(const float* q, float qx,
                                            float qy, float qxx, float qyy,
                                            float qxy) {
  return q[0] + q[1] * qx + q[2] * qy + q[3] * qxx + q[4] * qyy + q[5] * qxy;
}

// Column col of the [kGeo + C] row a kernel stages for gaussian g from the
// packed table [P, 6 + ceil(cg/2)]: geometry as it is, feature c < cg from
// word c/2 (hi = w & 0xFFFF0000 for even c, lo = w << 16 for odd c,
// composite_pallas.py:191-204), the ones channel (c >= cg) as 1; zeros for
// an id outside [0, P), the pad sentinel.
__device__ __forceinline__ float packed_value(const float* __restrict__ table,
                                              int P, int g, int cg,
                                              int col) {
  if (g < 0 || g >= P) return 0.f;
  const float* src = table + static_cast<size_t>(g) * (kGeo + (cg + 1) / 2);
  if (col < kGeo) return __ldg(src + col);
  const int c = col - kGeo;
  if (c >= cg) return 1.f;
  const unsigned w = __float_as_uint(__ldg(src + kGeo + (c >> 1)));
  return __uint_as_float((c & 1) ? (w << 16) : (w & 0xFFFF0000u));
}

// f32 -> its round-to-nearest-even bf16 in the top 16 bits, by the integer
// formula of composite_pallas.py::_round_bf16_bits (:207-211), so that K2's
// packed words are bit-equal to the plain version's for finite values.
__device__ __forceinline__ unsigned round_bf16_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

}  // namespace
