// Constants and helpers shared by the forward and backward composite kernels
// (composite_fwd.cuh, composite_bwd.cuh).
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
