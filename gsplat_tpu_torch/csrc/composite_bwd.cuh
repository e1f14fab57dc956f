// K2 — backward alpha composite, one CTA per tile: the kernel body, shared by
// K2 itself (composite_bwd.cu, the variant kBwdBase in the f32 form;
// composite_bwd_forms.cu, its other forms) and by the probes that change one
// piece of it (probe_bwd.cu, P2).
//
// Replaces the Pallas kernel gsplat_tpu/ops/composite_pallas.py::
// _backward_kernel (:356-563, launched by _composite_bwd :629) together with
// its scrub pass (:652-677).
//
// What it computes.  Inputs: the per-gaussian table [P, 6+C] (mean2d, conic,
// opacity, C features) and the sorted instance list K1 read, K1's packed
// output [T, C+2, TILE_PIX] (C channels, T_final, n_contrib) and its
// cotangent of the same shape (the cotangent of the n_contrib row is
// ignored).  Output: one gradient row per instance slot, d_inst [I, 6+Cg]:
// d mean2d (2), d conic (3), d opacity, d features (the first Cg <= C; the
// caller leaves out a constant last channel).  Per pixel the kernel walks the
// tile's instances front to back and recomputes power, alpha and the skip
// tests exactly as K1 does (same expressions, same operation order, built
// with the same --fmad=false), gated by position + 1 <= n_contrib, so the set
// of composited pairs is K1's own.  With g_i = <feat_i, d_out> and
// w_i = alpha_i T_i it carries the transmittance T by the forward recurrence
// and the prefix sum of w_i g_i, and takes the suffix as
//     S_i = TOT - prefix_i,   TOT = sum_c d_out_c * img_c
// from the forward's own accumulation, so there is no backward walk and no
// division to rebuild T:
//     d alpha_i = T_i g_i - (S_i + T_final dT_final) / (1 - alpha_i).
// alpha <= 0.99 on every pair, so 1 - alpha >= 0.01.  The
// 0.99 cap is a true min: where opacity * G >= 0.99 the pair passes no
// gradient to power or opacity (the JAX package's deliberate deviation from
// backward.cu).  With dpow = raw * d alpha the per-instance sums over the
// tile's pixels
//     sum dpow dx, sum dpow dy, sum dpow dx^2, sum dpow dx dy, sum dpow dy^2,
//     sum dpow, sum w d_out_c
// give d mean2d = -(A sx + B sy, C sy + B sx), d conic = (-sxx/2, -sxy,
// -syy/2), d opacity = s0 / opacity (0 where opacity is 0) and d feat_c.  The
// TPU kernel takes the moments from one matmul over a pixel basis; the direct
// sums are the same numbers.
//
// Design.  A thread owns four consecutive pixels of one tile row, and a
// warp a 16x8 block of them where the tile divides into such blocks (32x32:
// 256 threads in 8 warps; 16x16: 64 in 2), else 128 pixels in row-major
// order (a last warp that reaches past the tile has pixels that take part in
// nothing).  Each thread keeps its pixels' state in registers (T, the
// prefix, TOT, T_final dT_final, n_contrib, and d_out for C <= 8).  Batches
// of up to kBwdBatch instances are staged in shared memory straight from the
// [P, 6+C] table through gauss_id (the fused gather), with the quad form's
// coefficients and, per instance, the warps whose box of pixels the
// gaussian may reach: a warp is left out only where the least quadratic
// form of its box keeps the power below alpha's 1/255 threshold by a margin
// far above the rounding of K1's power (warps_that_may_composite), so every
// pair it skips is one K1 skips.  The walk stops at the tile's last
// contributor (the maximum n_contrib over the CTA), and each warp stops at
// its own.  For every instance left to it a thread recomputes power, alpha
// and the skip tests for its four pixels, and the warp votes once: if none
// of its 128 pixels composites the instance, it goes on.  Otherwise each
// thread adds its four pixels' 6+Cg terms in registers, straight-line, each
// pixel's terms selected to zero where it does not composite, so that the
// four chains run side by side (a branch per pixel would run them one after
// another, and some lane takes nearly every one), then the warp sums them
// with xor shuffles, eight values at a time in a tree that halves the
// values in flight at each step (18 shuffles for 12 values), leaves them in
// its own slot of shared memory (a value's slots kBwdBatch + 1 floats
// apart, so that the lanes writing one instance hit distinct banks) and
// sets the instance's bit in its mask.
// After the batch one thread per (instance, value) adds the slots of the
// warps whose bit is set, in warp order, and one thread per output word
// writes the row.  So the vote, the trees and the slot writes are paid once
// per 128 pixels, the epilogue adds at most 8 slots, four barriers serve 128
// instances, and a 32x32 tile's 256 threads with their ~60 KB of shared
// memory let two tiles share an SM.  Every sum is taken in a fixed order (a
// thread's pixels in order, a fixed tree, the warps in order): the same
// bits from run to run.  Each instance belongs to one tile, so rows are
// disjoint and each is written by one CTA: no atomics at all.  Rows the walk
// does not reach (past the tile's last contributor, alignment pads, the
// unused tail) are left as the caller's zeros.  d alpha's division is
// __fdividef (its divisor 1 - alpha lies in [0.01, 1]); the skip decisions
// take no division.  The TPU kernel's DMA prefetch, slot parity and log-step
// scans are not carried over.
//
// Bound on the H100: operations.  A tested pair costs what it costs K1 (17);
// a composited pair 2C for g, about 20 for d alpha, dpow and the six moment
// terms, Cg for the feature terms, and its share of the reductions.  Bytes
// (table rows, ids, the two packed arrays, the rows written) are far below
// that.  What the design is about is the cost per (warp, instance): the
// cull and the vote skip the warps that take no part, and owning four
// pixels a thread cuts the reductions of those that do by four.  C <= 8
// keeps d_out in registers; larger C re-reads it from global memory
// (correct, slow), and a C so large that kBwdBatch instances' slots do not
// fit the SM's shared memory halves the batch until they do.
//
// The forms (template parameter F, composite_common.cuh's Form bits), K1's:
//   kFormQuad    the power from K1's quad-form coefficients, computed once
//                per staged batch with K1's expressions in K1's order (the
//                same --fmad=false), and the power > 1e-4 skip, so the pairs
//                K2 composites are those K1 composited under n_contrib.  dx
//                and dy are still formed for the five moment products.
//   kFormPacked  staging as K1's packed form (the table [P, 6 + ceil(Cg/2)]
//                of bf16 pairs, the ones channel where C > Cg), and the Cg
//                feature sums written as ceil(Cg/2) words of RNE bf16 pairs
//                (composite_pallas.py:214-223, :533-542) by the integer
//                rounding of _round_bf16_bits: rows [I, 6 + ceil(Cg/2)], the
//                cotangent layout of gather_rows(packed_tail=).
//
// The probes' variants.  Each one changes one piece of the body above at
// compile time, so kBwdBase is K2 and every variant follows K2 when K2
// changes.  Each writes K2's rows d_inst [I, 6+Cg]; what each column holds
// is defined by the plain version (gsplat_tpu_torch/tools/probes.py::
// probe_backward_plain):
//   moments_basis  the TPU's pixel-moment form (bench_bwd_attrib.py:128-156,
//                  bench_kernels.py::_bwd_kernel_B): the warps sum the raw
//                  moments M0..M5 of dpow over the tile-local basis
//                  (1, qx, qy, qx^2, qy^2, qx qy) instead of the five
//                  products of dx and dy, and each instance recombines them
//                  with its tile-relative mean (xr, yr):
//                    sx = xr M0 - M1, sy = yr M0 - M2,
//                    sxx = xr^2 M0 - 2 xr M1 + M3,
//                    sxy = xr yr M0 - xr M2 - yr M1 + M5,
//                    syy = yr^2 M0 - 2 yr M2 + M4.
//   exp            the Gaussian as expf(power) where K2 (like the package
//                  since composite_pallas.py:160-163) takes
//                  exp2f(power log2 e): the tool's exp2 knob, turned round.
//   no_alpha       no Gaussian: raw = opacity (no power, no exp2, no
//                  power > 0 test, no warp left out by the cull), so
//                  every pair up to n_contrib whose opacity passes the
//                  1/255 test takes part.  It composites
//                  more pairs than base: base - no_alpha is a lower bound on
//                  what the alpha recompute costs.
//   no_moments     the five moment products are not formed: each warp sums
//                  dpow alone (one 5-step shuffle instead of an 8-value tree):
//                  columns 0..4 hold the sum of dpow, column 5 that sum over
//                  the opacity (base's d opacity).
//   no_dfeat       the Cg feature sums are not formed: each warp sums w
//                  alone; feature column 0 holds the sum of w, the others
//                  zero.
// Every knockout still writes rows that depend on what it kept.
#pragma once

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

// The warp map (thread_pixel0) and the per-warp cull over each warp's box
// (warps_that_may_composite, warp_box) are composite_common.cuh's, K1's too;
// gsplat_warp_map_check (composite_fwd.cu) holds the two to each other.  The
// staging loops are written out in the kernel below (K1's stage_instances
// made K2 3.3% slower).
constexpr int kMaxBwdThreads = kMaxWalkThreads;
constexpr int kMaxBwdWarps = kMaxBwdThreads / 32;
constexpr int kBwdBatch = 128;     // instances staged per round, at most
constexpr int kMaskWords = kBwdBatch / 32;

// In the order of probes.BWD_VARIANTS (P2's variant index).
enum BwdVariant {
  kBwdBase = 0,
  kMomentsBasis,
  kExp,
  kNoAlpha,
  kNoMoments,
  kNoDfeat,
  kNumBwdVariants
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Sums eight values across the warp in 9 shuffles instead of 40: at each of
// the first three steps a lane hands half of its values to its partner and
// keeps the other half, so the values in flight halve as the lanes summed
// double.  On return lane l holds the warp's total of v[l >> 2] (every lane
// of a group of four the same one).  The tree is fixed, so the bits are too.
__device__ __forceinline__ float warp_sum8(const float (&v)[8], int lane) {
  float a[4];
  float b[2];
  bool up = (lane & 16) != 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up ? v[i] : v[i + 4];
    const float keep = up ? v[i + 4] : v[i];
    a[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  up = (lane & 8) != 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up ? a[i] : a[i + 2];
    const float keep = up ? a[i + 2] : a[i];
    b[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  up = (lane & 4) != 0;
  const float send = up ? b[0] : b[1];
  const float keep = up ? b[1] : b[0];
  float c = keep + __shfl_xor_sync(kFull, send, 4);
  c += __shfl_xor_sync(kFull, c, 2);
  c += __shfl_xor_sync(kFull, c, 1);
  return c;
}

// CT > 0: compile-time channel count, d_out in registers.
// CT == 0: runtime channel count C, d_out re-read from global memory.
// F: the form (Form bits), 0 for f32.  kb: the batch, kBwdBatch unless the
// slots of a large C do not fit (bwd_batch).
template <int CT, int V, int F = 0>
__global__ void __launch_bounds__(kMaxBwdThreads, 2)
composite_backward_kernel(const float* __restrict__ table, int P, int C,
                          int Cg, const int* __restrict__ gauss_id,
                          const int* __restrict__ starts,
                          const int* __restrict__ counts, int grid_x,
                          int tile_x, int tile_y, int kb,
                          const float* __restrict__ packed,
                          const float* __restrict__ d_packed,
                          float* __restrict__ d_inst) {
  constexpr bool kQuad = (F & kFormQuad) != 0;
  constexpr bool kPacked = (F & kFormPacked) != 0;
  constexpr float kPowerCut = kQuad ? kQuadPowerCut : 0.f;
  constexpr int kAcc = CT > 0 ? CT : 1;
  extern __shared__ float smem[];
  const int nc = CT > 0 ? CT : C;
  const int row = kGeo + nc;
  const int nout = kGeo + Cg;
  // the words of a row written and of a table row: packed, the Cg features
  // as ceil(Cg/2) pairs
  const int nw = kPacked ? kGeo + (Cg + 1) / 2 : nout;
  const int trow = kPacked ? kGeo + (Cg + 1) / 2 : row;
  const int npix = tile_x * tile_y;  // a multiple of 32 (checked by the host)
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int ks = kb + 1;                      // a value's slots apart
  float* s_rows = smem;                       // [kb][row]
  float* s_part = s_rows + kb * row;          // [nwarps][nout][ks]
  // [kb]: bit w set where warp w may composite the instance (0 for a pad)
  unsigned* s_may = reinterpret_cast<unsigned*>(s_part + nwarps * nout * ks);
  int* s_red = reinterpret_cast<int*>(s_may + kb);  // [kMaxBwdWarps]
  // [nwarps][kMaskWords]: bit k of a warp's words set where it wrote slot k
  unsigned* s_wmask = reinterpret_cast<unsigned*>(s_red + kMaxBwdWarps);
  // [kb][kCoef], kFormQuad only
  float* s_coef = reinterpret_cast<float*>(s_wmask + nwarps * kMaskWords);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ox = (t % grid_x) * tile_x;
  const int oy = (t / grid_x) * tile_y;
  const int start = starts[t];
  const int count = counts[t];
  const size_t tile_off = static_cast<size_t>(t) * (nc + 2) * npix;
  const float* fwd_t = packed + tile_off;
  const float* dpk_t = d_packed + tile_off;

  // this thread's pixels pix0 .. pix0 + 3 of the tile, all inside it or
  // none (npix % 32 == 0): in the warp's block, or 128 a warp in row-major
  // order where the tile does not divide into blocks
  const int pix0 = thread_pixel0(tile_x, tile_y, tid);
  const bool live = pix0 < npix;
  float px[kPix], py[kPix], qx[kPix], qy[kPix], qxx[kPix], qyy[kPix],
      qxy[kPix];
  float T[kPix], pref[kPix], tot[kPix], bg_term[kPix];
  float dout[kPix][kAcc];
  int ncontrib[kPix];
  int nmax = 0;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int pix = pix0 + i;
    // the tile-local basis (moments_basis, kFormQuad) and the pixel centre
    qx[i] = static_cast<float>(pix % tile_x);
    qy[i] = static_cast<float>(pix / tile_x);
    qxx[i] = qx[i] * qx[i];
    qyy[i] = qy[i] * qy[i];
    qxy[i] = qx[i] * qy[i];
    px[i] = static_cast<float>(ox + pix % tile_x);
    py[i] = static_cast<float>(oy + pix / tile_x);
    T[i] = 1.f;
    pref[i] = 0.f;
    tot[i] = 0.f;
    bg_term[i] = 0.f;
    ncontrib[i] = 0;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) dout[i][c] = 0.f;
    if (live) {
      ncontrib[i] = static_cast<int>(fwd_t[(nc + 1) * npix + pix]);
      bg_term[i] = fwd_t[nc * npix + pix] * dpk_t[nc * npix + pix];
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < kAcc; ++c) {
          dout[i][c] = dpk_t[c * npix + pix];
          tot[i] += fwd_t[c * npix + pix] * dout[i][c];
        }
      } else {
        for (int c = 0; c < nc; ++c) {
          tot[i] += fwd_t[c * npix + pix] * dpk_t[c * npix + pix];
        }
      }
    }
    nmax = max(nmax, ncontrib[i]);
  }

  // the warp's and the tile's last contributing position
  int wmax = nmax;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(kFull, wmax, off));
  }
  if (lane == 0) s_red[warp] = wmax;
  __syncthreads();
  int limit = 0;
  for (int w = 0; w < nwarps; ++w) limit = max(limit, s_red[w]);
  limit = min(limit, count);

  float* part = s_part + warp * nout * ks;    // this warp's slots
  for (int b0 = 0; b0 < limit; b0 += kb) {
    const int nb = min(kb, limit - b0);
    const int* gid_b = gauss_id + start + b0;
    // the previous batch's rows, ids and sums have been read
    __syncthreads();
    for (int e = tid; e < nb * row; e += nthreads) {
      const int k = e / row;
      const int col = e - k * row;
      const int g = __ldg(gid_b + k);
      if constexpr (kPacked) {
        s_rows[e] = packed_value(table, P, g, Cg, col);
      } else {
        s_rows[e] = (g >= 0 && g < P)
                        ? __ldg(table + static_cast<size_t>(g) * row + col)
                        : 0.f;
      }
    }
    for (int k = tid; k < nb; k += nthreads) {
      const int g = __ldg(gid_b + k);
      const bool real = g >= 0 && g < P;
      // the geometry just staged, read again from the table
      float geo[kGeo];
#pragma unroll
      for (int j = 0; j < kGeo; ++j) {
        geo[j] = real ? __ldg(table + static_cast<size_t>(g) * trow + j)
                      : 0.f;
      }
      s_may[k] = !real ? 0u
                 : V == kNoAlpha
                     ? (1u << nwarps) - 1u
                     : warps_that_may_composite(
                           geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], ox,
                           oy, tile_x, tile_y, npix, nwarps);
      if constexpr (kQuad) {
        quad_coefficients(geo, static_cast<float>(ox), static_cast<float>(oy),
                          s_coef + k * kCoef);
      }
    }
    __syncthreads();

    const int kend = min(nb, wmax - b0);  // the same for the whole warp
    unsigned wrote = 0u;  // lane j: the slots 32 j .. 32 j + 31 written
    for (int k = 0; k < kend; ++k) {
      // a pad sentinel, or no pixel of this warp can pass the skip tests
      if (!((s_may[k] >> warp) & 1u)) continue;
      const float* r = s_rows + k * row;
      float dx[kPix], dy[kPix], raw[kPix], alpha[kPix];
      bool contrib[kPix];
      bool any = false;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        dx[i] = r[0] - px[i];
        dy[i] = r[1] - py[i];
        bool pass;
        if (V == kNoAlpha) {
          raw[i] = r[5];
          pass = true;
        } else {
          float power;
          if constexpr (kQuad) {
            power = quad_power(s_coef + k * kCoef, qx[i], qy[i], qxx[i],
                               qyy[i], qxy[i]);
          } else {
            power = -0.5f * (r[2] * dx[i] * dx[i] + r[4] * dy[i] * dy[i]) -
                    r[3] * dx[i] * dy[i];
          }
          raw[i] = V == kExp ? r[5] * expf(power)
                             : r[5] * exp2f(power * kLog2e);
          pass = power <= kPowerCut;
        }
        alpha[i] = fminf(kAlphaMax, raw[i]);
        contrib[i] = pass && (alpha[i] >= kAlphaMin) &&
                     (b0 + k + 1 <= ncontrib[i]);
        any = any || contrib[i];
      }
      if (__ballot_sync(kFull, any) == 0u) continue;

      // this thread's pixels' terms, added in pixel order: the same
      // straight-line arithmetic for every pixel, its terms selected to
      // zero where it does not composite (see Design).
      float geo[8];
      float fw[8];
      float w_of[kPix];
      float dsum = 0.f;
      float wsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        geo[j] = 0.f;
        fw[j] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        float gdot = 0.f;
        if (CT > 0) {
#pragma unroll
          for (int c = 0; c < kAcc; ++c) gdot += r[kGeo + c] * dout[i][c];
        } else if (contrib[i]) {
          for (int c = 0; c < nc; ++c) {
            gdot += r[kGeo + c] * dpk_t[c * npix + pix0 + i];
          }
        }
        const float w = contrib[i] ? alpha[i] * T[i] : 0.f;
        if (contrib[i]) pref[i] += w * gdot;
        const float suffix = tot[i] - pref[i];
        // 1 - alpha >= 0.01: alpha is capped at 0.99
        const float da = T[i] * gdot -
                         __fdividef(suffix + bg_term[i], 1.f - alpha[i]);
        const float dpow =
            contrib[i] && raw[i] < kAlphaMax ? raw[i] * da : 0.f;
        if (V == kMomentsBasis) {
          geo[0] += dpow;
          geo[1] += dpow * qx[i];
          geo[2] += dpow * qy[i];
          geo[3] += dpow * qxx[i];
          geo[4] += dpow * qyy[i];
          geo[5] += dpow * qxy[i];
        } else if (V == kNoMoments) {
          dsum += dpow;
        } else {
          const float dpx = dpow * dx[i];
          const float dpy = dpow * dy[i];
          geo[0] += dpx;
          geo[1] += dpy;
          geo[2] += dpx * dx[i];
          geo[3] += dpx * dy[i];
          geo[4] += dpy * dy[i];
          geo[5] += dpow;
        }
        if (V == kNoDfeat) {
          wsum += w;
        } else if (CT > 0) {
#pragma unroll
          for (int c = 0; c < kAcc && c < 8; ++c) fw[c] += w * dout[i][c];
        }
        w_of[i] = w;
        if (contrib[i]) T[i] = T[i] * (1.f - alpha[i]);
      }

      // the warp's sums into its slots
      const int slot = lane >> 2;  // the value this lane's group sums
      const bool writer = (lane & 3) == 0;
      if (V == kNoMoments) {
        const float s = warp_sum(dsum);
        if (lane < kGeo) part[lane * ks + k] = s;
      } else {
        const float gsum = warp_sum8(geo, lane);
        if (writer && slot < kGeo) part[slot * ks + k] = gsum;
      }
      if (V == kNoDfeat) {
        if (Cg > 0) {
          const float s = warp_sum(wsum);
          for (int c = lane; c < Cg; c += 32) {
            part[(kGeo + c) * ks + k] = c == 0 ? s : 0.f;
          }
        }
      } else if (CT > 0) {
        if (Cg > 0) {
          const float fsum = warp_sum8(fw, lane);
          if (writer && slot < Cg) part[(kGeo + slot) * ks + k] = fsum;
        }
      } else {
        for (int c = 0; c < Cg; ++c) {
          float x = 0.f;
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            if (contrib[i]) x += w_of[i] * dpk_t[c * npix + pix0 + i];
          }
          x = warp_sum(x);
          if (lane == 0) part[(kGeo + c) * ks + k] = x;
        }
      }
      if (lane == (k >> 5)) wrote |= 1u << (k & 31);
    }
    if (lane < kMaskWords) s_wmask[warp * kMaskWords + lane] = wrote;
    __syncthreads();

    // per-instance sums over the warps that wrote a slot, in warp order,
    // into warp 0's slots
    for (int e = tid; e < nout * nb; e += nthreads) {
      const int j = e / nb;
      const int k = e - j * nb;
      float* p = s_part + j * ks + k;
      const unsigned* m = s_wmask + (k >> 5);
      const unsigned bit = 1u << (k & 31);
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) {
        if (m[w * kMaskWords] & bit) s += p[w * nout * ks];
      }
      p[0] = s;
    }
    __syncthreads();
    for (int e = tid; e < nb * nw; e += nthreads) {
      const int k = e / nw;
      const int j = e - k * nw;
      const float* r = s_rows + k * row;
      const float* q = s_part + k;  // value x of instance k at q[x * ks]
      float o;
      if (kPacked && j >= kGeo) {
        // feature sums c, c+1 as one word of RNE bf16 pairs
        const int c = kGeo + 2 * (j - kGeo);
        const unsigned lo =
            c + 1 < nout ? round_bf16_bits(q[(c + 1) * ks]) >> 16 : 0u;
        o = __uint_as_float(round_bf16_bits(q[c * ks]) | lo);
      } else if (V == kMomentsBasis && j < kGeo) {
        // q = M0..M5 over (1, qx, qy, qx^2, qy^2, qx qy)
        const float m0 = q[0], m1 = q[ks], m2 = q[2 * ks];
        const float xr = r[0] - static_cast<float>(ox);
        const float yr = r[1] - static_cast<float>(oy);
        const float sx = xr * m0 - m1;
        const float sy = yr * m0 - m2;
        switch (j) {
          case 0: o = -(r[2] * sx + r[3] * sy); break;
          case 1: o = -(r[4] * sy + r[3] * sx); break;
          case 2: o = -0.5f * (xr * xr * m0 - 2.f * xr * m1 + q[3 * ks]); break;
          case 3:
            o = -(xr * yr * m0 - xr * m2 - yr * m1 + q[5 * ks]);
            break;
          case 4: o = -0.5f * (yr * yr * m0 - 2.f * yr * m2 + q[4 * ks]); break;
          default: o = r[5] > 0.f ? m0 / r[5] : 0.f; break;
        }
      } else if (V == kNoMoments && j < kGeo) {
        o = j == 5 ? (r[5] > 0.f ? q[5 * ks] / r[5] : 0.f) : q[j * ks];
      } else {
        // q = sx, sy, sxx, sxy, syy, s0, feats
        switch (j) {
          case 0: o = -(r[2] * q[0] + r[3] * q[ks]); break;
          case 1: o = -(r[4] * q[ks] + r[3] * q[0]); break;
          case 2: o = -0.5f * q[2 * ks]; break;
          case 3: o = -q[3 * ks]; break;
          case 4: o = -0.5f * q[4 * ks]; break;
          case 5: o = r[5] > 0.f ? q[5 * ks] / r[5] : 0.f; break;
          default: o = q[j * ks]; break;
        }
      }
      d_inst[static_cast<size_t>(start + b0 + k) * nw + j] = o;
    }
  }
}

size_t smem_bytes(int C, int Cg, int nwarps, int kb, bool quad) {
  const size_t row = kGeo + C;
  const size_t nout = kGeo + Cg;
  return (kb * row + nwarps * nout * (kb + 1) + (quad ? kb * kCoef : 0)) *
             sizeof(float) +
         (kb + kMaxBwdWarps + nwarps * kMaskWords) * sizeof(int);
}

// The batch: kBwdBatch, halved while its shared memory does not fit a block.
inline int bwd_batch(int C, int Cg, int nwarps, bool quad) {
  int kb = kBwdBatch;
  while (kb > 1 && smem_bytes(C, Cg, nwarps, kb, quad) > kMaxSmem) kb >>= 1;
  return kb;
}

template <int CT, int V, int F = 0>
int launch_backward(const float* table, int P, int C, int Cg,
                    const int* gauss_id, const int* starts, const int* counts,
                    int num_tiles, int grid_x, int tile_x, int tile_y,
                    const float* packed, const float* d_packed, float* d_inst,
                    cudaStream_t stream) {
  constexpr bool quad = (F & kFormQuad) != 0;
  const int threads = walk_threads(tile_x * tile_y);
  const int kb = bwd_batch(C, Cg, threads / 32, quad);
  const size_t smem = smem_bytes(C, Cg, threads / 32, kb, quad);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_backward_kernel<CT, V, F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite_backward_kernel<CT, V, F><<<num_tiles, threads, smem, stream>>>(
      table, P, C, Cg, gauss_id, starts, counts, grid_x, tile_x, tile_y, kb,
      packed, d_packed, d_inst);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel an SM holds at once for this shape (0 on an error).
template <int CT, int V, int F = 0>
int backward_occupancy(int C, int Cg, int tile_x, int tile_y) {
  constexpr bool quad = (F & kFormQuad) != 0;
  const int threads = walk_threads(tile_x * tile_y);
  const size_t smem = smem_bytes(C, Cg, threads / 32,
                                 bwd_batch(C, Cg, threads / 32, quad), quad);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(composite_backward_kernel<CT, V, F>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, composite_backward_kernel<CT, V, F>, threads, smem) !=
      cudaSuccess) {
    return 0;
  }
  return n;
}

}  // namespace
