// K2 — backward alpha composite, one CTA per tile: the kernel body, shared by
// K2 itself (composite_bwd.cu, the variant kBwdBase) and by the probes that
// change one piece of it (probe_bwd.cu, P2).
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
// The division is taken only on composited pairs, where alpha <= 0.99.  The
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
// Design.  One thread per tile pixel, as K1.  Batches of kBwdBatch instances
// are staged in shared memory straight from the [P, 6+C] table through
// gauss_id (the fused gather).  The walk stops at the tile's last contributor (the
// maximum n_contrib over the CTA), and each warp stops at its own.  For every
// instance a warp first votes: if none of its 32 pixels composites it, the
// warp adds nothing and shuffles nothing.  Otherwise the 6+Cg values are
// summed across the warp with xor shuffles, eight values at a time in a
// tree that halves the values in flight at each step (18 shuffles for 12
// values, not 60), and left in the warp's own slot of shared memory, and a
// bit is set in the instance's warp mask.  After the batch one thread per
// output word adds the slots of the warps whose bit is set, in warp order,
// and writes the row.  Each instance belongs to one tile,
// so rows are disjoint and each is written by one CTA: no atomics on global
// memory, and the same bits from run to run.  Rows the walk does not reach
// (past the tile's last contributor, alignment pads, the unused tail) are
// left as the caller's zeros.  The TPU kernel's DMA prefetch, slot parity
// and log-step scans are not carried over.
//
// Bound on the H100: operations.  A tested pair costs what it costs K1 (17);
// a composited pair 2C for g, about 20 for d alpha, dpow and the six moment
// terms, Cg for the feature terms, and its share of the reductions.  Bytes
// (table rows, ids, the two packed arrays, the rows written) are far below
// that.  The cross-thread reduction is the cost the design is about: most
// (pixel, instance) pairs are skipped, so the warp vote removes most
// shuffles.  C <= 8 keeps d_out in registers; larger C re-reads it from
// global memory (correct, slow).
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
//                  power > 0 test), so every pair up to n_contrib whose
//                  opacity passes the 1/255 test takes part.  It composites
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

constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBwdBatch = 64;      // instances staged per round
constexpr unsigned kFull = 0xffffffffu;

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
template <int CT, int V>
__global__ void __launch_bounds__(kMaxThreads)
composite_backward_kernel(const float* __restrict__ table, int P, int C,
                          int Cg, const int* __restrict__ gauss_id,
                          const int* __restrict__ starts,
                          const int* __restrict__ counts, int grid_x,
                          int tile_x, int tile_y,
                          const float* __restrict__ packed,
                          const float* __restrict__ d_packed,
                          float* __restrict__ d_inst) {
  extern __shared__ float smem[];
  const int nc = CT > 0 ? CT : C;
  const int row = kGeo + nc;
  const int nout = kGeo + Cg;
  const int npix = tile_x * tile_y;  // a multiple of 32 (checked by the host)
  const int nwarps = npix >> 5;
  float* s_rows = smem;                       // [kBwdBatch][row]
  float* s_sum = s_rows + kBwdBatch * row;    // [kBwdBatch][nout]
  float* s_part = s_sum + kBwdBatch * nout;   // [nwarps][kBwdBatch][nout]
  // [kBwdBatch] each
  int* s_gid = reinterpret_cast<int*>(s_part + nwarps * kBwdBatch * nout);
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_gid + kBwdBatch);
  int* s_red = reinterpret_cast<int*>(s_mask + kBwdBatch);  // [kMaxWarps]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ox = (t % grid_x) * tile_x;
  const int oy = (t / grid_x) * tile_y;
  const float px = static_cast<float>(ox + tid % tile_x);
  const float py = static_cast<float>(oy + tid / tile_x);
  // the tile-local basis of moments_basis
  const float qx = static_cast<float>(tid % tile_x);
  const float qy = static_cast<float>(tid / tile_x);
  const int start = starts[t];
  const int count = counts[t];
  const size_t tile_off = static_cast<size_t>(t) * (nc + 2) * npix;
  const float* fwd_t = packed + tile_off;
  const float* dpk_t = d_packed + tile_off;

  const int ncontrib = static_cast<int>(fwd_t[(nc + 1) * npix + tid]);
  const float bg_term = fwd_t[nc * npix + tid] * dpk_t[nc * npix + tid];
  constexpr int kAcc = CT > 0 ? CT : 1;
  float dout[kAcc];
  float tot = 0.f;
  if (CT > 0) {
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      dout[c] = dpk_t[c * npix + tid];
      tot += fwd_t[c * npix + tid] * dout[c];
    }
  } else {
    dout[0] = 0.f;
    for (int c = 0; c < nc; ++c) {
      tot += fwd_t[c * npix + tid] * dpk_t[c * npix + tid];
    }
  }

  // the warp's and the tile's last contributing position
  int wmax = ncontrib;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(kFull, wmax, off));
  }
  if (lane == 0) s_red[warp] = wmax;
  __syncthreads();
  int limit = 0;
  for (int w = 0; w < nwarps; ++w) limit = max(limit, s_red[w]);
  limit = min(limit, count);

  float T = 1.f;
  float pref = 0.f;

  for (int b0 = 0; b0 < limit; b0 += kBwdBatch) {
    const int nb = min(kBwdBatch, limit - b0);
    // the previous batch's rows and sums have been consumed
    __syncthreads();
    for (int k = tid; k < nb; k += npix) {
      s_gid[k] = gauss_id[start + b0 + k];
      s_mask[k] = 0u;
    }
    __syncthreads();
    for (int e = tid; e < nb * row; e += npix) {
      const int k = e / row;
      const int col = e - k * row;
      const int g = s_gid[k];
      s_rows[e] = (g >= 0 && g < P)
                      ? __ldg(table + static_cast<size_t>(g) * row + col)
                      : 0.f;
    }
    __syncthreads();

    const int kend = min(nb, wmax - b0);  // the same for the whole warp
    for (int k = 0; k < kend; ++k) {
      const int g = s_gid[k];
      if (g < 0 || g >= P) continue;  // pad sentinel, the same for the CTA
      const float* r = s_rows + k * row;
      const float dx = r[0] - px;
      const float dy = r[1] - py;
      float raw;
      bool pass;
      if (V == kNoAlpha) {
        raw = r[5];
        pass = true;
      } else {
        const float power =
            -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
        raw = V == kExp ? r[5] * expf(power) : r[5] * exp2f(power * kLog2e);
        pass = power <= 0.f;
      }
      const float alpha = fminf(kAlphaMax, raw);
      const bool contrib =
          pass && (alpha >= kAlphaMin) && (b0 + k + 1 <= ncontrib);
      if (__ballot_sync(kFull, contrib) == 0u) continue;

      float w = 0.f;
      float dpow = 0.f;
      float geo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) geo[j] = 0.f;
      if (contrib) {
        float gdot = 0.f;
        if (CT > 0) {
#pragma unroll
          for (int c = 0; c < kAcc; ++c) gdot += r[kGeo + c] * dout[c];
        } else {
          for (int c = 0; c < nc; ++c) {
            gdot += r[kGeo + c] * dpk_t[c * npix + tid];
          }
        }
        w = alpha * T;
        pref += w * gdot;
        const float suffix = tot - pref;
        const float da = T * gdot - (suffix + bg_term) / (1.f - alpha);
        dpow = raw < kAlphaMax ? raw * da : 0.f;
        if (V == kMomentsBasis) {
          geo[0] = dpow;
          geo[1] = dpow * qx;
          geo[2] = dpow * qy;
          geo[3] = dpow * (qx * qx);
          geo[4] = dpow * (qy * qy);
          geo[5] = dpow * (qx * qy);
        } else if (V != kNoMoments) {
          const float dpx = dpow * dx;
          const float dpy = dpow * dy;
          geo[0] = dpx;
          geo[1] = dpy;
          geo[2] = dpx * dx;
          geo[3] = dpx * dy;
          geo[4] = dpy * dy;
          geo[5] = dpow;
        }
        T = T * (1.f - alpha);
      }

      float* part = s_part + (warp * kBwdBatch + k) * nout;
      const int slot = lane >> 2;  // the value this lane's group sums
      const bool writer = (lane & 3) == 0;
      if (V == kNoMoments) {
        const float s = warp_sum(dpow);
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < kGeo; ++j) part[j] = s;
        }
      } else {
        const float gsum = warp_sum8(geo, lane);
        if (writer && slot < kGeo) part[slot] = gsum;
      }
      if (V == kNoDfeat) {
        if (Cg > 0) {
          const float s = warp_sum(w);
          if (lane == 0) {
            part[kGeo] = s;
            for (int c = 1; c < Cg; ++c) part[kGeo + c] = 0.f;
          }
        }
      } else if (CT > 0) {
        if (Cg > 0) {
          float fw[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            fw[c] = (c < kAcc && c < Cg) ? w * dout[c < kAcc ? c : 0] : 0.f;
          }
          const float fsum = warp_sum8(fw, lane);
          if (writer && slot < Cg) part[kGeo + slot] = fsum;
        }
      } else {
        for (int c = 0; c < Cg; ++c) {
          const float x = warp_sum(w * dpk_t[c * npix + tid]);
          if (lane == 0) part[kGeo + c] = x;
        }
      }
      if (lane == 0) atomicOr(s_mask + k, 1u << warp);
    }
    __syncthreads();

    // per-instance sums over the warps that took part, in warp order
    for (int e = tid; e < nb * nout; e += npix) {
      const int k = e / nout;
      const int j = e - k * nout;
      unsigned m = s_mask[k];
      float s = 0.f;
      while (m) {
        const int w = __ffs(m) - 1;
        m &= m - 1u;
        s += s_part[(w * kBwdBatch + k) * nout + j];
      }
      s_sum[e] = s;
    }
    __syncthreads();
    for (int e = tid; e < nb * nout; e += npix) {
      const int k = e / nout;
      const int j = e - k * nout;
      const float* r = s_rows + k * row;
      const float* q = s_sum + k * nout;
      float o;
      if (V == kMomentsBasis && j < kGeo) {
        // q = M0..M5 over (1, qx, qy, qx^2, qy^2, qx qy)
        const float xr = r[0] - static_cast<float>(ox);
        const float yr = r[1] - static_cast<float>(oy);
        const float sx = xr * q[0] - q[1];
        const float sy = yr * q[0] - q[2];
        switch (j) {
          case 0: o = -(r[2] * sx + r[3] * sy); break;
          case 1: o = -(r[4] * sy + r[3] * sx); break;
          case 2: o = -0.5f * (xr * xr * q[0] - 2.f * xr * q[1] + q[3]); break;
          case 3: o = -(xr * yr * q[0] - xr * q[2] - yr * q[1] + q[5]); break;
          case 4: o = -0.5f * (yr * yr * q[0] - 2.f * yr * q[2] + q[4]); break;
          default: o = r[5] > 0.f ? q[0] / r[5] : 0.f; break;
        }
      } else if (V == kNoMoments && j < kGeo) {
        o = j == 5 ? (r[5] > 0.f ? q[5] / r[5] : 0.f) : q[j];
      } else {
        // q = sx, sy, sxx, sxy, syy, s0, feats
        switch (j) {
          case 0: o = -(r[2] * q[0] + r[3] * q[1]); break;
          case 1: o = -(r[4] * q[1] + r[3] * q[0]); break;
          case 2: o = -0.5f * q[2]; break;
          case 3: o = -q[3]; break;
          case 4: o = -0.5f * q[4]; break;
          case 5: o = r[5] > 0.f ? q[5] / r[5] : 0.f; break;
          default: o = q[j]; break;
        }
      }
      d_inst[static_cast<size_t>(start + b0 + k) * nout + j] = o;
    }
  }
}

size_t smem_bytes(int C, int Cg, int npix) {
  const size_t row = kGeo + C;
  const size_t nout = kGeo + Cg;
  const size_t nwarps = npix / 32;
  return (kBwdBatch * row + kBwdBatch * nout + nwarps * kBwdBatch * nout) *
             sizeof(float) +
         2 * kBwdBatch * sizeof(int) + kMaxWarps * sizeof(int);
}

template <int CT, int V>
int launch_backward(const float* table, int P, int C, int Cg,
                    const int* gauss_id, const int* starts, const int* counts,
                    int num_tiles, int grid_x, int tile_x, int tile_y,
                    const float* packed, const float* d_packed, float* d_inst,
                    cudaStream_t stream) {
  const size_t smem = smem_bytes(C, Cg, tile_x * tile_y);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_backward_kernel<CT, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite_backward_kernel<CT, V><<<num_tiles, tile_x * tile_y, smem,
                                     stream>>>(
      table, P, C, Cg, gauss_id, starts, counts, grid_x, tile_x, tile_y,
      packed, d_packed, d_inst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
