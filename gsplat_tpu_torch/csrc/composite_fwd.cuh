// K1 — forward alpha composite, one CTA per tile: the kernel body, shared by
// K1 itself (composite_fwd.cu, the variant kFwdBase in the f32 form;
// composite_fwd_forms.cu, its other forms) and by the probes that change one
// piece of it (probe_fwd.cu, P1; probe_load.cu, P3's compute_resident and the
// staging of its load_only forms).
//
// Replaces the Pallas kernel gsplat_tpu/ops/composite_pallas.py::
// _forward_kernel (:247-353, launched by _pallas_forward :578-598), together
// with the row gather that fed it (segment_reduce.py::gather_rows forward,
// ``table[idx]``).
//
// What it computes, per pixel of tile t, walking the tile's depth-sorted
// instance list [starts[t], starts[t] + counts[t]) front to back:
//     power = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx = mean_x - px, ...
//     alpha = min(0.99, opacity * exp2(power * log2(e)))
//     skip the instance if power > 0 or alpha < 1/255;
//     test_T = T (1 - alpha); if test_T < 1e-4 the pixel is done and this
//     instance is NOT composited (forward.cu:351-358);
//     else acc_c += alpha T feat_c, T = test_T, n_contrib = position + 1.
// Output [T, C+2, TILE_PIX] f32, the layout of the Pallas kernel: the C
// composited channels, then T_final, then n_contrib (the training slice's
// backward kernel reads it).
//
// Design.  One thread per tile pixel (TILE_X * TILE_Y threads: 1024 at the
// default 32x32, 256 at 16x16).  The CTA stages batches of kFwdBatch
// instances in shared memory: threads read the batch's gaussian ids, then the
// per-gaussian rows (mean2d, conic, opacity, C features) straight from the
// [P, 6+C] table, the way renderCUDA stages its batches, so the [I, 6+C]
// gathered table the TPU path builds never exists.  Ids >= P are the pad
// sentinel and contribute nothing.  Every pixel then reads each staged row
// as a shared-memory broadcast.  A __syncthreads_count at each batch ends the
// tile once all its pixels are done.  The TPU kernel's cross-tile DMA
// prefetch (it relied on the sequential TPU grid) and its log-step scans
// (there for 128-wide vector tiles) are dropped: blocks run in parallel here
// and each pixel runs the recurrence serially, like renderCUDA.
//
// Bound on the H100.  Operations: 17 fp32 operations (one of them the
// exp2) for every (pixel, instance) pair up to the pixel's exit, 3 more
// for a pair that passes the skip tests and 1 + 2C more for a composited
// one.  At the 1080p asset most tested pairs are skipped (about one in six
// is composited), so the skip test dominates.  The output write
// (TILE_PIX (C+2) floats per tile) and the instance reads are far below the
// operation time at the render path's instance counts.  So the kernel is
// compute-bound on the per-pair arithmetic and the MUFU exp2 rate; the early
// exit is what keeps the pair count down.  Accumulators stay in registers
// for C <= 8 (compile-time C; the render path has C = 5 + num_class, or 3
// under render_only); __launch_bounds__(1024) caps a thread at 64 registers.
// Larger C is correct but slow: it accumulates straight into the output row
// in global memory (each pixel owns its own output words, so there are no
// races).
//
// The forms (template parameter F, composite_common.cuh's Form bits), the
// Pallas kernel's compile-time mxu_power and fp:
//   kFormQuad    the power as per-instance coefficients in tile-relative
//                coordinates (formed once per staged batch) times the
//                tile-local basis (1, qx, qy, qx^2, qy^2, qx qy), summed as
//                six products, with the power > 1e-4 skip
//                (composite_pallas.py:130-151, :172).  A plain product, not a
//                tensor-core mma: the TPU kernel took it to its matrix unit;
//                here it is six FMA-unit products against base's nine, and
//                six more floats per staged instance.
//   kFormPacked  the table is [P, 6 + ceil(Cg/2)] with the features as RNE
//                bf16 pairs; staging unpacks each word into two floats (an
//                and, a shift) and, with kFormOnes, appends the ones channel,
//                so the staged row and everything after it are base's.  The
//                table read shrinks from 6 + C to 6 + ceil(Cg/2) words per
//                instance.
//
// The probes' variants.  Each one changes one piece of the body above at
// compile time, so kFwdBase is K1 and every variant follows K1 when K1
// changes.  Each writes K1's [T, C+2, TILE_PIX] layout; what each row holds
// is defined by the plain version (gsplat_tpu_torch/tools/probes.py::
// probe_forward_plain and probe_load_plain):
//   no_cond          no early exit: the CTA's __syncthreads_count(done) vote
//                    and the per-pixel break are gone; a finished pixel keeps
//                    testing and updating, with its update masked to zero
//                    (the TPU's `where(~done)`).  Output equal to base.
//   no_scan          the transmittance update T = T (1 - alpha) is removed:
//                    T stays 1, so w = alpha and no pixel terminates (every
//                    pixel walks its whole tile; compare with no_cond).
//   no_matmul        the C-channel accumulation becomes one channel, the sum
//                    of the weights w (row 0; rows 1..C-1 are zero).
//   no_minmax        the n_contrib bookkeeping (`last`) is dropped: row C+1
//                    is zero.
//   alpha_only       power, alpha and the two skip tests only, and one add:
//                    row 0 is the sum of the passing alphas, row C is 1, the
//                    rest zero; no transmittance, no termination.
//   quad_power       K1's kFormQuad form: P1 launches kFwdBase with
//                    F = kFormQuad (the enum value is P1's index only).
//   no_exp           stripped with exp2 replaced by 1 + power (costs the
//                    special-function unit; compare with stripped).
//   stripped         no termination test, no done state, no `last`: the
//                    transmittance recurrence and the C channels only (row
//                    C+1 zero); every pixel walks its whole tile.
//   trim_bookkeeping base's output with less bookkeeping: no branch on the
//                    pad sentinel (its staged row is zeros, whose alpha fails
//                    the 1/255 test) and the done flag kept as the sign of T.
//   compute_resident base with its staging taken away: each tile's first
//                    batch is staged once, and every later batch computes on
//                    those resident rows (instance k of batch b is the first
//                    batch's k-th), with base's termination and exit (P3).
// Every knockout still writes an output that depends on what it kept, so
// nvcc cannot delete the work it measures.
#pragma once

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

constexpr int kFwdBatch = 256;     // instances staged per round
constexpr float kTEps = 1e-4f;

// The first ten in the order of probes.FWD_VARIANTS (P1's variant index).
enum FwdVariant {
  kFwdBase = 0,
  kNoCond,
  kNoScan,
  kNoMatmul,
  kNoMinmax,
  kAlphaOnly,
  kQuadPower,
  kNoExp,
  kStripped,
  kTrimBookkeeping,
  kComputeResident,
  kNumFwdVariants
};

// Stages instances [b0, b0 + nb) of the tile's list that starts at `start`:
// their gaussian ids into s_gid, then their [row] table rows into s_rows
// (zeros for an id outside [0, P), the pad sentinel).  Ends on a barrier.
__device__ __forceinline__ void stage_batch(const float* __restrict__ table,
                                            int P, int row,
                                            const int* __restrict__ gauss_id,
                                            int start, int b0, int nb,
                                            int npix, float* s_rows,
                                            int* s_gid) {
  const int tid = threadIdx.x;
  for (int k = tid; k < nb; k += npix) s_gid[k] = gauss_id[start + b0 + k];
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
}

// stage_batch from the packed table [P, 6 + ceil(cg/2)]: the staged rows of
// kGeo + C floats are what stage_batch stages from the f32 table.
__device__ __forceinline__ void stage_batch_packed(
    const float* __restrict__ table, int P, int row, int cg,
    const int* __restrict__ gauss_id, int start, int b0, int nb, int npix,
    float* s_rows, int* s_gid) {
  const int tid = threadIdx.x;
  for (int k = tid; k < nb; k += npix) s_gid[k] = gauss_id[start + b0 + k];
  __syncthreads();
  for (int e = tid; e < nb * row; e += npix) {
    const int k = e / row;
    s_rows[e] = packed_value(table, P, s_gid[k], cg, e - k * row);
  }
  __syncthreads();
}

// The kernel body.  CT > 0: compile-time channel count, accumulators in
// registers; CT == 0: runtime channel count C, accumulated in global memory.
// F: the form (Form bits), 0 for f32.
template <int CT, int V, int F>
__device__ __forceinline__ void composite_forward_body(
    const float* __restrict__ table, int P, int C,
    const int* __restrict__ gauss_id, const int* __restrict__ starts,
    const int* __restrict__ counts, int grid_x, int tile_x, int tile_y,
    float* __restrict__ out) {
  // what each variant keeps
  constexpr bool kQuad = (F & kFormQuad) != 0;
  constexpr bool kPacked = (F & kFormPacked) != 0;
  constexpr bool kStrip = V == kStripped || V == kNoExp;
  constexpr bool kTerminate = V != kAlphaOnly && !kStrip;
  constexpr bool kExit = kTerminate && V != kNoCond;
  constexpr bool kUpdateT = V != kNoScan && V != kAlphaOnly;
  constexpr bool kOneChannel = V == kNoMatmul || V == kAlphaOnly;
  constexpr bool kLast = V != kNoMinmax && V != kAlphaOnly && !kStrip;
  constexpr bool kSentinelBranch = V != kTrimBookkeeping;
  constexpr bool kStageEach = V != kComputeResident;
  constexpr float kPowerCut = kQuad ? kQuadPowerCut : 0.f;

  extern __shared__ float smem[];
  const int nc = CT > 0 ? CT : C;
  const int row = kGeo + nc;
  float* s_rows = smem;                                     // [kFwdBatch][row]
  float* s_coef = s_rows + kFwdBatch * row;  // [kFwdBatch][kCoef], quad only
  int* s_gid = reinterpret_cast<int*>(s_coef + (kQuad ? kFwdBatch * kCoef : 0));

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int npix = tile_x * tile_y;
  const int ox = (t % grid_x) * tile_x;
  const int oy = (t / grid_x) * tile_y;
  const float px = static_cast<float>(ox + tid % tile_x);
  const float py = static_cast<float>(oy + tid / tile_x);
  // the tile-local basis of quad_power
  const float qx = static_cast<float>(tid % tile_x);
  const float qy = static_cast<float>(tid / tile_x);
  const float qxx = qx * qx;
  const float qyy = qy * qy;
  const float qxy = qx * qy;
  const int start = starts[t];
  const int count = counts[t];
  float* out_t = out + static_cast<size_t>(t) * (nc + 2) * npix;

  constexpr int kAcc = kOneChannel ? 1 : (CT > 0 ? CT : 1);
  constexpr bool kGlobalAcc = CT == 0 && !kOneChannel;
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.f;
  if (kGlobalAcc) {
    for (int c = 0; c < nc; ++c) out_t[c * npix + tid] = 0.f;
  }

  float T = 1.f;  // trim_bookkeeping: negative once the pixel is done
  int last = 0;
  int done = 0;

  for (int b0 = 0; b0 < count; b0 += kFwdBatch) {
    // Also the barrier that keeps the previous batch's shared rows alive
    // until every thread has finished reading them.
    if (kExit) {
      const int finished = V == kTrimBookkeeping ? (T < 0.f) : done;
      if (__syncthreads_count(finished) == npix) break;
    } else {
      __syncthreads();
    }
    const int nb = min(kFwdBatch, count - b0);
    if (kStageEach || b0 == 0) {
      if constexpr (kPacked) {
        stage_batch_packed(table, P, row, nc - ((F & kFormOnes) ? 1 : 0),
                           gauss_id, start, b0, nb, npix, s_rows, s_gid);
      } else {
        stage_batch(table, P, row, gauss_id, start, b0, nb, npix, s_rows,
                    s_gid);
      }
    }
    if constexpr (kQuad) {
      for (int k = tid; k < nb; k += npix) {
        quad_coefficients(s_rows + k * row, static_cast<float>(ox),
                          static_cast<float>(oy), s_coef + k * kCoef);
      }
      __syncthreads();
    }
    if (kExit) {
      if (V == kTrimBookkeeping ? (T < 0.f) : (done != 0)) continue;
    }
    for (int k = 0; k < nb; ++k) {
      if (kSentinelBranch) {
        const int g = s_gid[k];
        if (g < 0 || g >= P) continue;  // pad sentinel
      }
      const float* r = s_rows + k * row;
      float power;
      if (kQuad) {
        power = quad_power(s_coef + k * kCoef, qx, qy, qxx, qyy, qxy);
      } else {
        const float dx = r[0] - px;
        const float dy = r[1] - py;
        power = -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
      }
      const float G = V == kNoExp ? 1.f + power : exp2f(power * kLog2e);
      const float alpha = fminf(kAlphaMax, r[5] * G);
      if (!(power <= kPowerCut) || !(alpha >= kAlphaMin)) continue;
      if (V == kAlphaOnly) {
        acc[0] += alpha;
        continue;
      }
      const float Tv = V == kTrimBookkeeping ? fabsf(T) : T;
      const float test_T = Tv * (1.f - alpha);
      float live = 1.f;  // no_cond: 0 once the pixel is done
      if (kTerminate) {
        if (V == kNoCond) {
          if (done || test_T < kTEps) {
            done = 1;
            live = 0.f;
          }
        } else if (test_T < kTEps) {
          if (V == kTrimBookkeeping) {
            T = -Tv;
          } else {
            done = 1;
          }
          break;
        }
      }
      const float w = V == kNoCond ? alpha * Tv * live : alpha * Tv;
      if (kOneChannel) {
        acc[0] += w;
      } else if (!kGlobalAcc) {
#pragma unroll
        for (int c = 0; c < kAcc; ++c) acc[c] += w * r[kGeo + c];
      } else {
        for (int c = 0; c < nc; ++c) out_t[c * npix + tid] += w * r[kGeo + c];
      }
      if (kUpdateT) {
        if (V == kNoCond) {
          T = live != 0.f ? test_T : T;
        } else {
          T = test_T;
        }
      }
      if (kLast) {
        if (V == kNoCond) {
          last = live != 0.f ? b0 + k + 1 : last;
        } else {
          last = b0 + k + 1;
        }
      }
    }
  }

  if (kOneChannel) {
    out_t[tid] = acc[0];
    for (int c = 1; c < nc; ++c) out_t[c * npix + tid] = 0.f;
  } else if (!kGlobalAcc) {
#pragma unroll
    for (int c = 0; c < kAcc; ++c) out_t[c * npix + tid] = acc[c];
  }
  out_t[nc * npix + tid] = V == kTrimBookkeeping ? fabsf(T) : T;
  out_t[(nc + 1) * npix + tid] = static_cast<float>(last);
}

#define GSPLAT_K1_PARAMS                                                     \
  const float* __restrict__ table, int P, int C,                             \
      const int* __restrict__ gauss_id, const int* __restrict__ starts,      \
      const int* __restrict__ counts, int grid_x, int tile_x, int tile_y,    \
      float* __restrict__ out
#define GSPLAT_K1_ARGS \
  table, P, C, gauss_id, starts, counts, grid_x, tile_x, tile_y, out

// The f32 form (and the probes' variants of it).
template <int CT, int V, int F = 0>
__global__ void __launch_bounds__(kMaxThreads)
composite_forward_kernel(GSPLAT_K1_PARAMS) {
  composite_forward_body<CT, V, F>(GSPLAT_K1_ARGS);
}

// The other forms ask for two CTAs of 1024 threads per SM, so at most 32
// registers a thread: left free, ptxas gave the packed quad form 42 at
// C = 7, one CTA per SM, and it ran 19% slower than the quad form (an
// H100, PERF.md).  A kernel of its own, because a second bound on the f32
// form's kernel changes its code.
template <int CT, int V, int F>
__global__ void __launch_bounds__(kMaxThreads, 2)
composite_forward_form_kernel(GSPLAT_K1_PARAMS) {
  composite_forward_body<CT, V, F>(GSPLAT_K1_ARGS);
}

#undef GSPLAT_K1_PARAMS
#undef GSPLAT_K1_ARGS

// The kernel entry of form F (only the one is instantiated).
template <int CT, int V, int F>
auto forward_kernel() {
  if constexpr (F == 0) {
    return composite_forward_kernel<CT, V, F>;
  } else {
    return composite_forward_form_kernel<CT, V, F>;
  }
}

template <int CT, int V, int F = 0>
int launch_forward(const float* table, int P, int C, const int* gauss_id,
                   const int* starts, const int* counts, int num_tiles,
                   int grid_x, int tile_x, int tile_y, float* out,
                   cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kFwdBatch) * (kGeo + C) * sizeof(float) +
      ((F & kFormQuad) ? kFwdBatch * kCoef * sizeof(float) : 0) +
      kFwdBatch * sizeof(int);
  const auto kernel = forward_kernel<CT, V, F>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<num_tiles, tile_x * tile_y, smem, stream>>>(
      table, P, C, gauss_id, starts, counts, grid_x, tile_x, tile_y, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
