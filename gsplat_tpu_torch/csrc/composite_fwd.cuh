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
// Design.  K2's warp map and cull (composite_common.cuh), so the two
// kernels walk one layout.  A thread owns kPix = 4 consecutive pixels of a
// tile row, and a warp a 16x8 block of them where the tile divides into such
// blocks (32x32: 8 warps; 16x16: 2), else 128 pixels in row-major order
// (where the row width is not a multiple of 4 a thread's pixels may cross a
// row, and the last thread's may reach past the tile: a kernel of its own,
// kCross, gives each pixel its own coordinates and stores word by word).  A
// CTA runs at most kFwdCtaWarps = 4 of a tile's warps (fwd_split: two CTAs
// of 128 threads at 32x32, one of 64 at 16x16), each CTA walking the tile's
// whole instance list for its own warps, so that a heavy tile's walk runs on
// two SMs.  Each CTA stages
// batches of kFwdBatch instances in shared memory as K2 does: the rows
// straight from the [P, 6+C] table through gauss_id (the fused gather: the
// [I, 6+C] gathered table the TPU path builds never exists; kStageLoads of a
// thread's loads in flight together), the quad form's coefficients and, per
// instance, the bits of its warps whose box of pixels the gaussian may reach
// (warps_that_may_composite: a warp is left out only where the least
// quadratic form over its box keeps the power under alpha's 1/255 threshold
// by a margin far above the rounding of the power; the pad sentinel,
// opacity 0, reaches none).  A warp takes the instances whose bit it has,
// found 32 at a time by a ballot.  For each, each thread reads the staged row
// once and computes power, alpha and both skip tests for its four pixels;
// the warp votes once and goes on if none of its 128 pixels passes;
// otherwise each thread takes its four pixels' steps straight-line, each
// pixel's sums and state selected where it does not composite, so the four
// chains run side by side.  A pixel's done state is the sign of its
// transmittance (negative once done; the output is |T|), so there is no
// per-pair sentinel branch and no done flag.  A warp stops once its 128
// pixels are done, and the CTA at the batch barrier's __syncthreads_count
// once all of its pixels are.  Each pixel's recurrence runs front to back,
// one instance after another, with the expressions and the operation order
// of the one-thread-per-pixel kernel it replaces (built with --fmad=false),
// so the output is that kernel's bit for bit.  The TPU kernel's cross-tile
// DMA prefetch (it relied on the sequential TPU grid) and its log-step scans
// (there for 128-wide vector tiles) are dropped.
//
// Bound on the H100.  Operations: 17 fp32 operations (one of them the
// exp2) for every (pixel, instance) pair up to the pixel's exit, 3 more
// for a pair that passes the skip tests and 1 + 2C more for a composited
// one.  At the 1080p asset most tested pairs are skipped (about one in six
// is composited), so the skip test dominates.  The output write
// (TILE_PIX (C+2) floats per tile) and the instance reads are far below the
// operation time at the render path's instance counts.  What holds the
// kernel back is the serial walk of the heaviest tiles (an H100 runs the
// heaviest 1080p tile alone for about half the kernel's time): the cull
// shortens a warp's walk, the split runs a tile on two SMs, the staged
// loads in flight together and the straight-line steps shorten the time an
// instance takes.  Accumulators stay in registers for a compile-time C (the
// render path has C = 5 + num_class, or 3 under render_only); a runtime C
// accumulates straight into the output row in global memory (each pixel owns
// its own output words, so there are no races): correct, slow.
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
//   no_cond          no early exit: the CTA's __syncthreads_count vote and
//                    the warp's stop are gone, and a finished pixel keeps
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
//                    pad sentinel and the done flag kept as the sign of T.
//                    Base itself keeps both so now (the sentinel's cull mask
//                    is 0), and the variant compiles to base's kernel.
//   compute_resident base with its staging taken away: each tile's first
//                    batch is staged once (rows, masks), and every later
//                    batch computes on those resident rows (instance k of
//                    batch b is the first batch's k-th), with base's
//                    termination and exit (P3).
// Every knockout still writes an output that depends on what it kept, so
// nvcc cannot delete the work it measures.
#pragma once

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

constexpr int kFwdBatch = 128;     // instances staged per round
constexpr int kFwdCtaWarps = 4;    // warps of a CTA, at most
constexpr int kFwdCtaThreads = 32 * kFwdCtaWarps;
constexpr int kStageLoads = 8;     // staged floats a thread loads at a time
constexpr float kTEps = 1e-4f;

// The CTAs a tile of npix pixels is split over, kFwdCtaWarps of its warps
// each (the last CTA's warps past the tile, if any, own no pixel), and the
// threads of each.
__host__ __device__ inline int fwd_split(int npix) {
  return (walk_threads(npix) / 32 + kFwdCtaWarps - 1) / kFwdCtaWarps;
}
inline int fwd_threads(int npix) {
  const int threads = walk_threads(npix);
  return threads < kFwdCtaThreads ? threads : kFwdCtaThreads;
}

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

// Stages the nb instances at gid_b of a tile at (ox, oy) as K2 stages them
// (composite_bwd.cuh, which spells the same loops out in its kernel): each
// instance's [row] floats through its gaussian id into
// s_rows (the fused gather: the table [P, trow] as it is, or, kPacked, its
// cg bf16 pair features unpacked and the ones channel made where row > kGeo
// + cg; zeros for an id outside [0, P), the pad sentinel), per instance the
// bits of the nwarps warps from w0 that may composite it into s_may (0 for
// the sentinel), and, kQuad, its quad-power coefficients into s_coef.  The
// geometry for the mask and the coefficients is read again from the table,
// so no barrier separates the two loops; the caller's barrier ends the
// staging.
template <bool kPacked, bool kQuad>
__device__ __forceinline__ void stage_instances(
    const float* __restrict__ table, int P, int row, int trow, int cg,
    const int* __restrict__ gid_b, int nb, int tid, int nthreads, int ox,
    int oy, int tile_x, int tile_y, int npix, int w0, int nwarps,
    float* s_rows, unsigned* s_may, float* s_coef) {
  // kStageLoads elements a thread at a time, all loaded before any is
  // stored, so that their loads are in flight together
  const int n = nb * row;
  for (int e0 = tid; e0 < n; e0 += kStageLoads * nthreads) {
    float v[kStageLoads];
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      const int e = e0 + j * nthreads;
      const int k = min(e, n - 1) / row;
      const int col = min(e, n - 1) - k * row;
      const int g = __ldg(gid_b + k);
      if constexpr (kPacked) {
        v[j] = packed_value(table, P, g, cg, col);
      } else {
        v[j] = (g >= 0 && g < P)
                   ? __ldg(table + static_cast<size_t>(g) * row + col)
                   : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kStageLoads; ++j) {
      if (e0 + j * nthreads < n) s_rows[e0 + j * nthreads] = v[j];
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
                     : warps_that_may_composite(geo[0], geo[1], geo[2], geo[3],
                                                geo[4], geo[5], ox, oy, tile_x,
                                                tile_y, npix, nwarps, w0);
    if constexpr (kQuad) {
      quad_coefficients(geo, static_cast<float>(ox), static_cast<float>(oy),
                        s_coef + k * kCoef);
    }
  }
}

// Bytes of shared memory a CTA of K1 uses: a batch's rows, masks and (quad)
// coefficients.
inline size_t fwd_smem_bytes(int C, bool quad) {
  return static_cast<size_t>(kFwdBatch) *
         ((kGeo + C + (quad ? kCoef : 0)) * sizeof(float) + sizeof(unsigned));
}

// The kernel body.  CT > 0: compile-time channel count, accumulators in
// registers; CT == 0: runtime channel count C, accumulated in global memory.
// F: the form (Form bits), 0 for f32.  kCross: a tile row width that is not
// a multiple of kPix (K1 itself at a runtime C only).
template <int CT, int V, int F, bool kCross = false>
__device__ __forceinline__ void composite_forward_body(
    const float* __restrict__ table, int P, int C,
    const int* __restrict__ gauss_id, const int* __restrict__ starts,
    const int* __restrict__ counts, int grid_x, int tile_x, int tile_y,
    float* __restrict__ out) {
  // what each variant keeps (trim_bookkeeping is base)
  constexpr bool kQuad = (F & kFormQuad) != 0;
  constexpr bool kPacked = (F & kFormPacked) != 0;
  constexpr bool kStrip = V == kStripped || V == kNoExp;
  constexpr bool kTerminate = V != kAlphaOnly && !kStrip;
  constexpr bool kExit = kTerminate && V != kNoCond;
  constexpr bool kUpdateT = V != kNoScan && V != kAlphaOnly;
  constexpr bool kOneChannel = V == kNoMatmul || V == kAlphaOnly;
  constexpr bool kLast = V != kNoMinmax && V != kAlphaOnly && !kStrip;
  constexpr bool kStageEach = V != kComputeResident;
  constexpr float kPowerCut = kQuad ? kQuadPowerCut : 0.f;
  static_assert(!kCross || (V == kFwdBase && CT == 0),
                "rows that cross take K1's runtime-C kernel only");

  extern __shared__ float smem[];
  const int nc = CT > 0 ? CT : C;
  const int row = kGeo + nc;
  // the stored features and the table's row: packed, Cg features as
  // ceil(Cg/2) pair words, the ones channel (kFormOnes) made in staging
  const int cg = nc - ((F & kFormOnes) ? 1 : 0);
  const int trow = kPacked ? kGeo + (cg + 1) / 2 : row;
  float* s_rows = smem;                            // [kFwdBatch][row]
  float* s_coef = s_rows + kFwdBatch * row;   // [kFwdBatch][kCoef], quad only
  unsigned* s_may = reinterpret_cast<unsigned*>(
      s_coef + (kQuad ? kFwdBatch * kCoef : 0));              // [kFwdBatch]

  // The tile's warps are split over `split` CTAs (fwd_split): this CTA runs
  // warps w0 .. w0 + nwarps - 1 of the tile's warp map.
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const int npix = tile_x * tile_y;
  const int split = fwd_split(npix);
  const int t = blockIdx.x / split;
  const int w0 = (blockIdx.x - t * split) * nwarps;
  const int ox = (t % grid_x) * tile_x;
  const int oy = (t / grid_x) * tile_y;
  const int start = starts[t];
  const int count = counts[t];
  float* out_t = out + static_cast<size_t>(t) * (nc + 2) * npix;

  // this thread's pixels pix0 .. pix0 + 3: in one row of the tile, all
  // inside it or none (tile_x % kPix == 0), or, kCross, each in its own row
  // and the last thread's partly past the tile
  const int pix0 = thread_pixel0(tile_x, tile_y, w0 * 32 + tid);
  const bool inside = pix0 < npix;
  const int lx = pix0 % tile_x;
  const int ly = pix0 / tile_x;
  // pixel centres and the tile-local basis of quad_power (pixel i's qx, qx^2
  // and qx qy, exact small integers, are formed where they are used: kept
  // for four pixels they made the quad forms spill)
  const float py = static_cast<float>(oy + ly);
  const float qx0 = static_cast<float>(lx);
  const float qy = static_cast<float>(ly);
  const float qyy = qy * qy;
  float px[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) px[i] = static_cast<float>(ox + lx + i);
  // kCross: pixel i's own tile-local coordinates and centre row
  float cx[kPix], cy[kPix], cpy[kPix];
  if constexpr (kCross) {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      cx[i] = static_cast<float>((pix0 + i) % tile_x);
      cy[i] = static_cast<float>((pix0 + i) / tile_x);
      px[i] = static_cast<float>(ox) + cx[i];
      cpy[i] = static_cast<float>(oy) + cy[i];
    }
  }

  constexpr int kAcc = kOneChannel ? 1 : (CT > 0 ? CT : 1);
  constexpr bool kGlobalAcc = CT == 0 && !kOneChannel;
  float acc[kPix][kAcc];
  float T[kPix];  // negative once the pixel is done (its |T| is T_final)
  int last[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[i][c] = 0.f;
    // a pixel past the tile is done from the start
    T[i] = (kCross ? pix0 + i < npix : inside) ? 1.f : -1.f;
    last[i] = 0;
  }
  if (kGlobalAcc && inside) {
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        if (!kCross || pix0 + i < npix) out_t[c * npix + pix0 + i] = 0.f;
      }
    }
  }

  bool warp_done = false;  // kExit: the warp's 128 pixels are done
  for (int b0 = 0; b0 < count; b0 += kFwdBatch) {
    // Also the barrier that keeps the previous batch's shared rows alive
    // until every thread has finished reading them.
    if (kExit) {
      bool fin = true;
#pragma unroll
      for (int i = 0; i < kPix; ++i) fin = fin && T[i] < 0.f;
      if (__syncthreads_count(fin) == nthreads) break;
    } else {
      __syncthreads();
    }
    const int nb = min(kFwdBatch, count - b0);
    if (kStageEach || b0 == 0) {
      stage_instances<kPacked, kQuad>(
          table, P, row, trow, cg, gauss_id + start + b0, nb, tid, nthreads,
          ox, oy, tile_x, tile_y, npix, w0, nwarps, s_rows, s_may, s_coef);
    }
    __syncthreads();
    for (int k0 = 0; k0 < nb && !(kExit && warp_done); k0 += 32) {
      // the next 32 instances this warp walks: those whose cull bit it has
      // (an instance no pixel of the warp can composite, the pad sentinel
      // among them, has it clear)
      unsigned todo = __ballot_sync(
          kFull, k0 + lane < nb && ((s_may[k0 + lane] >> warp) & 1u));
      while (todo) {
        const int k = k0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const float* r = s_rows + k * row;
        const float dy = r[1] - py;
        float alpha[kPix];
        bool pass[kPix];
        bool any = false;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          float power;
          if constexpr (kQuad && kCross) {
            power = quad_power(s_coef + k * kCoef, cx[i], cy[i],
                               cx[i] * cx[i], cy[i] * cy[i], cx[i] * cy[i]);
          } else if constexpr (kQuad) {
            const float qx = qx0 + static_cast<float>(i);
            power = quad_power(s_coef + k * kCoef, qx, qy, qx * qx, qyy,
                               qx * qy);
          } else {
            const float dx = r[0] - px[i];
            const float dyi = kCross ? r[1] - cpy[i] : dy;
            power = -0.5f * (r[2] * dx * dx + r[4] * dyi * dyi) -
                    r[3] * dx * dyi;
          }
          const float G = V == kNoExp ? 1.f + power : exp2f(power * kLog2e);
          alpha[i] = fminf(kAlphaMax, r[5] * G);
          pass[i] = power <= kPowerCut && alpha[i] >= kAlphaMin &&
                    (kExit ? T[i] > 0.f : inside);
          any = any || pass[i];
        }
        if (!__any_sync(kFull, any)) continue;
        const int pos = b0 + k + 1;
        // each pixel's step, straight-line: what it adds and keeps is
        // selected where it does not composite (a select of the sum, not of
        // the weight, so a pair it skips adds nothing whatever its features)
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          if (V == kAlphaOnly) {
            acc[i][0] = pass[i] ? acc[i][0] + alpha[i] : acc[i][0];
            continue;
          }
          const float Tv = V == kNoCond ? fabsf(T[i]) : T[i];
          const float test_T = Tv * (1.f - alpha[i]);
          const bool was = T[i] > 0.f;
          const bool stop = kTerminate && pass[i] && was && test_T < kTEps;
          // composited: base's passing pair that does not stop the pixel;
          // no_cond adds every passing pair, its weight 0 once done
          const bool add = pass[i] && (V == kNoCond || !stop);
          const bool live = V == kNoCond ? was && !stop : true;
          const float w = V == kNoCond ? alpha[i] * Tv * (live ? 1.f : 0.f)
                                       : alpha[i] * Tv;
          if (kOneChannel) {
            acc[i][0] = add ? acc[i][0] + w : acc[i][0];
          } else if (!kGlobalAcc) {
#pragma unroll
            for (int c = 0; c < kAcc; ++c) {
              const float term = w * r[kGeo + c];
              acc[i][c] = add ? acc[i][c] + term : acc[i][c];
            }
          } else if (add) {
            for (int c = 0; c < nc; ++c) {
              out_t[c * npix + pix0 + i] += w * r[kGeo + c];
            }
          }
          const bool step = add && live;  // the pixel takes this instance
          if (kUpdateT) T[i] = step ? test_T : T[i];
          if (kTerminate) T[i] = stop ? -T[i] : T[i];
          if (kLast) last[i] = step ? pos : last[i];
        }
        if (kExit) {
          bool alive = false;
#pragma unroll
          for (int i = 0; i < kPix; ++i) alive = alive || T[i] > 0.f;
          if (!__any_sync(kFull, alive)) {
            warp_done = true;
            break;
          }
        }
      }
    }
  }

  if (!inside) return;
  // four consecutive words per row, 16-byte aligned (npix and pix0 are
  // multiples of 4); kCross, word by word, those inside the tile
  auto put = [&](int rowi, float a0, float a1, float a2, float a3) {
    float* o = out_t + rowi * npix + pix0;
    if constexpr (kCross) {
      const float a[kPix] = {a0, a1, a2, a3};
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        if (pix0 + i < npix) o[i] = a[i];
      }
    } else {
      *reinterpret_cast<float4*>(o) = make_float4(a0, a1, a2, a3);
    }
  };
  static_assert(kPix == 4, "the output stores are float4");
  if (kOneChannel) {
    put(0, acc[0][0], acc[1][0], acc[2][0], acc[3][0]);
    for (int c = 1; c < nc; ++c) put(c, 0.f, 0.f, 0.f, 0.f);
  } else if (!kGlobalAcc) {
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      put(c, acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    }
  }
  put(nc, fabsf(T[0]), fabsf(T[1]), fabsf(T[2]), fabsf(T[3]));
  put(nc + 1, static_cast<float>(last[0]), static_cast<float>(last[1]),
      static_cast<float>(last[2]), static_cast<float>(last[3]));
}

// The CTAs an SM holds at once, per form, which sets the register budget
// ptxas gets: 65,536 / (128 N) a thread.  Six leave 80 registers for the
// 4 C accumulators of the compile-time C; the quad forms spilled at 80
// (C = 7) and take five, 96 registers.
template <int F>
constexpr int kFwdMinBlocks = (F & kFormQuad) ? 5 : 6;

template <int CT, int V, int F = 0, bool kCross = false>
__global__ void __launch_bounds__(kFwdCtaThreads, kFwdMinBlocks<F>)
composite_forward_kernel(const float* __restrict__ table, int P, int C,
                         const int* __restrict__ gauss_id,
                         const int* __restrict__ starts,
                         const int* __restrict__ counts, int grid_x,
                         int tile_x, int tile_y, float* __restrict__ out) {
  composite_forward_body<CT, V, F, kCross>(table, P, C, gauss_id, starts,
                                           counts, grid_x, tile_x, tile_y,
                                           out);
}

// Checks what the kernel takes (cudaErrorInvalidValue otherwise): a tile of
// at most kMaxThreads pixels and a batch whose shared memory fits a block.
inline int forward_shape_error(int C, int tile_x, int tile_y, bool quad) {
  const int npix = tile_x * tile_y;
  if (C < 1 || tile_x <= 0 || tile_y <= 0 || npix > kMaxThreads ||
      fwd_smem_bytes(C, quad) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The kernel of (CT, V, F) for rows of tile_x pixels: where tile_x is not a
// multiple of kPix, K1's runtime-C kernel whose threads' pixels cross rows
// (null for a probe's variant, which takes whole kPix groups only).
template <int CT, int V, int F>
auto forward_kernel(int tile_x) -> decltype(&composite_forward_kernel<CT, V, F>) {
  if (tile_x % kPix == 0) return composite_forward_kernel<CT, V, F>;
  if constexpr (V == kFwdBase) {
    return composite_forward_kernel<0, V, F, true>;
  } else {
    return nullptr;
  }
}

template <int CT, int V, int F = 0>
int launch_forward(const float* table, int P, int C, const int* gauss_id,
                   const int* starts, const int* counts, int num_tiles,
                   int grid_x, int tile_x, int tile_y, float* out,
                   cudaStream_t stream) {
  constexpr bool quad = (F & kFormQuad) != 0;
  if (const int e = forward_shape_error(C, tile_x, tile_y, quad)) return e;
  const size_t smem = fwd_smem_bytes(C, quad);
  const auto kernel = forward_kernel<CT, V, F>(tile_x);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<num_tiles * fwd_split(tile_x * tile_y),
           fwd_threads(tile_x * tile_y), smem, stream>>>(
      table, P, C, gauss_id, starts, counts, grid_x, tile_x, tile_y, out);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the kernel an SM holds at once for this shape (0 on an error).
template <int CT, int V, int F = 0>
int forward_occupancy(int C, int tile_x, int tile_y) {
  constexpr bool quad = (F & kFormQuad) != 0;
  if (forward_shape_error(C, tile_x, tile_y, quad)) return 0;
  const size_t smem = fwd_smem_bytes(C, quad);
  const auto kernel = forward_kernel<CT, V, F>(tile_x);
  if (kernel == nullptr) return 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return 0;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, fwd_threads(tile_x * tile_y), smem) != cudaSuccess) {
    return 0;
  }
  return n;
}

}  // namespace
