// K1 — forward alpha composite, one CTA per tile.
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
// default 32x32, 256 at 16x16).  The CTA stages batches of kBatch instances
// in shared memory: threads read the batch's gaussian ids, then the
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
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;  // TILE_X * TILE_Y must not exceed this
constexpr int kBatch = 256;        // instances staged per round
constexpr int kGeo = 6;            // mean x, mean y, conic a, b, c, opacity
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
constexpr float kLog2e = 1.4426950408889634f;

// CT > 0: compile-time channel count, accumulators in registers.
// CT == 0: runtime channel count C, accumulated in global memory.
template <int CT>
__global__ void __launch_bounds__(kMaxThreads)
composite_forward_kernel(const float* __restrict__ table, int P, int C,
                         const int* __restrict__ gauss_id,
                         const int* __restrict__ starts,
                         const int* __restrict__ counts, int grid_x,
                         int tile_x, int tile_y, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nc = CT > 0 ? CT : C;
  const int row = kGeo + nc;
  float* s_rows = smem;                                        // [kBatch][row]
  int* s_gid = reinterpret_cast<int*>(smem + kBatch * row);   // [kBatch]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int npix = tile_x * tile_y;
  const float px = static_cast<float>((t % grid_x) * tile_x + tid % tile_x);
  const float py = static_cast<float>((t / grid_x) * tile_y + tid / tile_x);
  const int start = starts[t];
  const int count = counts[t];
  float* out_t = out + static_cast<size_t>(t) * (nc + 2) * npix;

  constexpr int kAcc = CT > 0 ? CT : 1;
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.f;
  if (CT == 0) {
    for (int c = 0; c < nc; ++c) out_t[c * npix + tid] = 0.f;
  }

  float T = 1.f;
  int last = 0;
  int done = 0;

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // Also the barrier that keeps the previous batch's shared rows alive
    // until every thread has finished reading them.
    if (__syncthreads_count(done) == npix) break;
    const int nb = min(kBatch, count - b0);
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
    if (done) continue;
    for (int k = 0; k < nb; ++k) {
      const int g = s_gid[k];
      if (g < 0 || g >= P) continue;  // pad sentinel
      const float* r = s_rows + k * row;
      const float dx = r[0] - px;
      const float dy = r[1] - py;
      const float power =
          -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
      const float alpha = fminf(kAlphaMax, r[5] * exp2f(power * kLog2e));
      if (!(power <= 0.f) || !(alpha >= kAlphaMin)) continue;
      const float test_T = T * (1.f - alpha);
      if (test_T < kTEps) {
        done = 1;
        break;
      }
      const float w = alpha * T;
      if (CT > 0) {
#pragma unroll
        for (int c = 0; c < kAcc; ++c) acc[c] += w * r[kGeo + c];
      } else {
        for (int c = 0; c < nc; ++c) out_t[c * npix + tid] += w * r[kGeo + c];
      }
      T = test_T;
      last = b0 + k + 1;
    }
  }

  if (CT > 0) {
#pragma unroll
    for (int c = 0; c < kAcc; ++c) out_t[c * npix + tid] = acc[c];
  }
  out_t[nc * npix + tid] = T;
  out_t[(nc + 1) * npix + tid] = static_cast<float>(last);
}

template <int CT>
int launch(const float* table, int P, int C, const int* gauss_id,
           const int* starts, const int* counts, int num_tiles, int grid_x,
           int tile_x, int tile_y, float* out, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kBatch) * (kGeo + C) * sizeof(float) +
      kBatch * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_forward_kernel<CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite_forward_kernel<CT><<<num_tiles, tile_x * tile_y, smem, stream>>>(
      table, P, C, gauss_id, starts, counts, grid_x, tile_x, tile_y, out);
  return static_cast<int>(cudaGetLastError());
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
  switch (C) {
    case 1: return launch<1>(tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
    case 2: return launch<2>(tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
    case 3: return launch<3>(tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
    case 4: return launch<4>(tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
    case 5: return launch<5>(tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
    case 6: return launch<6>(tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
    case 7: return launch<7>(tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
    case 8: return launch<8>(tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
    default: return launch<0>(tb, P, C, gid, st, ct, num_tiles, grid_x, tile_x, tile_y, o, s);
  }
}
