// K7 and K8 — windowed SSIM forward and backward (train/losses.py::ssim).
//
// Replaces no Pallas kernel: the JAX package's ssim
// (gsplat_tpu/train/losses.py:33) is plain XLA, which fuses its
// shift-multiply-add chain.  In PyTorch the same chain ran as about 95
// aten calls forward and 118 in autograd's backward, most of them writing
// and re-reading a [5C, H, W] float32 temporary (PERF.md).  K7 is
// losses.py::ssim_plain in one launch (and a one-CTA launch that sums the
// tiles' partial sums), K8 the analytic gradient with respect to img1 that
// ssim_backward_plain spells out in torch, in another.
//
// What they compute.  The window is outer(g, g) of the 11 float32 taps the
// host makes (losses.py::_gaussian_1d), applied as a vertical then a
// horizontal 11-tap pass with zero padding (F.conv2d(padding=5)), each sum
// taken in tap order from the first tap's product, every product and sum
// rounded once (the library is built with --fmad=false): the five
// convolved planes mu1, mu2, E[x^2], E[y^2], E[xy] equal the plain
// version's.  K7 forms ssim_map per pixel in the plain version's order and
// sums it: a fixed warp-shuffle tree and warp order in each CTA, then one
// CTA sums the partials in double in a fixed order and writes the mean, so
// two launches give the same bits.  K8 takes, with S the SSIM of a pixel,
// N1 = 2 mu1 mu2 + C1, N2 = 2 sigma12 + C2, D1 = mu1^2 + mu2^2 + C1,
// D2 = sigma1^2 + sigma2^2 + C2, the partials
//   A   = dS/dmu1   = 2 mu2 (N2 - N1) / (D1 D2) - 2 mu1 S (1/D1 - 1/D2)
//   B   = dS/dE[x^2] = -S / D2
//   Cxy = dS/dE[xy]  = 2 N1 / (D1 D2),
// zero outside the image, and writes
//   dL/dx = g / (C H W) * (w*A + 2 x (w*B) + y (w*Cxy))
// with the same separable window; g is the upstream gradient, read from
// device memory.  Each CTA owns its output tile: no atomics.
//
// Bound on the H100: operations, just above bytes (ssim_bound in
// tools/workload.py: 231 operations a pixel and channel forward and 377
// backward, against 8 and 12 bytes).  Design: one CTA of 256 threads a
// channel and 32x32 output tile.  K7 stages x and y over the tile and a 5-pixel halo in
// shared memory, forms x^2, y^2 and xy as it runs the vertical pass of the
// five planes into shared memory, and runs the horizontal pass from there;
// neighbouring threads take neighbouring columns, so no access conflicts.
// K8 stages the inputs with a 10-pixel halo, recomputes the five planes and
// A, B and Cxy over the tile and a 5-pixel halo (nothing of the forward is
// saved), runs the two passes over those three, and writes the gradient
// tile once: it reads the two images and writes one, and keeps every
// intermediate in its 86,480 bytes of shared memory (two CTAs an SM).
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 11;               // taps a pass
constexpr int kR = kWin / 2;           // halo of one window
constexpr int kTX = 32, kTY = 32;      // output tile
constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

struct Taps {
  float w[kWin];
};

// K7: inputs over the tile and one halo; the vertical pass over its rows
constexpr int kFW = kTX + 2 * kR;      // 42 staged columns
constexpr int kFH = kTY + 2 * kR;      // 42 staged rows
// K8: inputs over the tile and two halos; the planes and A, B, Cxy over one
constexpr int kBW = kTX + 4 * kR;      // 52
constexpr int kBH = kTY + 4 * kR;      // 52
constexpr int kAW = kTX + 2 * kR;      // 42
constexpr int kAH = kTY + 2 * kR;      // 42
constexpr int kBwdStage = kBH * kBW;                 // one staged image
constexpr int kBwdPlanes = 5 * kAH * kBW;            // the first vertical pass
constexpr int kBwdAdjoint = 3 * kAH * kAW;           // A, B, Cxy
static_assert(3 * kTY * kAW <= kBwdPlanes, "second pass reuses the first's");
constexpr size_t kBwdSmem =
    sizeof(float) * (2 * kBwdStage + kBwdPlanes + kBwdAdjoint);

// x and y of a channel over a (rows x cols) window whose corner is image
// pixel (y0, x0), zero outside the image: the convolutions' zero padding
template <int rows, int cols>
__device__ __forceinline__ void stage(const float* __restrict__ x,
                                      const float* __restrict__ y, int H,
                                      int W, int y0, int x0, float* sx,
                                      float* sy) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, q = i % cols;
    const int gy = y0 + r, gx = x0 + q;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t at = static_cast<size_t>(gy) * W + gx;
    sx[i] = in ? x[at] : 0.f;
    sy[i] = in ? y[at] : 0.f;
  }
}

// The vertical pass of the five planes at staged column q, output row r
// (staged rows r .. r + 10), into out[p * plane + r * cols + q]
template <int cols>
__device__ __forceinline__ void vertical5(const float* sx, const float* sy,
                                          const Taps& t, int r, int q,
                                          float* out, int plane) {
  float m[5];
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
    const float vx = sx[(r + k) * cols + q], vy = sy[(r + k) * cols + q];
    const float v[5] = {vx, vy, vx * vx, vy * vy, vx * vy};
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const float term = t.w[k] * v[p];
      m[p] = k == 0 ? term : m[p] + term;
    }
  }
  const int at = r * cols + q;
#pragma unroll
  for (int p = 0; p < 5; ++p) out[p * plane + at] = m[p];
}

// The horizontal pass of n planes at output (r, q): columns q .. q + 10 of
// row r of each plane
template <int n, int cols>
__device__ __forceinline__ void horizontal(const float* in, int plane,
                                           const Taps& t, int r, int q,
                                           float* m) {
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
#pragma unroll
    for (int p = 0; p < n; ++p) {
      const float term = t.w[k] * in[p * plane + r * cols + q + k];
      m[p] = k == 0 ? term : m[p] + term;
    }
  }
}

// The vertical pass of n planes at output (r, q): rows r .. r + 10
template <int n, int cols>
__device__ __forceinline__ void vertical(const float* in, int in_plane,
                                         const Taps& t, int r, int q,
                                         float* m) {
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
#pragma unroll
    for (int p = 0; p < n; ++p) {
      const float term = t.w[k] * in[p * in_plane + (r + k) * cols + q];
      m[p] = k == 0 ? term : m[p] + term;
    }
  }
}

// SSIM of one pixel from its five planes, in ssim_plain's order
struct Pixel {
  float n1, n2, d1, d2, d, s;
};

__device__ __forceinline__ Pixel ssim_pixel(const float* m, float c1,
                                            float c2) {
  const float mu1 = m[0], mu2 = m[1];
  const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
  const float sigma1_sq = m[2] - mu1_sq, sigma2_sq = m[3] - mu2_sq;
  const float sigma12 = m[4] - mu1_mu2;
  Pixel p;
  p.n1 = 2.f * mu1_mu2 + c1;
  p.n2 = 2.f * sigma12 + c2;
  p.d1 = mu1_sq + mu2_sq + c1;
  p.d2 = sigma1_sq + sigma2_sq + c2;
  p.d = p.d1 * p.d2;
  p.s = (p.n1 * p.n2) / p.d;
  return p;
}

// A warp's sum by a fixed butterfly; lane 0's is the one used
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    ssim_forward_kernel(const float* __restrict__ x,
                        const float* __restrict__ y, int H, int W,
                        int tiles_x, Taps taps, float c1, float c2,
                        float* __restrict__ partial) {
  __shared__ float sx[kFH * kFW], sy[kFH * kFW];
  __shared__ float sv[5 * kTY * kFW];
  __shared__ float warps[kThreads / 32];
  const int c = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * kTY;
  const int tx0 = (blockIdx.x % tiles_x) * kTX;
  const size_t plane = static_cast<size_t>(H) * W;
  stage<kFH, kFW>(x + c * plane, y + c * plane, H, W, ty0 - kR, tx0 - kR,
                  sx, sy);
  __syncthreads();
  for (int i = threadIdx.x; i < kTY * kFW; i += kThreads) {
    vertical5<kFW>(sx, sy, taps, i / kFW, i % kFW, sv, kTY * kFW);
  }
  __syncthreads();
  float sum = 0.f;
  for (int i = threadIdx.x; i < kTY * kTX; i += kThreads) {
    const int r = i / kTX, q = i % kTX;
    if (ty0 + r < H && tx0 + q < W) {
      float m[5];
      horizontal<5, kFW>(sv, kTY * kFW, taps, r, q, m);
      sum += ssim_pixel(m, c1, c2).s;
    }
  }
  sum = warp_sum(sum);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = warps[0];
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) total += warps[i];
    partial[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

// One CTA: the partials summed in double in a fixed order, over n_pix
__global__ void __launch_bounds__(kReduceThreads)
    ssim_mean_kernel(const float* __restrict__ partial, int n,
                     long long n_pix, float* __restrict__ out) {
  __shared__ double acc[kReduceThreads];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) s += partial[i];
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) acc[threadIdx.x] += acc[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(acc[0] / static_cast<double>(n_pix));
  }
}

__global__ void __launch_bounds__(kThreads)
    ssim_backward_kernel(const float* __restrict__ x,
                         const float* __restrict__ y, int H, int W,
                         int tiles_x, Taps taps, float c1, float c2,
                         const float* __restrict__ g, long long n_pix,
                         float* __restrict__ dx) {
  extern __shared__ float smem[];
  float* sx = smem;                     // [kBH][kBW], corner (ty0-10, tx0-10)
  float* sy = sx + kBwdStage;
  float* sv = sy + kBwdStage;           // [5][kAH][kBW], then [3][kTY][kAW]
  float* sa = sv + kBwdPlanes;          // [3][kAH][kAW], corner (ty0-5, tx0-5)
  const int c = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * kTY;
  const int tx0 = (blockIdx.x % tiles_x) * kTX;
  const size_t plane = static_cast<size_t>(H) * W;
  stage<kBH, kBW>(x + c * plane, y + c * plane, H, W, ty0 - 2 * kR,
                  tx0 - 2 * kR, sx, sy);
  __syncthreads();
  // the five planes' vertical pass: image rows ty0-5 .. ty0+36
  for (int i = threadIdx.x; i < kAH * kBW; i += kThreads) {
    vertical5<kBW>(sx, sy, taps, i / kBW, i % kBW, sv, kAH * kBW);
  }
  __syncthreads();
  // their horizontal pass, S and its partials over the tile and one halo
  for (int i = threadIdx.x; i < kAH * kAW; i += kThreads) {
    const int r = i / kAW, q = i % kAW;
    const int gy = ty0 - kR + r, gx = tx0 - kR + q;
    float a = 0.f, b = 0.f, cxy = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      float m[5];
      horizontal<5, kBW>(sv, kAH * kBW, taps, r, q, m);
      const Pixel p = ssim_pixel(m, c1, c2);
      a = (2.f * m[1]) * (p.n2 - p.n1) / p.d -
          (2.f * m[0]) * p.s * (1.f / p.d1 - 1.f / p.d2);
      b = -p.s / p.d2;
      cxy = (2.f * p.n1) / p.d;
    }
    sa[i] = a;
    sa[kAH * kAW + i] = b;
    sa[2 * kAH * kAW + i] = cxy;
  }
  __syncthreads();
  // A, B, Cxy through the vertical pass: image rows ty0 .. ty0+31
  for (int i = threadIdx.x; i < kTY * kAW; i += kThreads) {
    const int r = i / kAW, q = i % kAW;
    float m[3];
    vertical<3, kAW>(sa, kAH * kAW, taps, r, q, m);
#pragma unroll
    for (int p = 0; p < 3; ++p) sv[p * kTY * kAW + i] = m[p];
  }
  __syncthreads();
  const float scale = g[0] * (1.f / static_cast<float>(n_pix));
  float* dxc = dx + c * plane;
  for (int i = threadIdx.x; i < kTY * kTX; i += kThreads) {
    const int r = i / kTX, q = i % kTX;
    const int gy = ty0 + r, gx = tx0 + q;
    if (gy < H && gx < W) {
      float m[3];
      horizontal<3, kAW>(sv, kTY * kAW, taps, r, q, m);
      const int at = (r + 2 * kR) * kBW + q + 2 * kR;
      const float xv = sx[at], yv = sy[at];
      dxc[static_cast<size_t>(gy) * W + gx] =
          scale * (m[0] + (2.f * xv) * m[1] + yv * m[2]);
    }
  }
}

bool bad_shape(int C, int H, int W) {
  return C <= 0 || H <= 0 || W <= 0 || C > 65535;
}

int tiles_x_of(int W) { return (W + kTX - 1) / kTX; }
int tiles_of(int H, int W) { return tiles_x_of(W) * ((H + kTY - 1) / kTY); }

Taps taps_of(const float* w) {
  Taps t;
  for (int k = 0; k < kWin; ++k) t.w[k] = w[k];
  return t;
}

}  // namespace

// The float32 words of gsplat_ssim_forward's partial sums
extern "C" int gsplat_ssim_partials(int C, int H, int W) {
  return bad_shape(C, H, W) ? 0 : C * tiles_of(H, W);
}

// x, y [C, H, W] float32 contiguous; taps: 11 floats on the host;
// partial [gsplat_ssim_partials] float32 scratch; out: one float32
extern "C" int gsplat_ssim_forward(const void* x, const void* y, int C, int H,
                                   int W, const float* taps, float c1,
                                   float c2, void* partial, void* out,
                                   void* stream) {
  if (bad_shape(C, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(H, W);
  ssim_forward_kernel<<<dim3(tiles, C), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), H, W,
      tiles_x_of(W), taps_of(taps), c1, c2, static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_mean_kernel<<<1, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), C * tiles,
      static_cast<long long>(C) * H * W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x, y as gsplat_ssim_forward's; g: the 0-d upstream gradient (device);
// dx [C, H, W] float32
extern "C" int gsplat_ssim_backward(const void* x, const void* y, int C,
                                    int H, int W, const float* taps,
                                    float c1, float c2, const void* g,
                                    void* dx, void* stream) {
  if (bad_shape(C, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssim_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_backward_kernel<<<dim3(tiles_of(H, W), C), kThreads, kBwdSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), H, W,
      tiles_x_of(W), taps_of(taps), c1, c2, static_cast<const float*>(g),
      static_cast<long long>(C) * H * W, static_cast<float*>(dx));
  return static_cast<int>(cudaGetLastError());
}
