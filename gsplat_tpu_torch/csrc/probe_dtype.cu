// P4 — the elementwise rate of float32 against packed bfloat16.
//
// Replaces the Pallas kernel of tools/bench_vpu_dtype.py::kernel (:23,
// launched at :67), which asked whether 16-bit math runs an alpha-shaped op
// mix at twice the 32-bit rate.
//
// What it computes.  For every element x of a [256, 1024] block, in each of
// n_programs programs (the TPU grid of 64, all on the same block), n_iters
// rounds of the tool's mix (bench_vpu_dtype.py:31-38), each operation
// rounded to the working type:
//     p = x x 0.5 + x 0.25;  g = exp(-p);  a = g x + p 0.5;
//     acc = acc + a;  x = x 0.9999
// and out = acc (every program writes the same values).  The f32 form runs
// one float a thread and takes the exponential as K1 and K2 do,
// exp2f(-p log2 e); the bf16 form one __nv_bfloat162 a thread, each
// operation on the packed pair (__hmul2, __hadd2, __hneg2, h2exp, which is
// also an exp2 of the scaled argument), so the two forms differ in the
// packing alone, which is what the question is about: CUDA C++ makes it
// explicit.  In bf16, 0.9999 rounds to 1 (as in the JAX tool).
//
// Bound on the H100: operations, 11 per element and round, over the
// published fp32 and bf16 rates outside the tensor cores; chip_smoke.py
// states which.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

enum Variant { kF32 = 0, kBf16, kNumVariants };

__global__ void __launch_bounds__(kThreads)
probe_dtype_f32(const float* __restrict__ x, int n, int n_iters,
                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  float acc = 0.f;
  for (int it = 0; it < n_iters; ++it) {
    const float p = v * v * 0.5f + v * 0.25f;
    const float g = exp2f(-p * kLog2e);
    const float a = g * v + p * 0.5f;
    acc = acc + a;
    v = v * 0.9999f;
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
probe_dtype_bf16(const __nv_bfloat162* __restrict__ x, int n2, int n_iters,
                 __nv_bfloat162* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 quarter = __float2bfloat162_rn(0.25f);
  const __nv_bfloat162 decay = __float2bfloat162_rn(0.9999f);
  __nv_bfloat162 v = x[i];
  __nv_bfloat162 acc = __float2bfloat162_rn(0.f);
  for (int it = 0; it < n_iters; ++it) {
    const __nv_bfloat162 p =
        __hadd2(__hmul2(__hmul2(v, v), half), __hmul2(v, quarter));
    const __nv_bfloat162 g = h2exp(__hneg2(p));
    const __nv_bfloat162 a = __hadd2(__hmul2(g, v), __hmul2(p, half));
    acc = __hadd2(acc, a);
    v = __hmul2(v, decay);
  }
  out[i] = acc;
}

}  // namespace

// x and out hold n elements of the variant's type (n even for bf16); the
// grid runs n_programs copies of the block.
extern "C" int gsplat_probe_dtype(int variant, const void* x, int n,
                                  int n_programs, int n_iters, void* out,
                                  void* stream) {
  if (variant < 0 || variant >= kNumVariants || n_programs <= 0 ||
      n_programs > 65535 || (variant == kBf16 && n % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = variant == kBf16 ? n / 2 : n;
  const dim3 grid((m + kThreads - 1) / kThreads, n_programs);
  if (variant == kF32) {
    probe_dtype_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), n, n_iters, static_cast<float*>(out));
  } else {
    probe_dtype_bf16<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat162*>(x), m, n_iters,
        static_cast<__nv_bfloat162*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
