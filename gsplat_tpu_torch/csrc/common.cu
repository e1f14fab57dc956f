// Shared C entry of the kernel library: CUDA error codes to text, for the
// Python wrappers' exceptions (gsplat_tpu_torch/_kernels.py::check).
#include <cuda_runtime.h>

extern "C" const char* gsplat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
