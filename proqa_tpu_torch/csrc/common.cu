// Shared C entry points of the kernel library: turning a CUDA error code into
// its message, so the Python wrappers can raise with it.
#include <cuda_runtime.h>

extern "C" const char* proqa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
