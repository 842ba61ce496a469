// Error text for the codes the launch functions of this library return.

#include <cuda_runtime.h>

extern "C" const char* npt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
