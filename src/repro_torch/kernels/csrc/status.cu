// Error text for the status codes the kernel entry points return.
#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
