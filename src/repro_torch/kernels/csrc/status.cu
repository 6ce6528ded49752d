// Error text for the status codes the kernel entry points return, and an
// empty kernel: the launch floor that a one-row call of a gain kernel is
// measured against (`_build.launch_floor`; on no path of the program).
#include <cuda_runtime.h>

namespace repro_torch {

__global__ void empty_kernel() {}

}  // namespace repro_torch

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int empty_launch(void* stream) {
  repro_torch::empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
