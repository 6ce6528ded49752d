// Shared definitions for the port's CUDA kernels (sm_90a).
//
// Every kernel takes packed bitset words as uint32_t; PyTorch holds them as
// int32 tensors with the same bit pattern. Each C entry point launches on
// the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr int kWord = 32;  // bits per packed word
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
// the gain kernels take their warps per block at launch (1-32, the
// autotuner's `warps`: a warp a row on the warp route, the warps of each
// CTA on the split route); kWarpsPerBlock is their default
constexpr int kMaxWarps = 32;
constexpr int kMaxThreads = kWarp * kMaxWarps;
constexpr unsigned kFull = 0xffffffffu;

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// -- the split route of the one-row gain kernels (coverage_gain.cu,
// bit_matvec.cu, partition_gain.cu): a row to a cluster of CTAs, each a
// slice of its words
constexpr int kSplitChunk = 4096;   // words a CTA stages in shared memory at a time
constexpr int kMaxSplitCtas = 16;   // CTAs a cluster (above 8: non-portable)

// words of each CTA's slice of a W-word row over `ctas` CTAs: a multiple
// of 4, so that the slices of a 16-byte aligned row start aligned
__host__ __device__ inline int64_t split_slice(int64_t W, int ctas) {
  return (W + 4 * ctas - 1) / (4 * ctas) * 4;
}

// the 16-byte aligned part [off, off + n) of the n words at p (n a
// multiple of 4): what one bulk copy brings; the words outside it are
// read by plain loads
struct Window {
  int off, n;
  __device__ bool holds(int i) const { return i >= off && i < off + n; }
};

__device__ inline Window aligned_window(const void* p, int n) {
  const int off = (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  return Window{off, off < n ? (n - off) / 4 * 4 : 0};
}

// launch `kernel` on `tasks` clusters of `ctas` CTAs of `warps` warps each,
// with `smem` bytes of dynamic shared memory a CTA (cudaLaunchKernelEx with a
// cluster dimension); the launch's own error, or cudaGetLastError()
template <typename... Params, typename... Args>
inline int split_launch_smem(void (*kernel)(Params...), int64_t tasks, int ctas, int warps,
                             size_t smem, void* stream, Args... args) {
  if (warps < 1 || warps > kMaxWarps || ctas < 1 || ctas > kMaxSplitCtas ||
      tasks * ctas > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (ctas > 8) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  // without this opt-in, static and dynamic shared memory together may not
  // pass 48 KiB, and a split kernel's static staging buffers already take 32
  if (smem > 0) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tasks * ctas));
  cfg.blockDim = dim3(warps * kWarp);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// split_launch_smem with no dynamic shared memory
template <typename... Params, typename... Args>
inline int split_launch(void (*kernel)(Params...), int64_t tasks, int ctas, int warps,
                        void* stream, Args... args) {
  return split_launch_smem(kernel, tasks, ctas, warps, 0, stream, args...);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

}  // namespace repro_torch
