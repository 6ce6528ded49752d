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
// the warp-per-row kernels take their warps per block at launch (1-32,
// the autotuner's `warps`); kWarpsPerBlock is their default
constexpr int kMaxWarps = 32;
constexpr int kMaxThreads = kWarp * kMaxWarps;
constexpr unsigned kFull = 0xffffffffu;

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

}  // namespace repro_torch
