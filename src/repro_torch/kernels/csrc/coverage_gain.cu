// coverage_gain: gains[c] = popcount(A[c] & ~mask) as int32.
//
// Replaces the Pallas kernel repro/kernels/coverage_gain.py::coverage_gain
// (body `_kernel`), the g(j|X) oracle behind SCSKProblem.g_gains.
//
// Bound on an H100: bytes. Each word of A is read once and costs one
// AND-NOT and one POPC, far below the card's integer rate, so the time is
// C*W*4 bytes over 3.35 TB/s (the mask and the output are noise).
//
// Design: one warp per row. When the row and the mask are 16-byte aligned
// each lane loads a uint4 (4 words), so a warp moves 512 contiguous bytes
// per iteration; otherwise lanes load consecutive words. The mask is at
// most 128 KiB at the production shapes and is re-read by every row, so it
// stays in L2 while A streams past it (loads of A use the streaming cache
// hint). Lanes keep a private count and a shuffle reduction finishes the
// row; lane 0 writes it. The TPU kernel's grid-carried accumulator over the
// W axis becomes the lane loop.
//
// A block holds `warps` rows, set at launch (1-32; 8 unless the autotuner's
// cache, kernels/autotune.py, picks another for the call's shape bucket):
// the counterpart of the Pallas kernel's block_c. The rows are independent,
// so the choice moves the time, never the result.
#include "common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kMaxThreads, 1)
coverage_gain_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ mask,
                     int32_t* __restrict__ out, int64_t C, int64_t W,
                     int vec) {
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= C) return;  // whole warp leaves together
  const uint32_t* r = a + row * W;
  int cnt = 0;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(r);
    const uint4* m4 = reinterpret_cast<const uint4*>(mask);
    const int64_t n4 = W / 4;
    for (int64_t i = lane; i < n4; i += kWarp) {
      const uint4 x = __ldcs(r4 + i);
      const uint4 m = __ldg(m4 + i);
      cnt += __popc(x.x & ~m.x) + __popc(x.y & ~m.y) +
             __popc(x.z & ~m.z) + __popc(x.w & ~m.w);
    }
  } else {
    for (int64_t i = lane; i < W; i += kWarp) cnt += __popc(__ldcs(r + i) & ~__ldg(mask + i));
  }
  cnt = warp_sum(cnt);
  if (lane == 0) out[row] = cnt;
}

}  // namespace repro_torch

// warps: warps per block (one row each), 1-32.
extern "C" int coverage_gain_launch(const void* a, const void* mask, void* out,
                                    int64_t C, int64_t W, int vec, int warps,
                                    void* stream) {
  using namespace repro_torch;
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div(C, warps));
  coverage_gain_kernel<<<grid, warps * kWarp, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)mask, (int32_t*)out, C, W, vec);
  return (int)cudaGetLastError();
}
