// partition_gain: gains[c, k] = popcount(A[c, lo_k:hi_k] & ~mask[lo_k:hi_k])
// as int32 [C, P], for P word-aligned partitions given by P+1 word offsets.
//
// Replaces the Pallas kernel repro/kernels/partition_gain.py::partition_gain
// (body `_kernel`, reduction `segment_selector`), the per-shard g_k(j|X)
// oracle behind PartitionedBudget.gains.
//
// Bound on an H100: bytes. Each word of A is read once and costs one
// AND-NOT and one POPC; the C*P int32 outputs are small beside the C*W words
// read while P << W. The time is 4*(C*W + W + C*P) bytes over 3.35 TB/s.
//
// Design: coverage_gain's, one warp per row, with a loop over the
// partitions inside the warp. The TPU kernel reduced words to partitions
// with an f32 one-hot matmul on the MXU, which is exact only below 2^24
// docs; here every count is an integer shuffle sum, exact at any size.
// Partition offsets arrive as a device array (they change with every
// split) and need not be multiples of 4 words, so when the row and the mask
// are 16-byte aligned each partition is a scalar head up to the next
// 4-word boundary, a uint4 body, and a scalar tail; otherwise lanes load
// consecutive words. Lane 0 writes the P counts of its row.
// A block holds `warps` rows, set at launch as in coverage_gain.
#include "common.cuh"

namespace repro_torch {

__device__ __forceinline__ int and_not_pop(uint4 x, uint4 m) {
  return __popc(x.x & ~m.x) + __popc(x.y & ~m.y) + __popc(x.z & ~m.z) +
         __popc(x.w & ~m.w);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
partition_gain_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ mask,
                      const long long* __restrict__ bounds,
                      int32_t* __restrict__ out, int64_t C, int64_t W,
                      int64_t P, int vec) {
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= C) return;  // whole warp leaves together
  const uint32_t* r = a + row * W;
  for (int64_t k = 0; k < P; ++k) {
    const int64_t lo = __ldg(bounds + k), hi = __ldg(bounds + k + 1);
    int cnt = 0;
    int64_t b0 = lo, b1 = lo;  // the uint4 body [b0, b1), empty if not vec
    if (vec) {
      b0 = (lo + 3) & ~int64_t(3);
      b1 = hi & ~int64_t(3);
      if (b1 < b0) b1 = b0 = lo;
    }
    if (b1 > b0) {
      const uint4* r4 = reinterpret_cast<const uint4*>(r + b0);
      const uint4* m4 = reinterpret_cast<const uint4*>(mask + b0);
      const int64_t n4 = (b1 - b0) / 4;
      for (int64_t i = lane; i < n4; i += kWarp)
        cnt += and_not_pop(__ldcs(r4 + i), __ldg(m4 + i));
      // head [lo, b0) and tail [b1, hi): fewer than 4 words each
      if (lane < b0 - lo) cnt += __popc(__ldcs(r + lo + lane) & ~__ldg(mask + lo + lane));
      if (lane < hi - b1) cnt += __popc(__ldcs(r + b1 + lane) & ~__ldg(mask + b1 + lane));
    } else {
      for (int64_t i = lo + lane; i < hi; i += kWarp)
        cnt += __popc(__ldcs(r + i) & ~__ldg(mask + i));
    }
    cnt = warp_sum(cnt);
    if (lane == 0) out[row * P + k] = cnt;
  }
}

}  // namespace repro_torch

// warps: warps per block (one row each), 1-32.
extern "C" int partition_gain_launch(const void* a, const void* mask,
                                     const void* bounds, void* out, int64_t C,
                                     int64_t W, int64_t P, int vec, int warps,
                                     void* stream) {
  using namespace repro_torch;
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div(C, warps));
  partition_gain_kernel<<<grid, warps * kWarp, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)mask, (const long long*)bounds,
      (int32_t*)out, C, W, P, vec);
  return (int)cudaGetLastError();
}
