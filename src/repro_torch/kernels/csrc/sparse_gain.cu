// sparse_gain: gains[c] = #{m : ids[c, m] >= 0 and bit(mask, ids[c, m]) == 0}
// as int32 [C], over -1-padded doc-id lists int32 [C, M].
//
// Replaces the Pallas kernel repro/kernels/sparse_gain.py::sparse_gain (body
// `_kernel`), the g(j|X) oracle of the production sparse greedy round
// (core/sparse_step.py), where a dense clause x doc matrix would not fit.
//
// Bound on an H100: bytes of the id lists, 4*(C*M + W + C) over 3.35 TB/s;
// each id costs one gather of a mask word, a shift and a compare. The TPU
// kernel kept the whole covered bitset in VMEM. Here it takes one of two
// routes, chosen by the caller from the mask's size alone:
//   smem: the mask fits in shared memory (W*4 bytes up to the 227 KB
//         opt-in). A persistent grid of at most (SMs x resident blocks)
//         blocks stages it once per block, and each warp then walks rows
//         with gathers from shared memory.
//   l2:   a larger mask (2^28 docs is 32 MiB) is gathered with __ldg from
//         global memory and stays in the 50 MB L2 while the ids stream past
//         it with the evict-first hint. Lanes of a warp then touch different
//         32-byte sectors, so L2 sector traffic can exceed the HBM bytes of
//         the ids several times over.
// Both: one warp per row; lanes read consecutive ids (int4 when the row is
// 16-byte aligned); a -1 may sit anywhere in a row, so there is no early
// exit; a shuffle sum finishes the row and lane 0 writes it.
#include <algorithm>

#include "common.cuh"

namespace repro_torch {

constexpr int kSmemWarps = 32;
constexpr int kSmemThreads = kWarp * kSmemWarps;

__device__ __forceinline__ int fresh(const uint32_t* m, int id) {
  return id >= 0 && !((m[id >> 5] >> (id & 31)) & 1u);
}

__device__ __forceinline__ int fresh_ldg(const uint32_t* m, int id) {
  return id >= 0 && !((__ldg(m + (id >> 5)) >> (id & 31)) & 1u);
}

template <bool kShared>
__device__ __forceinline__ int row_count(const int32_t* __restrict__ r,
                                         const uint32_t* m, int64_t M,
                                         int lane, int vec) {
  int cnt = 0;
  if (vec) {
    const int4* r4 = reinterpret_cast<const int4*>(r);
    for (int64_t i = lane; i < M / 4; i += kWarp) {
      const int4 v = __ldcs(r4 + i);
      if (kShared)
        cnt += fresh(m, v.x) + fresh(m, v.y) + fresh(m, v.z) + fresh(m, v.w);
      else
        cnt += fresh_ldg(m, v.x) + fresh_ldg(m, v.y) + fresh_ldg(m, v.z) +
               fresh_ldg(m, v.w);
    }
  } else {
    for (int64_t i = lane; i < M; i += kWarp) {
      const int id = __ldcs(r + i);
      cnt += kShared ? fresh(m, id) : fresh_ldg(m, id);
    }
  }
  return warp_sum(cnt);
}

__global__ void __launch_bounds__(kSmemThreads)
sparse_gain_smem_kernel(const int32_t* __restrict__ ids,
                        const uint32_t* __restrict__ mask,
                        int32_t* __restrict__ out, int64_t C, int64_t M,
                        int64_t W, int vec) {
  extern __shared__ uint32_t s_mask[];
  for (int64_t i = threadIdx.x; i < W; i += blockDim.x) s_mask[i] = __ldg(mask + i);
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = (int64_t)gridDim.x * kSmemWarps;
  for (int64_t row = (int64_t)blockIdx.x * kSmemWarps + threadIdx.x / kWarp;
       row < C; row += warps) {
    const int cnt = row_count<true>(ids + row * M, s_mask, M, lane, vec);
    if (lane == 0) out[row] = cnt;
  }
}

__global__ void __launch_bounds__(kThreads)
sparse_gain_l2_kernel(const int32_t* __restrict__ ids,
                      const uint32_t* __restrict__ mask,
                      int32_t* __restrict__ out, int64_t C, int64_t M,
                      int vec) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= C) return;  // whole warp leaves together
  const int cnt = row_count<false>(ids + row * M, mask, M, lane, vec);
  if (lane == 0) out[row] = cnt;
}

}  // namespace repro_torch

extern "C" int sparse_gain_launch(const void* ids, const void* mask, void* out,
                                  int64_t C, int64_t M, int64_t W, int vec,
                                  int smem, void* stream) {
  using namespace repro_torch;
  if (!smem) {
    const dim3 grid((unsigned)ceil_div(C, kWarpsPerBlock));
    sparse_gain_l2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const uint32_t*)mask, (int32_t*)out, C, M, vec);
    return (int)cudaGetLastError();
  }
  const size_t bytes = (size_t)W * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_gain_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sparse_gain_smem_kernel, kSmemThreads, bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t blocks = std::min<int64_t>(ceil_div(C, kSmemWarps),
                                           (int64_t)sms * per_sm);
  sparse_gain_smem_kernel<<<(unsigned)blocks, kSmemThreads, bytes,
                            (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const uint32_t*)mask, (int32_t*)out, C, M, W, vec);
  return (int)cudaGetLastError();
}
