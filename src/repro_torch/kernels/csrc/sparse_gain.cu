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
//   l2:   a larger mask (2^28 docs is 32 MiB) is gathered from global
//         memory with an L2 evict_last policy, while the ids stream past it
//         evict-first (__ldcs), so the mask keeps its place in the 50 MB L2.
//         Each lane keeps its next 16 ids in flight while it gathers for
//         the current 16, and the grid is persistent (SMs x resident
//         blocks). Lanes of a warp touch different 32-byte sectors: one L2
//         request per valid id, so L2's rate of random requests, not HBM,
//         sets this route (tools/sparse_l2_probe.py measures both).
// Both: one warp per row; lanes read consecutive ids (int4 when the row is
// 16-byte aligned); a -1 may sit anywhere in a row, so there is no early
// exit; a shuffle sum finishes the row and lane 0 writes it.
#include <algorithm>

#include "common.cuh"

namespace repro_torch {

constexpr int kSmemWarps = 32;
constexpr int kSmemThreads = kWarp * kSmemWarps;
constexpr int kL2Batch = 4;  // int4 of ids per lane per step of the L2 route

__device__ __forceinline__ int fresh(const uint32_t* m, int id) {
  return id >= 0 && !((m[id >> 5] >> (id & 31)) & 1u);
}

__device__ __forceinline__ int row_count(const int32_t* __restrict__ r,
                                         const uint32_t* m, int64_t M,
                                         int lane, int vec) {
  int cnt = 0;
  if (vec) {
    const int4* r4 = reinterpret_cast<const int4*>(r);
    for (int64_t i = lane; i < M / 4; i += kWarp) {
      const int4 v = __ldcs(r4 + i);
      cnt += fresh(m, v.x) + fresh(m, v.y) + fresh(m, v.z) + fresh(m, v.w);
    }
  } else {
    for (int64_t i = lane; i < M; i += kWarp) cnt += fresh(m, __ldcs(r + i));
  }
  return warp_sum(cnt);
}

// L2 route: mask words loaded with an L2 evict_last policy `pol`.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ int fresh_l2(const uint32_t* m, int id, uint64_t pol) {
  if (id < 0) return 0;
  uint32_t w;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(w) : "l"(m + (id >> 5)), "l"(pol));
  return !((w >> (id & 31)) & 1u);
}

// This lane's next kL2Batch int4 of ids (-1 past the row's end).
__device__ __forceinline__ void load_ids(int4 (&v)[kL2Batch], const int4* r4,
                                         int64_t i, int64_t n4) {
#pragma unroll
  for (int u = 0; u < kL2Batch; ++u) {
    const int64_t j = i + (int64_t)u * kWarp;
    v[u] = j < n4 ? __ldcs(r4 + j) : make_int4(-1, -1, -1, -1);
  }
}

__device__ __forceinline__ int row_count_l2(const int32_t* __restrict__ r,
                                            const uint32_t* m, int64_t M,
                                            int lane, int vec, uint64_t pol) {
  int cnt = 0;
  if (vec) {
    const int4* r4 = reinterpret_cast<const int4*>(r);
    const int64_t n4 = M / 4;
    int4 cur[kL2Batch], nxt[kL2Batch];
    load_ids(cur, r4, lane, n4);
    for (int64_t i = lane; i < n4; i += kWarp * kL2Batch) {
      load_ids(nxt, r4, i + kWarp * kL2Batch, n4);  // in flight meanwhile
#pragma unroll
      for (int u = 0; u < kL2Batch; ++u)
        cnt += fresh_l2(m, cur[u].x, pol) + fresh_l2(m, cur[u].y, pol) +
               fresh_l2(m, cur[u].z, pol) + fresh_l2(m, cur[u].w, pol);
#pragma unroll
      for (int u = 0; u < kL2Batch; ++u) cur[u] = nxt[u];
    }
  } else {
    for (int64_t i = lane; i < M; i += kWarp) cnt += fresh_l2(m, __ldcs(r + i), pol);
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
    const int cnt = row_count(ids + row * M, s_mask, M, lane, vec);
    if (lane == 0) out[row] = cnt;
  }
}

__global__ void __launch_bounds__(kThreads)
sparse_gain_l2_kernel(const int32_t* __restrict__ ids,
                      const uint32_t* __restrict__ mask,
                      int32_t* __restrict__ out, int64_t C, int64_t M,
                      int vec) {
  const uint64_t pol = evict_last_policy();
  const int lane = threadIdx.x % kWarp;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
       row < C; row += warps) {
    const int cnt = row_count_l2(ids + row * M, mask, M, lane, vec, pol);
    if (lane == 0) out[row] = cnt;
  }
}

// Blocks of a persistent grid: at most (SMs x resident blocks) of `kernel`.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                              int64_t want, int64_t* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = std::min<int64_t>(want, (int64_t)sms * per_sm);
  return cudaSuccess;
}

}  // namespace repro_torch

extern "C" int sparse_gain_launch(const void* ids, const void* mask, void* out,
                                  int64_t C, int64_t M, int64_t W, int vec,
                                  int smem, void* stream) {
  using namespace repro_torch;
  int64_t blocks = 0;
  cudaError_t err;
  if (!smem) {
    if ((err = persistent_blocks(sparse_gain_l2_kernel, kThreads, 0,
                                 ceil_div(C, kWarpsPerBlock), &blocks)) != cudaSuccess)
      return (int)err;
    sparse_gain_l2_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)ids, (const uint32_t*)mask, (int32_t*)out, C, M, vec);
    return (int)cudaGetLastError();
  }
  const size_t bytes = (size_t)W * sizeof(uint32_t);
  err = cudaFuncSetAttribute(sparse_gain_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if ((err = persistent_blocks(sparse_gain_smem_kernel, kSmemThreads, bytes,
                               ceil_div(C, kSmemWarps), &blocks)) != cudaSuccess)
    return (int)err;
  sparse_gain_smem_kernel<<<(unsigned)blocks, kSmemThreads, bytes,
                            (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const uint32_t*)mask, (int32_t*)out, C, M, W, vec);
  return (int)cudaGetLastError();
}
