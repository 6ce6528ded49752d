// clause_match: eligible[b] = exists k such that clause_k ⊆ query_b, i.e.
// (c_k & ~q_b) == 0 in every word (the ψ^clause classifier, paper eq. 8).
//
// Replaces the Pallas kernel repro/kernels/clause_match.py::clause_match
// (body `_kernel`), run on every serve batch.
//
// Bound on an H100: bytes. The least traffic is reading both operands
// once, (B + K) * Wv * 4 bytes, plus B bytes written. The kernel re-reads
// the clause rows once per block of queries; those reads hit L2 when the
// clause matrix fits there (K * Wv * 4 bytes: 2 MiB for 128 clauses over a
// 2^17-term vocabulary), so L2 bandwidth, not HBM, is what it spends.
//
// Design: a block owns up to kMaxQ queries and stages their complemented
// words in shared memory (16 KiB per query at Wv = 4096; the block takes as
// many as fit in 48 KiB). Its 8 warps stride over the clause rows; lanes
// read 32 consecutive clause words at a time and test only the non-zero
// ones against every still-open query, so a sparse clause costs one read
// of its row. After each 32-word chunk a warp vote (__reduce_or_sync)
// stops the row as soon as every open query has a miss, and a query is
// closed for the whole block once any clause matched it; the block stops
// when all its queries are closed. The loop runs over the true K, so there
// are no padded rows to mask (the TPU kernel had to mask its zero-padded
// clause rows, which are the empty clause and match everything).
#include <algorithm>

#include "common.cuh"

namespace repro_torch {

constexpr int kMaxQ = 8;
constexpr int64_t kSmemTarget = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
clause_match_kernel(const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ c, bool* __restrict__ out,
                    int64_t B, int64_t K, int64_t Wv, int qpb) {
  extern __shared__ uint32_t not_q[];  // [qpb, Wv] complemented query words
  __shared__ int matched[kMaxQ];
  const int64_t b0 = (int64_t)blockIdx.x * qpb;
  const int n = (int)(B - b0 < qpb ? B - b0 : qpb);
  for (int64_t i = threadIdx.x; i < (int64_t)n * Wv; i += blockDim.x)
    not_q[i] = ~q[b0 * Wv + i];
  if (threadIdx.x < kMaxQ) matched[threadIdx.x] = (int)threadIdx.x >= n;
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  volatile int* closed = matched;
  for (int64_t k = warp; k < K; k += kWarpsPerBlock) {
    unsigned open = 0;
    for (int j = 0; j < n; ++j)
      if (!closed[j]) open |= 1u << j;
    open = __shfl_sync(kFull, open, 0);  // one view per warp: uniform exits
    if (!open) break;
    const uint32_t* cr = c + k * Wv;
    unsigned miss = 0;
    for (int64_t base = 0; base < Wv; base += kWarp) {
      const int64_t i = base + lane;
      if (i < Wv) {
        const uint32_t cw = __ldg(cr + i);
        if (cw) {
          for (int j = 0; j < n; ++j)
            if (((open >> j) & 1u) && (cw & not_q[j * Wv + i])) miss |= 1u << j;
        }
      }
      miss = __reduce_or_sync(kFull, miss);
      if ((miss & open) == open) break;
    }
    const unsigned hit = open & ~miss;
    if (lane == 0 && hit) {
      for (int j = 0; j < n; ++j)
        if ((hit >> j) & 1u) closed[j] = 1;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < n) out[b0 + threadIdx.x] = matched[threadIdx.x] != 0;
}

}  // namespace repro_torch

extern "C" int clause_match_launch(const void* q, const void* c, void* out,
                                   int64_t B, int64_t K, int64_t Wv,
                                   void* stream) {
  using namespace repro_torch;
  const int qpb = Wv > 0
      ? (int)std::max<int64_t>(1, std::min<int64_t>(kMaxQ, kSmemTarget / (Wv * 4)))
      : kMaxQ;
  const size_t smem = (size_t)qpb * (size_t)Wv * sizeof(uint32_t);
  // dynamic + static shared memory above 48 KiB needs the opt-in, and 48 KiB
  // of query words plus the flags already is above it
  const cudaError_t e = cudaFuncSetAttribute(
      clause_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)ceil_div(B, qpb));
  clause_match_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const uint32_t*)c, (bool*)out, B, K, Wv, qpb);
  return (int)cudaGetLastError();
}
