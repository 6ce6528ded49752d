// clause_match: eligible[b] = exists k such that clause_k ⊆ query_b, i.e.
// (c_k & ~q_b) == 0 in every word (the ψ^clause classifier, paper eq. 8).
//
// Replaces the Pallas kernel repro/kernels/clause_match.py::clause_match
// (body `_kernel`), run on every serve batch.
//
// Bound on an H100: bytes. The least traffic is reading both operands
// once, (B + K) * Wv * 4 bytes, plus B bytes written: 0.341 ms for 4096
// queries against serve_route's 2^16 clauses over a 2^17-term vocabulary
// (a 1 GiB clause matrix).
//
// A clause is a few tokens (the miner emits at most 4) spread over Wv
// words. Testing it word by word once per block of queries re-reads the
// clause matrix once per block, and how far each read goes depends on
// where the clause's bits sit in the vocabulary. Two launches on the
// caller's stream instead, with no host sync between them:
//   A. compaction (clause_tokens_kernel): one warp per clause row reads it
//      once (int4 loads when aligned, evict-first) and writes its first
//      kSlots set-bit positions, ascending, to tokens [K, kSlots] (-1 past
//      its count), and its number of set bits to count [K], or kOverflow
//      when it has more than kSlots; the warp stops reading the row there.
//      At K = 2^16 the table is 1 MiB and stays in L2.
//   B. subset test (clause_test_kernel): a block stages the complemented
//      words of qpb queries in shared memory, and with qpb > 1 the
//      complement of their union (the wrapper's `plan` picks qpb: 1 when
//      the table is smaller than a query's words, else as many as fit,
//      leaving at least two blocks per SM; the autotuner's cache,
//      kernels/autotune.py, may pick another that fits); its threads
//      stride over the
//      table. A clause lies in a
//      query iff none of its tokens hits a 0 bit of the query: a few
//      shared-memory lookups, wherever the bits sit. A clause with a token
//      outside the union lies in none of the block's queries, which one
//      lookup shows (nearly every clause, for serving's queries of <= 8
//      tokens). An overflow clause is tested on its first kSlots tokens,
//      then, if they all hit, against its full row. A query is closed for
//      the block once a clause matched it, and a thread stops when all the
//      block's queries are closed. An empty clause (count 0) matches every
//      query; the loops run over the true K, so nothing is padded.
#include "common.cuh"

namespace repro_torch {

constexpr int kSlots = 4;
constexpr int kOverflow = kSlots + 1;
constexpr int kMaxQ = 32;            // queries per block: one bit each
constexpr int kTestThreads = 1024;
constexpr int kUnroll = 4;           // loads in flight per lane in pass A

// This lane's E words w, at word index word0.., appended to the row's
// table in ascending position; returns the warp's count so far.
template <int E>
__device__ __forceinline__ int append_bits(const uint32_t (&w)[E],
                                           int64_t word0, int found, int lane,
                                           int32_t* tok) {
  int n = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) n += __popc(w[e]);
  int incl = n;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  const int total = __shfl_sync(kFull, incl, kWarp - 1);
  int rank = found + incl - n;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    for (uint32_t x = w[e]; x && rank < kSlots; x &= x - 1)
      tok[rank++] = (int32_t)((word0 + e) * kWord + (__ffs((int)x) - 1));
  }
  return found + total;
}

template <int E>
__device__ __forceinline__ void load_words(uint32_t (&w)[E],
                                           const uint32_t* row, int64_t i,
                                           int64_t n) {
  if (i >= n) {
#pragma unroll
    for (int e = 0; e < E; ++e) w[e] = 0;
  } else if constexpr (E == 4) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(row) + i);
    w[0] = (uint32_t)v.x;
    w[1] = (uint32_t)v.y;
    w[2] = (uint32_t)v.z;
    w[3] = (uint32_t)v.w;
  } else {
    w[0] = __ldcs(row + i);
  }
}

// E = 4: Wv % 4 == 0 and 16-byte aligned rows; E = 1 otherwise.
template <int E>
__global__ void __launch_bounds__(kThreads)
clause_tokens_kernel(const uint32_t* __restrict__ c,
                     int32_t* __restrict__ tokens, int32_t* __restrict__ count,
                     int64_t K, int64_t Wv) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= K) return;  // whole warp leaves together
  const uint32_t* cr = c + row * Wv;
  int32_t* tok = tokens + row * kSlots;
  const int64_t n = Wv / E;
  int found = 0;
  for (int64_t base = 0; base < n && found <= kSlots; base += kWarp * kUnroll) {
    uint32_t w[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_words<E>(w[u], cr, base + u * kWarp + lane, n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint32_t any = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) any |= w[u][e];
      if (found <= kSlots && __any_sync(kFull, any != 0))
        found = append_bits<E>(w[u], (base + u * kWarp + lane) * E, found,
                               lane, tok);
    }
  }
  if (lane < kSlots && lane >= found) tok[lane] = -1;
  if (lane == 0) count[row] = found > kSlots ? kOverflow : found;
}

// Queries of `open` that the clause row `cr` does not lie in, by its words.
__device__ unsigned row_miss(const uint32_t* __restrict__ cr,
                             const uint32_t* not_q, int64_t Wv, unsigned open) {
  unsigned miss = 0;
  for (int64_t i = 0; i < Wv && miss != open; ++i) {
    const uint32_t cw = __ldg(cr + i);
    if (!cw) continue;
    for (unsigned o = open & ~miss; o; o &= o - 1) {
      const int j = __ffs((int)o) - 1;
      if (cw & not_q[(int64_t)j * Wv + i]) miss |= 1u << j;
    }
  }
  return miss;
}

// Does one of the clause's first `cnt` tokens hit a set bit of `not_w`?
__device__ __forceinline__ bool any_token(const uint32_t* not_w, int4 t, int cnt) {
  const int tk[kSlots] = {t.x, t.y, t.z, t.w};
  uint32_t m = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (s < cnt) m |= not_w[tk[s] >> 5] >> (tk[s] & 31);
  return m & 1u;
}

// Queries of `open` with a 0 bit under one of the clause's first `cnt`
// tokens.
__device__ __forceinline__ unsigned token_miss(const uint32_t* not_q,
                                               int64_t Wv, int4 t, int cnt,
                                               unsigned open) {
  unsigned miss = 0;
  for (unsigned o = open; o; o &= o - 1) {
    const int j = __ffs((int)o) - 1;
    if (any_token(not_q + (int64_t)j * Wv, t, cnt)) miss |= 1u << j;
  }
  return miss;
}

__global__ void __launch_bounds__(kTestThreads)
clause_test_kernel(const uint32_t* __restrict__ q,
                   const uint32_t* __restrict__ c,
                   const int4* __restrict__ tokens,
                   const int32_t* __restrict__ count, bool* __restrict__ out,
                   int64_t B, int64_t K, int64_t Wv, int qpb, int vec) {
  extern __shared__ int4 smem[];
  // [qpb, Wv] complemented query words, then (qpb > 1) the complement of
  // their union: a clause with a token outside the union is in no query of
  // the block, one lookup instead of one per query
  uint32_t* not_q = reinterpret_cast<uint32_t*>(smem);
  uint32_t* not_u = qpb > 1 ? not_q + (int64_t)qpb * Wv : not_q;
  __shared__ unsigned closed;
  const int64_t b0 = (int64_t)blockIdx.x * qpb;
  const int n = (int)(B - b0 < qpb ? B - b0 : qpb);
  const unsigned all = n == kMaxQ ? kFull : (1u << n) - 1u;
  const int64_t words = (int64_t)n * Wv;
  if (vec) {
    const int4* q4 = reinterpret_cast<const int4*>(q + b0 * Wv);
    for (int64_t i = threadIdx.x; i < words / 4; i += blockDim.x) {
      const int4 v = __ldcs(q4 + i);
      smem[i] = make_int4(~v.x, ~v.y, ~v.z, ~v.w);
    }
  } else {
    for (int64_t i = threadIdx.x; i < words; i += blockDim.x)
      not_q[i] = ~__ldcs(q + b0 * Wv + i);
  }
  if (threadIdx.x == 0) closed = 0;
  __syncthreads();
  if (qpb > 1) {
    for (int64_t i = threadIdx.x; i < Wv; i += blockDim.x) {
      uint32_t w = kFull;
      for (int j = 0; j < n; ++j) w &= not_q[j * Wv + i];
      not_u[i] = w;
    }
    __syncthreads();
  }

  volatile unsigned* vclosed = &closed;
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    const unsigned open = all & ~*vclosed;
    if (!open) break;
    const int cnt = __ldg(count + k);
    unsigned hit = open;
    if (cnt > 0) {
      const int4 t = __ldg(tokens + k);
      const int first = cnt < kSlots ? cnt : kSlots;
      if (any_token(not_u, t, first)) continue;
      hit &= ~token_miss(not_q, Wv, t, first, open);
      if (hit && cnt == kOverflow) hit &= ~row_miss(c + k * Wv, not_q, Wv, hit);
    }
    if (hit) atomicOr(&closed, hit);
  }
  __syncthreads();
  if ((int)threadIdx.x < n) out[b0 + threadIdx.x] = (closed >> threadIdx.x) & 1u;
}

int launch_tokens(const void* c, void* tokens, void* count, int64_t K,
                  int64_t Wv, int vec, cudaStream_t stream) {
  const dim3 grid((unsigned)ceil_div(K, kWarpsPerBlock));
  if (vec)
    clause_tokens_kernel<4><<<grid, kThreads, 0, stream>>>(
        (const uint32_t*)c, (int32_t*)tokens, (int32_t*)count, K, Wv);
  else
    clause_tokens_kernel<1><<<grid, kThreads, 0, stream>>>(
        (const uint32_t*)c, (int32_t*)tokens, (int32_t*)count, K, Wv);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// Pass A alone: the compact table of K clause rows.
extern "C" int clause_tokens_launch(const void* c, void* tokens, void* count,
                                    int64_t K, int64_t Wv, int vec,
                                    void* stream) {
  return repro_torch::launch_tokens(c, tokens, count, K, Wv, vec,
                                    (cudaStream_t)stream);
}

// Both passes; tokens [K, 4] and count [K] int32 are the caller's scratch.
// vec: Wv % 4 == 0 and q, c 16-byte aligned.
extern "C" int clause_match_launch(const void* q, const void* c, void* tokens,
                                   void* count, void* out, int64_t B, int64_t K,
                                   int64_t Wv, int qpb, int vec, void* stream) {
  using namespace repro_torch;
  if (qpb < 1 || qpb > kMaxQ) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = launch_tokens(c, tokens, count, K, Wv, vec, s);
  if (err) return err;
  const size_t smem = (size_t)(qpb + (qpb > 1)) * (size_t)Wv * sizeof(uint32_t);
  // above 48 KiB of shared memory needs the opt-in; set it every time
  const cudaError_t e = cudaFuncSetAttribute(
      clause_test_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)ceil_div(B, qpb));
  clause_test_kernel<<<grid, kTestThreads, smem, s>>>(
      (const uint32_t*)q, (const uint32_t*)c, (const int4*)tokens,
      (const int32_t*)count, (bool*)out, B, K, Wv, qpb, vec);
  return (int)cudaGetLastError();
}
