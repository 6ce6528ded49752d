// flash_backward: the gradient of flash_attention (GQA, causal or not, optional
// sliding window and logit softcap, q_offset 0) with respect to q, k and v,
// by FlashAttention-2's backward: the scores are recomputed tile by tile
// from q, k, v, the forward's output o and its gradient dO; no [Sq, Skv]
// matrix is ever stored. q/o/dO [B, S, Hq, D], k/v [B, Skv, Hkv, D] (f32
// or bf16, read in place through their strides, last dimension
// contiguous), D in {8, 16, 32, 64, 128, 256} -> dQ [B, S, Hq, D] and dK,
// dV [B, Skv, Hkv, D] in f32 (through their strides; the autograd Function
// in flash_attention.py casts them to the operands' dtype).
//
// Replaces no Pallas kernel: the reference has no Pallas backward (its
// training forward runs the pure-JAX chunked_attention, which jax.grad
// differentiates). It is the gradient of the port's forward kernels for
// the calls that neither flash_backward_tc.cu (bf16 after flash_prefill,
// with its lse) nor flash_backward_short.cu (at most 256 keys and D <= 32)
// takes (flash_backward.route): long sequences in f32 or at small head
// dims, and D of 64 and above without a saved lse (the f32 gradients of
// internlm2-1.8b and gemma2-2b). Its plain version is
// ref.flash_attention_bwd, in f32 throughout.
//
// Bound on an H100: 10*D FLOPs per visible (query, key) pair and query
// head (S = QK^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ = dS K),
// over the 989 TFLOP/s bf16 tensor-core peak; this kernel runs on the
// CUDA cores in f32 (67 TFLOP/s) and does 16*D: the row statistics
// recompute S once more and the dQ pass recomputes S and dP. It keeps f32
// arithmetic (phase 6c holds the f32 gradients to the CPU's at 1e-3 of max),
// which bf16 tensor cores would not give.
//
// Arithmetic, all f32 (the plain version's rule):
//   s = (q.k) * scale, scale = 1/sqrt(D) from the wrapper (1/sqrt(D0) when
//   it zero-pads a head dim D0 < 8 to 8); with a softcap, s = cap * tanh(s / cap);
//   a key is visible when key <= query (causal), query - key < window
//   (when set) and key < kv_len; lse = max + log(sum exp(s - max)) over a
//   row's visible keys; delta = rowsum(dO * o);
//   p = exp(s - lse) (0 where not visible); dp = dO.v;
//   ds = p * (dp - delta), times (1 - (s / cap)^2) with a softcap;
//   dV = sum p * dO, dK = sum ds * q * scale, dQ = sum ds * k * scale.
//
// Design. Three kernels, one launch entry, no float atomics, so two runs
// give the same bits:
//   a. rowstats: one CTA per (b, q head, BQ query rows) walks the row
//      block's visible key tiles and writes lse and delta (f32) to a
//      workspace (the forward kernels write no log-sum-exp);
//   b. dkdv: one CTA per (b, kv head, BK keys) loops over the G query heads
//      of its kv head and over the query blocks that see its keys (causal
//      from the block's first key, a window up to its last key + window),
//      keeping dK and dV in registers: the sum over the group needs no
//      atomics;
//   c. dq: one CTA per (b, q head, BQ query rows) loops over its visible
//      key tiles.
// Tiles are staged in shared memory as f32, rows padded by 4 floats so
// that the 16-byte loads of the score products are free of bank
// conflicts. A score tile [BQ, BK] is split 16 x 16 over the 256 threads
// (rows ty + 16r, keys tx + 16c); an accumulator [rows, D] is split with
// min(D, 32) threads across D and each thread's rows contiguous, so P and
// dS are read as broadcast vectors. BQ = BK = 64, 32 at D = 256 (the
// accumulators stay at 32 floats a thread).
#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBwdThreads = 256;

template <int D>
struct Bwd {
  static constexpr int kTile = D <= 128 ? 64 : 32;   // BQ = BK
  static constexpr int kStride = D + 4;               // a staged row, floats
  static constexpr int kPStride = kTile + 4;          // a P / dS row, floats
  static constexpr int kTm = kTile / 16;              // score rows a thread
  static constexpr int kTn = kTile / 16;              // score keys a thread
  static constexpr int kNd = D < 32 ? D : 32;         // threads across D
  static constexpr int kNr = kBwdThreads / kNd;       // threads across rows
  static constexpr int kRr = kTile / kNr;             // accumulator rows a thread
  static constexpr int kCd = D / kNd;                 // accumulator columns a thread
  static constexpr int kTileFloats = kTile * kStride;
  static constexpr int kPFloats = kTile * kPStride;
  static_assert(kRr >= 1 && kTile % kNr == 0, "rows do not split");
  static_assert(D % 4 == 0, "rows are read 4 floats at a time");
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  float* dq;
  float* dk;
  float* dv;
  float* lse;     // [B, Hq, S]
  float* delta;   // [B, Hq, S]
  int64_t q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  int s;          // query positions
  int skv;        // key positions
  int hq, hkv, g;
  int kv_len;
  int window;     // -1: none
  int causal;
  float cap;      // 0: none
  float inv_cap;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool visible(const BwdArgs& a, int i, int j) {
  return j < a.kv_len && (!a.causal || j <= i) && (a.window < 0 || i - j < a.window);
}

// rows [p0, p0 + rows) of head h of a [B, S, H, D] operand into a staged
// tile (zeros past `limit`)
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const void* src, const int64_t* st,
                                      int b, int h, int p0, int rows, int limit) {
  const T* base = static_cast<const T*>(src) + b * st[0] + h * st[2];
  for (int idx = threadIdx.x; idx < rows * D; idx += kBwdThreads) {
    const int r = idx / D, d = idx % D, p = p0 + r;
    dst[r * Bwd<D>::kStride + d] = p < limit ? to_f(base[(int64_t)p * st[1] + d]) : 0.f;
  }
}

// acc[r][c] += sum_d A[ty + 16r][d] * B[tx + 16c][d] over staged tiles
template <int D>
__device__ __forceinline__ void score_tile(float (&acc)[Bwd<D>::kTm][Bwd<D>::kTn],
                                           const float* A, const float* B) {
  using P = Bwd<D>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[P::kTm], bv[P::kTn];
#pragma unroll
    for (int r = 0; r < P::kTm; ++r)
      av[r] = *reinterpret_cast<const float4*>(A + (ty + 16 * r) * P::kStride + d);
#pragma unroll
    for (int c = 0; c < P::kTn; ++c)
      bv[c] = *reinterpret_cast<const float4*>(B + (tx + 16 * c) * P::kStride + d);
#pragma unroll
    for (int r = 0; r < P::kTm; ++r)
#pragma unroll
      for (int c = 0; c < P::kTn; ++c) {
        acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
        acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
        acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
        acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
      }
  }
}

template <int N>
__device__ __forceinline__ void load_row(float (&out)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      out[i] = x.x; out[i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// acc[a][c] += sum_i W[i][tr * kRr + a] * X[i][td + kNd * c], i < kTile:
// W a [kTile, kPStride] matrix of weights (P or dS, read along its rows),
// X a staged [kTile, kStride] tile
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[Bwd<D>::kRr][Bwd<D>::kCd],
                                           const float* W, const float* X) {
  using P = Bwd<D>;
  const int tr = threadIdx.x / P::kNd, td = threadIdx.x % P::kNd;
#pragma unroll 4
  for (int i = 0; i < P::kTile; ++i) {
    float w[P::kRr], x[P::kCd];
    load_row<P::kRr>(w, W + i * P::kPStride + tr * P::kRr);
#pragma unroll
    for (int c = 0; c < P::kCd; ++c) x[c] = X[i * P::kStride + td + P::kNd * c];
#pragma unroll
    for (int a = 0; a < P::kRr; ++a)
#pragma unroll
      for (int c = 0; c < P::kCd; ++c) acc[a][c] = fmaf(w[a], x[c], acc[a][c]);
  }
}

// the score after scale and softcap, and the softcap's derivative factor
__device__ __forceinline__ float capped(const BwdArgs& a, float dot, float* dcap) {
  const float s = dot * a.scale;
  if (a.cap > 0.f) {
    const float t = tanhf(s * a.inv_cap);
    *dcap = 1.f - t * t;
    return a.cap * t;
  }
  *dcap = 1.f;
  return s;
}

// (m, l) of an online softmax merged with another's
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * __expf(m - mn)) + (m2 == -INFINITY ? 0.f : l2 * __expf(m2 - mn));
  m = mn;
}

template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_backward_rowstats(const BwdArgs a) {
  using P = Bwd<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + P::kTileFloats;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * P::kTile;
  const int hk = h / a.g;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t ws = ((int64_t)b * a.hq + h) * a.s;

  // delta = rowsum(dO * o), one warp a row
  {
    const T* ob = static_cast<const T*>(a.o) + b * a.o_s[0] + h * a.o_s[2];
    const T* db = static_cast<const T*>(a.dout) + b * a.do_s[0] + h * a.do_s[2];
    for (int r = warp; r < P::kTile; r += kBwdThreads / kWarp) {
      const int i = q0 + r;
      if (i >= a.s) break;
      float sum = 0.f;
      for (int d = lane; d < D; d += kWarp)
        sum = fmaf(to_f(db[(int64_t)i * a.do_s[1] + d]), to_f(ob[(int64_t)i * a.o_s[1] + d]), sum);
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) a.delta[ws + i] = sum;
    }
  }

  stage<D, T>(qs, a.q, a.q_s, b, h, q0, P::kTile, a.s);
  float m[P::kTm], l[P::kTm];
#pragma unroll
  for (int r = 0; r < P::kTm; ++r) { m[r] = -INFINITY; l[r] = 0.f; }
  const int q1 = min(a.s, q0 + P::kTile);
  int k_lo = a.window >= 0 ? max(0, q0 - a.window + 1) : 0;
  k_lo = k_lo / P::kTile * P::kTile;
  const int k_hi = a.causal ? min(a.kv_len, q1) : a.kv_len;
  for (int k0 = k_lo; k0 < k_hi; k0 += P::kTile) {
    __syncthreads();
    stage<D, T>(ks, a.k, a.k_s, b, hk, k0, P::kTile, a.kv_len);
    __syncthreads();
    float s[P::kTm][P::kTn] = {};
    score_tile<D>(s, qs, ks);
#pragma unroll
    for (int r = 0; r < P::kTm; ++r)
#pragma unroll
      for (int c = 0; c < P::kTn; ++c) {
        const int i = q0 + ty + 16 * r, j = k0 + tx + 16 * c;
        if (i < a.s && visible(a, i, j)) {
          float dcap;
          merge(m[r], l[r], capped(a, s[r][c], &dcap), 1.f);
        }
      }
  }
#pragma unroll
  for (int r = 0; r < P::kTm; ++r) {
    // the 16 threads of a row are the 16 lanes of a half warp
    for (int off = 8; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(kFull, m[r], off);
      const float l2 = __shfl_xor_sync(kFull, l[r], off);
      merge(m[r], l[r], m2, l2);
    }
    const int i = q0 + ty + 16 * r;
    if (tx == 0 && i < a.s)   // a row with no visible key gets p = 0 everywhere
      a.lse[ws + i] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
}

// p and ds of one score tile into shared memory: p at P[row][key] and ds at
// dS[row][key], or with `transposed` ds at dS[key][row] (P not written)
template <int D, bool transposed>
__device__ __forceinline__ void p_ds(const BwdArgs& a, const float (&s)[Bwd<D>::kTm][Bwd<D>::kTn],
                                     const float (&dp)[Bwd<D>::kTm][Bwd<D>::kTn],
                                     const float* lse, const float* delta, int q0, int k0,
                                     float* ps, float* dss) {
  using P = Bwd<D>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < P::kTm; ++r)
#pragma unroll
    for (int c = 0; c < P::kTn; ++c) {
      const int ri = ty + 16 * r, cj = tx + 16 * c;
      const int i = q0 + ri, j = k0 + cj;
      float p = 0.f, ds = 0.f;
      if (i < a.s && visible(a, i, j)) {
        float dcap;
        const float sc = capped(a, s[r][c], &dcap);
        p = __expf(sc - lse[ri]);
        ds = p * (dp[r][c] - delta[ri]) * dcap;
      }
      if (transposed) {
        dss[cj * P::kPStride + ri] = ds;
      } else {
        ps[ri * P::kPStride + cj] = p;
        dss[ri * P::kPStride + cj] = ds;
      }
    }
}

template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_backward_dkdv(const BwdArgs a) {
  using P = Bwd<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + P::kTileFloats;
  float* qs = vs + P::kTileFloats;
  float* dos = qs + P::kTileFloats;
  float* pT = dos + P::kTileFloats;     // [query][key]
  float* dsT = pT + P::kPFloats;        // [query][key]
  float* lse = dsT + P::kPFloats;
  float* delta = lse + P::kTile;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * P::kTile;
  const int tr = threadIdx.x / P::kNd, td = threadIdx.x % P::kNd;

  stage<D, T>(ks, a.k, a.k_s, b, hk, k0, P::kTile, a.kv_len);
  stage<D, T>(vs, a.v, a.v_s, b, hk, k0, P::kTile, a.kv_len);
  float dk[P::kRr][P::kCd] = {}, dv[P::kRr][P::kCd] = {};
  const int q_lo = a.causal ? k0 : 0;   // BQ = BK: k0 is a query-block edge
  const int q_hi = a.window >= 0 ? min(a.s, k0 + P::kTile - 1 + a.window) : a.s;
  for (int gi = 0; gi < a.g; ++gi) {
    const int h = hk * a.g + gi;
    const int64_t ws = ((int64_t)b * a.hq + h) * a.s;
    for (int q0 = q_lo; q0 < q_hi; q0 += P::kTile) {
      __syncthreads();
      stage<D, T>(qs, a.q, a.q_s, b, h, q0, P::kTile, a.s);
      stage<D, T>(dos, a.dout, a.do_s, b, h, q0, P::kTile, a.s);
      for (int r = threadIdx.x; r < P::kTile; r += kBwdThreads) {
        const bool in = q0 + r < a.s;
        lse[r] = in ? a.lse[ws + q0 + r] : INFINITY;
        delta[r] = in ? a.delta[ws + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[P::kTm][P::kTn] = {}, dp[P::kTm][P::kTn] = {};
      score_tile<D>(s, qs, ks);
      score_tile<D>(dp, dos, vs);
      p_ds<D, false>(a, s, dp, lse, delta, q0, k0, pT, dsT);
      __syncthreads();
      accumulate<D>(dv, pT, dos);
      accumulate<D>(dk, dsT, qs);
    }
  }
  float* dkb = a.dk + b * a.dk_s[0] + hk * a.dk_s[2];
  float* dvb = a.dv + b * a.dv_s[0] + hk * a.dv_s[2];
#pragma unroll
  for (int r = 0; r < P::kRr; ++r) {
    const int j = k0 + tr * P::kRr + r;
    if (j >= a.skv) break;
#pragma unroll
    for (int c = 0; c < P::kCd; ++c) {
      const int d = td + P::kNd * c;
      dkb[(int64_t)j * a.dk_s[1] + d] = dk[r][c] * a.scale;
      dvb[(int64_t)j * a.dv_s[1] + d] = dv[r][c];
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_backward_dq(const BwdArgs a) {
  using P = Bwd<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + P::kTileFloats;
  float* ks = dos + P::kTileFloats;
  float* vs = ks + P::kTileFloats;
  float* dsT = vs + P::kTileFloats;     // [key][query]
  float* lse = dsT + P::kPFloats;
  float* delta = lse + P::kTile;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * P::kTile;
  const int hk = h / a.g;
  const int tr = threadIdx.x / P::kNd, td = threadIdx.x % P::kNd;
  const int64_t ws = ((int64_t)b * a.hq + h) * a.s;

  stage<D, T>(qs, a.q, a.q_s, b, h, q0, P::kTile, a.s);
  stage<D, T>(dos, a.dout, a.do_s, b, h, q0, P::kTile, a.s);
  for (int r = threadIdx.x; r < P::kTile; r += kBwdThreads) {
    const bool in = q0 + r < a.s;
    lse[r] = in ? a.lse[ws + q0 + r] : INFINITY;
    delta[r] = in ? a.delta[ws + q0 + r] : 0.f;
  }
  float dq[P::kRr][P::kCd] = {};
  const int q1 = min(a.s, q0 + P::kTile);
  int k_lo = a.window >= 0 ? max(0, q0 - a.window + 1) : 0;
  k_lo = k_lo / P::kTile * P::kTile;
  const int k_hi = a.causal ? min(a.kv_len, q1) : a.kv_len;
  for (int k0 = k_lo; k0 < k_hi; k0 += P::kTile) {
    __syncthreads();
    stage<D, T>(ks, a.k, a.k_s, b, hk, k0, P::kTile, a.kv_len);
    stage<D, T>(vs, a.v, a.v_s, b, hk, k0, P::kTile, a.kv_len);
    __syncthreads();
    float s[P::kTm][P::kTn] = {}, dp[P::kTm][P::kTn] = {};
    score_tile<D>(s, qs, ks);
    score_tile<D>(dp, dos, vs);
    p_ds<D, true>(a, s, dp, lse, delta, q0, k0, nullptr, dsT);
    __syncthreads();
    accumulate<D>(dq, dsT, ks);
  }
  float* dqb = a.dq + b * a.dq_s[0] + h * a.dq_s[2];
#pragma unroll
  for (int r = 0; r < P::kRr; ++r) {
    const int i = q0 + tr * P::kRr + r;
    if (i >= a.s) break;
#pragma unroll
    for (int c = 0; c < P::kCd; ++c)
      dqb[(int64_t)i * a.dq_s[1] + td + P::kNd * c] = dq[r][c] * a.scale;
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, typename T>
int launch_bwd(const BwdArgs& a, int64_t batch, cudaStream_t stream) {
  using P = Bwd<D>;
  constexpr int stats_bytes = 2 * P::kTileFloats * 4;
  constexpr int dkdv_bytes = (4 * P::kTileFloats + 2 * P::kPFloats + 2 * P::kTile) * 4;
  constexpr int dq_bytes = (4 * P::kTileFloats + P::kPFloats + 2 * P::kTile) * 4;
  static_assert(dkdv_bytes <= 232448 && dq_bytes <= 232448,
                "tiles exceed the per-block shared memory");
  int err;
  if ((err = set_smem(flash_backward_rowstats<D, T>, stats_bytes))) return err;
  if ((err = set_smem(flash_backward_dkdv<D, T>, dkdv_bytes))) return err;
  if ((err = set_smem(flash_backward_dq<D, T>, dq_bytes))) return err;
  const unsigned qb = (unsigned)ceil_div(a.s, P::kTile);
  const unsigned kb = (unsigned)ceil_div(a.skv, P::kTile);
  flash_backward_rowstats<D, T><<<dim3(qb, a.hq, (unsigned)batch), kBwdThreads, stats_bytes, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  flash_backward_dkdv<D, T><<<dim3(kb, a.hkv, (unsigned)batch), kBwdThreads, dkdv_bytes, stream>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  flash_backward_dq<D, T><<<dim3(qb, a.hq, (unsigned)batch), kBwdThreads, dq_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs& a, int64_t d, int64_t batch, cudaStream_t st) {
  switch (d) {
    case 8: return launch_bwd<8, T>(a, batch, st);
    case 16: return launch_bwd<16, T>(a, batch, st);
    case 32: return launch_bwd<32, T>(a, batch, st);
    case 64: return launch_bwd<64, T>(a, batch, st);
    case 128: return launch_bwd<128, T>(a, batch, st);
    case 256: return launch_bwd<256, T>(a, batch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

void copy3(int64_t* dst, const int64_t* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

}  // namespace
}  // namespace repro_torch

// strides: 8 groups of [batch, position, head] element strides, in the
// order q, k, v, o, dO, dQ, dK, dV; lse and delta: f32 workspaces of
// B * Hq * S floats each
extern "C" int flash_backward_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* dq, void* dk, void* dv, void* lse, void* delta, int64_t B, int64_t S,
    int64_t Skv, int64_t Hq, int64_t Hkv, int64_t D, const int64_t* strides,
    int64_t kv_len, int64_t window, float cap, float scale, int causal, int bf16,
    void* stream) {
  using namespace repro_torch;
  if (Hkv <= 0 || Hq % Hkv || B <= 0 || S <= 0 || Skv <= 0 || kv_len > Skv)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  int64_t* dst[8] = {a.q_s, a.k_s, a.v_s, a.o_s, a.do_s, a.dq_s, a.dk_s, a.dv_s};
  for (int i = 0; i < 8; ++i) copy3(dst[i], strides + 3 * i);
  a.s = (int)S;
  a.skv = (int)Skv;
  a.hq = (int)Hq;
  a.hkv = (int)Hkv;
  a.g = (int)(Hq / Hkv);
  a.kv_len = (int)kv_len;
  a.window = (int)window;
  a.causal = causal;
  a.cap = cap;
  a.inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  a.scale = scale;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(a, D, B, st) : dispatch<float>(a, D, B, st);
}
