// flash_decode: GQA attention of one query position (the decode step) with
// a causal mask, a sliding window, a logit softcap, a query offset and a
// valid KV length, by split-KV online softmax. q [B, 1, Hq, D], k/v
// [B, Skv, Hkv, D] (f32 or bf16, read in place through their strides, last
// dimension contiguous) -> out [B, 1, Hq, D] contiguous, q's dtype.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// _flash_attention_impl at Sq = 1: the attention of every layer of a decode
// step, against one layer's slice of the [L, B, Smax, Hkv, D] cache with
// q_offset = cur_len and kv_len = cur_len + 1.
//
// Bound on an H100: the bytes of the visible K/V rows (3.35 TB/s); the
// 4 FLOPs per (key, query head, element) are a few per byte. The design
// keeps every SM streaming K/V. At Sq = 1 the keys a row sees are one
// interval [lo, hi), the same for every row; the host cuts it into
// n_splits runs and launches one CTA per (split, row chunk) x KV head x
// batch, about 4 per SM. Inside the interval every key is visible, so no
// key is masked one by one. No K/V tile goes to shared memory: a warp reads
// a key's K and V rows with one 16-byte load per lane each (LPK lanes per
// key, KPW keys per warp step when D is small), and uses each byte for the
// CTA's GC query heads in registers, where it keeps q (scaled by 1/sqrt(D)
// in f32 as it is loaded) and its online (m, l, acc). The 8 warps walk
// strided steps of U keys per lane group, with all U K and V loads issued
// before the first is used. A score is a dot product over the lane's slice
// and an xor-shuffle sum over its LPK lanes, then the softcap; m starts at
// the finite NEG = -1e30. One max and one correction per step of U keys.
// At the end the lane groups merge by shuffles and the warps through
// shared memory, and the CTA writes (acc[GC][D], m, l) of its split to an
// f32 workspace [B, Hkv, n_splits, G, D + 2]; a second kernel merges the
// splits of each (b, query head) with weights exp(m_s - max m) and rounds
// once. With one split the CTA writes the output itself. When no key is
// visible (lo >= hi) the host passes [0, kv_len) with `no_key` set and
// every score is NEG: the uniform mean the masked softmax gives.
#include <cmath>

#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr float kNeg = -1e30f;
constexpr int kCombineThreads = 128;

struct FdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* ws;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t hq, hkv, g;
  int64_t lo, n_keys, per, n_splits;
  float cap;   // <= 0: no softcap
  float scale;
  int no_key;
  int vec16;   // every row start 16-byte aligned
};

// 16 bytes of a row: one 16-byte load, or two 8-byte ones where bf16 rows
// are only 8-byte aligned (f32 rows always are 16-byte aligned).
template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p, bool vec16) {
  if (sizeof(T) == 4 || vec16) return __ldg(reinterpret_cast<const uint4*>(p));
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  const uint2 b = __ldg(reinterpret_cast<const uint2*>(p) + 1);
  return make_uint4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&o)[4]) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&o)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D, typename T>
struct Shape {
  static constexpr int E = 16 / (int)sizeof(T);     // elements per load
  static constexpr int C = D / E;                    // loads per row
  static constexpr int LPK = C < kWarp ? C : kWarp;  // lanes per key
  static constexpr int NL = C / LPK;                 // loads per lane and row
  static constexpr int F = NL * E;                   // floats per lane and row
  static constexpr int KPW = kWarp / LPK;            // keys per warp step
  static constexpr int U = NL == 1 ? 8 : 4;          // steps in flight
  static constexpr int R = U < LPK ? U : LPK;        // lanes a step's scores spread over
  static constexpr int NS = U / R;                   // scores per lane
  static constexpr int LOG_R = R >= 32 ? 5 : R >= 16 ? 4 : R >= 8 ? 3 : R >= 4 ? 2 : R >= 2 ? 1 : 0;
};

// The lane (within its key group) that holds the score of step u after the
// transposed sum, at index u % NS.
template <int LPK, int U, int LOG_R>
__device__ __forceinline__ constexpr int score_lane(int u) {
  int lane = 0;
#pragma unroll
  for (int k = 0; k < LOG_R; ++k) lane += ((u / (U >> (k + 1))) & 1) * (LPK >> (k + 1));
  return lane;
}

// Sum v[0..U) over the LPK lanes of a key group so that each lane ends with
// NS full sums in v[0..NS): those of steps u = i + (its offset). Each
// halving step keeps one half of the values and trades the other with the
// lane `o` away; the last steps are a plain xor sum.
template <int LPK, int U, int LOG_R>
__device__ __forceinline__ void transpose_sum(float (&v)[U], int sub) {
#pragma unroll
  for (int k = 0; k < LOG_R; ++k) {
    const int o = LPK >> (k + 1);
    const bool up = sub & o;
#pragma unroll
    for (int i = 0; i < U / 2; ++i) {
      if (i < (U >> (k + 1))) {
        const int h = U >> (k + 1);
        const float keep = up ? v[i + h] : v[i];
        const float send = up ? v[i] : v[i + h];
        v[i] = keep + __shfl_xor_sync(kFull, send, o);
      }
    }
  }
#pragma unroll
  for (int o = LPK >> (LOG_R + 1); o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < (U >> LOG_R); ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
}

template <int D, typename T, int GC>
__global__ void __launch_bounds__(kThreads, GC <= 2 ? 2 : 1)
flash_decode_kernel(const FdArgs a) {
  using S = Shape<D, T>;
  constexpr int E = S::E, LPK = S::LPK, NL = S::NL, F = S::F, KPW = S::KPW,
                U = S::U, NS = S::NS, LOG_R = S::LOG_R;
  __shared__ float red[kWarpsPerBlock][GC][D + 2];

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int slot = lane / LPK, sub = lane % LPK;
  int own = 0;   // the first step whose score this lane holds
#pragma unroll
  for (int k = 0; k < LOG_R; ++k) own += ((sub & (LPK >> (k + 1))) != 0) * (U >> (k + 1));
  const int64_t n_chunks = (a.g + GC - 1) / GC;
  const int64_t split = blockIdx.x / n_chunks, g0 = blockIdx.x % n_chunks * GC;
  const int64_t hk = blockIdx.y, b = blockIdx.z;
  const int rows = (int)(a.g - g0 < GC ? a.g - g0 : GC);
  const bool vec16 = a.vec16;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (hk * a.g + g0) * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // per row: q's slice, and the online (m, l, acc); m is the same on every
  // lane of a key group, l sums this lane's own scores only
  float qv[GC][F], m[GC], l[GC], acc[GC][F];
#pragma unroll
  for (int r = 0; r < GC; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      float x[E];
      if (r < rows) {
        unpack(ld16(q + r * a.q_sh + (sub + j * LPK) * E, vec16), x);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qv[r][j * E + e] = x[e] * a.scale;
        acc[r][j * E + e] = 0.f;
      }
    }
  }

  const int64_t k_begin = a.lo + split * a.per;
  const int64_t k_end =
      k_begin + a.per < a.lo + a.n_keys ? k_begin + a.per : a.lo + a.n_keys;
  constexpr int kStep = kWarpsPerBlock * KPW * U;
  for (int64_t base = k_begin + (int64_t)warp * KPW * U; base < k_end; base += kStep) {
    uint4 kr[U][NL], vr[U][NL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t key = base + u * KPW + slot;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        if (key < k_end) {
          const int64_t col = (sub + j * LPK) * E;
          kr[u][j] = ld16(k + key * a.k_ss + col, vec16);
          vr[u][j] = ld16(v + key * a.v_ss + col, vec16);
        }
      }
    }

    // partial dot products of the lane's slice, then the transposed sum
    float s[GC][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[F];
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        float x[E];
        unpack(kr[u][j], x);
#pragma unroll
        for (int e = 0; e < E; ++e) kf[j * E + e] = x[e];
      }
#pragma unroll
      for (int r = 0; r < GC; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) dot = fmaf(qv[r][f], kf[f], dot);
        s[r][u] = dot;
      }
    }
#pragma unroll
    for (int r = 0; r < GC; ++r) transpose_sum<LPK, U, LOG_R>(s[r], sub);

    // this lane's NS scores: softcap, online max over the group, weights
    bool ok[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) ok[i] = base + (int64_t)(own + i) * KPW + slot < k_end;
#pragma unroll
    for (int r = 0; r < GC; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = s[r][i];
        if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
        s[r][i] = a.no_key ? kNeg : x;
        if (ok[i]) mx = fmaxf(mx, s[r][i]);
      }
#pragma unroll
      for (int o = LPK / 2; o >= (LPK >> LOG_R); o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float corr = expf(m[r] - mx);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[r][f] *= corr;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[r][i] = ok[i] ? expf(s[r][i] - mx) : 0.f;
        l[r] += s[r][i];
      }
    }

    // acc += p_u * V_u, p_u from the lane that holds it
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[F];
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        float x[E];
        unpack(vr[u][j], x);
#pragma unroll
        for (int e = 0; e < E; ++e) vf[j * E + e] = x[e];
      }
#pragma unroll
      for (int r = 0; r < GC; ++r) {
        const float p = LPK == 1 ? s[r][u % NS]
            : __shfl_sync(kFull, s[r][u % NS], score_lane<LPK, U, LOG_R>(u), LPK);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[r][f] = fmaf(p, vf[f], acc[r][f]);
      }
    }
  }

  // l over the lanes of a key group that hold distinct scores
#pragma unroll
  for (int r = 0; r < GC; ++r)
#pragma unroll
    for (int o = LPK / 2; o >= (LPK >> LOG_R); o >>= 1)
      l[r] += __shfl_xor_sync(kFull, l[r], o);

  // merge the KPW key groups of the warp (lanes sub, sub + LPK, ...)
#pragma unroll
  for (int off = kWarp / 2; off >= LPK; off >>= 1) {
#pragma unroll
    for (int r = 0; r < GC; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], off);
      const float lb = __shfl_xor_sync(kFull, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float wa = expf(m[r] - mx), wb = expf(mo - mx);
      m[r] = mx;
      l[r] = l[r] * wa + lb * wb;
#pragma unroll
      for (int f = 0; f < F; ++f)
        acc[r][f] = acc[r][f] * wa + __shfl_xor_sync(kFull, acc[r][f], off) * wb;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int r = 0; r < GC; ++r) {
#pragma unroll
      for (int j = 0; j < NL; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) red[warp][r][(sub + j * LPK) * E + e] = acc[r][j * E + e];
      if (sub == 0) {
        red[warp][r][D] = m[r];
        red[warp][r][D + 1] = l[r];
      }
    }
  }
  __syncthreads();

  // merge the warps: one (row, element) per thread and pass
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) mx = fmaxf(mx, red[w][r][D]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      const float wt = expf(red[w][r][D] - mx);
      num = fmaf(wt, red[w][r][d], num);
      den = fmaf(wt, red[w][r][D + 1], den);
    }
    const int64_t h = hk * a.g + g0 + r;
    if (a.n_splits == 1) {
      put(static_cast<T*>(a.out) + (b * a.hq + h) * D + d, num / fmaxf(den, 1e-30f));
    } else {
      float* o = a.ws + (((b * a.hkv + hk) * a.n_splits + split) * a.g + g0 + r) * (D + 2);
      o[d] = num;
      if (d == 0) {
        o[D] = mx;
        o[D + 1] = den;
      }
    }
  }
}

// out[b, 0, h] = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), w_s =
// exp(m_s - max_s m_s), over the splits in order; one block per (h, b),
// two elements per thread (rows of D + 2 floats are 8-byte aligned).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine(const FdArgs a, int64_t d) {
  const int64_t h = blockIdx.x, b = blockIdx.y;
  const int64_t hk = h / a.g, gi = h % a.g;
  const int64_t stride = a.g * (d + 2);
  const float* ws = a.ws + ((b * a.hkv + hk) * a.n_splits * a.g + gi) * (d + 2);
  float mx = kNeg;
#pragma unroll 4
  for (int64_t s = 0; s < a.n_splits; ++s) mx = fmaxf(mx, ws[s * stride + d]);
  float den = 0.f;
#pragma unroll 4
  for (int64_t s = 0; s < a.n_splits; ++s)
    den = fmaf(expf(ws[s * stride + d] - mx), ws[s * stride + d + 1], den);
  den = fmaxf(den, 1e-30f);
  T* out = static_cast<T*>(a.out) + (b * a.hq + h) * d;
  for (int64_t e = 2 * threadIdx.x; e < d; e += 2 * kCombineThreads) {
    float2 num = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int64_t s = 0; s < a.n_splits; ++s) {
      const float* p = ws + s * stride;
      const float wt = expf(p[d] - mx);
      const float2 x = *reinterpret_cast<const float2*>(p + e);
      num.x = fmaf(wt, x.x, num.x);
      num.y = fmaf(wt, x.y, num.y);
    }
    put(out + e, num.x / den);
    put(out + e + 1, num.y / den);
  }
}

using SplitKernel = void (*)(FdArgs);

template <int D, typename T>
SplitKernel pick_gc(int gc) {
  if (gc == 1) return flash_decode_kernel<D, T, 1>;
  if (gc == 2) return flash_decode_kernel<D, T, 2>;
  if (gc == 4) return flash_decode_kernel<D, T, 4>;
  return nullptr;
}

template <typename T>
SplitKernel pick_d(int64_t d, int gc) {
  switch (d) {
    case 8: return pick_gc<8, T>(gc);
    case 16: return pick_gc<16, T>(gc);
    case 32: return pick_gc<32, T>(gc);
    case 64: return pick_gc<64, T>(gc);
    case 128: return pick_gc<128, T>(gc);
    case 256: return pick_gc<256, T>(gc);
    default: return nullptr;
  }
}

// the split kernel for head dim d, type and row chunk gc (null: none)
SplitKernel pick(int64_t d, int bf16, int gc) {
  return bf16 ? pick_d<__nv_bfloat16>(d, gc) : pick_d<float>(d, gc);
}

}  // namespace
}  // namespace repro_torch

extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, void* out, float* ws,
    int64_t B, int64_t Hq, int64_t Hkv, int64_t D, int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t lo, int64_t n_keys, int64_t per, int64_t n_splits,
    int gc, float cap, int no_key, int bf16, int vec16, void* stream) {
  using namespace repro_torch;
  const SplitKernel kernel = pick(D, bf16, gc);
  if (kernel == nullptr || n_splits < 1 || (n_splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const FdArgs a{q,    k,    v,    out,  ws,     q_sb,   q_sh,     k_sb,
                 k_ss, k_sh, v_sb, v_ss, v_sh,   Hq,     Hkv,      Hq / Hkv,
                 lo,   n_keys, per, n_splits, cap, (float)(1.0 / sqrt((double)D)),
                 no_key, vec16};
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t n_chunks = (a.g + gc - 1) / gc;
  kernel<<<dim3((unsigned)(n_splits * n_chunks), (unsigned)Hkv, (unsigned)B), kThreads, 0,
           st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  const dim3 grid((unsigned)Hq, (unsigned)B);
  if (bf16)
    flash_decode_combine<__nv_bfloat16><<<grid, kCombineThreads, 0, st>>>(a, D);
  else
    flash_decode_combine<float><<<grid, kCombineThreads, 0, st>>>(a, D);
  return (int)cudaGetLastError();
}

// How many split-kernel CTAs of this instantiation one SM holds at once.
extern "C" int flash_decode_ctas_per_sm(int64_t D, int bf16, int gc, int* per_sm) {
  using namespace repro_torch;
  const SplitKernel kernel = pick(D, bf16, gc);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
}
