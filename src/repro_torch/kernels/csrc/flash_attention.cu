// flash_attention: GQA attention with a causal mask, a sliding window, a
// logit softcap, a query offset and a valid KV length, by online softmax.
// q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] (f32 or bf16, read in place through
// their strides, last dimension contiguous) -> out [B, Sq, Hq, D] contiguous,
// q's dtype.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// _flash_attention_impl (body `_kernel`) for Sq > 1, the attention of every
// layer of the LM serving path's prefill (Sq = S). One query position (the
// decode step) goes to flash_decode.cu.
//
// Bound on an H100: at prefill the 4*D FLOPs per unmasked (query, key) pair
// and query head (against the 989 TFLOP/s bf16 tensor-core peak); with few
// rows the bytes of the live K/V blocks (against 3.35 TB/s). This first version
// multiplies in f32 on the CUDA cores, as the Pallas kernel and the
// reference's chunked attention cast to f32; wgmma, TMA and bf16 tensor
// cores are a later redesign.
//
// Design. The TPU grid (b, kv-head, q-block, kv-block) ran the kv-block axis
// in order on one core, carrying (m, l, acc) in VMEM; here one CTA owns
// (b, kv-head, row tile) and loops over the KV tiles itself. The rows of a
// tile are the flattened (query position, group head) pairs of that KV head,
// r = qi * G + g, so each K/V tile is staged in shared memory once for all G
// query heads, and any G is taken. 256 threads form 16 row groups of 16
// lanes (two per warp): a group owns RT rows, each lane 4 of the 64 keys of
// a tile for the scores and 4-float chunks of D for the output. q is scaled
// by 1/sqrt(D) in f32 as it is staged, as Pallas does. Fully masked KV tiles
// are never visited: the loop runs over the key range the tile's first and
// last rows can see (the Pallas block skip). Masked scores are the finite
// NEG = -1e30 and m starts at NEG, as in Pallas: a row that meets a tile in
// which all of its own keys are masked gets p = 1 there, and the correction
// exp(NEG - m) = 0 of its first real key wipes it out, where -inf would give
// NaN. Keys at or past kv_len are staged as zeros and score the lower
// NEG_PAD = -2e30, so they get p = exp(NEG_PAD - NEG) = 0 even in a row that
// sees no key at all. Such a row (its window starts past the last valid
// key) must give the masked softmax's answer, the uniform mean of
// v[:kv_len]; the rows that see no key are the latest ones, so when the
// tile's last row sees none the tile walks all of [0, kv_len), where that
// row's NEG scores weigh every valid key alike. Shared memory at D = 256
// and RT = 4 is 210 KiB, above the 48 KiB default, so the entry sets the
// opt-in limit for each instantiation.
#include <cmath>

#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegPad = -2e30f;           // keys at or past kv_len
constexpr int kFaThreads = 256;
constexpr int kTX = 16;                     // lanes of a row group
constexpr int kTY = kFaThreads / kTX;       // row groups per CTA
constexpr int kBK = 64;                     // keys per KV tile
constexpr int kCT = kBK / kTX;              // score columns per lane
constexpr int kPad = 4;                     // floats of row padding (banks)

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t sq, hq, g, n_rows;     // n_rows = sq * g per (b, kv head)
  int64_t kv_len, q_offset, window;  // window < 0: none
  float cap;                     // <= 0: no softcap
  float scale;
  int causal;
};

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int D, int RT>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kTY * RT + kBK) * (D + kPad) + (size_t)kBK * D +
          (size_t)kTY * RT * (kBK + 1));
}

template <int D, int RT, typename T>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_attention_kernel(const FaArgs a) {
  constexpr int R = kTY * RT;              // rows per tile
  constexpr int QS = D + kPad;             // Qs / Ks row stride (floats)
  constexpr int PS = kBK + 1;              // Ps row stride
  constexpr int C4 = D / 4;                // 4-float chunks per row
  constexpr int NCH = (C4 + kTX - 1) / kTX;  // output chunks per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + R * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int64_t tile = (int64_t)gridDim.x - 1 - blockIdx.x;  // longest first
  const int64_t hk = blockIdx.y, b = blockIdx.z;
  const int64_t r0 = tile * R;
  const int64_t rows = min64(R, a.n_rows - r0);
  const int64_t G = a.g;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hk * G * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int i = tid; i < R * C4; i += kFaThreads) {
    const int r = i / C4, c4 = i % C4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows) {
      const int64_t fr = r0 + r;
      load4(q + (fr / G) * a.q_ss + (fr % G) * a.q_sh + c4 * 4, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= a.scale;
    }
    store4(Qs + r * QS + c4 * 4, x);
  }

  float m[RT], l[RT], acc[RT][NCH][4];
  int64_t qpos[RT];
  bool live[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = ty * RT + i;
    live[i] = row < rows;
    qpos[i] = (r0 + row) / G + a.q_offset;
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  // a warp holds row groups 2w and 2w+1; a warp with no row computes nothing
  const bool busy = (tid / kWarp) * 2 * RT < rows;

  // the keys this tile's rows can see: the Pallas block skip
  const int64_t q_lo = r0 / G + a.q_offset;
  const int64_t q_hi = (r0 + rows - 1) / G + a.q_offset;
  int64_t k_end = a.kv_len;
  if (a.causal) k_end = min64(k_end, q_hi + 1);
  int64_t k_begin = a.window >= 0 ? max64(0, q_lo - a.window + 1) : 0;
  // the last row sees no key: walk every valid key (see the note above)
  const int64_t last_lo = a.window >= 0 ? max64(0, q_hi - a.window + 1) : 0;
  const int64_t last_hi = a.causal ? min64(a.kv_len, q_hi + 1) : a.kv_len;
  if (last_lo >= last_hi) {
    k_begin = 0;
    k_end = a.kv_len;
  }
  k_begin = k_begin / kBK * kBK;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's K, V and P are no longer read
#pragma unroll 4
    for (int i = tid; i < kBK * C4; i += kFaThreads) {
      const int c = i / C4, c4 = i % C4;
      float x[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + c < a.kv_len) {
        load4(k + (k0 + c) * a.k_ss + c4 * 4, x);
        load4(v + (k0 + c) * a.v_ss + c4 * 4, y);
      }
      store4(Ks + c * QS + c4 * 4, x);
      store4(Vs + c * D + c4 * 4, y);
    }
    __syncthreads();
    if (!busy) continue;

    float s[RT][kCT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < kCT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RT], kv[kCT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * RT + i) * QS + d);
#pragma unroll
      for (int j = 0; j < kCT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + kTX * j) * QS + d);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const int64_t kp = k0 + tx + kTX * j;
        bool ok = live[i] && kp < a.kv_len;
        if (a.causal) ok = ok && qpos[i] >= kp;
        if (a.window >= 0) ok = ok && qpos[i] - kp < a.window;
        float x = s[i][j];
        if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
        s[i][j] = ok ? x : kp < a.kv_len ? kNeg : kNegPad;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * RT + i) * PS + tx + kTX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncwarp();  // a row group's P is written and read by its own 16 lanes

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) p[i] = Ps[(ty * RT + i) * PS + c];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int cc = tx + kTX * ch;
        if (cc < C4) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + c * D + cc * 4);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            acc[i][ch][0] = fmaf(p[i], vv.x, acc[i][ch][0]);
            acc[i][ch][1] = fmaf(p[i], vv.y, acc[i][ch][1]);
            acc[i][ch][2] = fmaf(p[i], vv.z, acc[i][ch][2]);
            acc[i][ch][3] = fmaf(p[i], vv.w, acc[i][ch][3]);
          }
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (!live[i]) continue;
    const int64_t fr = r0 + ty * RT + i;
    T* o = out + ((b * a.sq + fr / G) * a.hq + hk * G + fr % G) * D;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int cc = tx + kTX * ch;
      if (cc < C4) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = acc[i][ch][e] / den;
        store4(o + cc * 4, x);
      }
    }
  }
}

template <int D, int RT, typename T>
int launch_fa(const FaArgs& a, int64_t batch, int64_t hkv, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D, RT>();
  static_assert(bytes <= 232448, "tile exceeds the per-block shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, RT, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(a.n_rows, kTY * RT), (unsigned)hkv,
                  (unsigned)batch);
  flash_attention_kernel<D, RT, T><<<grid, kFaThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_rt(const FaArgs& a, int64_t batch, int64_t hkv, int rt,
              cudaStream_t stream) {
  if (rt == 4) return launch_fa<D, 4, T>(a, batch, hkv, stream);
  if (rt == 1) return launch_fa<D, 1, T>(a, batch, hkv, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_d(const FaArgs& a, int64_t d, int64_t batch, int64_t hkv, int rt,
             cudaStream_t stream) {
  switch (d) {
    case 8: return launch_rt<8, T>(a, batch, hkv, rt, stream);
    case 16: return launch_rt<16, T>(a, batch, hkv, rt, stream);
    case 32: return launch_rt<32, T>(a, batch, hkv, rt, stream);
    case 64: return launch_rt<64, T>(a, batch, hkv, rt, stream);
    case 128: return launch_rt<128, T>(a, batch, hkv, rt, stream);
    case 256: return launch_rt<256, T>(a, batch, hkv, rt, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int64_t B,
    int64_t Sq, int64_t Hq, int64_t Hkv, int64_t D, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t kv_len, int64_t q_offset,
    int64_t window, float cap, int causal, int bf16, int rt, void* stream) {
  using namespace repro_torch;
  const int64_t g = Hq / Hkv;
  const FaArgs a{q,    k,    v,    out,  q_sb,   q_ss,     q_sh,
                 k_sb, k_ss, k_sh, v_sb, v_ss,   v_sh,     Sq,
                 Hq,   g,    Sq * g, kv_len, q_offset, window,
                 cap,  (float)(1.0 / sqrt((double)D)), causal};
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_d<__nv_bfloat16>(a, D, B, Hkv, rt, st)
              : launch_d<float>(a, D, B, Hkv, rt, st);
}
