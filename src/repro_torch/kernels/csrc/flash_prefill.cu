// flash_prefill: flash_attention at Sq > 1 in bf16 on Hopper's tensor cores
// (wgmma), K/V tiles brought by TMA. q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]
// bf16, read in place through their strides (every base and stride 16-byte
// aligned, last dimension contiguous), D in {64, 128, 256} -> out
// [B, Sq, Hq, D] bf16 contiguous. Causal mask, sliding window, logit
// softcap, query offset and valid KV length as in flash_attention.cu.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// _flash_attention_impl (body `_kernel`) for the bf16 prefill, the attention
// of every layer of the LM serving path's prefill. flash_attention.cu keeps
// f32 and the shapes this kernel does not take; flash_decode.cu one query.
//
// Bound on an H100: 4*D FLOPs per unmasked (query, key) pair and query head
// against the 989 TFLOP/s bf16 tensor-core peak. This kernel does 6*D: P
// goes through the tensor cores as two bf16 terms (below), so its own floor
// is 1.5x that bound.
//
// Arithmetic (the plain version is ref.flash_prefill):
//   1. S = Q.K^T on bf16 wgmma with f32 accumulation;
//   2. times 1/sqrt(D) in f32 after the product;
//   3. softcap as cap * tanh(s / cap) with tanh = 1 - 2 / (1 + 2^(2|y| log2 e))
//      on ex2.approx, sign restored: within ~1e-7, where tanh.approx's 2^-11
//      relative error, through cap = 50, puts the output at about 10x the
//      attention's limit; then the mask with the finite NEG = -1e30;
//   4. online (m, l) in f32 in base 2 (log2 e folded into the scores), exp
//      on ex2.approx;
//   5. O += P_hi.V + P_lo.V, p_hi = bf16(p), p_lo = bf16(p - p_hi): one bf16
//      P puts the output at 35x the limit, the pair at 0.98x
//      (tools/prefill_precision.py, gemma2-2b's heads over 4096 tokens); P
//      stays in registers as wgmma's A operand, V is read from shared memory
//      as a transposed B;
//   6. O / max(l, 1e-30), rounded once to bf16; when asked (a non-null
//      lse), each row's lse2 = m + log2(l) in f32, the log-sum-exp in base
//      2 that flash_backward_tc.cu takes (O is the same either way).
//
// Design. One CTA owns (b, kv head, 128-row tile) and walks its KV tiles
// itself. Rows are the flattened (query position, group head) pairs of the
// KV head, r = qi * G + g, so each K/V tile serves all G query heads. Two
// warpgroups of 128 threads each own 64 rows (wgmma's M). Q is loaded once
// with 16-byte loads and stored in the 128-byte-swizzled layout wgmma
// reads; K and V come as 64-key tiles by TMA (64-element boxes along D,
// 128-byte swizzle, the map's key extent cut at kv_len so that keys past it
// arrive as zeros) into a ring of two stages with mbarriers: thread 0 loads
// tile i + 2 into the stage that both warpgroups released after tile i, so
// the next tile's load overlaps this tile's math. Fully masked tiles are
// never visited (the Pallas block skip over the tile's first and last
// rows); only tiles that cross the diagonal, the window edge or kv_len are
// masked per element. Keys at or past kv_len score NEG_PAD = -2e30, below
// NEG, so they get p = 0 even in a row that sees no key: such a row must
// give the masked softmax's uniform mean of v[:kv_len]. The rows that see no
// key are the latest ones, so a tile whose last row sees none walks all of
// [0, kv_len). Grid order is longest tiles first. Shared memory is
// 768 * D bytes (192 KiB at D = 256: Q 64 KiB, two stages of K and V 128
// KiB); at D = 256 a thread holds O (128 floats), S (32) and P hi/lo (32
// words), in 256 threads with no producer warp, so no setmaxnreg.
#include <cmath>

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegPad = -2e30f;           // keys at or past kv_len
constexpr int kFpThreads = 256;             // two warpgroups
constexpr int kRows = 128;                  // rows per CTA, 64 per warpgroup
constexpr int kKeys = 64;                   // keys per KV tile

struct FpArgs {
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  float* lse;                    // [B, Hq, Sq] lse2 = m + log2(l), or null
  int64_t q_sb, q_ss, q_sh;
  int64_t sq, hq;
  int g, n_rows;                 // n_rows = sq * g per (b, kv head)
  int kv_len, q_offset, window;  // window < 0: none
  float cap, inv_cap;            // cap <= 0: no softcap
  float scale;
  int causal;
};

template <int D>
constexpr int smem_bytes() { return 768 * D + 6 * 8 + 1024; }

// the rows that see no key are the latest: does position p see none?
__device__ __forceinline__ bool sees_no_key(int p, const FpArgs& a) {
  const int lo = a.window >= 0 ? max(0, p - a.window + 1) : 0;
  const int hi = a.causal ? min(a.kv_len, p + 1) : a.kv_len;
  return lo >= hi;
}

// thread 0: K and V of tile i (keys k0..k0+63) by TMA into stage i % 2
template <int NC>
__device__ __forceinline__ void load_tile(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                          uint32_t s_k, uint32_t s_v, uint32_t full_k,
                                          uint32_t full_v, int i, int k0, int hk, int b) {
  const int st = i & 1;
  mbar_expect_tx(full_k + 8 * st, NC * kBox);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load_4d(s_k + st * NC * kBox + c * kBox, kmap, full_k + 8 * st, c * 64, k0, hk, b);
  mbar_expect_tx(full_v + 8 * st, NC * kBox);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load_4d(s_v + st * NC * kBox + c * kBox, vmap, full_v + 8 * st, c * 64, k0, hk, b);
}

template <int D>
__global__ void __launch_bounds__(kFpThreads, 1)
flash_prefill_kernel(const FpArgs a, const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap) {
  constexpr int NC = D / 64;           // 64-element (128-byte) chunks of D
  constexpr int TILE = NC * kBox;      // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(base);                  // 2 x [64 rows][D]
  const uint32_t s_k = s_q + 2 * TILE;                  // 2 stages
  const uint32_t s_v = s_k + 2 * TILE;                  // 2 stages
  const uint32_t s_bar = s_v + 2 * TILE;                // full_k[2] full_v[2] empty[2]
  const uint32_t full_k = s_bar, full_v = s_bar + 16, empty = s_bar + 32;

  const int tid = threadIdx.x;
  const int wg = tid / 128, t = tid % 128;
  const int lane = t % kWarp, quad = lane % 4;
  const int tile = (int)gridDim.x - 1 - (int)blockIdx.x;   // longest first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.g;
  const int r0 = tile * kRows;
  const int rows = min(kRows, a.n_rows - r0);

  // the keys this tile walks: the block skip, or all of them when its last
  // row sees none
  const int q_lo = r0 / G + a.q_offset;
  const int q_hi = (r0 + rows - 1) / G + a.q_offset;
  int k_end = a.causal ? min(a.kv_len, q_hi + 1) : a.kv_len;
  int k_begin = a.window >= 0 ? max(0, q_lo - a.window + 1) : 0;
  if (sees_no_key(q_hi, a)) {
    k_begin = 0;
    k_end = a.kv_len;
  }
  k_begin = k_begin / kKeys * kKeys;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, kFpThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < min(n_tiles, 2); ++i)
      load_tile<NC>(&kmap, &vmap, s_k, s_v, full_k, full_v, i, k_begin + i * kKeys, hk, b);
  }

  // Q: 16-byte loads, stored swizzled (the 16-byte chunk c of row r at
  // c ^ (r % 8)) as TMA's 128-byte swizzle would; zeros past the last row
  const __nv_bfloat16* q = a.q + b * a.q_sb + (int64_t)hk * G * a.q_sh;
  for (int i = tid; i < kRows * (D / 8); i += kFpThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const int fr = r0 + r;
      x = __ldg(reinterpret_cast<const uint4*>(q + (fr / G) * a.q_ss + (fr % G) * a.q_sh +
                                               c * 8));
    }
    const int rr = r % 64;
    const uint32_t dst = s_q + (r / 64) * TILE + (c / 8) * kBox + rr * 128 +
                         (((c % 8) ^ (rr % 8)) << 4);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(x.x),
                 "r"(x.y), "r"(x.z), "r"(x.w)
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's two rows of its warpgroup's 64: rw and rw + 8
  const int rw = (t / kWarp) * 16 + lane / 4;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = (r0 + wg * 64 + rw + 8 * h) / G + a.q_offset;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const uint32_t q_base = s_q + wg * TILE;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1, k0 = k_begin + i * kKeys;
    const uint32_t par = (i >> 1) & 1;
    const uint32_t k_base = s_k + st * TILE, v_base = s_v + st * TILE;

    // 1. S = Q.K^T
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    mbar_wait(full_k + 8 * st, par);
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(s, sw128_desc(q_base + c * kBox + kk * 32, 16, 1024),
                     sw128_desc(k_base + c * kBox + kk * 32, 16, 1024), c + kk > 0);
    wg_commit();
    wg_wait0();
    reg_fence(s);

    // 2-4. scale, softcap, mask, online softmax in base 2
    const bool full = k0 + kKeys <= a.kv_len &&
                      (!a.causal || k0 + kKeys - 1 <= q_lo) &&
                      (a.window < 0 || q_hi - k0 < a.window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e;
          float x = s[idx] * a.scale;
          if (a.cap > 0.f) x = a.cap * tanh_accurate(x * a.inv_cap);
          x *= kLog2e;
          if (!full) {
            const int kp = k0 + 8 * j + 2 * quad + e;
            bool ok = kp < a.kv_len;
            if (a.causal) ok = ok && pos[h] >= kp;
            if (a.window >= 0) ok = ok && pos[h] - kp < a.window;
            x = ok ? x : kp < a.kv_len ? kNeg : kNegPad;
          }
          s[idx] = x;
          mx[h] = fmaxf(mx[h], x);
        }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int i2 = 0; i2 < 16; ++i2) {
      const int h = i2 % 2;                // s[2 * i2], s[2 * i2 + 1]: row rw + 8h
      const float p0 = ex2(s[2 * i2] - m[h]), p1 = ex2(s[2 * i2 + 1] - m[h]);
      l[h] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      ph[i2] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[i2] = pack_bf16(p0 - hf.x, p1 - hf.y);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) o[4 * j + 2 * h + e] *= corr[h];

    // 5. O += P_hi.V + P_lo.V; P's registers are wgmma's A fragments
    mbar_wait(full_v + 8 * st, par);
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t fa[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
      wgmma_rs_nd<D>(o, fa, sw128_desc(v_base + kk * 2048, kBox, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t fa[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
      wgmma_rs_nd<D>(o, fa, sw128_desc(v_base + kk * 2048, kBox, 1024));
    }
    wg_commit();
    wg_wait0();
    reg_fence(o);
    mbar_arrive(empty + 8 * st);
    if (tid == 0 && i + 2 < n_tiles) {
      mbar_wait(empty + 8 * st, par);
      load_tile<NC>(&kmap, &vmap, s_k, s_v, full_k, full_v, i + 2, k0 + 2 * kKeys, hk, b);
    }
  }

  // 6. O / max(l, 1e-30), rounded once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int fr = r0 + wg * 64 + rw + 8 * h;
    if (fr >= a.n_rows) continue;
    if (a.lse != nullptr && quad == 0)
      a.lse[((int64_t)b * a.hq + (int64_t)hk * G + fr % G) * a.sq + fr / G] =
          m[h] + log2f(l[h]);
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* out =
        a.out + (((int64_t)b * a.sq + fr / G) * a.hq + (int64_t)hk * G + fr % G) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * quad) =
          pack_bf16(o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
  }
}

template <int D>
int launch_fp(const FpArgs& a, const CUtensorMap& km, const CUtensorMap& vm,
              int64_t batch, int64_t hkv, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static_assert(bytes <= 232448, "tile exceeds the per-block shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(a.n_rows, kRows), (unsigned)hkv, (unsigned)batch);
  flash_prefill_kernel<D><<<grid, kFpThreads, bytes, stream>>>(a, km, vm);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, int64_t B,
    int64_t Sq, int64_t Hq, int64_t Hkv, int64_t D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t kv_len, int64_t q_offset, int64_t window, float cap,
    int causal, void* stream) {
  using namespace repro_torch;
  CUtensorMap km, vm;
  if (!tile_map(&km, k, B, kv_len, Hkv, D, k_sb, k_ss, k_sh) ||
      !tile_map(&vm, v, B, kv_len, Hkv, D, v_sb, v_ss, v_sh))
    return (int)cudaErrorInvalidValue;
  const int g = (int)(Hq / Hkv);
  FpArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.sq = Sq;
  a.hq = Hq;
  a.g = g;
  a.n_rows = (int)(Sq * g);
  a.kv_len = (int)kv_len;
  a.q_offset = (int)q_offset;
  a.window = (int)window;
  a.cap = cap;
  a.inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  a.scale = (float)(1.0 / sqrt((double)D));
  a.causal = causal;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_fp<64>(a, km, vm, B, Hkv, st);
    case 128: return launch_fp<128>(a, km, vm, B, Hkv, st);
    case 256: return launch_fp<256>(a, km, vm, B, Hkv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
