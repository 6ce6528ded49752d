// flash_backward_tc: the gradient of flash_attention (GQA, causal or not,
// sliding window, logit softcap, q_offset 0, every key valid) with respect
// to q, k and v on Hopper's bf16 tensor cores (wgmma), from the forward's
// per-row log-sum-exp. q/o/dO [B, S, Hq, D], k/v [B, S, Hkv, D] bf16, read
// in place through their strides (every base and stride 16-byte aligned,
// last dimension contiguous), D in {64, 128, 256}, lse [B, Hq, S] f32 in
// base 2 as flash_prefill.cu writes it -> dQ [B, S, Hq, D], dK, dV [B, S,
// Hkv, D] f32, contiguous (the autograd Function in flash_attention.py
// casts them to the operands' dtype).
//
// Replaces no Pallas kernel: the reference has no Pallas backward (its
// training forward runs the pure-JAX chunked_attention, which jax.grad
// differentiates). It is the gradient of flash_prefill.cu's forward for
// the trainer, and takes every call whose forward went through
// flash_prefill (D in {64, 128, 256}); flash_backward.cu keeps f32, the
// other head dims and a forward that saved no lse. Its plain version is
// ref.flash_backward_tc.
//
// Bound on an H100: 10*D FLOPs per visible (query, key) pair and query
// head (S = QK^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ = dS K) over
// the 989 TFLOP/s bf16 tensor-core peak. This pair does 14*D: the dq
// kernel recomputes S and dP rather than sum dQ across key blocks with
// atomics, so its own floor is 1.4x that bound. The row statistics come
// from the forward, so no kernel recomputes them.
//
// Arithmetic (the plain version's rule):
//   s = (q.k) on bf16 wgmma with f32 accumulation, times 1/sqrt(D) after
//   the product; with a softcap t = tanh(s / cap) as flash_prefill.cu takes
//   it (tanh_accurate), s = cap * t; a key is visible when key <= query
//   (causal), query - key < window (when set), both < S;
//   p = 2^(s log2 e - lse2) on ex2.approx, 0 where not visible;
//   dp = dO.v (bf16 wgmma, f32); delta = rowsum(dO * o) in f32;
//   ds = p * (1 - t^2) * (dp - delta), p * (dp - delta) without a softcap;
//   dV += bf16(p)^T dO, dK += bf16(ds)^T q, dQ += bf16(ds) k (wgmma, f32
//   accumulators), dK and dQ times 1/sqrt(D) once at the end.
// P and dS enter the tensor cores as one bf16 term each, as SDPA's flash
// backward rounds them; the gradients are rounded to bf16 afterwards anyway.
//
// Design. Three kernels, one launch entry, no float atomics and a fixed
// summation order, so two runs give the same bits:
//   a. stats: one warp a (b, q head, position) writes (lse2, delta) into a
//      workspace [B, Hq, S_pad] with positions padded to a multiple of 64
//      ((+inf, 0) past S), so that a 64-position tile of it is one 512-byte
//      bulk copy. Bound by bytes: it reads o and dO once.
//   b. dq: flash_prefill's skeleton with one more product. One CTA owns
//      (b, kv head, 128 rows), rows r = position * G + group head, so each
//      K/V tile serves the whole head group; two warpgroups of 64 rows.
//      Q and dO are loaded once (16-byte loads, stored in the swizzled
//      layout); K and V come as tiles of KT keys by TMA through a 2-stage
//      mbarrier ring. A tile: S and dP (A and B from shared memory, two
//      wgmma groups: p is made while dP is in flight), dS in registers,
//      dQ += dS.K (dS's registers as wgmma's A, K read transposed as P.V
//      reads V in the forward).
//   c. dkdv: the transpose. One CTA owns (b, kv head, a block of keys), K
//      and V loaded once by TMA. It walks the G query heads of its kv head and
//      the 64-position query tiles that see its keys (causal: from the
//      block's first key; a window: up to its last key + window), Q, dO and
//      the tile's (lse2, delta) by TMA and a bulk copy through a 2-stage
//      ring. A tile: S^T = K.Q^T and dP^T = V.dO^T, then P^T and dS^T in
//      registers as the A operands of dV += P^T.dO and dK += dS^T.Q (dO and
//      Q read transposed). dK and dV stay in registers for the whole walk:
//      the sum over the group needs no atomics. A warpgroup skips a tile
//      none of whose pairs is visible.
// Both grids run the longest CTAs first. Only tiles that cross the
// diagonal, the window edge or S are masked per element.
//
// Tiling by D (TcShape): a thread has at most 255 registers and a block
// 227 KiB of shared memory.
//   D <= 128: KT = 64 keys a dq tile; a dkdv CTA owns 128 keys, 64 a
//     warpgroup, each holding dK and dV over all of D. At D = 128 a dkdv
//     thread holds dK and dV (64 + 64 floats), S^T and dP^T (32 + 32) and
//     the bf16 P^T and dS^T (16 + 16 words); either kernel's shared memory
//     is 8 tiles of 64 x D bf16 (128 KiB).
//   D = 256: dK and dV over all of D would be 256 floats a thread, so a
//     dkdv CTA (flash_backward_tc_dkdv_d256) owns 64 keys and warpgroup w
//     owns columns [128w, 128w + 128) of their dK and dV (64 + 64 floats a
//     thread, as at D = 128). S^T and dP^T contract over all of D: warpgroup
//     0 computes S^T, warpgroup 1 dP^T, and each hands the other the f32
//     half of its product at the other's 32 positions (16 KiB of shared
//     memory), so each makes P^T and dS^T for 32 positions and writes them
//     as bf16 swizzled tiles (2 x 8 KiB) that both read as wgmma's A from
//     shared memory; two named barriers a tile. Shared memory: K and V (64
//     KiB), the Q/dO ring (128 KiB), those 32 KiB and the stats: 226 KiB of
//     the 227. Computing S^T and dP^T in both warpgroups instead (18*D a
//     pair, no exchange) took 3.27 ms against 2.64 at gemma2-2b's global
//     layer (tools/backward_probe.py). The dq kernel takes K/V tiles of
//     KT = 32 keys (boxes of 32 rows): S and dP are 16 + 16 floats beside
//     dQ's 128, and the ring is 64 KiB beside Q and dO's 128 KiB.
#include <cmath>

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace repro_torch {
namespace {

constexpr int kTcThreads = 256;            // two warpgroups
constexpr int kDqRows = 128;               // dq: rows a CTA, 64 a warpgroup
constexpr int kKeyBlock = 128;             // dkdv at D <= 128: keys a CTA, 64 a warpgroup
constexpr int kTile = 64;                  // dkdv: positions a ring tile
constexpr int kStatsTile = kTile * 8;      // bytes of a tile's (lse2, delta)
constexpr int kXchg = 2 * 64 * 32 * 4;     // dkdv at D = 256: two f32 halves of 64 x 32
constexpr int kSmemLimit = 232448;         // opt-in shared memory of a block

// the tiling of one head dim (the header's "Tiling by D")
template <int D>
struct TcShape {
  static constexpr int NC = D / 64;              // 64-column (128-byte) boxes of D
  static constexpr int TILE = NC * kBox;         // bytes of 64 rows of D
  static constexpr int KT = D == 256 ? 32 : 64;  // dq: keys a K/V ring tile
  static constexpr int KT_BOX = KT * 128;        // bytes of a KT-row box
  static constexpr int KT_TILE = NC * KT_BOX;    // bytes of a K (or V) ring tile
  static constexpr int BARS = 5 * 8 + 1024;      // mbarriers and the 1024-byte alignment
  static constexpr int DQ_SMEM = 4 * TILE + 4 * KT_TILE + BARS;
  // D <= 128: K and V of 128 keys, the Q/dO ring, the stats ring; D = 256:
  // K and V of 64 keys, the rings, the exchange and the bf16 P^T and dS^T
  static constexpr int DKDV_SMEM = D == 256
      ? 6 * TILE + 2 * kStatsTile + kXchg + 2 * kBox + BARS
      : 8 * TILE + 2 * kStatsTile + BARS;
};

struct TcArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* dout;
  const float2* stats;   // [B, Hq, s_pad] (lse2, delta)
  float* dq;             // [B, S, Hq, D]
  float* dk;             // [B, S, Hkv, D]
  float* dv;
  int64_t q_sb, q_ss, q_sh, do_sb, do_ss, do_sh;
  int s, s_pad, hq, hkv, g, n_rows, batch;   // n_rows = s * g
  int window;            // < 0: none
  int causal;
  float cap, inv_cap;    // cap <= 0: no softcap
  float scale;
};

__device__ __forceinline__ bool visible(const TcArgs& a, int i, int j) {
  return i < a.s && j < a.s && (!a.causal || j <= i) && (a.window < 0 || i - j < a.window);
}

// p of one score (before masking) and the softcap's derivative factor
__device__ __forceinline__ float prob(const TcArgs& a, float dot, float lse, float* dcap) {
  float x = dot * a.scale;
  *dcap = 1.f;
  if (a.cap > 0.f) {
    const float t = tanh_accurate(x * a.inv_cap);
    x = a.cap * t;
    *dcap = 1.f - t * t;
  }
  return ex2(x * kLog2e - lse);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_backward_tc_stats(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                        const float* lse, float2* stats, int64_t o_sb, int64_t o_ss,
                        int64_t o_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh, int s,
                        int s_pad, int hq, int64_t n) {
  constexpr int PER = D / kWarp;       // elements a lane
  const int64_t row = (int64_t)blockIdx.x * (kTcThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;
  const int p = (int)(row % s_pad);
  const int64_t bh = row / s_pad;
  if (p >= s) {
    if (lane == 0) stats[row] = make_float2(INFINITY, 0.f);
    return;
  }
  const int64_t h = bh % hq, b = bh / hq;
  const __nv_bfloat16* ob = o + b * o_sb + p * o_ss + h * o_sh + lane * PER;
  const __nv_bfloat16* db = dout + b * do_sb + p * do_ss + h * do_sh + lane * PER;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; i += 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ob + i));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(db + i));
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) stats[row] = make_float2(lse[bh * s + p], sum);
}

// thread 0: K and V of keys k0..k0+KT-1 by TMA into ring stage st
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        uint32_t s_k, uint32_t s_v, uint32_t full, int st,
                                        int k0, int hk, int b) {
  using T = TcShape<D>;
  const uint32_t bar = full + 8 * st;
  mbar_expect_tx(bar, 2 * T::KT_TILE);
#pragma unroll
  for (int c = 0; c < T::NC; ++c) {
    tma_load_4d(s_k + st * T::KT_TILE + c * T::KT_BOX, kmap, bar, c * 64, k0, hk, b);
    tma_load_4d(s_v + st * T::KT_TILE + c * T::KT_BOX, vmap, bar, c * 64, k0, hk, b);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_backward_tc_dq(const TcArgs a, const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap) {
  using T = TcShape<D>;
  constexpr int NC = T::NC, TILE = T::TILE, KT = T::KT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(base);        // 2 x [64 rows][D]
  const uint32_t s_do = s_q + 2 * TILE;       // 2 x [64 rows][D]
  const uint32_t s_k = s_do + 2 * TILE;       // 2 stages of [KT keys][D]
  const uint32_t s_v = s_k + 2 * T::KT_TILE;  // 2 stages
  const uint32_t full = s_v + 2 * T::KT_TILE, empty = full + 16;

  const int tid = threadIdx.x;
  const int wg = tid / 128, t = tid % 128;
  const int lane = t % kWarp, quad = lane % 4;
  const int G = a.g;
  const int per = a.hkv * a.batch;
  const int n_row_tiles = (a.n_rows + kDqRows - 1) / kDqRows;
  const int tile = n_row_tiles - 1 - (int)(blockIdx.x / per);     // longest first
  const int hk = (int)(blockIdx.x % per) % a.hkv, b = (int)(blockIdx.x % per) / a.hkv;
  const int r0 = tile * kDqRows;
  const int rows = min(kDqRows, a.n_rows - r0);

  // the keys this tile's rows see: the causal end, the window's start
  const int q_lo = r0 / G, q_hi = (r0 + rows - 1) / G;
  const int k_end = a.causal ? min(a.s, q_hi + 1) : a.s;
  int k_begin = a.window >= 0 ? max(0, q_lo - a.window + 1) : 0;
  k_begin = k_begin / KT * KT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kTcThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < min(n_tiles, 2); ++i)
      load_kv<D>(&kmap, &vmap, s_k, s_v, full, i, k_begin + i * KT, hk, b);
  }

  // Q and dO rows: 16-byte loads, stored swizzled; zeros past the last row
  for (int i = tid; i < kDqRows * (D / 8); i += kTcThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x;
    if (r < rows) {
      const int fr = r0 + r;
      const int64_t p = fr / G, h = (int64_t)hk * G + fr % G;
      x = __ldg(reinterpret_cast<const uint4*>(a.q + b * a.q_sb + p * a.q_ss + h * a.q_sh +
                                               c * 8));
      y = __ldg(reinterpret_cast<const uint4*>(a.dout + b * a.do_sb + p * a.do_ss +
                                               h * a.do_sh + c * 8));
    }
    const int rr = r % 64;
    const uint32_t off = (r / 64) * TILE + (c / 8) * kBox + rr * 128 +
                         (((c % 8) ^ (rr % 8)) << 4);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(s_q + off), "r"(x.x),
                 "r"(x.y), "r"(x.z), "r"(x.w)
                 : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(s_do + off), "r"(y.x),
                 "r"(y.y), "r"(y.z), "r"(y.w)
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's two rows of its warpgroup's 64: rw and rw + 8; rows past
  // the last get lse = +inf, so p = 0
  const int rw = (t / kWarp) * 16 + lane / 4;
  int pos[2];
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = r0 + wg * 64 + rw + 8 * h;
    pos[h] = fr / G;
    lse[h] = INFINITY;
    delta[h] = 0.f;
    if (fr < a.n_rows) {
      const float2 st =
          a.stats[((int64_t)b * a.hq + (int64_t)hk * G + fr % G) * a.s_pad + pos[h]];
      lse[h] = st.x;
      delta[h] = st.y;
    }
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const uint32_t q_base = s_q + wg * TILE, do_base = s_do + wg * TILE;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1, k0 = k_begin + i * KT;
    const uint32_t par = (i >> 1) & 1;
    const uint32_t k_base = s_k + st * T::KT_TILE, v_base = s_v + st * T::KT_TILE;

    // S = Q.K^T, dP = dO.V^T
    float s[KT / 2], dp[KT / 2];
#pragma unroll
    for (int j = 0; j < KT / 2; ++j) s[j] = dp[j] = 0.f;
    mbar_wait(full + 8 * st, par);
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_nn<KT>(s, sw128_desc(q_base + c * kBox + kk * 32, 16, 1024),
                        sw128_desc(k_base + c * T::KT_BOX + kk * 32, 16, 1024), c + kk > 0);
    wg_commit();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_nn<KT>(dp, sw128_desc(do_base + c * kBox + kk * 32, 16, 1024),
                        sw128_desc(v_base + c * T::KT_BOX + kk * 32, 16, 1024), c + kk > 0);
    wg_commit();
    wg_wait<1>();
    reg_fence(s);

    // p * dcap in place of s while dP is in flight (0 where not visible)
    const bool all = k0 + KT <= a.s && (!a.causal || k0 + KT - 1 <= q_lo) &&
                     (a.window < 0 || q_hi - k0 < a.window);
#pragma unroll
    for (int w = 0; w < KT / 4; ++w) {
      const int j = w / 2, h = w % 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float dc;
        const float p = prob(a, s[2 * w + e], lse[h], &dc);
        const bool ok = all || visible(a, pos[h], k0 + 8 * j + 2 * quad + e);
        s[2 * w + e] = ok ? p * dc : 0.f;
      }
    }
    wg_wait0();
    reg_fence(dp);

    // dS in registers, bf16, as wgmma's A fragments (word 2j + h: row
    // rw + 8h, keys k0 + 8j + 2 quad + {0, 1})
    uint32_t ds[KT / 4];
#pragma unroll
    for (int w = 0; w < KT / 4; ++w) {
      const int h = w % 2;
      ds[w] = pack_bf16(s[2 * w] * (dp[2 * w] - delta[h]),
                        s[2 * w + 1] * (dp[2 * w + 1] - delta[h]));
    }

    // dQ += dS.K, K read transposed
    reg_fence(dq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t fa[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
      wgmma_rs_nd<D>(dq, fa, sw128_desc(k_base + kk * 2048, T::KT_BOX, 1024));
    }
    wg_commit();
    wg_wait0();
    reg_fence(dq);
    mbar_arrive(empty + 8 * st);
    if (tid == 0 && i + 2 < n_tiles) {
      mbar_wait(empty + 8 * st, par);
      load_kv<D>(&kmap, &vmap, s_k, s_v, full, st, k0 + 2 * KT, hk, b);
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = r0 + wg * 64 + rw + 8 * h;
    if (fr >= a.n_rows) continue;
    float* out = a.dq + (((int64_t)b * a.s + fr / G) * a.hq + (int64_t)hk * G + fr % G) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * quad) =
          make_float2(dq[4 * j + 2 * h] * a.scale, dq[4 * j + 2 * h + 1] * a.scale);
  }
}

// thread 0: Q, dO and (lse2, delta) of ring step i (query head gi, tile q0)
// into stage i % 2
template <int NC>
__device__ __forceinline__ void load_q(const TcArgs& a, const CUtensorMap* qmap,
                                       const CUtensorMap* domap, uint32_t s_q, uint32_t s_do,
                                       uint32_t s_st, uint32_t full, int i, int n_qt,
                                       int q_lo, int hk, int b) {
  const int st = i & 1, h = hk * a.g + i / n_qt, q0 = q_lo + (i % n_qt) * kTile;
  const uint32_t bar = full + 8 * st;
  mbar_expect_tx(bar, 2 * NC * kBox + kStatsTile);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    tma_load_4d(s_q + st * NC * kBox + c * kBox, qmap, bar, c * 64, q0, h, b);
    tma_load_4d(s_do + st * NC * kBox + c * kBox, domap, bar, c * 64, q0, h, b);
  }
  bulk_load(s_st + st * kStatsTile, a.stats + ((int64_t)b * a.hq + h) * a.s_pad + q0,
            kStatsTile, bar);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_backward_tc_dkdv(const TcArgs a, const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap) {
  constexpr int NC = D / 64;
  constexpr int TILE = NC * kBox;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_k = smem_u32(base);        // 2 x [64 keys][D], one a warpgroup
  const uint32_t s_v = s_k + 2 * TILE;
  const uint32_t s_q = s_v + 2 * TILE;        // 2 stages of [64 positions][D]
  const uint32_t s_do = s_q + 2 * TILE;
  const uint32_t s_st = s_do + 2 * TILE;      // 2 stages of 64 (lse2, delta)
  const uint32_t full = s_st + 2 * kStatsTile, empty = full + 16, kv = full + 32;
  const float* stats_smem = reinterpret_cast<const float*>(base + 8 * TILE);

  const int tid = threadIdx.x;
  const int wg = tid / 128, t = tid % 128;
  const int lane = t % kWarp, quad = lane % 4;
  const int per = a.hkv * a.batch;
  const int k0 = (int)(blockIdx.x / per) * kKeyBlock;   // longest first (causal)
  const int hk = (int)(blockIdx.x % per) % a.hkv, b = (int)(blockIdx.x % per) / a.hkv;

  // the query tiles that see some key of the block, for each of the G heads
  const int q_lo = a.causal ? k0 : 0;
  const int q_end = a.window >= 0 ? min(a.s, k0 + kKeyBlock - 1 + a.window) : a.s;
  const int n_qt = (q_end - q_lo + kTile - 1) / kTile;
  const int n_it = a.g * n_qt;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kTcThreads);
    }
    mbar_init(kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv, 4 * TILE);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_4d(s_k + w * TILE + c * kBox, &kmap, kv, c * 64, k0 + w * 64, hk, b);
        tma_load_4d(s_v + w * TILE + c * kBox, &vmap, kv, c * 64, k0 + w * 64, hk, b);
      }
    for (int i = 0; i < min(n_it, 2); ++i)
      load_q<NC>(a, &qmap, &domap, s_q, s_do, s_st, full, i, n_qt, q_lo, hk, b);
  }

  // this thread's two keys of its warpgroup's 64: rw and rw + 8
  const int rw = (t / kWarp) * 16 + lane / 4;
  const int kw0 = k0 + wg * 64;
  const int key[2] = {kw0 + rw, kw0 + rw + 8};
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_base = s_k + wg * TILE, v_base = s_v + wg * TILE;
  mbar_wait(kv, 0);

  for (int i = 0; i < n_it; ++i) {
    const int st = i & 1, q0 = q_lo + (i % n_qt) * kTile;
    const uint32_t par = (i >> 1) & 1;
    const uint32_t q_base = s_q + st * TILE, do_base = s_do + st * TILE;
    // does any (position, key) pair of this tile and warpgroup see the other?
    const bool any = kw0 < a.s && (!a.causal || q0 + kTile - 1 >= kw0) &&
                     (a.window < 0 || q0 - (kw0 + 63) < a.window);
    mbar_wait(full + 8 * st, par);
    if (any) {
      // S^T = K.Q^T, dP^T = V.dO^T: rows are keys, columns positions
      float s[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      reg_fence(s);
      reg_fence(dp);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(s, sw128_desc(k_base + c * kBox + kk * 32, 16, 1024),
                       sw128_desc(q_base + c * kBox + kk * 32, 16, 1024), c + kk > 0);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(dp, sw128_desc(v_base + c * kBox + kk * 32, 16, 1024),
                       sw128_desc(do_base + c * kBox + kk * 32, 16, 1024), c + kk > 0);
      wg_commit();
      wg_wait0();
      reg_fence(s);
      reg_fence(dp);

      // P^T and dS^T in registers, bf16, as wgmma's A fragments (word
      // 2j + h: key rw + 8h, positions q0 + 8j + 2 quad + {0, 1})
      const bool all = q0 + kTile <= a.s && kw0 + 64 <= a.s &&
                       (!a.causal || q0 >= kw0 + 63) &&
                       (a.window < 0 || q0 + kTile - 1 - kw0 < a.window);
      const float* sts = stats_smem + st * (kStatsTile / 4);
      uint32_t pt[16], dst[16];
#pragma unroll
      for (int w = 0; w < 16; ++w) {
        const int j = w / 2, h = w % 2, col = 8 * j + 2 * quad;
        const float4 ld = *reinterpret_cast<const float4*>(sts + 2 * col);
        float pv[2], dv2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float dc;
          const float p = prob(a, s[2 * w + e], e ? ld.z : ld.x, &dc);
          const bool ok = all || visible(a, q0 + col + e, key[h]);
          pv[e] = ok ? p : 0.f;
          dv2[e] = ok ? p * dc * (dp[2 * w + e] - (e ? ld.w : ld.y)) : 0.f;
        }
        pt[w] = pack_bf16(pv[0], pv[1]);
        dst[w] = pack_bf16(dv2[0], dv2[1]);
      }

      // dV += P^T.dO, dK += dS^T.Q, dO and Q read transposed
      reg_fence(dv);
      reg_fence(dk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t fa[4] = {pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2], pt[4 * kk + 3]};
        wgmma_rs_nd<D>(dv, fa, sw128_desc(do_base + kk * 2048, kBox, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t fa[4] = {dst[4 * kk], dst[4 * kk + 1], dst[4 * kk + 2],
                                dst[4 * kk + 3]};
        wgmma_rs_nd<D>(dk, fa, sw128_desc(q_base + kk * 2048, kBox, 1024));
      }
      wg_commit();
      wg_wait0();
      reg_fence(dv);
      reg_fence(dk);
    }
    mbar_arrive(empty + 8 * st);
    if (tid == 0 && i + 2 < n_it) {
      mbar_wait(empty + 8 * st, par);
      load_q<NC>(a, &qmap, &domap, s_q, s_do, s_st, full, i + 2, n_qt, q_lo, hk, b);
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= a.s) continue;
    const int64_t row = (((int64_t)b * a.s + key[h]) * a.hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(a.dk + row + 8 * j + 2 * quad) =
          make_float2(dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dv + row + 8 * j + 2 * quad) =
          make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// D = 256, warpgroup W of dkdv_d256 after its product (W = 0: S^T, W = 1:
// dP^T, both [64 keys][64 positions] in wgmma's accumulator layout): it
// hands the half of its accumulator at the other warpgroup's positions
// over through `xs` (f32, by thread fragment) and takes the other's at its
// own, positions [32W, 32W + 32); then writes P^T and dS^T of those as bf16
// into the swizzled tiles at s_p and s_ds, where both warpgroups read them
// as wgmma's A (word 2j + h of a thread: key rw + 8h, positions
// 8j + 2 quad + {0, 1}, 16-byte chunk j of the key's 128-byte row)
template <int W>
__device__ __forceinline__ void exchange_half(const TcArgs& a, const float (&acc)[32],
                                              float4* xs, uint32_t s_p, uint32_t s_ds,
                                              const float* sts, int q0, int k0, int rw,
                                              int quad, int t, const int (&key)[2]) {
  constexpr int mine = 4 * W, theirs = 4 * (1 - W);   // first float4 of each half
#pragma unroll
  for (int u = 0; u < 4; ++u)
    xs[W * 512 + u * 128 + t] =
        make_float4(acc[4 * (theirs + u)], acc[4 * (theirs + u) + 1],
                    acc[4 * (theirs + u) + 2], acc[4 * (theirs + u) + 3]);
  bar_sync(1, kTcThreads);
  const bool all = q0 + kTile <= a.s && k0 + 64 <= a.s && (!a.causal || q0 >= k0 + 63) &&
                   (a.window < 0 || q0 + kTile - 1 - k0 < a.window);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 x = xs[(1 - W) * 512 + u * 128 + t];
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int w = 2 * (mine + u) + v, j = w / 2, h = w % 2, col = 8 * j + 2 * quad;
      const float4 ld = *reinterpret_cast<const float4*>(sts + 2 * col);
      float pv[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sv = W == 0 ? acc[2 * w + e] : xv[2 * v + e];
        const float dpv = W == 0 ? xv[2 * v + e] : acc[2 * w + e];
        float dc;
        const float p = prob(a, sv, e ? ld.z : ld.x, &dc);
        const bool ok = all || visible(a, q0 + col + e, key[h]);
        pv[e] = ok ? p : 0.f;
        dsv[e] = ok ? p * dc * (dpv - (e ? ld.w : ld.y)) : 0.f;
      }
      const int r = rw + 8 * h;
      const uint32_t off = r * 128 + ((j ^ (r % 8)) << 4) + 4 * quad;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(s_p + off), "r"(pack_bf16(pv[0], pv[1]))
                   : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(s_ds + off),
                   "r"(pack_bf16(dsv[0], dsv[1]))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// dkdv at D = 256 (the header's "Tiling by D"): one CTA owns 64 keys;
// warpgroup 0 computes S^T = K.Q^T, warpgroup 1 dP^T = V.dO^T, each over all
// of D; they trade halves (exchange_half) and make P^T and dS^T for 32
// positions each; then warpgroup w adds P^T.dO and dS^T.Q into columns
// [128w, 128w + 128) of dV and dK. Named barrier 1: the halves are in xs;
// 2: P^T and dS^T are written (and, for the next tile, read: a warpgroup
// reaches barrier 1 again only after its products have completed).
__global__ void __launch_bounds__(kTcThreads, 1)
flash_backward_tc_dkdv_d256(const TcArgs a, const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap domap) {
  constexpr int D = 256, NC = 4, TILE = NC * kBox, DW = 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_k = smem_u32(base);        // [64 keys][D]
  const uint32_t s_v = s_k + TILE;
  const uint32_t s_q = s_v + TILE;            // 2 stages of [64 positions][D]
  const uint32_t s_do = s_q + 2 * TILE;
  const uint32_t s_st = s_do + 2 * TILE;      // 2 stages of 64 (lse2, delta)
  const uint32_t s_x = s_st + 2 * kStatsTile; // the halves handed over
  const uint32_t s_p = s_x + kXchg;           // P^T, bf16, one swizzled box
  const uint32_t s_ds = s_p + kBox;           // dS^T
  const uint32_t full = s_ds + kBox, empty = full + 16, kv = full + 32;
  const float* stats_smem = reinterpret_cast<const float*>(base + 6 * TILE);
  float4* xs = reinterpret_cast<float4*>(base + 6 * TILE + 2 * kStatsTile);

  const int tid = threadIdx.x;
  const int wg = tid / 128, t = tid % 128;
  const int lane = t % kWarp, quad = lane % 4;
  const int per = a.hkv * a.batch;
  const int k0 = (int)(blockIdx.x / per) * 64;   // longest first (causal)
  const int hk = (int)(blockIdx.x % per) % a.hkv, b = (int)(blockIdx.x % per) / a.hkv;
  const int q_lo = a.causal ? k0 : 0;
  const int q_end = a.window >= 0 ? min(a.s, k0 + 63 + a.window) : a.s;
  const int n_qt = (q_end - q_lo + kTile - 1) / kTile;
  const int n_it = a.g * n_qt;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kTcThreads);
    }
    mbar_init(kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv, 2 * TILE);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load_4d(s_k + c * kBox, &kmap, kv, c * 64, k0, hk, b);
      tma_load_4d(s_v + c * kBox, &vmap, kv, c * 64, k0, hk, b);
    }
    for (int i = 0; i < min(n_it, 2); ++i)
      load_q<NC>(a, &qmap, &domap, s_q, s_do, s_st, full, i, n_qt, q_lo, hk, b);
  }

  // this thread's two keys: rw and rw + 8; its columns of dK and dV
  const int rw = (t / kWarp) * 16 + lane / 4;
  const int key[2] = {k0 + rw, k0 + rw + 8};
  const int col0 = wg * DW;
  float dk[DW / 2], dv[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t a_base = wg == 0 ? s_k : s_v;
  mbar_wait(kv, 0);

  for (int i = 0; i < n_it; ++i) {
    const int st = i & 1, q0 = q_lo + (i % n_qt) * kTile;
    const uint32_t par = (i >> 1) & 1;
    const uint32_t q_base = s_q + st * TILE, do_base = s_do + st * TILE;
    const uint32_t b_base = wg == 0 ? q_base : do_base;
    // does any (position, key) pair of this tile see the other? (the same
    // answer in both warpgroups, so both meet the named barriers)
    const bool any = k0 < a.s && (!a.causal || q0 + kTile - 1 >= k0) &&
                     (a.window < 0 || q0 - (k0 + 63) < a.window);
    mbar_wait(full + 8 * st, par);
    if (any) {
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(acc, sw128_desc(a_base + c * kBox + kk * 32, 16, 1024),
                       sw128_desc(b_base + c * kBox + kk * 32, 16, 1024), c + kk > 0);
      wg_commit();
      wg_wait0();
      reg_fence(acc);
      const float* sts = stats_smem + st * (kStatsTile / 4);
      if (wg == 0)
        exchange_half<0>(a, acc, xs, s_p, s_ds, sts, q0, k0, rw, quad, t, key);
      else
        exchange_half<1>(a, acc, xs, s_p, s_ds, sts, q0, k0, rw, quad, t, key);
      bar_sync(2, kTcThreads);

      // dV += P^T.dO, dK += dS^T.Q over this warpgroup's columns, dO and Q
      // read transposed
      reg_fence(dv);
      reg_fence(dk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128_t(dv, sw128_desc(s_p + kk * 32, 16, 1024),
                        sw128_desc(do_base + (col0 / 64) * kBox + kk * 2048, kBox, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128_t(dk, sw128_desc(s_ds + kk * 32, 16, 1024),
                        sw128_desc(q_base + (col0 / 64) * kBox + kk * 2048, kBox, 1024));
      wg_commit();
      wg_wait0();
      reg_fence(dv);
      reg_fence(dk);
    }
    mbar_arrive(empty + 8 * st);
    if (tid == 0 && i + 2 < n_it) {
      mbar_wait(empty + 8 * st, par);
      load_q<NC>(a, &qmap, &domap, s_q, s_do, s_st, full, i + 2, n_qt, q_lo, hk, b);
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= a.s) continue;
    const int64_t row = (((int64_t)b * a.s + key[h]) * a.hkv + hk) * D + col0;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      *reinterpret_cast<float2*>(a.dk + row + 8 * j + 2 * quad) =
          make_float2(dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dv + row + 8 * j + 2 * quad) =
          make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

template <int D>
int launch_tc(const TcArgs& a, const CUtensorMap (&maps)[6], const __nv_bfloat16* o,
              const float* lse, float2* stats, const int64_t* o_s, cudaStream_t stream) {
  using T = TcShape<D>;
  static_assert(T::DQ_SMEM <= kSmemLimit, "dq's tiles exceed the per-block shared memory");
  static_assert(T::DKDV_SMEM <= kSmemLimit, "dkdv's tiles exceed the per-block shared memory");
  int err;
  if ((err = (int)cudaFuncSetAttribute(flash_backward_tc_dq<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       T::DQ_SMEM)))
    return err;
  const auto dkdv = [] {
    if constexpr (D == 256) return flash_backward_tc_dkdv_d256;
    else return flash_backward_tc_dkdv<D>;
  }();
  if ((err = (int)cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       T::DKDV_SMEM)))
    return err;
  const int64_t n = (int64_t)a.batch * a.hq * a.s_pad;
  const int64_t per = (int64_t)a.hkv * a.batch;
  const unsigned stats_grid = (unsigned)ceil_div(n, kTcThreads / kWarp);
  flash_backward_tc_stats<D><<<stats_grid, kTcThreads, 0, stream>>>(
      o, a.dout, lse, stats, o_s[0], o_s[1], o_s[2], a.do_sb, a.do_ss, a.do_sh, a.s, a.s_pad,
      a.hq, n);
  if ((err = (int)cudaGetLastError())) return err;
  const unsigned dq_grid = (unsigned)(ceil_div(a.n_rows, kDqRows) * per);
  flash_backward_tc_dq<D><<<dq_grid, kTcThreads, T::DQ_SMEM, stream>>>(a, maps[4], maps[5]);
  if ((err = (int)cudaGetLastError())) return err;
  const unsigned dkdv_grid = (unsigned)(ceil_div(a.s, D == 256 ? 64 : kKeyBlock) * per);
  dkdv<<<dkdv_grid, kTcThreads, T::DKDV_SMEM, stream>>>(a, maps[0], maps[1], maps[2], maps[3]);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// strides: 5 groups of [batch, position, head] element strides, in the
// order q, k, v, o, dO; lse: [B, Hq, S] f32 contiguous; stats: an f32
// workspace of B * Hq * S_pad * 2 floats, S_pad = S rounded up to 64;
// dq, dk, dv: f32 contiguous outputs
extern "C" int flash_backward_tc_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* stats, void* dq, void* dk, void* dv, int64_t B, int64_t S,
    int64_t Hq, int64_t Hkv, int64_t D, const int64_t* strides, int64_t window,
    float cap, int causal, void* stream) {
  using namespace repro_torch;
  if (Hkv <= 0 || Hq % Hkv || B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int64_t* qs = strides;
  const int64_t* ks = strides + 3;
  const int64_t* vs = strides + 6;
  const int64_t* ds = strides + 12;
  // K, V, Q, dO in 64-row boxes (dkdv); K, V in the dq kernel's KT-row boxes
  const int kt = D == 256 ? TcShape<256>::KT : TcShape<128>::KT;
  CUtensorMap maps[6];
  if (!tile_map(&maps[0], k, B, S, Hkv, D, ks[0], ks[1], ks[2]) ||
      !tile_map(&maps[1], v, B, S, Hkv, D, vs[0], vs[1], vs[2]) ||
      !tile_map(&maps[2], q, B, S, Hq, D, qs[0], qs[1], qs[2]) ||
      !tile_map(&maps[3], dout, B, S, Hq, D, ds[0], ds[1], ds[2]) ||
      !tile_map(&maps[4], k, B, S, Hkv, D, ks[0], ks[1], ks[2], kt) ||
      !tile_map(&maps[5], v, B, S, Hkv, D, vs[0], vs[1], vs[2], kt))
    return (int)cudaErrorInvalidValue;
  TcArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.stats = static_cast<const float2*>(stats);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.q_sb = qs[0];
  a.q_ss = qs[1];
  a.q_sh = qs[2];
  a.do_sb = ds[0];
  a.do_ss = ds[1];
  a.do_sh = ds[2];
  a.s = (int)S;
  a.s_pad = (int)ceil_div(S, kTile) * kTile;
  a.hq = (int)Hq;
  a.hkv = (int)Hkv;
  a.g = (int)(Hq / Hkv);
  a.n_rows = (int)(S * a.g);
  a.batch = (int)B;
  a.window = (int)window;
  a.causal = causal;
  a.cap = cap;
  a.inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  a.scale = (float)(1.0 / sqrt((double)D));
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(o);
  const float* lp = static_cast<const float*>(lse);
  float2* sp = static_cast<float2*>(stats);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_tc<64>(a, maps, ob, lp, sp, strides + 9, st);
    case 128: return launch_tc<128>(a, maps, ob, lp, sp, strides + 9, st);
    case 256: return launch_tc<256>(a, maps, ob, lp, sp, strides + 9, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
