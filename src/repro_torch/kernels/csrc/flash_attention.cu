// flash_attention: GQA attention with a causal mask, a sliding window, a
// logit softcap, a query offset and a valid KV length, by online softmax,
// on Hopper's tensor cores in split TF32. q [B, Sq, Hq, D], k/v [B, Skv,
// Hkv, D] (f32 or bf16, read in place through their strides, last
// dimension contiguous, every base and stride a multiple of 4 elements),
// D in {8, 16, 32, 64, 128, 256} -> out [B, Sq, Hq, D] contiguous, q's dtype.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// _flash_attention_impl (body `_kernel`, f32 products) for every Sq > 1 call
// that neither flash_attention_short.cu (up to 256 keys at head dims up to
// 32) nor flash_prefill.cu takes: f32 operands past 256 keys or at D 64 and
// above, views that are not 16-byte aligned. One query position (the decode
// step) goes to flash_decode.cu.
//
// Bound on an H100: 4*D FLOPs per unmasked (query, key) pair and query head.
// An f32 product needs three TF32 products to keep f32's accuracy (below),
// so for f32 operands the bound is three times those FLOPs over the 494.7
// TFLOP/s dense TF32 tensor-core peak; for bf16 operands it is the FLOPs
// over the 989 TFLOP/s bf16 peak (this kernel runs them on TF32 products
// too, one for Q.K^T and two for P.V).
//
// Arithmetic (the plain version is ref.flash_tile):
//   1. S = Q.K^T with mma.sync m16n8k8 TF32 and f32 accumulators, each f32
//      operand split as x = hi + lo, hi = tf32(x), lo = tf32(x - hi)
//      (cvt.rna.tf32.f32), and S = hi.hi + hi.lo + lo.hi: within ~2^-21 of
//      the f32 product, where one TF32 pass rounds each operand to 2^-11.
//      bf16 values are exact in TF32 (lo = 0): one product;
//   2. times the softmax scale in f32 after the product: 1/sqrt(D) from the
//      wrapper, or 1/sqrt(D0) when it zero-pads a head dim D0 < 8 to D = 8
//      (zero columns add exact zeros to every split product);
//   3. softcap as cap * tanh(s / cap) with tanh = 1 - 2 / (1 + 2^(2|y| log2 e))
//      on ex2.approx, sign restored (tanh.approx's 2^-11 is too coarse);
//      then the mask with the finite NEG = -1e30;
//   4. online (m, l) in f32 in base 2 (log2 e folded into the scores);
//   5. O = O * corr + P.V, the tile's P.V as P_hi.V_hi + P_hi.V_lo + P_lo.V_hi
//      (bf16: P_hi.V + P_lo.V) in accumulators of its own, added in f32 on
//      the CUDA cores;
//   6. O / max(l, 1e-30), rounded once to q's dtype.
//
// Design. One CTA owns (b, kv head, 64-row tile) and walks its KV tiles
// itself. Rows are the flattened (query position, group head) pairs of the
// KV head, r = qi * G + g, so each K/V tile serves all G query heads and
// any G is taken; each of 4 warps owns 16 rows (the MMA's M), and at
// D = 256 two warps share them, one for each half of D, adding each other's
// partial scores through shared memory (see Layout). Q is
// staged once in f32; K and V come as 32-key tiles by cp.async (16-byte
// copies for f32, 8-byte for bf16; keys at or past kv_len zero-filled) into
// a ring of two stages: the copy of tile i + 1 is issued right after the
// barrier that opens tile i, so it lands under tile i's products. Register
// fragments take V as it lies ([key, D]), so no transposed copy is staged.
// Fragment loads are 4 consecutive elements a lane (2 at D = 8): the k
// index of Q.K^T and the n index of P.V are permuted within each 16 (or
// 32) columns so that one load feeds two k-steps or four n-tiles, and P's
// accumulator registers are the A fragment of P.V as they lie (the key
// order of the A and B fragments permuted alike). Row strides are padded
// so those loads are free of bank conflicts. Operands are split as their
// fragments are loaded (Q each tile: a pre-split Q would not fit beside
// two K/V stages at D = 256). Fully masked KV tiles are never visited: the
// loop runs over the key range the tile's first and last rows can see (the
// Pallas block skip); only tiles that cross the diagonal, the window edge
// or kv_len are masked per element. Masked scores are the finite NEG and m
// starts at NEG, as in Pallas: a row whose own keys in a tile are all
// masked gets p = 1 there, and the correction 2^(NEG - m) = 0 of its first
// real key wipes it out. Keys at or past kv_len score NEG_PAD = -2e30, so
// they get p = 0 even in a row that sees no key at all; such a row (its
// window starts past the last valid key) must give the masked softmax's
// uniform mean of v[:kv_len], and as the rows that see no key are the
// latest ones, a tile whose last row sees none walks all of [0, kv_len).
// Shared memory is 217 KiB at D = 256 in f32 (Q 68 KiB, two stages of K and
// V 133 KiB, the score exchange 16 KiB), so the entry sets the opt-in limit
// for each instantiation; the wrapper's plan (flash_attention.tile_plan)
// must name the same size.
#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr float kNeg = -1e30f;
constexpr float kNegPad = -2e30f;           // keys at or past kv_len
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowGroups = 4;              // of 16 rows (the MMA's M) per CTA
constexpr int kRows = kRowGroups * 16;      // rows per CTA
constexpr int kKeys = 32;                   // keys per K/V tile
constexpr int kStages = 2;                  // K/V tiles in the ring
constexpr int kNT = kKeys / 8;              // n-tiles of S per tile

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// The CTA's shape and shared memory, mirrored by flash_attention.tile_plan.
// At D = 256 two warps share each row group, one for each half of D
// (H = 2): a CTA of 4 warps has one warp per scheduler, too few to hide the
// MMA and shared-memory latencies, and at D <= 128 two CTAs of 4 warps fit
// on an SM instead. Row strides are in 4-byte words: a lane loads KC elements of a
// Q or K row (LQ or LK words) at column KC * t of row g, and a row stride
// of 4L mod 8L words puts the lanes of one load phase on distinct banks; a
// V load is VC elements at column VC * g of rows 2t and 2t + 1, where a
// stride of 4 mod 8 words does the same. XW: words of the buffer in which
// the two warps of a row group swap their partial scores.
template <int D, typename T>
struct Layout {
  static constexpr int H = D == 256 ? 2 : 1;            // D halves
  static constexpr int kThreads = kRowGroups * H * kWarp;
  static constexpr int KC = D >= 16 ? 4 : 2;           // Q/K elements per load
  static constexpr int CW = 4 * KC;                     // D columns per chunk
  static constexpr int DW = D < 32 ? D : 32;            // D columns per V group
  static constexpr int VC = DW / 8;                     // V elements per load
  static constexpr int DT = D * (int)sizeof(T) / 4;     // words of a K/V row
  static constexpr int LQ = KC;                         // words per Q load (f32)
  static constexpr int LK = KC * (int)sizeof(T) / 4;    // words per K load
  static constexpr int SQ = D + ((4 * LQ - D) % (8 * LQ) + 8 * LQ) % (8 * LQ);
  static constexpr int SK = DT + ((4 * LK - DT) % (8 * LK) + 8 * LK) % (8 * LK);
  static constexpr int SV = DT + ((4 - DT) % 8 + 8) % 8;
  static constexpr int XW = H == 2 ? kRowGroups * H * kNT * 4 * kWarp : 0;
  static constexpr int kBytes = 4 * (kRows * SQ + kStages * kKeys * (SK + SV) + XW);
};

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t sq, hq, g, n_rows;     // n_rows = sq * g per (b, kv head)
  int64_t kv_len, q_offset, window;  // window < 0: none
  float cap, inv_cap;            // cap <= 0: no softcap
  float scale;
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (f32) or 8-byte (bf16) asynchronous copy of 4 elements; zeros
// when !valid (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = bf16_lo(u.x); o[1] = bf16_hi(u.x); o[2] = bf16_lo(u.y); o[3] = bf16_hi(u.y);
}

// N consecutive elements from shared memory, as f32
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
    o[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[N]) {
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    o[0] = bf16_lo(u.x); o[1] = bf16_hi(u.x); o[2] = bf16_lo(u.y); o[3] = bf16_hi(u.y);
  } else if constexpr (N == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    o[0] = bf16_lo(u); o[1] = bf16_hi(u);
  } else {
    o[0] = bf16_lo(*reinterpret_cast<const uint16_t*>(p));
  }
}

// N consecutive elements to global memory, rounded to T
template <int N>
__device__ __forceinline__ void stg(float* p, const float (&x)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

template <int N>
__device__ __forceinline__ void stg(__nv_bfloat16* p, const float (&x)[N]) {
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                              pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x[0], x[1]);
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest, ties
// away from zero, the low 13 bits zeroed), in two integer instructions
// where cvt.rna compiles to a compare-and-select sequence; a non-finite x
// gives a NaN lo, and so a NaN product, either way
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32 (kSplit), or x as it is (exact in TF32, lo unused)
template <bool kSplit, int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (kSplit) {
      hi[i] = tf32(x[i]);
      lo[i] = tf32(x[i] - __uint_as_float(hi[i]));
    } else {
      hi[i] = __float_as_uint(x[i]);
      lo[i] = 0u;
    }
  }
}

// D[16x8] += A[16x8] . B[8x8], TF32 in, f32 accumulators. Fragments (lane =
// 4 * gr + t): a = (gr, t), (gr + 8, t), (gr, t + 4), (gr + 8, t + 4);
// b = (k t, n gr), (k t + 4, n gr); d = (gr, 2t), (gr, 2t + 1), (gr + 8, 2t),
// (gr + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh within ~1e-7 (see the note above)
__device__ __forceinline__ float tanh_accurate(float y) {
  const float e = ex2(fabsf(y) * (2.f * kLog2e));
  return copysignf(1.f - __fdividef(2.f, 1.f + e), y);
}

// the rows that see no key are the latest: does position p see none?
__device__ __forceinline__ bool sees_no_key(int64_t p, const FaArgs& a) {
  const int64_t lo = a.window >= 0 ? max64(0, p - a.window + 1) : 0;
  const int64_t hi = a.causal ? min64(a.kv_len, p + 1) : a.kv_len;
  return lo >= hi;
}

// every thread: its share of K and V of the tile at keys k0.. into one stage
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* k, const T* v,
                                          const FaArgs& a, int64_t k0) {
  using L = Layout<D, T>;
  constexpr int SKE = L::SK * 4 / (int)sizeof(T), SVE = L::SV * 4 / (int)sizeof(T);
  constexpr int C4 = D / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < kKeys * C4; i += L::kThreads) {
    const int c = i / C4, c4 = i % C4;
    const bool ok = k0 + c < a.kv_len;
    const int64_t key = ok ? k0 + c : 0;
    cp_async4(ks + c * SKE + c4 * 4, k + key * a.k_ss + c4 * 4, ok);
    cp_async4(vs + c * SVE + c4 * 4, v + key * a.v_ss + c4 * 4, ok);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(Layout<D, T>::kThreads)
flash_attention_kernel(const FaArgs a) {
  using L = Layout<D, T>;
  constexpr int KC = L::KC, CW = L::CW, DW = L::DW, VC = L::VC, SQ = L::SQ, H = L::H;
  constexpr int SKE = L::SK * 4 / (int)sizeof(T), SVE = L::SV * 4 / (int)sizeof(T);
  constexpr int NC = D / CW / H;                     // Q.K^T chunks of a warp
  constexpr int NJ = D / DW / H;                     // V groups of a warp
  constexpr bool kSplit = std::is_same<T, float>::value;  // bf16 is exact in TF32
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  T* Ks = reinterpret_cast<T*>(Qs + kRows * SQ);
  T* Vs = Ks + kStages * kKeys * SKE;
  float4* Xs = reinterpret_cast<float4*>(Vs + kStages * kKeys * SVE);

  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int rg = warp % kRowGroups, hf = warp / kRowGroups;  // row group, D half
  const int gr = lane / 4, t = lane % 4;
  const int64_t tile = (int64_t)gridDim.x - 1 - blockIdx.x;  // longest first
  const int64_t hk = blockIdx.y, b = blockIdx.z;
  const int64_t r0 = tile * kRows;
  const int64_t rows = min64(kRows, a.n_rows - r0);
  const int64_t G = a.g;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hk * G * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // the keys this tile walks: the block skip, or all of them when its last
  // row sees none
  const int64_t q_lo = r0 / G + a.q_offset;
  const int64_t q_hi = (r0 + rows - 1) / G + a.q_offset;
  int64_t k_end = a.causal ? min64(a.kv_len, q_hi + 1) : a.kv_len;
  int64_t k_begin = a.window >= 0 ? max64(0, q_lo - a.window + 1) : 0;
  if (sees_no_key(q_hi, a)) {
    k_begin = 0;
    k_end = a.kv_len;
  }
  k_begin = k_begin / kKeys * kKeys;
  const int64_t n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;

  if (n_tiles > 0) load_tile<D, T>(Ks, Vs, k, v, a, k_begin);
  cp_async_commit();

  // Q as read, in f32 (zeros past the last row); the first tile's barrier
  // publishes it
  for (int i = tid; i < kRows * (D / 4); i += L::kThreads) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows) {
      const int64_t fr = r0 + r;
      load4(q + (fr / G) * a.q_ss + (fr % G) * a.q_sh + c4 * 4, x);
    }
    *reinterpret_cast<float4*>(Qs + r * SQ + c4 * 4) = make_float4(x[0], x[1], x[2], x[3]);
  }

  const int wr = rg * 16;                   // the warp's first row in the tile
  const bool busy = wr < rows;              // a row group with no row computes nothing
  int64_t pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = (r0 + wr + gr + 8 * h) / G + a.q_offset;
  float o[NJ][VC][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int u = 0; u < VC; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][u][c] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const float* qa = Qs + (wr + gr) * SQ + hf * (D / H) + KC * t;  // rows gr, gr + 8
  const float* qb = qa + 8 * SQ;

  for (int64_t i = 0; i < n_tiles; ++i) {
    const int st = (int)(i % kStages);
    const int64_t k0 = k_begin + i * kKeys;
    cp_async_wait_all();
    __syncthreads();  // tile i landed for all; every warp left tile i - 1
    if (i + 1 < n_tiles) {
      const int nx = (int)((i + 1) % kStages);
      load_tile<D, T>(Ks + nx * kKeys * SKE, Vs + nx * kKeys * SVE, k, v, a, k0 + kKeys);
    }
    cp_async_commit();
    if (!busy) continue;
    const T* kt = Ks + st * kKeys * SKE + gr * SKE + hf * (D / H) + KC * t;
    const T* vt = Vs + st * kKeys * SVE + 2 * t * SVE + hf * (D / H) + VC * gr;

    // 1. S = Q.K^T over this warp's half of D. Chunk c holds D columns
    // CW*c + KC*t + e of the half; its k-step s takes e = 2s as column t and
    // e = 2s + 1 as column t + 4.
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float xa[KC], xb[KC];
      uint32_t ha[KC], la[KC], hb[KC], lb[KC];   // rows gr (a) and gr + 8 (b)
      lds<KC>(qa + c * CW, xa);
      lds<KC>(qb + c * CW, xb);
      split<kSplit>(xa, ha, la);
      split<kSplit>(xb, hb, lb);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float xk[KC];
        uint32_t kh[KC], kl[KC];
        lds<KC>(kt + n * 8 * SKE + c * CW, xk);
        split<kSplit>(xk, kh, kl);
#pragma unroll
        for (int e = 0; e < KC; e += 2) {
          mma(s[n], ha[e], hb[e], ha[e + 1], hb[e + 1], kh[e], kh[e + 1]);
          if constexpr (kSplit) {
            mma(s[n], ha[e], hb[e], ha[e + 1], hb[e + 1], kl[e], kl[e + 1]);
            mma(s[n], la[e], lb[e], la[e + 1], lb[e + 1], kh[e], kh[e + 1]);
          }
        }
      }
    }

    if constexpr (H == 2) {
      // the two warps of the row group add each other's partial scores;
      // both then hold the same S and run the same softmax
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        Xs[((rg * H + hf) * kNT + n) * kWarp + lane] =
            make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "r"(H * kWarp) : "memory");
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float4 x = Xs[((rg * H + 1 - hf) * kNT + n) * kWarp + lane];
        s[n][0] += x.x; s[n][1] += x.y; s[n][2] += x.z; s[n][3] += x.w;
      }
    }

    // 2-4. scale, softcap, mask, online softmax in base 2. s[n][c] is row
    // gr + 8 * (c / 2), key k0 + 8n + 2t + c % 2.
    const bool full = k0 + kKeys <= a.kv_len && (!a.causal || k0 + kKeys - 1 <= q_lo) &&
                      (a.window < 0 || q_hi - k0 < a.window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c / 2;
        float x = s[n][c] * a.scale;
        if (a.cap > 0.f) x = a.cap * tanh_accurate(x * a.inv_cap);
        x *= kLog2e;
        if (!full) {
          const int64_t kp = k0 + 8 * n + 2 * t + c % 2;
          bool ok = kp < a.kv_len;
          if (a.causal) ok = ok && pos[h] >= kp;
          if (a.window >= 0) ok = ok && pos[h] - kp < a.window;
          x = ok ? x : kp < a.kv_len ? kNeg : kNegPad;
        }
        s[n][c] = x;
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
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = ex2(s[n][c] - m[c / 2]);
        l[c / 2] += p[c];
      }
      split<true>(p, ph[n], pl[n]);
    }

    // 5. O = O * corr + P.V over this warp's half of D, the tile's P.V
    // summed in accumulators of its own and added on the CUDA cores: the
    // tensor cores' f32 accumulation truncates, and over the 3 * 4096
    // products of a 32768-key row that drift puts the output past the f32
    // limit. The k-step of keys 8n..
    // takes P's accumulator registers as they lie: key 2t as column t, key
    // 2t + 1 as column t + 4, and V's rows 2t and 2t + 1 alike. V group j
    // holds D columns DW*j + VC*gr + u as the n index gr of its n-tile u.
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float pv[VC][4];
#pragma unroll
      for (int u = 0; u < VC; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) pv[u][c] = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float x0[VC], x1[VC];
        uint32_t h0[VC], l0[VC], h1[VC], l1[VC];
        lds<VC>(vt + 8 * n * SVE + DW * j, x0);
        lds<VC>(vt + (8 * n + 1) * SVE + DW * j, x1);
        split<kSplit>(x0, h0, l0);
        split<kSplit>(x1, h1, l1);
#pragma unroll
        for (int u = 0; u < VC; ++u) {
          mma(pv[u], ph[n][0], ph[n][2], ph[n][1], ph[n][3], h0[u], h1[u]);
          if constexpr (kSplit)
            mma(pv[u], ph[n][0], ph[n][2], ph[n][1], ph[n][3], l0[u], l1[u]);
          mma(pv[u], pl[n][0], pl[n][2], pl[n][1], pl[n][3], h0[u], h1[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < VC; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[j][u][c] = fmaf(o[j][u][c], corr[c / 2], pv[u][c]);
    }
  }

  // 6. O / max(l, 1e-30), rounded once. Row gr + 8h holds D columns
  // DW*j + 2*VC*t + e: o[j][e][2h] for e < VC, o[j][e - VC][2h + 1] after.
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int64_t fr = r0 + wr + gr + 8 * h;
    if (!busy || fr >= a.n_rows) continue;
    const float den = fmaxf(l[h], 1e-30f);
    T* dst = out + ((b * a.sq + fr / G) * a.hq + hk * G + fr % G) * D + hf * (D / H) +
             2 * VC * t;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float x[2 * VC];
#pragma unroll
      for (int e = 0; e < VC; ++e) {
        x[e] = o[j][e][2 * h] / den;
        x[VC + e] = o[j][e][2 * h + 1] / den;
      }
      stg<2 * VC>(dst + DW * j, x);
    }
  }
}

template <int D, typename T>
int launch_fa(const FaArgs& a, int64_t batch, int64_t hkv, int64_t smem,
              cudaStream_t stream) {
  constexpr int bytes = Layout<D, T>::kBytes;
  static_assert(bytes <= 232448, "tile exceeds the per-block shared memory");
  if (smem != bytes) return (int)cudaErrorInvalidValue;  // the wrapper's plan differs
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ceil_div(a.n_rows, kRows), (unsigned)hkv, (unsigned)batch);
  flash_attention_kernel<D, T><<<grid, Layout<D, T>::kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const FaArgs& a, int64_t d, int64_t batch, int64_t hkv, int64_t smem,
             cudaStream_t stream) {
  switch (d) {
    case 8: return launch_fa<8, T>(a, batch, hkv, smem, stream);
    case 16: return launch_fa<16, T>(a, batch, hkv, smem, stream);
    case 32: return launch_fa<32, T>(a, batch, hkv, smem, stream);
    case 64: return launch_fa<64, T>(a, batch, hkv, smem, stream);
    case 128: return launch_fa<128, T>(a, batch, hkv, smem, stream);
    case 256: return launch_fa<256, T>(a, batch, hkv, smem, stream);
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
    int64_t window, float cap, float scale, int causal, int bf16, int64_t smem,
    void* stream) {
  using namespace repro_torch;
  const int64_t g = Hq / Hkv;
  const FaArgs a{q,      k,        v,      out,  q_sb, q_ss, q_sh,
                 k_sb,   k_ss,     k_sh,   v_sb, v_ss, v_sh, Sq,
                 Hq,     g,        Sq * g, kv_len, q_offset, window,
                 cap,    cap > 0.f ? 1.f / cap : 0.f,
                 scale,  causal};
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_d<__nv_bfloat16>(a, D, B, Hkv, smem, st)
              : launch_d<float>(a, D, B, Hkv, smem, st);
}
