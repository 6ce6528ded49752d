// flash_attention_short: GQA attention (causal or not, an optional sliding
// window, a logit softcap, a query offset and a valid KV length) in one pass
// for short key ranges: Skv <= 256 keys and head dims D <= 32. q [B, Sq,
// Hq, D], k/v [B, Skv, Hkv, D] (f32 or bf16, read in place through their
// strides, last dimension contiguous), any D in 1..32 -> out [B, Sq, Hq, D]
// in q's dtype, at the true D.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// _flash_attention_impl for every call flash_attention.route sends here: a
// forward of Sq > 1, or of any Sq at D < 8, whose Skv, D, G and dtype
// flash_attention.short_plan takes (the recsys blocks: BST at S 21, 8 heads,
// D 4; BERT4Rec at S 200, 2 heads, D 32). It is the forward twin of
// flash_backward_short.cu: a CTA owns whole (batch, kv head) units, u = b *
// Hkv + kv head, on grid x, so any batch is one launch; each unit's K and V
// are staged once, and each row's softmax is taken over its whole row at
// once (no online rescaling, no workspace, no lse written). A head dim below
// 8 is read in place: no padded copy goes through device memory.
//
// Arithmetic: s = (q.k) * scale, scale = 1/sqrt(D); with a softcap s = cap *
// tanh(s / cap); key j is visible to the row at absolute position i = qi +
// q_offset when j < kv_len, j <= i (causal) and i - j < window (when set);
// m = the row's max over its visible keys, p = exp(s - m) on them, o = sum
// p v / sum p, all in base 2 (q times scale * log2(e) before the product,
// p = 2^(s' - m') by ex2.approx). A row that sees no key gives the uniform
// mean of v[:kv_len] (the reference's finite mask makes every score equal
// there), or 0 at kv_len 0. Keys at or past kv_len are never read.
//
// Bound on an H100: the bytes of q, k, v and o once, and 4*D FLOPs a visible
// (query, key) pair and query head. Two routes, by flash_attention.short_plan:
//  - D <= 8, Skv <= 32 (BST): the bytes bound it (704 MB at B 65536: 0.210
//    ms at 3.35 TB/s), so f32 FMA on the CUDA cores
//    (flash_attention_tiny_kernel). A CTA takes whole batch entries where
//    they fit (a multiple of Hkv units: a batch entry's rows lie contiguous
//    in memory, so its K and V come as one span of 16-byte cp.async copies
//    and its threads' q loads and o stores are consecutive rows), else a
//    divisor of Hkv units. A thread takes up to 3 rows of one unit and
//    group head (positions P0 = ceil(Sq / rows) apart), so that each K and
//    V row it reads from shared memory (four wavefronts a 16-byte load)
//    serves them all; it scores its rows twice, the max, then p, l and p.v,
//    so that no score waits in a register, and keeps the mask out of the
//    loops where every row sees the same keys (BST's non-causal blocks).
//    Plain version: ref.flash_attention.
//  - the rest (BERT4Rec: S 200, D 32): every product on the TF32 tensor
//    cores by mma.sync m16n8k8 with split operands, hi = tf32(x) and lo = x
//    - hi, three TF32 products a product (the backward's arithmetic,
//    tf32_split.cuh), within ~2^-21 of f32 (flash_attention_short_kernel).
//    K of the CTA's units is staged once split (rows of hi then lo) and V
//    once in f32 by cp.async, zero-filled past kv_len to a whole 8-key tile
//    and past D to DP in {8, 16, 32}; each of 8 warps then takes 16-row
//    tiles of its units: Q from device memory straight into A fragments,
//    scaled and split once; a first pass over the key tiles takes each row's
//    max from hi.hi products alone (a shift that the softmax cancels, ~2^-10
//    off), a second the scores in full, p, l and O = P.V, with P's
//    accumulators as the A fragments as they lie (the key order of the A and
//    B fragments permuted alike) and even and odd key tiles on their own
//    accumulator chains, a few key tiles of scores in registers at a time;
//    O / l goes out from registers. Plain version: ref.flash_attention_short.
//    Sized for two CTAs an SM (K and V of a BERT4Rec unit take 86 KB with
//    their padding).
// No float atomics, no library call: two runs give the same bits. The
// operands' dtype is picked at run time in the loads and stores, so each
// kernel is built once per head width. flash_attention.short_plan mirrors
// both routes' layouts and the launch checks the plan against its own.
#include <cmath>

#include <cuda_bf16.h>

#include "common.cuh"
#include "tf32_split.cuh"

namespace repro_torch {
namespace {

constexpr int kFwdMaxWarps = 8;    // warps a CTA of the tensor-core route at most
constexpr int kChunk = 4;          // 8-key tiles of scores a warp of that route holds at a time
constexpr int kTinyMaxThreads = 256;
constexpr int kTinyMaxRows = 3;    // rows a thread of that route at most
constexpr int kTinyMaxKeys = 32;
constexpr float kLog2e = 1.4426950408889634f;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_s[3], k_s[3], v_s[3], o_s[3];
  int64_t batch;     // B
  int sq, kv_len;    // query positions; keys that exist
  int hkv, g, d;     // kv heads, group, true head dim
  int rows;          // Sq * G rows a unit
  int units, ub;     // units a CTA; of one batch entry: min(units, Hkv)
  int p0;            // the tiny route's position blocks: ceil(Sq / rows a thread)
  int sk, sv;        // shared-memory row strides in words of K and V
  int q_offset, window, causal;
  int vec_in;        // 16-byte loads of k and v (tiny: also of q)
  int vec_out;       // the tiny route's row stores whole (16 or 8 bytes)
  int pair;          // the tensor-core route's 2-element loads of q and stores of o
  int bf16;          // the operands' dtype: bf16, else f32
  float cap, inv_cap, scale;
};

// 2^x by the special-function unit (ex2.approx, flushing subnormals: a p
// below 2^-126 of the row's largest adds nothing to l)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the keys [lo, hi) that the row at query position qi sees
__device__ __forceinline__ void key_range(const FwdArgs& a, int qi, int& lo, int& hi) {
  const int i = qi + a.q_offset;
  lo = a.window >= 0 ? max(0, i - a.window + 1) : 0;
  hi = a.causal ? min(a.kv_len, i + 1) : a.kv_len;
  hi = max(lo, hi);
}

// Keys [0, n) of each of the CTA's units (K or V) into shared memory as f32,
// columns [0, DP) of rows ld words apart. The CTA's units are U / UB batch
// entries from b0 (bl) times UB kv heads from hk0 (hl): whole entries (hk0
// = 0, UB = Hkv) or part of one (U = UB). The row of (bl, key j, hl) lies at
// ((bl * n + j) * UB + hl) * ld (the tensor's memory order: consecutive
// threads copy consecutive 16-byte chunks of a batch entry), or with
// UNIT_MAJOR at ((bl * UB + hl) * n + j) * ld, copied a unit at a time.
// Zeros at or past kv_len, past D and for batch entries past the last. f32
// with 16-byte rows and strides (vec_in) goes by cp.async, to be waited for
// with cp_async_wait_all; anything else through registers.
template <int DP, bool UNIT_MAJOR, typename T>
__device__ __forceinline__ void stage_keys(float* dst, int ld, int n, const void* src_v,
                                           const int64_t* st, int64_t b0, int hk0,
                                           const FwdArgs& a) {
  const T* src = static_cast<const T*>(src_v);
  const int UB = a.ub, nt = blockDim.x;
  const bool vec = a.vec_in && sizeof(T) == 4;
  constexpr int CH = DP / 4;                 // 16-byte chunks a row (f32)
  const int per = vec ? CH : DP;             // copies a row
  auto copy = [&](int bl, int hl, int j, int c) {
    const int64_t b = b0 + bl;
    const int row = UNIT_MAJOR ? (bl * UB + hl) * n + j : (bl * n + j) * UB + hl;
    const int e = vec ? 4 * c : c;           // the first element copied
    const bool ok = b < a.batch && j < a.kv_len && e < a.d;
    const T* p = src + (ok ? b * st[0] + (int64_t)j * st[1] + (hk0 + hl) * st[2] + e : 0);
    if (vec) {
      cp_async16(dst + row * ld + e, p, ok);
    } else {
      dst[row * ld + e] = ok ? to_f(*p) : 0.f;
    }
  };
  if (UNIT_MAJOR) {
    for (int ul = 0; ul < a.units; ++ul)
      for (int idx = threadIdx.x; idx < n * per; idx += nt)
        copy(ul / UB, ul % UB, idx / per, idx % per);
  } else {
    for (int idx = threadIdx.x; idx < a.units * n * per; idx += nt) {
      const int r = idx / per, r2 = r / UB;
      copy(r2 / n, r % UB, r2 % n, idx % per);
    }
  }
}

template <int DP, bool UNIT_MAJOR>
__device__ __forceinline__ void stage_any(float* dst, int ld, int n, const void* src,
                                          const int64_t* st, int64_t b0, int hk0,
                                          const FwdArgs& a) {
  if (a.bf16)
    stage_keys<DP, UNIT_MAJOR, __nv_bfloat16>(dst, ld, n, src, st, b0, hk0, a);
  else
    stage_keys<DP, UNIT_MAJOR, float>(dst, ld, n, src, st, b0, hk0, a);
}

// K of the CTA's units into shared memory split for the tensor cores, a unit
// at a time: row (unit ul, key j) at (ul * n + j) * ld holds hi = tf32(k) in
// words [0, DP) and lo = k - hi in [DP, 2 DP) (zeros at or past kv_len,
// past D and for batch entries past the last), so that no fragment load
// splits K again. A thread has four 4-element loads in flight (16-byte ones
// for f32 with 16-byte rows and strides) and splits each as it lands.
template <int DP, typename T>
__device__ __forceinline__ void stage_split(float* dst, int ld, int n, const void* src_v,
                                            const int64_t* st, int64_t b0, int hk0,
                                            const FwdArgs& a) {
  const T* src = static_cast<const T*>(src_v);
  constexpr int CH = DP / 4;   // 4-element chunks a row
  const int per_unit = n * CH, total = a.units * per_unit, nt = blockDim.x;
  const bool vec = a.vec_in && sizeof(T) == 4;
  for (int base = threadIdx.x; base < total; base += 4 * nt) {
    float x[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = base + r * nt, ul = idx / per_unit, c = idx % CH,
                j = idx % per_unit / CH;
      const int64_t b = b0 + ul / a.ub;
      const bool ok = idx < total && b < a.batch && j < a.kv_len;
      const T* p = src + (ok ? b * st[0] + (int64_t)j * st[1] + (hk0 + ul % a.ub) * st[2] + 4 * c
                             : 0);
      if (vec) {
        const float4 y = ok && 4 * c < a.d ? __ldg(reinterpret_cast<const float4*>(p))
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        x[r][0] = y.x;
        x[r][1] = y.y;
        x[r][2] = y.z;
        x[r][3] = y.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[r][e] = ok && 4 * c + e < a.d ? to_f(p[e]) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = base + r * nt;
      if (idx >= total) break;
      uint32_t h[4], l[4];
      split4(x[r][0], x[r][1], x[r][2], x[r][3], h, l);
      float* q = dst + (idx / CH) * ld + 4 * (idx % CH);
      *reinterpret_cast<uint4*>(q) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(q + DP) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// ---- the CUDA-core route: D <= 8, Skv <= 32 ------------------------------

// a row of D elements at p into x[0, DT) as f32, zeros past D
template <int DT, typename T>
__device__ __forceinline__ void load_row(float (&x)[DT], const T* p, int d, bool vec) {
#pragma unroll
  for (int i = 0; i < DT; ++i) x[i] = 0.f;
  constexpr int E = 16 / (int)sizeof(T);
  if (vec) {   // d a multiple of E
#pragma unroll
    for (int c = 0; c < (DT + E - 1) / E; ++c) {
      if (c * E >= d) break;
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p + c * E));
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int i = 0; i < E && c * E + i < DT; ++i) x[c * E + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < DT; ++i)
      if (i < d) x[i] = to_f(p[i]);
  }
}

template <int DT>
__device__ __forceinline__ void load_q(float (&x)[DT], const void* p, int d, bool vec, int bf16) {
  if (bf16)
    load_row<DT>(x, static_cast<const __nv_bfloat16*>(p), d, vec);
  else
    load_row<DT>(x, static_cast<const float*>(p), d, vec);
}

// x[0, D) to a row of the output in its dtype: whole (vec: one 16-byte f32
// store a 4 columns, or D 4 / 8 bf16 as 8 / 16 bytes) or element by element
template <int DT>
__device__ __forceinline__ void store_out(void* dst, const float (&x)[DT], int d, bool vec,
                                          int bf16) {
  if (bf16) {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(dst);
    if (vec) {
      __nv_bfloat162 h[DT / 2];
#pragma unroll
      for (int i = 0; i < DT / 2; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      if constexpr (DT == 4)   // d 4 (vec holds d 4 or 8 only)
        *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
      else
        *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
    } else {
#pragma unroll
      for (int i = 0; i < DT; ++i)
        if (i < d) p[i] = __float2bfloat16_rn(x[i]);
    }
  } else {
    float* p = static_cast<float*>(dst);
    if (vec) {
#pragma unroll
      for (int c = 0; c < DT; c += 4)
        if (c < d) *reinterpret_cast<float4*>(p + c) = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < DT; ++i)
        if (i < d) p[i] = x[i];
    }
  }
}

// q . k + base over DT columns, k as DT / 4 float4s: two accumulator chains
template <int DT>
__device__ __forceinline__ float dot_key(const float (&q)[DT], const float4 (&k)[DT / 4],
                                         float base = 0.f) {
  float a0 = base, a1 = 0.f;
#pragma unroll
  for (int c = 0; c < DT / 4; ++c) {
    a0 = fmaf(q[4 * c], k[c].x, a0);
    a1 = fmaf(q[4 * c + 1], k[c].y, a1);
    a0 = fmaf(q[4 * c + 2], k[c].z, a0);
    a1 = fmaf(q[4 * c + 3], k[c].w, a1);
  }
  return a0 + a1;
}

// The softmax of a thread's R rows over the keys [jlo, jhi) of its unit (K
// and V rows `stride` words apart in shared memory): l = sum p and o = sum p
// v, p = 2^(s - m) with m each row's max. The scores come in base 2: q was
// multiplied by scale * log2(e) (CAP, a softcap: by scale alone, and the
// capped score by log2(e)). MASK: row k sees [lo[k], hi[k]) and a key it
// does not see scores -inf (p = 0); without it every row sees [jlo, jhi).
// A row that sees no key comes with q = 0 and [lo, hi) = [0, kv_len): p = 1
// on each of those keys. No branch inside the loops.
template <int DT, int R, bool CAP, bool MASK>
__device__ __forceinline__ void tiny_rows(const FwdArgs& a, const float (&q)[R][DT],
                                          const float* Ku, const float* Vu, int stride,
                                          const int (&lo)[R], const int (&hi)[R], int jlo,
                                          int jhi, float (&l)[R], float (&o)[R][DT]) {
  // the score of key j for row k, less `shift` (folded into the dot
  // product where there is no softcap)
  auto score = [&](int k, const float4 (&kk)[DT / 4], int j, float shift) {
    float s;
    if (CAP)
      s = a.cap * tanhf(dot_key<DT>(q[k], kk) * a.inv_cap) * kLog2e - shift;
    else
      s = dot_key<DT>(q[k], kk, -shift);
    if (MASK) s = (unsigned)(j - lo[k]) < (unsigned)(hi[k] - lo[k]) ? s : -INFINITY;
    return s;
  };
  float m[R];
#pragma unroll
  for (int k = 0; k < R; ++k) m[k] = -INFINITY;
#pragma unroll 2
  for (int j = jlo; j < jhi; ++j) {
    float4 kk[DT / 4];
#pragma unroll
    for (int c = 0; c < DT / 4; ++c) kk[c] = reinterpret_cast<const float4*>(Ku + j * stride)[c];
#pragma unroll
    for (int k = 0; k < R; ++k) m[k] = fmaxf(m[k], score(k, kk, j, 0.f));
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    m[k] = m[k] == -INFINITY ? 0.f : m[k];   // a row past Sq: no key, p unused
    l[k] = 0.f;
#pragma unroll
    for (int i = 0; i < DT; ++i) o[k][i] = 0.f;
  }
#pragma unroll 2
  for (int j = jlo; j < jhi; ++j) {
    float4 kk[DT / 4], vv[DT / 4];
#pragma unroll
    for (int c = 0; c < DT / 4; ++c) {
      kk[c] = reinterpret_cast<const float4*>(Ku + j * stride)[c];
      vv[c] = reinterpret_cast<const float4*>(Vu + j * stride)[c];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float e = ex2(score(k, kk, j, m[k]));
      l[k] += e;
#pragma unroll
      for (int c = 0; c < DT / 4; ++c) {
        o[k][4 * c] = fmaf(e, vv[c].x, o[k][4 * c]);
        o[k][4 * c + 1] = fmaf(e, vv[c].y, o[k][4 * c + 1]);
        o[k][4 * c + 2] = fmaf(e, vv[c].z, o[k][4 * c + 2]);
        o[k][4 * c + 3] = fmaf(e, vv[c].w, o[k][4 * c + 3]);
      }
    }
  }
}

// The address of row (batch entry b, position p, head h) of a [B, S, H, D]
// operand whose strides st count elements of `esize` bytes
__device__ __forceinline__ const char* row_at(const void* base, const int64_t* st, int64_t b,
                                              int p, int h, int esize) {
  return static_cast<const char*>(base) + (b * st[0] + (int64_t)p * st[1] + h * st[2]) * esize;
}

// R (position, query head) rows a thread, of one unit and group head: slot s
// of the CTA is (entry bl, position block pb, unit of the entry hl, group
// head gh) in the tensor's memory order, and takes positions pb + k * P0, k
// < R, so that for each k a warp's q loads and o stores are consecutive
// rows, and each K and V row a thread reads from shared memory serves R
// rows. K and V of the CTA's units land there by cp.async while each
// thread's q rows come into registers; then each row scores its visible
// keys twice: the max, then p = exp(s - m), l = sum p and o = sum p v, f32
// FMA throughout.
template <int DT, int R>
__global__ void __launch_bounds__(kTinyMaxThreads, 4)
flash_attention_tiny_kernel(const FwdArgs a) {
  extern __shared__ float4 smem4[];
  const int U = a.units, UB = a.ub, G = a.g, n = a.kv_len, P0 = a.p0;
  float* Ks = reinterpret_cast<float*>(smem4);   // [U / UB][n][UB][DT]
  float* Vs = Ks + U * n * DT;
  const int64_t u0 = (int64_t)blockIdx.x * U;
  const int64_t b0 = u0 / a.hkv;
  const int hk0 = (int)(u0 - b0 * a.hkv);
  const int esize = a.bf16 ? 2 : 4;
  stage_any<DT, false>(Ks, DT, n, a.k, a.k_s, b0, hk0, a);
  stage_any<DT, false>(Vs, DT, n, a.v, a.v_s, b0, hk0, a);

  const int per_pos = UB * G, per_entry = P0 * per_pos, slots = U / UB * per_entry;
  float q[R][DT];
  // slot sl: its entry, position block, unit of the entry and head; its q rows
  auto take = [&](int sl, int& bl, int& pb, int& hl, int& h, int64_t& b) {
    bl = sl / per_entry;
    const int rem = sl % per_entry, w = rem % per_pos;
    pb = rem / per_pos;
    hl = w / G;
    b = b0 + bl;
    h = (hk0 + hl) * G + w % G;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int pos = pb + k * P0;
      if (b < a.batch && pos < a.sq) {
        load_q<DT>(q[k], row_at(a.q, a.q_s, b, pos, h, esize), a.d, a.vec_in, a.bf16);
      } else {
#pragma unroll
        for (int i = 0; i < DT; ++i) q[k][i] = 0.f;
      }
    }
  };
  int bl, pb, hl, h;
  int64_t b;
  if (threadIdx.x < slots) take(threadIdx.x, bl, pb, hl, h, b);   // in flight with K and V
  cp_async_wait_all();
  __syncthreads();
  for (int sl = threadIdx.x; sl < slots; sl += blockDim.x) {
    if (sl != threadIdx.x) take(sl, bl, pb, hl, h, b);
    if (b >= a.batch) continue;
    const float* Ku = Ks + (bl * n * UB + hl) * DT;
    const float* Vu = Vs + (bl * n * UB + hl) * DT;
    // each row's keys; a row that sees none takes every key below kv_len
    // with q = 0 (p = 1 on each); the thread's range of keys, and whether
    // each of its rows sees all of it (no mask)
    int lo[R], hi[R], jlo = n, jhi = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (pb + k * P0 < a.sq) {
        key_range(a, pb + k * P0, lo[k], hi[k]);
        if (lo[k] >= hi[k]) {
          lo[k] = 0;
          hi[k] = n;
#pragma unroll
          for (int i = 0; i < DT; ++i) q[k][i] = 0.f;
        }
      } else {
        lo[k] = hi[k] = 0;
      }
      if (hi[k] > lo[k]) {
        jlo = min(jlo, lo[k]);
        jhi = max(jhi, hi[k]);
      }
    }
    bool same = true;
#pragma unroll
    for (int k = 0; k < R; ++k) same = same && lo[k] == jlo && hi[k] == jhi;
    const float qs = a.cap > 0.f ? a.scale : a.scale * kLog2e;
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int i = 0; i < DT; ++i) q[k][i] *= qs;
    float l[R], o[R][DT];
    const int st = UB * DT;
    if (a.cap > 0.f) {
      if (same)
        tiny_rows<DT, R, true, false>(a, q, Ku, Vu, st, lo, hi, jlo, jhi, l, o);
      else
        tiny_rows<DT, R, true, true>(a, q, Ku, Vu, st, lo, hi, jlo, jhi, l, o);
    } else if (same) {
      tiny_rows<DT, R, false, false>(a, q, Ku, Vu, st, lo, hi, jlo, jhi, l, o);
    } else {
      tiny_rows<DT, R, false, true>(a, q, Ku, Vu, st, lo, hi, jlo, jhi, l, o);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int pos = pb + k * P0;
      if (pos >= a.sq) continue;
      const float inv = l[k] > 0.f ? 1.f / l[k] : 0.f;
#pragma unroll
      for (int i = 0; i < DT; ++i) o[k][i] *= inv;
      store_out<DT>(const_cast<char*>(row_at(a.o, a.o_s, b, pos, h, esize)), o[k], a.d,
                    a.vec_out, a.bf16);
    }
  }
}

// ---- the tensor-core route: the rest, up to 256 keys and D 32 ------------

// elements col and col + 1 of a row as f32, zeros past D; `pair`: one
// 8-byte (f32) or 4-byte (bf16) load
__device__ __forceinline__ float2 load2(const void* row, int col, int d, int pair, int bf16) {
  if (bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(row) + col;
    if (pair && col + 1 < d) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    return make_float2(col < d ? __bfloat162float(p[0]) : 0.f,
                       col + 1 < d ? __bfloat162float(p[1]) : 0.f);
  }
  const float* p = static_cast<const float*>(row) + col;
  if (pair && col + 1 < d) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(col < d ? __ldg(p) : 0.f, col + 1 < d ? __ldg(p + 1) : 0.f);
}

__device__ __forceinline__ void store2(void* row, int col, float x, float y, int d, int pair,
                                       int bf16) {
  if (bf16) {
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(row) + col;
    if (pair && col + 1 < d) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
    } else {
      if (col < d) p[0] = __float2bfloat16_rn(x);
      if (col + 1 < d) p[1] = __float2bfloat16_rn(y);
    }
    return;
  }
  float* p = static_cast<float*>(row) + col;
  if (pair && col + 1 < d) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    if (col < d) p[0] = x;
    if (col + 1 < d) p[1] = y;
  }
}

// S = Q.K^T for the key tiles [n0, n0 + NC) of one warp's 16 rows into c,
// in base 2: Q comes multiplied by scale * log2(e) (by scale alone under a
// softcap, whose capped score is then multiplied by log2(e)). The k index of
// each 8-column step permuted, slot t <-> column 2t and slot t + 4 <->
// column 2t + 1, alike in A (Q's fragments, split once: qh, ql) and B (K
// split in shared memory, `stage_split`, at a stride of 8 mod 32 words:
// float2 loads at row gr, column 2t, on distinct banks). FULL: the three
// TF32 products hi.hi + hi.lo + lo.hi; else hi.hi alone, within ~2^-10 of
// each score, enough for the row's max (a shift that softmax cancels). The
// NC tiles' chains interleaved, no branch inside; then the softcap and the
// mask (-inf where the row, gr or gr + 8, does not see the key: [lo, hi)),
// skipped where every key of the tiles is in both rows' ranges.
template <int DP, int NC, bool FULL>
__device__ __forceinline__ void scores(float (&c)[NC][4], const uint32_t (&qh)[DP / 8][4],
                                       const uint32_t (&ql)[DP / 8][4], const float* Ku, int n0,
                                       const int (&lo)[2], const int (&hi)[2], const FwdArgs& a,
                                       int gr, int t) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    uint2 yh[NC], yl[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float* kr = Ku + (8 * (n0 + n) + gr) * a.sk + 8 * ks + 2 * t;
      yh[n] = *reinterpret_cast<const uint2*>(kr);
      if (FULL) yl[n] = *reinterpret_cast<const uint2*>(kr + DP);
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) mma(c[n], qh[ks], yh[n].x, yh[n].y);
    if (FULL) {
#pragma unroll
      for (int n = 0; n < NC; ++n) mma(c[n], qh[ks], yl[n].x, yl[n].y);
#pragma unroll
      for (int n = 0; n < NC; ++n) mma(c[n], ql[ks], yh[n].x, yh[n].y);
    }
  }
  if (a.cap > 0.f) {   // a uniform branch around its loop
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n][i] = a.cap * tanhf(c[n][i] * a.inv_cap) * kLog2e;
  }
  if (8 * n0 < max(lo[0], lo[1]) || 8 * (n0 + NC) > min(hi[0], hi[1])) {
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = i / 2, j = 8 * (n0 + n) + 2 * t + (i & 1);
        c[n][i] = (unsigned)(j - lo[x]) < (unsigned)(hi[x] - lo[x]) ? c[n][i] : -INFINITY;
      }
  }
}

// Each row's max over the scores c of NC key tiles, into m
template <int NC>
__device__ __forceinline__ void row_max(const float (&c)[NC][4], float (&m)[2]) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i / 2] = fmaxf(m[i / 2], c[n][i]);
}

// p = 2^(s - m) over the scores c of the key tiles [n0, n0 + NC) (1 on
// every key below kv_len for a row that sees none), l += p, and O += P.V:
// c[n] is the A fragment of key tile n as it lies (slot t <-> key 2t, t + 4
// <-> 2t + 1: (c0, c2, c1, c3)), V's keys 2t, 2t + 1 at column gr the B
// fragment (stride sv = 4 mod 32: distinct banks); even and odd key tiles
// on their own accumulator chains
template <int DP, int NC>
__device__ __forceinline__ void accumulate(float (&c)[NC][4], const float* Vu, int n0,
                                           const float (&m)[2], const bool (&none)[2],
                                           float (&l)[2], float (&o)[2][DP / 8][4],
                                           const FwdArgs& a, int gr, int t) {
#pragma unroll
  for (int n = 0; n < NC; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = i / 2, j = 8 * (n0 + n) + 2 * t + (i & 1);
      const float p = none[x] ? (j < a.kv_len ? 1.f : 0.f) : ex2(c[n][i] - m[x]);
      c[n][i] = p;
      l[x] += p;
    }
    uint32_t ph[4], pl[4];
    split4(c[n][0], c[n][2], c[n][1], c[n][3], ph, pl);
    const float* v0 = Vu + (8 * (n0 + n) + 2 * t) * a.sv + gr;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      uint32_t bh0, bl0, bh1, bl1;
      split(v0[8 * dn], bh0, bl0);
      split(v0[a.sv + 8 * dn], bh1, bl1);
      mma(o[n & 1][dn], ph, bh0, bh1);
      mma(o[n & 1][dn], ph, bl0, bl1);
      mma(o[n & 1][dn], pl, bh0, bh1);
    }
  }
}

// One warp, one 16-row tile (rows r0..r0 + 15 of the unit of batch entry b
// whose query heads start at h0; the rows past the unit's last are computed
// on zeros and not stored), in two passes over the unit's nt 8-key tiles:
// the first takes each row's max over its whole row from hi.hi products
// (kChunk tiles of scores in registers at a time), the second the scores in
// full, p, l and O (`accumulate`, kChunk / 2 tiles at a time); the tiles
// past the last whole chunk one at a time. O / l goes out from registers.
// Q comes from device memory straight into A fragments, scaled and split
// once.
template <int DP>
__device__ __forceinline__ void tile(const FwdArgs& a, const float* Ku, const float* Vu,
                                     int64_t b, int h0, int r0, int gr, int t) {
  constexpr int KS = DP / 8, C2 = kChunk / 2;
  const int esize = a.bf16 ? 2 : 4;
  const int nt = (a.kv_len + 7) / 8;
  const float qs = a.cap > 0.f ? a.scale : a.scale * kLog2e;
  int rr[2], lo[2], hi[2];
  const char* qrow[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    rr[x] = r0 + gr + 8 * x;
    const bool ok = rr[x] < a.rows;
    const int qi = ok ? rr[x] / a.g : 0, gh = ok ? rr[x] % a.g : 0;
    qrow[x] = ok ? row_at(a.q, a.q_s, b, qi, h0 + gh, esize) : nullptr;
    if (ok) {
      key_range(a, qi, lo[x], hi[x]);
    } else {
      lo[x] = hi[x] = 0;
    }
  }
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = 8 * ks + 2 * t;
    const float2 x0 = qrow[0] ? load2(qrow[0], col, a.d, a.pair, a.bf16) : make_float2(0.f, 0.f);
    const float2 x1 = qrow[1] ? load2(qrow[1], col, a.d, a.pair, a.bf16) : make_float2(0.f, 0.f);
    split4(x0.x * qs, x1.x * qs, x0.y * qs, x1.y * qs, qh[ks], ql[ks]);
  }

  float m[2] = {-INFINITY, -INFINITY};
  {
    float c[kChunk][4], c1[1][4];
    int n0 = 0;
    for (; n0 + kChunk <= nt; n0 += kChunk) {
      scores<DP, kChunk, false>(c, qh, ql, Ku, n0, lo, hi, a, gr, t);
      row_max<kChunk>(c, m);
    }
    for (; n0 < nt; ++n0) {
      scores<DP, 1, false>(c1, qh, ql, Ku, n0, lo, hi, a, gr, t);
      row_max<1>(c1, m);
    }
  }
  bool none[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    m[x] = fmaxf(m[x], __shfl_xor_sync(kFull, m[x], 1));
    m[x] = fmaxf(m[x], __shfl_xor_sync(kFull, m[x], 2));
    none[x] = m[x] == -INFINITY;   // no visible key: the uniform mean of v[:kv_len]
  }

  float l[2] = {0.f, 0.f}, o[2][KS][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int dn = 0; dn < KS; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[e][dn][i] = 0.f;
  {
    float c[C2][4], c1[1][4];
    int n0 = 0;
    for (; n0 + C2 <= nt; n0 += C2) {
      scores<DP, C2, true>(c, qh, ql, Ku, n0, lo, hi, a, gr, t);
      accumulate<DP, C2>(c, Vu, n0, m, none, l, o, a, gr, t);
    }
    for (; n0 < nt; ++n0) {
      scores<DP, 1, true>(c1, qh, ql, Ku, n0, lo, hi, a, gr, t);
      accumulate<DP, 1>(c1, Vu, n0, m, none, l, o, a, gr, t);
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(kFull, l[x], 1);
    l[x] += __shfl_xor_sync(kFull, l[x], 2);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (rr[x] >= a.rows) continue;
    const float inv = l[x] > 0.f ? 1.f / l[x] : 0.f;
    char* row = const_cast<char*>(row_at(a.o, a.o_s, b, rr[x] / a.g, h0 + rr[x] % a.g, esize));
#pragma unroll
    for (int dn = 0; dn < KS; ++dn) {
      const int col = 8 * dn + 2 * t;
      if (col >= a.d) break;
      store2(row, col, (o[0][dn][2 * x] + o[1][dn][2 * x]) * inv,
             (o[0][dn][2 * x + 1] + o[1][dn][2 * x + 1]) * inv, a.d, a.pair, a.bf16);
    }
  }
}

// K (split, `stage_split`) and V of the CTA's units in shared memory
// ([unit][key][sk or sv], keys up to the last whole 8-key tile below
// kv_len), then each warp takes (unit, 16-row tile) items in turn
template <int DP>
__global__ void __launch_bounds__(kFwdMaxWarps * kWarp, 2)
flash_attention_short_kernel(const FwdArgs a) {
  extern __shared__ float4 smem4[];
  const int U = a.units, n = (a.kv_len + 7) / 8 * 8;   // keys staged a unit
  const int nw = blockDim.x / kWarp;
  float* Ks = reinterpret_cast<float*>(smem4);   // [U][n][sk]: hi, then lo
  float* Vs = Ks + U * n * a.sk;                   // [U][n][sv]
  const int64_t u0 = (int64_t)blockIdx.x * U;
  const int64_t b0 = u0 / a.hkv;
  const int hk0 = (int)(u0 - b0 * a.hkv);
  stage_any<DP, true>(Vs, a.sv, n, a.v, a.v_s, b0, hk0, a);   // in flight while K is split
  if (a.bf16)
    stage_split<DP, __nv_bfloat16>(Ks, a.sk, n, a.k, a.k_s, b0, hk0, a);
  else
    stage_split<DP, float>(Ks, a.sk, n, a.k, a.k_s, b0, hk0, a);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int gr = lane / 4, t = lane % 4;
  const int mt = (a.rows + 15) / 16;
  for (int it = warp; it < U * mt; it += nw) {
    const int ul = it / mt, r0 = 16 * (it % mt);
    const int64_t b = b0 + ul / a.ub;
    if (b >= a.batch) break;
    tile<DP>(a, Ks + ul * n * a.sk, Vs + ul * n * a.sv, b, (hk0 + ul % a.ub) * a.g, r0, gr, t);
  }
}

// ---- launch --------------------------------------------------------------

int64_t tiny_smem(int dt, int64_t skv, int64_t units) { return 8 * units * skv * dt; }

// a row stride in words: at least w, `rest` mod 32
int words_mod(int w, int rest) { return w + ((rest - w) % 32 + 32) % 32; }

int64_t short_smem(int dp, int64_t skv, int64_t units) {
  const int64_t s_pad = (skv + 7) / 8 * 8;
  return 4 * units * s_pad * (words_mod(2 * dp, 8) + words_mod(dp, 4));
}

template <typename K>
int launch(K kernel, int64_t grid, int threads, int64_t smem, const FwdArgs& a,
           cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, threads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_tiny(int rows, int64_t grid, int threads, int64_t smem, const FwdArgs& a,
                cudaStream_t st) {
  switch (rows) {
    case 1: return launch(flash_attention_tiny_kernel<DT, 1>, grid, threads, smem, a, st);
    case 2: return launch(flash_attention_tiny_kernel<DT, 2>, grid, threads, smem, a, st);
    default: return launch(flash_attention_tiny_kernel<DT, 3>, grid, threads, smem, a, st);
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace
}  // namespace repro_torch

// strides: 4 groups of [batch, position, head] element strides, in the order
// q, k, v, out; the plan (tiny, dp, rows a thread, units, threads) and its
// shared-memory bytes as flash_attention.short_plan gives them
extern "C" int flash_attention_short_launch(
    const void* q, const void* k, const void* v, void* out, int64_t B, int64_t Sq,
    int64_t Skv, int64_t Hq, int64_t Hkv, int64_t D, const int64_t* strides, int64_t kv_len,
    int64_t q_offset, int64_t window, float cap, float scale, int causal, int bf16, int tiny,
    int64_t dp, int64_t rows, int64_t units, int64_t threads, int64_t smem, void* stream) {
  using namespace repro_torch;
  if (Hkv <= 0 || Hq % Hkv || B <= 0 || Sq <= 0 || Skv <= 0 || D < 1 || D > 32 ||
      Skv > 256 || kv_len < 0 || kv_len > Skv || units < 1 || smem > 232448 ||
      Sq * (Hq / Hkv) > (1 << 30) || B * Hkv > ((int64_t)1 << 40) ||
      q_offset > (1 << 30) || q_offset < -(1 << 30) || (units % Hkv && Hkv % units))
    return (int)cudaErrorInvalidValue;
  const int64_t g = Hq / Hkv;
  if (tiny) {
    if (dp != (D <= 4 ? 4 : 8) || D > 8 || Skv > kTinyMaxKeys || threads < 32 ||
        threads % 32 || threads > kTinyMaxThreads || smem != tiny_smem((int)dp, Skv, units) ||
        rows < 1 || rows > kTinyMaxRows)
      return (int)cudaErrorInvalidValue;
  } else if (dp != (D <= 8 ? 8 : D <= 16 ? 16 : 32) || threads % kWarp ||
             threads < kWarp || threads > kFwdMaxWarps * kWarp ||
             smem != short_smem((int)dp, Skv, units)) {
    return (int)cudaErrorInvalidValue;
  }
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  int64_t* dst[4] = {a.q_s, a.k_s, a.v_s, a.o_s};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  a.batch = B;
  a.sq = (int)Sq;
  a.kv_len = (int)kv_len;
  a.hkv = (int)Hkv;
  a.g = (int)g;
  a.d = (int)D;
  a.rows = (int)(Sq * g);
  a.units = (int)units;
  a.ub = (int)(units < Hkv ? units : Hkv);
  a.p0 = tiny ? (int)((Sq + rows - 1) / rows) : 0;
  a.sk = tiny ? (int)dp : words_mod(2 * (int)dp, 8);
  a.sv = tiny ? (int)dp : words_mod((int)dp, 4);
  a.q_offset = (int)q_offset;
  a.window = (int)window;
  a.causal = causal;
  a.cap = cap;
  a.inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  a.scale = scale;
  a.bf16 = bf16;
  const int64_t esize = bf16 ? 2 : 4;
  // 16-byte loads of k and v (and the tiny route's q): whole 16-byte rows,
  // bases and strides
  bool vin = (D * esize) % 16 == 0;
  const void* ins[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    vin = vin && aligned(ins[i], 16);
    for (int j = 0; j < 3; ++j) vin = vin && (strides[3 * i + j] * esize) % 16 == 0;
  }
  // the tiny route's whole-row stores: f32 D 4 or 8, bf16 D 4 or 8
  bool vout = D == 4 || D == 8;
  vout = vout && aligned(out, (int)(D * esize >= 16 ? 16 : 8));
  for (int j = 0; j < 3; ++j) vout = vout && (strides[9 + j] * esize) % (D * esize >= 16 ? 16 : 8) == 0;
  // the tensor-core route's element pairs of q and out
  bool pair = D % 2 == 0 && aligned(q, 2 * (int)esize) && aligned(out, 2 * (int)esize);
  for (int j = 0; j < 3; ++j) pair = pair && strides[j] % 2 == 0 && strides[9 + j] % 2 == 0;
  a.vec_in = vin;
  a.vec_out = vout;
  a.pair = pair;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t grid = (B * Hkv + units - 1) / units;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (tiny) return dp == 4 ? launch_tiny<4>((int)rows, grid, (int)threads, smem, a, st)
                           : launch_tiny<8>((int)rows, grid, (int)threads, smem, a, st);
  switch (dp) {
    case 8: return launch(flash_attention_short_kernel<8>, grid, (int)threads, smem, a, st);
    case 16: return launch(flash_attention_short_kernel<16>, grid, (int)threads, smem, a, st);
    default: return launch(flash_attention_short_kernel<32>, grid, (int)threads, smem, a, st);
  }
}
