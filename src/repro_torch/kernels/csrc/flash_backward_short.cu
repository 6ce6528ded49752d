// flash_backward_short: the gradient of flash_attention (GQA, causal or not,
// optional sliding window and logit softcap, q_offset 0, every key valid)
// with respect to q, k and v, for short sequences: Skv <= 256 keys and head
// dims D <= 32. One pass, no workspace: a CTA owns whole (batch, kv head)
// units, keeps all of a unit's keys and values in shared memory or
// registers and takes each row's softmax over its whole row at once, so
// S = Q.K^T is computed once and no lse or delta goes to memory. q/o/dO
// [B, S, Hq, D], k/v [B, Skv, Hkv, D] (f32 or bf16, read in place through
// their strides, last dimension contiguous), any D in 1..32 -> dQ
// [B, S, Hq, D] and dK, dV [B, Skv, Hkv, D] in f32.
//
// Replaces no Pallas kernel: the reference has no Pallas backward (its
// training forward runs the pure-JAX chunked_attention, which jax.grad
// differentiates). It is the gradient of the port's tile kernel for the
// recsys blocks (BST: S 21, 8 heads, D 4; BERT4Rec: S 200, 2 heads, D 32)
// and for every other call flash_backward.route sends here; longer
// sequences and D >= 64 stay on flash_backward.cu or flash_backward_tc.cu.
//
// Bound on an H100: 10*D FLOPs a visible (query, key) pair and query head
// (S = QK^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ = dS K), and the
// bytes of q, k, v, o, dO read once and dq, dk, dv written once. Two
// routes, by flash_backward.short_plan:
//  - D <= 8, Skv <= 32 (BST): the bytes bound it (0.42 ms at B 65536;
//    10*D FLOPs on the CUDA cores take 0.14 ms), so f32 FMA on the CUDA
//    cores, one thread a row (flash_backward_tiny_kernel). Its plain
//    version is ref.flash_attention_bwd.
//  - the rest (BERT4Rec: S 200, D 32): the f32 CUDA cores would need 0.39 ms
//    against 0.125 ms of bytes, so every product runs on the TF32 tensor
//    cores by mma.sync m16n8k8 with split operands, three TF32 products a
//    product (494.7 TFLOP/s: 0.16 ms), D zero-filled to DP in {8, 16, 32}
//    in shared memory (flash_backward_short_kernel). Its plain version is
//    ref.flash_backward_short.
// Neither pads a head dim in device memory: D 4 is read in place.
//
// Arithmetic:
//   s = (q.k) * scale, scale = 1/sqrt(D); with a softcap s = cap *
//   tanh(s/cap); a key is visible when key < Skv, key <= query (causal)
//   and query - key < window (when set); m = the row's max over visible
//   keys, l = sum exp(s - m), lse = m + log(l) (a row that sees no key:
//   p = 0); p = exp(s - lse) where visible, else 0; dp = dO.v; delta =
//   rowsum(dO*o); ds = p * (dp - delta), times 1 - (s/cap)^2 under a
//   softcap; dQ = scale * dS K, dK = scale * dS^T Q, dV = P^T dO. On the
//   tensor cores each product is hi.hi + hi.lo + lo.hi with hi = tf32(x)
//   and lo = x - hi unrounded (three instructions an operand, where the
//   tile kernel's split takes five), within ~2^-21 of f32.
//
// Tensor-core design. A CTA of 8 warps owns U consecutive units (u = b *
// Hkv + kv head: at G 1 these are neighbouring heads of one batch entry)
// on grid x, so any batch is one launch. K and V of its units are staged
// once in f32 by cp.async, zero-filled past Skv and D. Rows r = position *
// G + group head are taken RG at a time (the plan's `rows`); for each
// group:
//   1. Q, dO and o of the group's rows land (issued during the last
//      group's steps 2-4); delta = rowsum(dO * o) a row;
//   2. S and dP by mma.sync, (unit, 32 rows, product, 32 keys) items:
//      eight accumulator chains, each K or V fragment split once for two
//      row tiles, the three TF32 products as three passes over them; S
//      scaled, capped and masked to -inf; both into shared memory [rows,
//      keys]. The next group's o goes in flight;
//   3. four threads a row hold its S in registers: the max, the sum, then
//      P and dS in place of S and dP;
//   4. dV += P^T dO and dK += dS^T Q: each warp owns at most 2 (unit, two
//      16-key tiles, dK or dV) items for the whole launch and adds each
//      group's product (fresh accumulators, so the tensor cores never sum
//      more than one group) to its f32 totals on the CUDA cores, in the
//      same order in every run. The next group's Q and dO go in flight;
//      dQ = dS K by (unit, row tile, half of the keys) items, each half's
//      sum into P's rows, added in a fixed order as dQ goes out.
// dK and dV are written once at the end. No float atomics on either route:
// two runs give the same bits. Shared-memory rows are padded to 8 mod 32
// words: the fragment loads (float2 along a row for S, dP and dQ's A; one
// word a lane across rows for P^T and dS^T and their B operands) and the
// accumulators' float2 stores then hit distinct banks, but for dQ's B
// operand (two ways). The operands' dtype is picked at run time in the
// loads, so each kernel is built once. flash_backward.short_plan mirrors
// both routes' layouts and the launch checks the shared-memory size
// against it. Measured (tools/short_probe.py): at BERT4Rec's shape a unit
// spends about a quarter of its cycles in each of steps 2 and 3, a sixth in
// each half of step 4 and a ninth waiting for its rows; mma.sync TF32
// alone peaks near 1.5 cycles a product an SM (~300 TFLOP/s), at which the
// kernel's ~21700 products a unit would take a fifth of its time.
#include <cmath>

#include <cuda_bf16.h>

#include "common.cuh"
#include "tf32_split.cuh"

namespace repro_torch {
namespace {

constexpr int kShortWarps = 8;  // warps a CTA of the tensor-core route
constexpr int kKvItems = 2;   // (unit, two 16-key tiles, dK or dV) items a warp owns at most
constexpr int kRowThreads = 4;  // threads a row in step 3
constexpr int kPairs = 256 / (2 * kRowThreads);   // key pairs a thread of step 3 holds

struct ShortArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  float* dq;
  float* dk;
  float* dv;
  int64_t q_s[3], k_s[3], v_s[3], o_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  int64_t n_units;  // B * Hkv
  int skv;          // keys
  int hkv, g, d;    // kv heads, group, true head dim
  int rows;         // S * G rows a unit
  int s_pad, rg, units;      // the plan: keys (mult. of 16), rows a group, units a CTA
  int sq, sk, sp;   // row strides in words of Q/dO/o/dQ, K/V, P/dS
  int window;       // -1: none
  int causal;
  int vec_in, vec_out;  // 16-byte loads of the inputs / float4 stores of the outputs
  int bf16;             // the operands' dtype: bf16, else f32
  float cap;        // 0: none
  float inv_cap;
  float scale;
};

__device__ __forceinline__ bool visible(const ShortArgs& a, int i, int j) {
  return j < a.skv && (!a.causal || j <= i) && (a.window < 0 || i - j < a.window);
}

// Rows [0, n) of each of the CTA's U units into dst[unit][row][0, DP) (row
// stride ld words) as f32: row lr of unit u is the tensor's (position,
// head) = ((r0 + lr) / G, kv head * G + (r0 + lr) % G); zeros past `limit`
// rows, past D and for units past the last. f32 with 16-byte rows and
// strides (vec_in) goes by cp.async, to be waited for with
// cp_async_wait_all; anything else through registers.
template <int DP, int NT, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, int n, int r0, int G, int limit,
                                      const void* src_v, const int64_t* st, int64_t u0,
                                      const ShortArgs& a) {
  const T* src = static_cast<const T*>(src_v);
  constexpr int E = 16 / (int)sizeof(T);   // elements of a 16-byte chunk
  constexpr int CH = DP / E < 1 ? 1 : DP / E;
  for (int ul = 0; ul < a.units; ++ul) {
    const int64_t gu = u0 + ul;
    const bool unit = gu < a.n_units;
    const int64_t b = unit ? gu / a.hkv : 0, hk = unit ? gu % a.hkv : 0;
    const T* base = src + b * st[0] + hk * G * st[2];
    float* out = dst + ul * n * ld;
    if (a.vec_in) {
      for (int idx = threadIdx.x; idx < n * CH; idx += NT) {
        const int lr = idx / CH, c = idx % CH, rr = r0 + lr;
        const bool ok = unit && rr < limit && c * E < a.d;
        const int pos = G == 1 ? rr : rr / G, gh = G == 1 ? 0 : rr % G;
        const T* p = ok ? base + (int64_t)pos * st[1] + gh * st[2] + c * E : src;
        if constexpr (sizeof(T) == 4) {
          cp_async16(out + lr * ld + c * E, p, ok);
        } else {
          float x[E];
#pragma unroll
          for (int e = 0; e < E; ++e) x[e] = 0.f;
          if (ok) {
            const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
            const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
            for (int i = 0; i < E; ++i) x[i] = to_f(e[i]);
          }
#pragma unroll
          for (int i = 0; i < E && i < DP; i += 4)
            *reinterpret_cast<float4*>(out + lr * ld + c * E + i) =
                make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < n * DP; idx += NT) {
        const int lr = idx / DP, c = idx % DP, rr = r0 + lr;
        float x = 0.f;
        if (unit && rr < limit && c < a.d) {
          const int pos = G == 1 ? rr : rr / G, gh = G == 1 ? 0 : rr % G;
          x = to_f(base[(int64_t)pos * st[1] + gh * st[2] + c]);
        }
        out[lr * ld + c] = x;
      }
    }
  }
}

// stage() for the operands' dtype (a.bf16), picked at run time: only the
// loads differ, so each kernel is built once for both dtypes
template <int DP, int NT>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int n, int r0, int G, int limit,
                                           const void* src, const int64_t* st, int64_t u0,
                                           const ShortArgs& a) {
  if (a.bf16)
    stage<DP, NT, __nv_bfloat16>(dst, ld, n, r0, G, limit, src, st, u0, a);
  else
    stage<DP, NT, float>(dst, ld, n, r0, G, limit, src, st, u0, a);
}

// The inverse for f32 outputs: rows [0, n) of each unit from src (unit
// stride us, row stride ld), plus src2 at the same offsets where given, to
// the tensor, columns < D, rows < limit, units that exist
template <int NT>
__device__ __forceinline__ void store(float* dst, const int64_t* st, const float* src,
                                      const float* src2, int us, int ld, int n, int r0, int G,
                                      int limit, int64_t u0, const ShortArgs& a) {
  const int ch = a.vec_out ? a.d / 4 : a.d, w = a.vec_out ? 4 : 1;
  for (int ul = 0; ul < a.units; ++ul) {
    const int64_t gu = u0 + ul;
    if (gu >= a.n_units) break;
    const int64_t b = gu / a.hkv, hk = gu % a.hkv;
    float* base = dst + b * st[0] + hk * G * st[2];
    const int rows = min(n, limit - r0);
    for (int idx = threadIdx.x; idx < rows * ch; idx += NT) {
      const int lr = idx / ch, c = idx % ch, rr = r0 + lr;
      const int pos = G == 1 ? rr : rr / G, gh = G == 1 ? 0 : rr % G;
      float* p = base + (int64_t)pos * st[1] + gh * st[2] + c * w;
      const int off = ul * us + lr * ld + c * w;
      if (w == 4) {
        float4 x = *reinterpret_cast<const float4*>(src + off);
        if (src2) {
          const float4 y = *reinterpret_cast<const float4*>(src2 + off);
          x = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
        }
        *reinterpret_cast<float4*>(p) = x;
      } else {
        *p = src2 ? src[off] + src2[off] : src[off];
      }
    }
  }
}

// Step 2, one item: rows [16 m, 16 m + 16) of A (Q or dO, row stride lda)
// for m < mcount (1 or 2) against the keys of n-tiles [nt0, nt0 + 4) below
// n_tiles of B (K or V, stride ldb), into C (stride ldc) at the same rows
// and keys; `scores`: S times the scale, under the softcap, and -inf
// where the key is not visible (row 16 m + gr + 8 h sees keys [lo[m][h],
// hi[m][h])). Eight independent accumulator chains, each B fragment split once for both row
// tiles, the three TF32 products issued as three passes over the eight
// tiles (so no mma waits on the one before it); no branch inside (a row or
// key tile past the last is computed on clamped indices and not stored).
// The k index of each 8-column step is permuted, slot t <-> column 2t and
// slot t + 4 <-> column 2t + 1, alike in A and B, so each lane loads
// float2s.
template <int DP>
__device__ __forceinline__ void product_item(const float* A, int lda, const float* B, int ldb,
                                             float* C, int ldc, int mcount, int nt0,
                                             int n_tiles, bool scores, const int (&lo)[2][2],
                                             const int (&hi)[2][2], const ShortArgs& a,
                                             int gr, int t) {
  constexpr int KS = DP / 8;
  const int m1 = mcount > 1 ? 16 : 0;    // the second row tile, or the first again
  int nb[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) nb[n] = 8 * min(nt0 + n, n_tiles - 1);
  float c[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[m][n][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* ar = A + (m * m1 + gr) * lda + 8 * ks + 2 * t;
      const float2 x0 = lds2(ar), x1 = lds2(ar + 8 * lda);
      split4(x0.x, x1.x, x0.y, x1.y, ah[m], al[m]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float2 y = lds2(B + (nb[n] + gr) * ldb + 8 * ks + 2 * t);
      split(y.x, bh[n][0], bl[n][0]);
      split(y.y, bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma(c[m][n], ah[m], bh[n][0], bh[n][1]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma(c[m][n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) mma(c[m][n], al[m], bh[n][0], bh[n][1]);
  }
  if (scores) {   // the scale, the softcap (a uniform branch around its loop), the mask
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[m][n][i] *= a.scale;
    if (a.cap > 0.f) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[m][n][i] = a.cap * tanhf(c[m][n][i] * a.inv_cap);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i / 2, j = 8 * (nt0 + n) + 2 * t + (i & 1);
          const bool ok = (unsigned)(j - lo[m][h]) < (unsigned)(hi[m][h] - lo[m][h]);
          c[m][n][i] = ok ? c[m][n][i] : -INFINITY;
        }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (m >= mcount) break;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int nt = nt0 + n;
      if (nt >= n_tiles) break;
      float* cr = C + (16 * m + gr) * ldc + 8 * nt + 2 * t;
      sts2(cr, c[m][n][0], c[m][n][1]);
      sts2(cr + 8 * ldc, c[m][n][2], c[m][n][3]);
    }
  }
}

// Step 4b, one 8-key step of dQ = dS K for QN 8-column tiles: A = dS at
// the item's 16 rows (row stride sp, lanes at column 2t), B = K (row
// stride sk, lanes at column gr); the k slots permuted as in step 2, the
// three TF32 products as three passes over the tiles
template <int QN>
__device__ __forceinline__ void dq_step(float (&c)[QN][4], const float* A, const float* B,
                                        int ks, int sp, int sk, int gr) {
  const float2 x0 = lds2(A + gr * sp + 8 * ks);
  const float2 x1 = lds2(A + (gr + 8) * sp + 8 * ks);
  uint32_t ah[4], al[4], bh[QN][2], bl[QN][2];
  split4(x0.x, x1.x, x0.y, x1.y, ah, al);
  const float* b = B + (8 * ks + 2 * (threadIdx.x % 4)) * sk;
#pragma unroll
  for (int n = 0; n < QN; ++n) {
    split(b[8 * n], bh[n][0], bl[n][0]);
    split(b[sk + 8 * n], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < QN; ++n) mma(c[n], ah, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < QN; ++n) mma(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < QN; ++n) mma(c[n], al, bh[n][0], bh[n][1]);
}

template <int DP>
__global__ void __launch_bounds__(kShortWarps * kWarp, 1)
flash_backward_short_kernel(const ShortArgs a) {
  constexpr int NW = kShortWarps, NT = NW * kWarp;
  constexpr int KS = DP / 8;               // 8-column steps of D
  extern __shared__ float4 smem4[];
  const int U = a.units, RG = a.rg, SP = a.s_pad;
  float* Ks = reinterpret_cast<float*>(smem4);   // [U][SP][sk], then dK
  float* Vs = Ks + U * SP * a.sk;                 // [U][SP][sk], then dV
  float* Qs = Vs + U * SP * a.sk;                 // [U][RG][sq]
  float* dOs = Qs + U * RG * a.sq;                // [U][RG][sq]
  float* Os = dOs + U * RG * a.sq;                // [U][RG][sq]
  float* Ps = Os + U * RG * a.sq;                 // [U][RG][sp]: S, then P, then dQ
  float* dSs = Ps + U * RG * a.sp;                // [U][RG][sp]: dP, then dS
  float* delta = dSs + U * RG * a.sp;             // [U][RG]

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int gr = lane / 4, t = lane % 4;
  const int64_t u0 = (int64_t)blockIdx.x * U;
  const int KMT = SP / 16;                        // 16-key tiles a unit
  const int KPR = (KMT + 1) / 2;                  // pairs of key tiles
  const int n_kv = 2 * U * KPR;                   // (unit, key tile pair, dK or dV) items
  const int ksplit = a.sp >= 2 * a.sq ? 2 : 1;    // dQ items a row tile: key halves
  const int n_tiles = (a.skv + 7) / 8;            // 8-key tiles that hold a key

  float acc[kKvItems][2][KS][4];
#pragma unroll
  for (int x = 0; x < kKvItems; ++x)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[x][m][n][i] = 0.f;

  // K, V and the first group's rows, all in flight together
  stage_rows<DP, NT>(Ks, a.sk, SP, 0, 1, a.skv, a.k, a.k_s, u0, a);
  stage_rows<DP, NT>(Vs, a.sk, SP, 0, 1, a.skv, a.v, a.v_s, u0, a);
  stage_rows<DP, NT>(Qs, a.sq, RG, 0, a.g, a.rows, a.q, a.q_s, u0, a);
  stage_rows<DP, NT>(dOs, a.sq, RG, 0, a.g, a.rows, a.dout, a.do_s, u0, a);
  stage_rows<DP, NT>(Os, a.sq, RG, 0, a.g, a.rows, a.o, a.o_s, u0, a);

  for (int r0 = 0; r0 < a.rows; r0 += RG) {
    // 1. the group's rows landed; delta
    cp_async_wait_all();
    __syncthreads();
    for (int r = tid; r < U * RG; r += NT) {
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) sum = fmaf(dOs[r * a.sq + c], Os[r * a.sq + c], sum);
      delta[r] = sum;
    }

    // 2. S (scaled, capped, masked to -inf) and dP into Ps and dSs, by
    // (unit, 32 rows, product, 32 keys) items over the group's row tiles
    // that hold a row
    const int mts = (min(RG, a.rows - r0) + 15) / 16;
    {
      const int mps = (mts + 1) / 2, nch = (n_tiles + 3) / 4;
      const int n_items = U * mps * 2 * nch;
      for (int it = warp; it < n_items; it += NW) {
        const int nc = it % nch, rest = it / nch, prod = rest % 2;
        const int mp = (rest / 2) % mps, ul = rest / 2 / mps;
        const int row = ul * RG + 32 * mp;
        const bool s_item = prod == 0;
        int lo[2][2], hi[2][2];   // each row's visible keys: [lo, hi)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = r0 + 32 * mp + 16 * m + 8 * h + gr, i = rr / a.g;
            lo[m][h] = a.window >= 0 ? max(0, i - a.window + 1) : 0;
            hi[m][h] = rr >= a.rows ? lo[m][h]
                                    : max(lo[m][h], a.causal ? min(a.skv, i + 1) : a.skv);
          }
        product_item<DP>((s_item ? Qs : dOs) + row * a.sq, a.sq,
                         (s_item ? Ks : Vs) + ul * SP * a.sk, a.sk,
                         (s_item ? Ps : dSs) + row * a.sp, a.sp, min(2, mts - 2 * mp),
                         4 * nc, n_tiles, s_item, lo, hi, a, gr, t);
      }
    }
    __syncthreads();
    // the next group's o in flight: delta, its only reader, is done
    if (r0 + RG < a.rows)
      stage_rows<DP, NT>(Os, a.sq, RG, r0 + RG, a.g, a.rows, a.o, a.o_s, u0, a);

    // 3. P and dS, four threads a row (a warp's rows are 8 consecutive
    // rows of U * RG, a multiple of 16: every lane of a warp takes the
    // loop's branches alike): the row's S in registers (a thread's keys
    // 2 sub + 8 i and the next), its max and sum over them, then P and dS
    // in place of S and dP; keys past the last 8-key tile get zeros
    {
      const int kw = 8 * n_tiles;
      for (int row = tid / kRowThreads; row < U * RG; row += NT / kRowThreads) {
        if (row % RG >= 16 * mts) continue;   // a whole row tile past the last row
        const int sub = tid % kRowThreads;
        float* prow = Ps + row * a.sp + 2 * sub;
        float* drow = dSs + row * a.sp + 2 * sub;
        float2 sv[kPairs];
#pragma unroll
        for (int i = 0; i < kPairs; ++i)
          sv[i] = 8 * i < kw ? lds2(prow + 8 * i) : make_float2(-INFINITY, -INFINITY);
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) m = fmaxf(m, fmaxf(sv[i].x, sv[i].y));
        m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
        m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
        const float mm = m == -INFINITY ? 0.f : m;   // a row that sees no key: l = 0
        float l = 0.f;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          if (8 * i >= kw) break;
          l += __expf(sv[i].x - mm) + __expf(sv[i].y - mm);
        }
        l += __shfl_xor_sync(kFull, l, 1);
        l += __shfl_xor_sync(kFull, l, 2);
        const float lse = l > 0.f ? m + logf(l) : INFINITY;
        const float dl = delta[row];
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          if (8 * i >= SP) break;
          float p[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
          if (8 * i < kw) {
            const float2 dp = lds2(drow + 8 * i);
            const float s2[2] = {sv[i].x, sv[i].y}, dv[2] = {dp.x, dp.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              p[e] = __expf(s2[e] - lse);   // 0 where s = -inf
              float dcap = 1.f;
              if (a.cap > 0.f) {            // 0, not -inf, where s = -inf
                const float tc = s2[e] * a.inv_cap;
                dcap = fmaxf(1.f - tc * tc, 0.f);
              }
              ds[e] = p[e] * (dv[e] - dl) * dcap;
            }
          }
          sts2(prow + 8 * i, p[0], p[1]);
          sts2(drow + 8 * i, ds[0], ds[1]);
        }
      }
    }
    __syncthreads();

    // 4a. dV += P^T dO and dK += dS^T Q over the group's rows, by the
    // pairs of key tiles each warp owns: A[key][row] read across rows (slot
    // t <-> row t), each B fragment split once for both key tiles, the
    // three TF32 products as three passes
    {
      const int nk = (min(RG, a.rows - r0) + 7) / 8;   // 8-row steps holding a row
#pragma unroll
      for (int x = 0; x < kKvItems; ++x) {
        const int it = warp + NW * x;
        if (it >= n_kv) break;
        const int prod = it % 2, kp = (it / 2) % KPR, ul = it / 2 / KPR;
        const int m1 = 2 * kp + 1 < KMT ? 16 : 0;   // the second key tile, or the first again
        const float* A = (prod ? dSs : Ps) + ul * RG * a.sp + 32 * kp + gr;
        const float* B = (prod ? Qs : dOs) + ul * RG * a.sq + gr;
        float c[2][KS][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < KS; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) c[m][n][i] = 0.f;
        for (int ks = 0; ks < nk; ++ks) {
          uint32_t ah[2][4], al[2][4], bh[KS][2], bl[KS][2];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* a0 = A + (8 * ks + t) * a.sp + m * m1;
            const float* a1 = a0 + 4 * a.sp;
            split4(a0[0], a0[8], a1[0], a1[8], ah[m], al[m]);
          }
          const float* b0 = B + (8 * ks + t) * a.sq;
          const float* b1 = b0 + 4 * a.sq;
#pragma unroll
          for (int n = 0; n < KS; ++n) {
            split(b0[8 * n], bh[n][0], bl[n][0]);
            split(b1[8 * n], bh[n][1], bl[n][1]);
          }
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < KS; ++n) mma(c[m][n], ah[m], bh[n][0], bh[n][1]);
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < KS; ++n) mma(c[m][n], ah[m], bl[n][0], bl[n][1]);
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int n = 0; n < KS; ++n) mma(c[m][n], al[m], bh[n][0], bh[n][1]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < KS; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[x][m][n][i] += c[m][n][i];
      }
    }
    __syncthreads();
    // the next group's Q and dO in flight (read no more) while this group's
    // dQ is computed and goes out
    if (r0 + RG < a.rows) {
      stage_rows<DP, NT>(Qs, a.sq, RG, r0 + RG, a.g, a.rows, a.q, a.q_s, u0, a);
      stage_rows<DP, NT>(dOs, a.sq, RG, r0 + RG, a.g, a.rows, a.dout, a.do_s, u0, a);
    }
    // 4b. dQ = scale * dS K by (unit, row tile, half of the keys) items, all
    // of D's 8-column tiles an item, even and odd 8-key steps on their own
    // chains; each half's partial sum into P's rows (P is read no more), at
    // the head-dim stride, the second half RG rows on where P's rows hold
    // both (ksplit 2); the store adds the halves in that order
    {
      const int n_items = U * mts * ksplit;
      const int kh = ksplit == 2 ? (n_tiles + 1) / 2 : n_tiles;
      for (int it = warp; it < n_items; it += NW) {
        const int half = it % ksplit, mt = (it / ksplit) % mts, ul = it / ksplit / mts;
        const int row = ul * RG + 16 * mt;
        const float* A = dSs + row * a.sp + 2 * t;
        const float* B = Ks + ul * SP * a.sk + gr;
        const int k0 = half * kh, k1 = half ? n_tiles : kh;
        float c0[KS][4], c1[KS][4];
#pragma unroll
        for (int n = 0; n < KS; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) c0[n][i] = c1[n][i] = 0.f;
        int ks = k0;
        for (; ks + 1 < k1; ks += 2) {
          dq_step<KS>(c0, A, B, ks, a.sp, a.sk, gr);
          dq_step<KS>(c1, A, B, ks + 1, a.sp, a.sk, gr);
        }
        if (ks < k1) dq_step<KS>(c0, A, B, ks, a.sp, a.sk, gr);
        float* dst = Ps + ul * RG * a.sp + (half * RG + 16 * mt) * a.sq + 2 * t;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          sts2(dst + gr * a.sq + 8 * n, (c0[n][0] + c1[n][0]) * a.scale,
               (c0[n][1] + c1[n][1]) * a.scale);
          sts2(dst + (gr + 8) * a.sq + 8 * n, (c0[n][2] + c1[n][2]) * a.scale,
               (c0[n][3] + c1[n][3]) * a.scale);
        }
      }
    }
    __syncthreads();
    store<NT>(a.dq, a.dq_s, Ps, ksplit == 2 ? Ps + RG * a.sq : nullptr, RG * a.sp, a.sq, RG,
              r0, a.g, a.rows, u0, a);
  }

  // dK (times the scale) and dV into the K and V buffers, then out (every
  // read of K and V ended at the last group's barrier)
#pragma unroll
  for (int x = 0; x < kKvItems; ++x) {
    const int it = warp + NW * x;
    if (it >= n_kv) break;
    const int prod = it % 2, kp = (it / 2) % KPR, ul = it / 2 / KPR;
    const float f = prod ? a.scale : 1.f;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (2 * kp + m >= KMT) break;
      float* dst = (prod ? Ks : Vs) + (ul * SP + 32 * kp + 16 * m + gr) * a.sk + 2 * t;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        sts2(dst + 8 * n, acc[x][m][n][0] * f, acc[x][m][n][1] * f);
        sts2(dst + 8 * a.sk + 8 * n, acc[x][m][n][2] * f, acc[x][m][n][3] * f);
      }
    }
  }
  __syncthreads();
  store<NT>(a.dk, a.dk_s, Ks, nullptr, SP * a.sk, a.sk, SP, 0, 1, a.skv, u0, a);
  store<NT>(a.dv, a.dv_s, Vs, nullptr, SP * a.sk, a.sk, SP, 0, 1, a.skv, u0, a);
}

// ---- the CUDA-core route for tiny heads: D <= 8, Skv <= 32 -------------

constexpr int kTinyThreads = 128;
constexpr int kTinyKeys = 32;

// row `pos`, head `h` of a [B, S, H, D] operand of batch entry b into x[0,
// DT) as f32, zeros past D (and everywhere when !ok)
template <int DT, typename T>
__device__ __forceinline__ void load_row(float (&x)[DT], const void* src_v,
                                         const int64_t* st, int64_t b, int64_t h, int pos,
                                         bool ok, const ShortArgs& a) {
#pragma unroll
  for (int i = 0; i < DT; ++i) x[i] = 0.f;
  if (!ok) return;
  const T* p = static_cast<const T*>(src_v) + b * st[0] + (int64_t)pos * st[1] + h * st[2];
  constexpr int E = 16 / (int)sizeof(T);
  if (a.vec_in) {
#pragma unroll
    for (int c = 0; c < (DT + E - 1) / E; ++c) {
      if (c * E >= a.d) break;
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p + c * E));
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int i = 0; i < E && c * E + i < DT; ++i) x[c * E + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < DT; ++i)
      if (i < a.d) x[i] = to_f(p[i]);
  }
}

// load_row() for the operands' dtype (a.bf16), picked at run time
template <int DT>
__device__ __forceinline__ void load_any(float (&x)[DT], const void* src, const int64_t* st,
                                         int64_t b, int64_t h, int pos, bool ok,
                                         const ShortArgs& a) {
  if (a.bf16)
    load_row<DT, __nv_bfloat16>(x, src, st, b, h, pos, ok, a);
  else
    load_row<DT, float>(x, src, st, b, h, pos, ok, a);
}

// x[0, D) to row `pos`, head `h` of an f32 [B, S, H, D] output, times f
template <int DT>
__device__ __forceinline__ void store_row(float* dst, const int64_t* st, int64_t b, int64_t h,
                                          int pos, const float (&x)[DT], float f,
                                          const ShortArgs& a) {
  float* p = dst + b * st[0] + (int64_t)pos * st[1] + h * st[2];
  if (a.vec_out) {
#pragma unroll
    for (int c = 0; c < DT; c += 4)
      if (c < a.d)
        *reinterpret_cast<float4*>(p + c) =
            make_float4(x[c] * f, x[c + 1] * f, x[c + 2] * f, x[c + 3] * f);
  } else {
#pragma unroll
    for (int i = 0; i < DT; ++i)
      if (i < a.d) p[i] = x[i] * f;
  }
}

template <int DT>
__device__ __forceinline__ float dot_row(const float (&x)[DT], const float* r) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < DT; c += 4) {
    const float4 y = *reinterpret_cast<const float4*>(r + c);
    acc = fmaf(x[c], y.x, acc);
    acc = fmaf(x[c + 1], y.y, acc);
    acc = fmaf(x[c + 2], y.z, acc);
    acc = fmaf(x[c + 3], y.w, acc);
  }
  return acc;
}

// One thread a (position, group head) row: thread tid is row tid / U of
// unit tid % U, so neighbouring threads read neighbouring heads. Q, dO and
// o rows and (for rows r < Skv) the K and V rows r come from device memory
// into registers at once; K, V, Q and dO go to shared memory. Each row
// then scores every key (S in 32 registers), takes its softmax over the
// whole row, and computes P, dS and dQ; P and dS go to shared memory
// [unit][row][key]; then each thread r < Skv sums dV and dK of key r over
// the unit's rows. f32 FMA throughout: 10 * DT FLOPs a pair.
template <int DT>
__global__ void __launch_bounds__(kTinyThreads)
flash_backward_tiny_kernel(const ShortArgs a) {
  extern __shared__ float4 smem4[];
  const int U = a.units, R = a.rows, S = a.skv, PS = a.sp;
  float* Ks = reinterpret_cast<float*>(smem4);   // [U][S][DT]
  float* Vs = Ks + U * S * DT;
  float* Qs = Vs + U * S * DT;                    // [U][R][DT]
  float* dOs = Qs + U * R * DT;
  float* Ps = dOs + U * R * DT;                   // [U][R][PS]
  float* dSs = Ps + U * R * PS;
  const int tid = threadIdx.x, ul = tid % U, r = tid / U;
  const int64_t gu = (int64_t)blockIdx.x * U + ul;
  const bool unit = gu < a.n_units, row = r < R;
  const int64_t b = unit ? gu / a.hkv : 0, hk = unit ? gu % a.hkv : 0;
  const int pos = r / a.g, h = (int)hk * a.g + r % a.g;

  float q[DT], dout[DT], o[DT], kr[DT], vr[DT];
  load_any<DT>(q, a.q, a.q_s, b, h, pos, unit && row, a);
  load_any<DT>(dout, a.dout, a.do_s, b, h, pos, unit && row, a);
  load_any<DT>(o, a.o, a.o_s, b, h, pos, unit && row, a);
  load_any<DT>(kr, a.k, a.k_s, b, hk, r, unit && r < S, a);
  load_any<DT>(vr, a.v, a.v_s, b, hk, r, unit && r < S, a);
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < DT; ++i) delta = fmaf(dout[i], o[i], delta);
  if (row) {
    float* qs = Qs + (ul * R + r) * DT;
    float* ds = dOs + (ul * R + r) * DT;
#pragma unroll
    for (int c = 0; c < DT; c += 4) {
      *reinterpret_cast<float4*>(qs + c) = make_float4(q[c], q[c + 1], q[c + 2], q[c + 3]);
      *reinterpret_cast<float4*>(ds + c) =
          make_float4(dout[c], dout[c + 1], dout[c + 2], dout[c + 3]);
    }
  }
  if (r < S) {
    float* ks = Ks + (ul * S + r) * DT;
    float* vs = Vs + (ul * S + r) * DT;
#pragma unroll
    for (int c = 0; c < DT; c += 4) {
      *reinterpret_cast<float4*>(ks + c) = make_float4(kr[c], kr[c + 1], kr[c + 2], kr[c + 3]);
      *reinterpret_cast<float4*>(vs + c) = make_float4(vr[c], vr[c + 1], vr[c + 2], vr[c + 3]);
    }
  }
  __syncthreads();

  if (row) {
    const float* Ku = Ks + ul * S * DT;
    const float* Vu = Vs + ul * S * DT;
    float sc[kTinyKeys];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTinyKeys; ++j) {
      if (j >= S) break;
      sc[j] = dot_row<DT>(q, Ku + j * DT) * a.scale;
    }
    if (a.cap > 0.f) {   // a uniform branch around the loop
#pragma unroll
      for (int j = 0; j < kTinyKeys; ++j) {
        if (j >= S) break;
        sc[j] = a.cap * tanhf(sc[j] * a.inv_cap);
      }
    }
#pragma unroll
    for (int j = 0; j < kTinyKeys; ++j) {
      if (j >= S) break;
      sc[j] = visible(a, pos, j) ? sc[j] : -INFINITY;
      m = fmaxf(m, sc[j]);
    }
    const float mm = m == -INFINITY ? 0.f : m;   // a row that sees no key: l = 0
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kTinyKeys; ++j) {
      if (j >= S) break;
      l += __expf(sc[j] - mm);
    }
    const float lse = l > 0.f ? m + logf(l) : INFINITY;
    float dq[DT];
#pragma unroll
    for (int i = 0; i < DT; ++i) dq[i] = 0.f;
    float* prow = Ps + (ul * R + r) * PS;
    float* drow = dSs + (ul * R + r) * PS;
#pragma unroll
    for (int j = 0; j < kTinyKeys; ++j) {
      if (j >= S) break;
      const float p = __expf(sc[j] - lse);   // 0 where s = -inf
      float dcap = 1.f;
      if (a.cap > 0.f) {                     // 0, not -inf, where s = -inf
        const float tc = sc[j] * a.inv_cap;
        dcap = fmaxf(1.f - tc * tc, 0.f);
      }
      const float ds = p * (dot_row<DT>(dout, Vu + j * DT) - delta) * dcap;
      const float4* kj = reinterpret_cast<const float4*>(Ku + j * DT);
#pragma unroll
      for (int c = 0; c < DT / 4; ++c) {
        const float4 y = kj[c];
        dq[4 * c] = fmaf(ds, y.x, dq[4 * c]);
        dq[4 * c + 1] = fmaf(ds, y.y, dq[4 * c + 1]);
        dq[4 * c + 2] = fmaf(ds, y.z, dq[4 * c + 2]);
        dq[4 * c + 3] = fmaf(ds, y.w, dq[4 * c + 3]);
      }
      prow[j] = p;
      drow[j] = ds;
    }
    if (unit) store_row<DT>(a.dq, a.dq_s, b, h, pos, dq, a.scale, a);
  }
  __syncthreads();

  if (row && r < S && unit) {   // key r of the unit: sums over its rows
    float dk[DT], dv[DT];
#pragma unroll
    for (int i = 0; i < DT; ++i) dk[i] = dv[i] = 0.f;
    const float* pc = Ps + ul * R * PS + r;
    const float* dc = dSs + ul * R * PS + r;
    const float* qu = Qs + ul * R * DT;
    const float* du = dOs + ul * R * DT;
    for (int i = 0; i < R; ++i) {
      const float p = pc[i * PS], ds = dc[i * PS];
#pragma unroll
      for (int c = 0; c < DT; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(du + i * DT + c);
        const float4 y = *reinterpret_cast<const float4*>(qu + i * DT + c);
        dv[c] = fmaf(p, x.x, dv[c]);
        dv[c + 1] = fmaf(p, x.y, dv[c + 1]);
        dv[c + 2] = fmaf(p, x.z, dv[c + 2]);
        dv[c + 3] = fmaf(p, x.w, dv[c + 3]);
        dk[c] = fmaf(ds, y.x, dk[c]);
        dk[c + 1] = fmaf(ds, y.y, dk[c + 1]);
        dk[c + 2] = fmaf(ds, y.z, dk[c + 2]);
        dk[c + 3] = fmaf(ds, y.w, dk[c + 3]);
      }
    }
    store_row<DT>(a.dk, a.dk_s, b, hk, r, dk, a.scale, a);
    store_row<DT>(a.dv, a.dv_s, b, hk, r, dv, 1.f, a);
  }
}

int64_t tiny_smem_bytes(int dt, int s, int rows, int units, int ps) {
  return 4 * (int64_t)units * (2 * s * dt + 2 * rows * dt + 2 * rows * ps);
}

template <int DT>
int launch_tiny(const ShortArgs& a, int64_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_backward_tiny_kernel<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (a.n_units + a.units - 1) / a.units;
  flash_backward_tiny_kernel<DT><<<(unsigned)grid, kTinyThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// a row stride in words: at least w, 8 mod 32
int words8(int w) { return w + ((8 - w) % 32 + 32) % 32; }

int64_t smem_bytes(int dp, int s_pad, int rg, int units) {
  const int64_t sq = words8(dp), sp = words8(s_pad);
  return 4 * (int64_t)units * (2 * s_pad * sq + 3 * rg * sq + 2 * rg * sp + rg);
}

template <int DP>
int launch_short(const ShortArgs& a, int64_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_backward_short_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (a.n_units + a.units - 1) / a.units;
  flash_backward_short_kernel<DP><<<(unsigned)grid, kShortWarps * kWarp, (size_t)smem,
                                    stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

void copy3(int64_t* dst, const int64_t* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

}  // namespace
}  // namespace repro_torch

// strides: 8 groups of [batch, position, head] element strides, in the
// order q, k, v, o, dO, dQ, dK, dV; the plan (tiny, dp, s_pad, rows, units,
// warps, p_words) and its shared-memory bytes as flash_backward.short_plan
// gives them
extern "C" int flash_backward_short_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* dq, void* dk, void* dv, int64_t B, int64_t S, int64_t Skv, int64_t Hq,
    int64_t Hkv, int64_t D, const int64_t* strides, int tiny, int64_t dp, int64_t s_pad,
    int64_t rows, int64_t units, int64_t warps, int64_t p_words, int64_t window, float cap,
    float scale, int causal, int bf16, int64_t smem, void* stream) {
  using namespace repro_torch;
  if (Hkv <= 0 || Hq % Hkv || B <= 0 || S <= 0 || Skv <= 0 || D < 1 || units < 1 ||
      S * (Hq / Hkv) > (1 << 30) || smem > 232448)
    return (int)cudaErrorInvalidValue;
  const int64_t g = Hq / Hkv;
  if (tiny) {
    if (dp != (D <= 4 ? 4 : 8) || D > 8 || Skv > kTinyKeys || s_pad != Skv ||
        rows != S * g || units * rows > kTinyThreads || p_words < Skv || warps != 4 ||
        smem != tiny_smem_bytes((int)dp, (int)Skv, (int)rows, (int)units, (int)p_words))
      return (int)cudaErrorInvalidValue;
  } else if (dp != (D <= 8 ? 8 : D <= 16 ? 16 : 32) || D > 32 || s_pad < Skv || s_pad % 16 ||
             s_pad > 256 || rows < 16 || rows % 16 || warps != kShortWarps ||
             2 * units * ((s_pad / 16 + 1) / 2) > kKvItems * warps ||
             p_words != words8((int)s_pad) ||
             smem != smem_bytes((int)dp, (int)s_pad, (int)rows, (int)units)) {
    return (int)cudaErrorInvalidValue;
  }
  ShortArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  int64_t* dst[8] = {a.q_s, a.k_s, a.v_s, a.o_s, a.do_s, a.dq_s, a.dk_s, a.dv_s};
  for (int i = 0; i < 8; ++i) copy3(dst[i], strides + 3 * i);
  a.n_units = B * Hkv;
  a.skv = (int)Skv;
  a.hkv = (int)Hkv;
  a.g = (int)g;
  a.d = (int)D;
  a.rows = (int)(S * g);
  a.s_pad = (int)s_pad;
  a.rg = (int)rows;
  a.units = (int)units;
  a.sq = tiny ? (int)dp : words8((int)dp);
  a.sk = a.sq;
  a.sp = (int)p_words;
  a.window = (int)window;
  a.causal = causal;
  a.cap = cap;
  a.inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  a.scale = scale;
  const int64_t esize = bf16 ? 2 : 4;
  bool vin = (D * esize) % 16 == 0;
  const void* ins[5] = {q, k, v, o, dout};
  for (int i = 0; i < 5; ++i) {
    vin = vin && aligned16(ins[i]);
    for (int j = 0; j < 3; ++j) vin = vin && (strides[3 * i + j] * esize) % 16 == 0;
  }
  bool vout = D % 4 == 0;
  const void* outs[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i) {
    vout = vout && aligned16(outs[i]);
    for (int j = 0; j < 3; ++j) vout = vout && strides[15 + 3 * i + j] % 4 == 0;
  }
  a.vec_in = vin;
  a.vec_out = vout;
  a.bf16 = bf16;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tiny) return dp == 4 ? launch_tiny<4>(a, smem, st) : launch_tiny<8>(a, smem, st);
  switch (dp) {
    case 8: return launch_short<8>(a, smem, st);
    case 16: return launch_short<16>(a, smem, st);
    default: return launch_short<32>(a, smem, st);
  }
}
