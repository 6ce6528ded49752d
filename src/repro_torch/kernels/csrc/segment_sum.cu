// segment_sum: out[n, :] = out0[n, :] + the rows of segment n, as f32 [N, F],
// each segment's rows added one at a time, left to right, in f32 (round to
// nearest, no contraction). out0 may be null (zeros) and may be out itself
// (each value is read and written by the same thread).
//
// Replaces no Pallas kernel. The reference's EGNN sums its edge messages
// onto the nodes with XLA's jax.ops.segment_sum (src/repro/models/egnn.py:
// 108-110), and the gradients of its edge gathers are segment sums too.
// PyTorch's index_add_ on CUDA adds with float atomics, whose order changes
// from run to run; here the order is the plan's (the valid rows by segment,
// stably), so a training step repeats its bits, and the result equals a
// sequential index_add_ on the CPU in the same order bit for bit.
//
// Bound on an H100: bytes. Each valid row read once (M*F*4), the index
// (perm M*4 and offsets (N+1)*4, or the offsets of the node range), out0 and
// out over the summed nodes (N*F*4 each), over 3.35 TB/s; one add a value
// read. Two routes, chosen by the plan:
//
//   gather (segment_sum_launch): a plan with a perm, rows[perm[offsets[n]]],
//     ... in any order (the sums by src, graph pooling). Every one of the N
//     segments is written.
//     half:   F >= 16, F % 4 == 0, 16-byte aligned operands (EGNN's F = 64).
//             A half-warp a segment, a float4 a lane (a 256-byte row is one
//             load instruction); the 16 lanes read 16 perm entries at once
//             and pass them round by shuffle, and all 16 rows are loaded
//             before any is added, so 16 random rows are in flight a
//             half-warp while the sum itself runs in order. Rows are read
//             once: no L1 allocation, L2 evict-first.
//     warp:   other F > 8. A warp a segment, lanes over F, kSegCols columns
//             a lane in each pass of 128 columns, kSegAhead rows in flight.
//     thread: F <= 8 (the coordinate updates, F = 3; pooling, F = 1). A
//             thread a segment, its F sums in registers, kSegAhead rows
//             loaded ahead.
//   stream (segment_sum_stream_launch): rows already in segment order (no
//     perm; segment n is rows offsets[n] .. offsets[n + 1] - 1), summed only
//     over the node range bounds = [n_lo, n_hi) read on the device, and
//     written only there (the caller holds out0 outside it: EGNN's chunks
//     run in place on a running sum). A persistent grid, one CTA an SM:
//     each CTA takes an equal run of the range's rows and owns the segments
//     whose first row lies in it, then streams the rows from its first
//     segment's start to its last one's end through a ring of kStages
//     shared-memory stages. One producer thread keeps the stages filled by
//     1-D bulk asynchronous copies (cp.async.bulk, completing on an mbarrier
//     a stage); since a stage holds whole rows and F = 3 rows start at
//     12-byte steps, it copies the 16-byte aligned superset of its rows and
//     the consumers offset into it. Eight consumer warps add each segment's
//     rows from shared memory in order: a warp a segment, lanes over
//     columns, at F > 8; a thread a segment at F <= 8. Segment n goes to
//     the same consumer in every stage, so a segment longer than a stage is
//     carried across stages by its one owner with its sums in registers.
//
// No atomics and no tree: a hub segment runs on one warp or thread.
#include "common.cuh"
#include "wgmma.cuh"

namespace repro_torch {

constexpr int kSegCols = 4;      // gather warp layout: columns a lane holds (a pass: 128)
constexpr int kSegAhead = 8;     // gather warp and thread layouts: rows loaded before added
constexpr int kThreadMaxF = 8;   // the thread layouts' widest row
constexpr int kHalf = 16;        // gather half layout: lanes a segment, rows in flight

constexpr int kStreamWarps = 8;                              // consumer warps
constexpr int kStreamThreads = (kStreamWarps + 1) * kWarp;   // and one producer warp
constexpr int kStages = 6;
constexpr int kStageBytes = 32768;   // rows a stage: kStageBytes / (4 F), at least 1
constexpr int kStreamMaxF = 256;     // the stream warp layout holds F / 32 columns a lane
constexpr int kStreamAhead = 4;      // rows read from shared memory before they are added

// -- the gather route ----------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
segment_sum_gather_warp_kernel(const float* __restrict__ rows,
                               const int32_t* __restrict__ perm,
                               const int32_t* __restrict__ offsets, const float* out0,
                               float* out, int64_t N, int64_t F) {
  const int lane = threadIdx.x % kWarp;
  const int64_t n = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (n >= N) return;  // the whole warp: n is the warp's
  const int lo = __ldg(offsets + n), hi = __ldg(offsets + n + 1);
  for (int64_t c0 = 0; c0 < F; c0 += kWarp * kSegCols) {
    float acc[kSegCols];
#pragma unroll
    for (int u = 0; u < kSegCols; ++u) {
      const int64_t c = c0 + u * kWarp + lane;
      acc[u] = (out0 != nullptr && c < F) ? out0[n * F + c] : 0.f;
    }
    for (int base = lo; base < hi; base += kWarp) {
      const int cnt = min(kWarp, hi - base);
      const int mine = lane < cnt ? __ldg(perm + base + lane) : 0;
      for (int j0 = 0; j0 < cnt; j0 += kSegAhead) {
        float v[kSegAhead][kSegCols];
#pragma unroll
        for (int a = 0; a < kSegAhead; ++a) {
          const int64_t r = (int64_t)__shfl_sync(kFull, mine, (j0 + a) % kWarp) * F;
          const bool live = j0 + a < cnt;
#pragma unroll
          for (int u = 0; u < kSegCols; ++u) {
            const int64_t c = c0 + u * kWarp + lane;
            v[a][u] = (live && c < F) ? __ldg(rows + r + c) : 0.f;
          }
        }
#pragma unroll
        for (int a = 0; a < kSegAhead; ++a) {
          if (j0 + a < cnt) {
#pragma unroll
            for (int u = 0; u < kSegCols; ++u) acc[u] = __fadd_rn(acc[u], v[a][u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSegCols; ++u) {
      const int64_t c = c0 + u * kWarp + lane;
      if (c < F) out[n * F + c] = acc[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_gather_thread_kernel(const float* __restrict__ rows,
                                 const int32_t* __restrict__ perm,
                                 const int32_t* __restrict__ offsets, const float* out0,
                                 float* out, int64_t N, int F) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int lo = __ldg(offsets + n), hi = __ldg(offsets + n + 1);
  float acc[kThreadMaxF];
#pragma unroll
  for (int c = 0; c < kThreadMaxF; ++c)
    acc[c] = (out0 != nullptr && c < F) ? out0[n * F + c] : 0.f;
  for (int i = lo; i < hi; i += kSegAhead) {
    float v[kSegAhead][kThreadMaxF];
#pragma unroll
    for (int a = 0; a < kSegAhead; ++a) {
      const bool live = i + a < hi;
      const int64_t r = live ? (int64_t)__ldg(perm + i + a) * F : 0;
#pragma unroll
      for (int c = 0; c < kThreadMaxF; ++c)
        v[a][c] = (live && c < F) ? __ldg(rows + r + c) : 0.f;
    }
#pragma unroll
    for (int a = 0; a < kSegAhead; ++a) {
      if (i + a < hi) {
#pragma unroll
        for (int c = 0; c < kThreadMaxF; ++c) acc[c] = __fadd_rn(acc[c], v[a][c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kThreadMaxF; ++c)
    if (c < F) out[n * F + c] = acc[c];
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// a row read once: no L1 allocation, L2 evict-first
__device__ __forceinline__ float4 load_once(const float4* p, uint64_t pol) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
  acc.z = __fadd_rn(acc.z, v.z);
  acc.w = __fadd_rn(acc.w, v.w);
}

// F4 = F / 4 float4 columns
__global__ void __launch_bounds__(kThreads)
segment_sum_gather_half_kernel(const float4* __restrict__ rows,
                               const int32_t* __restrict__ perm,
                               const int32_t* __restrict__ offsets, const float4* out0,
                               float4* out, int64_t N, int64_t F4) {
  const int lane = threadIdx.x % kWarp, hl = lane % kHalf;
  const unsigned mask = lane < kHalf ? 0x0000ffffu : 0xffff0000u;
  const int64_t n =
      ((int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) * 2 + lane / kHalf;
  if (n >= N) return;  // the whole half-warp: n is the half's
  const uint64_t pol = evict_first_policy();
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int lo = __ldg(offsets + n), hi = __ldg(offsets + n + 1);
  for (int64_t c0 = 0; c0 < F4; c0 += kHalf) {
    const int64_t c = c0 + hl;
    const bool col = c < F4;
    float4 acc = (out0 != nullptr && col) ? out0[n * F4 + c] : zero;
    for (int base = lo; base < hi; base += kHalf) {
      const int cnt = min(kHalf, hi - base);
      const int mine = hl < cnt ? __ldg(perm + base + hl) : 0;
      float4 v[kHalf];
#pragma unroll
      for (int a = 0; a < kHalf; ++a) {
        const int64_t r = __shfl_sync(mask, mine, a, kHalf);
        v[a] = (a < cnt && col) ? load_once(rows + r * F4 + c, pol) : zero;
      }
#pragma unroll
      for (int a = 0; a < kHalf; ++a)
        if (a < cnt) add4(acc, v[a]);
    }
    if (col) out[n * F4 + c] = acc;
  }
}

// -- the stream route ----------------------------------------------------------

// The first n in [lo, hi) with offsets[n] >= x, or hi (offsets nondecreasing):
// a 32-way search by the whole warp, each step one probe a lane.
__device__ int warp_lower_bound(const int32_t* __restrict__ offsets, int lo, int hi,
                                int64_t x) {
  const int lane = threadIdx.x % kWarp;
  while (hi - lo > kWarp) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int p = lo + lane * step;
    const unsigned m = __ballot_sync(kFull, p >= hi || __ldg(offsets + p) >= x);
    const int f = m ? __ffs(m) - 1 : kWarp;  // the answer lies in (probe f - 1, probe f]
    const int new_hi = f == kWarp ? hi : min(hi, lo + f * step);
    lo = f == 0 ? lo : lo + (f - 1) * step + 1;
    hi = new_hi;
  }
  const int p = lo + lane;
  const unsigned m = __ballot_sync(kFull, p >= hi || __ldg(offsets + p) >= x);
  return m ? lo + __ffs(m) - 1 : hi;
}

// kCols: values a consumer holds (the warp layout: columns lane + 32 u, u <
// kCols; the thread layout: columns u < kThreadMaxF).
template <int kCols, bool kThreadLayout>
__global__ void __launch_bounds__(kStreamThreads, 1)
segment_sum_stream_kernel(const float* rows, const int32_t* __restrict__ bounds,
                          const int32_t* __restrict__ offsets, const float* out0, float* out,
                          int F, int stage_rows, int slot_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)kStages * slot_bytes);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // every thread derives the same run, so the early exits are the whole CTA's
  const int n_lo = __ldg(bounds), n_hi = __ldg(bounds + 1);
  if (n_lo >= n_hi) return;
  const int64_t r0 = __ldg(offsets + n_lo), r1 = __ldg(offsets + n_hi);
  const int64_t per = max((int64_t)1, (r1 - r0 + gridDim.x - 1) / gridDim.x);
  const int64_t run_lo = r0 + (int64_t)blockIdx.x * per, run_hi = run_lo + per;
  if (blockIdx.x > 0 && run_lo >= r1) return;
  // the segments whose first row lies in [run_lo, run_hi); the last run
  // takes every segment to n_hi
  const int s_lo = warp_lower_bound(offsets, n_lo, n_hi, run_lo);
  const int s_hi = run_hi >= r1 ? n_hi : warp_lower_bound(offsets, s_lo, n_hi, run_hi);
  if (s_lo >= s_hi) return;
  const int64_t a = __ldg(offsets + s_lo), b = __ldg(offsets + s_hi);  // their rows
  const int n_stages = (int)((b - a + stage_rows - 1) / stage_rows);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kStreamWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kStreamWarps) {  // the producer
    if (lane == 0) {
      for (int k = 0; k < n_stages; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(empty0 + 8 * s, (k / kStages - 1) & 1);
        const int64_t ra = a + (int64_t)k * stage_rows, rb = min(b, ra + stage_rows);
        const uintptr_t g0 = reinterpret_cast<uintptr_t>(rows + ra * F);
        const uintptr_t g1 = reinterpret_cast<uintptr_t>(rows + rb * F);
        const uintptr_t s0 = g0 & ~uintptr_t(15), s1 = (g1 + 15) & ~uintptr_t(15);
        mbar_expect_tx(full0 + 8 * s, (uint32_t)(s1 - s0));
        bulk_load(smem_u32(smem + (size_t)s * slot_bytes), reinterpret_cast<const void*>(s0),
                  (uint32_t)(s1 - s0), full0 + 8 * s);
      }
    }
    return;
  }

  // the consumers: segment s_lo + w, then every nw-th after it
  constexpr int kNw = kThreadLayout ? kStreamWarps * kWarp : kStreamWarps;
  const int w = kThreadLayout ? (int)threadIdx.x : warp;
  int n = s_lo + w;
  int64_t seg_lo = 0, seg_hi = 0;
  float acc[kCols];
  auto begin = [&]() {
    if (n >= s_hi) return;
    seg_lo = __ldg(offsets + n);
    seg_hi = __ldg(offsets + n + 1);
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = kThreadLayout ? u : lane + kWarp * u;
      acc[u] = (out0 != nullptr && c < F) ? out0[(int64_t)n * F + c] : 0.f;
    }
  };
  begin();
  const int last = max(n_stages, 1) - 1;
  for (int k = 0; k <= last; ++k) {
    const int s = k % kStages;
    const int64_t ra = a + (int64_t)k * stage_rows, rb = min(b, ra + stage_rows);
    const float* stage = nullptr;  // row ra's first value in shared memory
    if (n_stages > 0) {
      mbar_wait(full0 + 8 * s, (k / kStages) & 1);
      const uintptr_t g0 = reinterpret_cast<uintptr_t>(rows + ra * F);
      stage = reinterpret_cast<const float*>(smem + (size_t)s * slot_bytes + (g0 & 15));
    }
    // every segment that starts before this stage's end (all, in the last)
    while (n < s_hi && (seg_lo < rb || k == last)) {
      const int64_t lo_r = max(seg_lo, ra), hi_r = min(seg_hi, rb);
      for (int64_t r = lo_r; r < hi_r; r += kStreamAhead) {
        const float* src = stage + (r - ra) * F;
        float v[kStreamAhead][kCols];
#pragma unroll
        for (int j = 0; j < kStreamAhead; ++j) {
#pragma unroll
          for (int u = 0; u < kCols; ++u) {
            const int c = kThreadLayout ? u : lane + kWarp * u;
            v[j][u] = (r + j < hi_r && c < F) ? src[j * F + c] : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < kStreamAhead; ++j) {
          if (r + j < hi_r) {
#pragma unroll
            for (int u = 0; u < kCols; ++u) acc[u] = __fadd_rn(acc[u], v[j][u]);
          }
        }
      }
      if (seg_hi > rb && k != last) break;  // carried into the next stage
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = kThreadLayout ? u : lane + kWarp * u;
        if (c < F) out[(int64_t)n * F + c] = acc[u];
      }
      n += kNw;
      begin();
    }
    if (n_stages > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
  }
}

template <int kCols, bool kThreadLayout>
cudaError_t stream_launch(const float* rows, const int32_t* bounds, const int32_t* offsets,
                          const float* out0, float* out, int F, cudaStream_t stream) {
  const int stage_rows = max(1, kStageBytes / (F * (int)sizeof(float)));
  const int slot_bytes = (int)(ceil_div((int64_t)stage_rows * F * 4 + 32, 128) * 128);
  const size_t smem = (size_t)kStages * slot_bytes + 2 * kStages * sizeof(uint64_t);
  auto kernel = segment_sum_stream_kernel<kCols, kThreadLayout>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  kernel<<<(unsigned)sms, kStreamThreads, smem, stream>>>(rows, bounds, offsets, out0, out, F,
                                                          stage_rows, slot_bytes);
  return cudaGetLastError();
}

}  // namespace repro_torch

// layout: 0 warp, 1 thread, 2 half (F % 4 == 0, F >= 16, 16-byte aligned)
extern "C" int segment_sum_launch(const void* rows, const void* perm, const void* offsets,
                                  const void* out0, void* out, int64_t N, int64_t F,
                                  int layout, void* stream) {
  using namespace repro_torch;
  if (N <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == 1) {
    if (F > kThreadMaxF) return (int)cudaErrorInvalidValue;
    segment_sum_gather_thread_kernel<<<(unsigned)ceil_div(N, kThreads), kThreads, 0, st>>>(
        (const float*)rows, (const int32_t*)perm, (const int32_t*)offsets,
        (const float*)out0, (float*)out, N, (int)F);
  } else if (layout == 2) {
    if (F % 4 != 0 || F < 16) return (int)cudaErrorInvalidValue;
    segment_sum_gather_half_kernel<<<(unsigned)ceil_div(N, 2 * kWarpsPerBlock), kThreads, 0,
                                     st>>>(
        (const float4*)rows, (const int32_t*)perm, (const int32_t*)offsets,
        (const float4*)out0, (float4*)out, N, F / 4);
  } else {
    segment_sum_gather_warp_kernel<<<(unsigned)ceil_div(N, kWarpsPerBlock), kThreads, 0,
                                     st>>>(
        (const float*)rows, (const int32_t*)perm, (const int32_t*)offsets,
        (const float*)out0, (float*)out, N, F);
  }
  return (int)cudaGetLastError();
}

// bounds: int32 [2] on the device, the node range [n_lo, n_hi); offsets:
// int32 [N + 1], row offsets into rows (nondecreasing)
extern "C" int segment_sum_stream_launch(const void* rows, const void* bounds,
                                         const void* offsets, const void* out0, void* out,
                                         int64_t F, void* stream) {
  using namespace repro_torch;
  if (F <= 0 || F > kStreamMaxF) return (int)cudaErrorInvalidValue;
  const auto r = (const float*)rows;
  const auto bd = (const int32_t*)bounds;
  const auto off = (const int32_t*)offsets;
  const auto o0 = (const float*)out0;
  const auto o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const int f = (int)F;
  cudaError_t err;
  if (f <= kThreadMaxF) err = stream_launch<kThreadMaxF, true>(r, bd, off, o0, o, f, st);
  else if (f <= 2 * kWarp) err = stream_launch<2, false>(r, bd, off, o0, o, f, st);
  else if (f <= 4 * kWarp) err = stream_launch<4, false>(r, bd, off, o0, o, f, st);
  else err = stream_launch<8, false>(r, bd, off, o0, o, f, st);
  return (int)err;
}
