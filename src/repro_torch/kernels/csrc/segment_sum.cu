// segment_sum: out[n, :] = out0[n, :] + rows[perm[offsets[n]], :] + ... +
// rows[perm[offsets[n + 1] - 1], :] as f32 [N, F], each segment's rows added
// one at a time, left to right, in f32 (round to nearest, no contraction).
// out0 may be null (zeros) and may be out itself (each value is read and
// written by the same thread).
//
// Replaces no Pallas kernel. The reference's EGNN sums its edge messages
// onto the nodes with XLA's jax.ops.segment_sum (src/repro/models/egnn.py:
// 108-110), and the gradients of its edge gathers are segment sums too.
// PyTorch's index_add_ on CUDA adds with float atomics, whose order changes
// from run to run; here the order is the plan's (the valid rows sorted by
// segment, stably), so a training step repeats its bits, and the result
// equals a sequential index_add_ on the CPU in the same order bit for bit.
//
// Bound on an H100: bytes. Each valid row read once (M*F*4), perm (M*4),
// offsets ((N+1)*4), out0 and out (N*F*4 each), over 3.35 TB/s; one add a
// value read. Two routes, chosen by the caller from F:
//   warp:   F > 8 (EGNN's messages, F = 64). A warp a segment, lanes over F,
//           kSegCols columns a lane in each pass of 128 columns. The lanes
//           read 32 perm entries at once and pass them round by shuffle, and
//           kSegAhead rows are loaded before any of them is added, so the
//           loads of a random gather stay in flight while the sum itself
//           runs in order.
//   thread: F <= 8 (the coordinate updates, F = 3; graph pooling, F = 1). A
//           thread a segment, its F sums in registers, kSegAhead rows loaded
//           ahead.
// No atomics and no tree: a hub segment runs on one warp or thread.
#include "common.cuh"

namespace repro_torch {

constexpr int kSegCols = 4;      // columns a lane holds: a pass covers 128
constexpr int kSegAhead = 8;     // rows loaded before they are added
constexpr int kThreadMaxF = 8;   // the thread route's widest row

__global__ void __launch_bounds__(kThreads)
segment_sum_warp_kernel(const float* __restrict__ rows, const int32_t* __restrict__ perm,
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
segment_sum_thread_kernel(const float* __restrict__ rows, const int32_t* __restrict__ perm,
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

}  // namespace repro_torch

extern "C" int segment_sum_launch(const void* rows, const void* perm, const void* offsets,
                                  const void* out0, void* out, int64_t N, int64_t F,
                                  int thread_route, void* stream) {
  using namespace repro_torch;
  if (N <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (thread_route) {
    if (F > kThreadMaxF) return (int)cudaErrorInvalidValue;
    segment_sum_thread_kernel<<<(unsigned)ceil_div(N, kThreads), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const float*)rows, (const int32_t*)perm, (const int32_t*)offsets,
        (const float*)out0, (float*)out, N, (int)F);
  } else {
    segment_sum_warp_kernel<<<(unsigned)ceil_div(N, kWarpsPerBlock), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const float*)rows, (const int32_t*)perm, (const int32_t*)offsets,
        (const float*)out0, (float*)out, N, F);
  }
  return (int)cudaGetLastError();
}
