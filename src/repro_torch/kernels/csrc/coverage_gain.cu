// coverage_gain: gains[c] = popcount(A[c] & ~mask) as int32.
//
// Replaces the Pallas kernel repro/kernels/coverage_gain.py::coverage_gain
// (body `_kernel`), the g(j|X) oracle behind SCSKProblem.g_gains.
//
// Bound on an H100: bytes. Each word of A is read once and costs one
// AND-NOT and one POPC, far below the card's integer rate, so the time is
// C*W*4 bytes over 3.35 TB/s (the mask and the output are noise).
//
// Two routes, picked by the wrapper from the shape (`tiles.gain_route`):
//
//   warp (coverage_gain_launch), many rows: one warp per row. When the row
//     and the mask are 16-byte aligned each lane loads a uint4 (4 words),
//     so a warp moves 512 contiguous bytes per iteration; otherwise lanes
//     load consecutive words. The mask is at most 128 KiB at the production
//     shapes and is re-read by every row, so it stays in L2 while A streams
//     past it (loads of A use the streaming cache hint). Lanes keep a
//     private count and a shuffle reduction finishes the row; lane 0 writes
//     it. The TPU kernel's grid-carried accumulator over the W axis becomes
//     the lane loop. A block holds `warps` rows (1-32; 8 unless the
//     autotuner's cache, kernels/autotune.py, picks another for the call's
//     shape bucket): the counterpart of the Pallas kernel's block_c.
//
//   split (coverage_gain_split_launch), too few rows to fill the card (lazy
//     greedy's exact evaluations and ingest's offers: one row): a row to a
//     thread-block cluster of `ctas` CTAs (1-16), each CTA a contiguous
//     slice of the row's words. At one row a single warp would walk 32768
//     words alone on one SM; here the 8 CTAs of a cluster each take 4096.
//     One thread brings each chunk of the CTA's slice of A, and of the
//     mask, into shared memory with a bulk asynchronous copy
//     (cp.async.bulk, completing on an mbarrier): its 16-byte aligned part
//     in one round trip; the up to 3 words before and after it (a row that
//     starts anywhere, W not a multiple of 4) are read by plain loads in
//     the same loop. The CTA's threads count over the chunk, a block sum
//     gives the CTA's partial in its shared memory, and after a cluster
//     barrier rank 0 adds the partials of ranks 0..ctas-1, in rank order,
//     through distributed shared memory and writes the row; a second
//     barrier keeps every CTA resident until it has read them. No atomics
//     and no global scratch. `warps` is the warps a CTA here.
//
// The rows are independent and integer sums are exact, so neither route
// nor block size moves a result.
#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

__global__ void __launch_bounds__(kMaxThreads, 1)
coverage_gain_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ mask,
                     int32_t* __restrict__ out, int64_t C, int64_t W,
                     int vec) {
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= C) return;  // whole warp leaves together
  const uint32_t* r = a + row * W;
  int cnt = 0;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(r);
    const uint4* m4 = reinterpret_cast<const uint4*>(mask);
    const int64_t n4 = W / 4;
    for (int64_t i = lane; i < n4; i += kWarp) {
      const uint4 x = __ldcs(r4 + i);
      const uint4 m = __ldg(m4 + i);
      cnt += __popc(x.x & ~m.x) + __popc(x.y & ~m.y) +
             __popc(x.z & ~m.z) + __popc(x.w & ~m.w);
    }
  } else {
    for (int64_t i = lane; i < W; i += kWarp) cnt += __popc(__ldcs(r + i) & ~__ldg(mask + i));
  }
  cnt = warp_sum(cnt);
  if (lane == 0) out[row] = cnt;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
coverage_gain_split_kernel(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ mask,
                           int32_t* __restrict__ out, int64_t W) {
  __shared__ __align__(128) uint32_t sa[kSplitChunk];
  __shared__ __align__(128) uint32_t sm[kSplitChunk];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int part[kMaxWarps];
  __shared__ int partial;
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / ctas;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const uint32_t b = smem_u32(&bar);
  if (tid == 0) {
    mbar_init(b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t* r = a + row * W;
  const int64_t lo = min(W, rank * split_slice(W, ctas));
  const int64_t hi = min(W, lo + split_slice(W, ctas));
  int cnt = 0;
  uint32_t phase = 0;
  for (int64_t c0 = lo; c0 < hi; c0 += kSplitChunk) {
    const int n = (int)min((int64_t)kSplitChunk, hi - c0);
    const Window wa = aligned_window(r + c0, n), wm = aligned_window(mask + c0, n);
    if (wa.n + wm.n) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(b, (uint32_t)(wa.n + wm.n) * 4);
        if (wa.n) bulk_load(smem_u32(sa), r + c0 + wa.off, wa.n * 4, b);
        if (wm.n) bulk_load(smem_u32(sm), mask + c0 + wm.off, wm.n * 4, b);
      }
      mbar_wait(b, phase);
      phase ^= 1;
    }
    for (int i = tid; i < n; i += nthr) {
      const uint32_t x = wa.holds(i) ? sa[i - wa.off] : __ldg(r + c0 + i);
      const uint32_t m = wm.holds(i) ? sm[i - wm.off] : __ldg(mask + c0 + i);
      cnt += __popc(x & ~m);
    }
    __syncthreads();  // every read of this chunk done before the next copy
  }
  cnt = warp_sum(cnt);
  if (tid % kWarp == 0) part[tid / kWarp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < nthr / kWarp; ++w) s += part[w];
    partial = s;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    int s = 0;
    for (int k = 0; k < ctas; ++k) s += *cluster.map_shared_rank(&partial, k);
    out[row] = s;
  }
  cluster.sync();  // rank 0 has read every partial before any CTA exits
}

}  // namespace repro_torch

// warps: warps per block (one row each), 1-32.
extern "C" int coverage_gain_launch(const void* a, const void* mask, void* out,
                                    int64_t C, int64_t W, int vec, int warps,
                                    void* stream) {
  using namespace repro_torch;
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div(C, warps));
  coverage_gain_kernel<<<grid, warps * kWarp, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)mask, (int32_t*)out, C, W, vec);
  return (int)cudaGetLastError();
}

// ctas: CTAs a row's cluster (1-16); warps: warps a CTA (1-32).
extern "C" int coverage_gain_split_launch(const void* a, const void* mask, void* out,
                                          int64_t C, int64_t W, int ctas, int warps,
                                          void* stream) {
  using namespace repro_torch;
  return split_launch(coverage_gain_split_kernel, C, ctas, warps, stream,
                      (const uint32_t*)a, (const uint32_t*)mask, (int32_t*)out, W);
}
