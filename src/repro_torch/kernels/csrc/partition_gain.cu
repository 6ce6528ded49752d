// partition_gain: gains[c, k] = popcount(A[c, lo_k:hi_k] & ~mask[lo_k:hi_k])
// as int32 [C, P], for P word-aligned partitions given by P+1 word offsets.
//
// Replaces the Pallas kernel repro/kernels/partition_gain.py::partition_gain
// (body `_kernel`, reduction `segment_selector`), the per-shard g_k(j|X)
// oracle behind PartitionedBudget.gains.
//
// Bound on an H100: bytes. Each word of A is read once and costs one
// AND-NOT and one POPC; the C*P int32 outputs are small beside the C*W words
// read while P << W. The time is 4*(C*W + W + C*P) bytes over 3.35 TB/s.
//
// The TPU kernel reduced words to partitions with an f32 one-hot matmul on
// the MXU, which is exact only below 2^24 docs; here every count is an
// integer sum, exact at any size. Partition offsets arrive as a device
// array (they change with every split) and need not be multiples of 4
// words. Two routes, picked by the wrapper from the shape
// (`tiles.gain_route`):
//
//   warp (partition_gain_launch), many rows: coverage_gain's design, one
//     warp per row, with a loop over the partitions inside the warp. When
//     the row and the mask are 16-byte aligned each partition is a scalar
//     head up to the next 4-word boundary, a uint4 body, and a scalar
//     tail; otherwise lanes load consecutive words. Lane 0 writes the P
//     counts of its row. A block holds `warps` rows, set at launch as in
//     coverage_gain.
//
//   split (partition_gain_split_launch), too few rows to fill the card
//     (lazy greedy's exact evaluations under per-shard caps and ingest's
//     offers on a per-shard constraint: one row): coverage_gain's split
//     route with a count per partition. A row goes to a thread-block
//     cluster of `ctas` CTAs, each CTA a contiguous slice of the row's
//     words, brought with the mask's slice into shared memory by
//     cp.async.bulk on an mbarrier (the up to 3 unaligned words at each
//     end by plain loads; the first chunk's copy is in flight while the
//     offsets are staged). A partition may span several CTAs and one CTA
//     may hold many partitions, one word wide or not a multiple of 4: each
//     warp takes 32 consecutive words at a time, each lane finds its
//     word's partition by a cursor over the offsets (staged in shared
//     memory; a lane's words only ascend) and counts in a register while
//     its partition stays the same. When a lane leaves its partition, its
//     warp flushes: a segmented shuffle sum over the lanes of one
//     partition leaves each partition's sum in its last lane, which adds it
//     to the warp's own int32 counts [P] in shared memory (a vote finds the
//     iterations that need it: at most one a partition boundary, so the
//     loop is coverage_gain's but for a cursor check and a vote). The CTA
//     adds its warps' counts; after a cluster barrier rank
//     0 adds the partials of ranks 0..ctas-1, in rank order, through
//     distributed shared memory and writes the row's P counts; a second
//     barrier keeps every CTA resident until it has read them. No atomics
//     and no global scratch. The warps' counts take warps * P * 4 bytes of
//     dynamic shared memory, so P is at most kSplitMaxParts (1024:
//     128 KiB at 32 warps); above it the wrapper takes the warp route, and
//     refuses a forced split route before any launch. `warps` is the warps
//     a CTA here.
//
// The rows are independent and integer sums are exact, so neither route
// nor block size moves a result.
#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

__device__ __forceinline__ int and_not_pop(uint4 x, uint4 m) {
  return __popc(x.x & ~m.x) + __popc(x.y & ~m.y) + __popc(x.z & ~m.z) +
         __popc(x.w & ~m.w);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
partition_gain_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ mask,
                      const long long* __restrict__ bounds,
                      int32_t* __restrict__ out, int64_t C, int64_t W,
                      int64_t P, int vec) {
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= C) return;  // whole warp leaves together
  const uint32_t* r = a + row * W;
  for (int64_t k = 0; k < P; ++k) {
    const int64_t lo = __ldg(bounds + k), hi = __ldg(bounds + k + 1);
    int cnt = 0;
    int64_t b0 = lo, b1 = lo;  // the uint4 body [b0, b1), empty if not vec
    if (vec) {
      b0 = (lo + 3) & ~int64_t(3);
      b1 = hi & ~int64_t(3);
      if (b1 < b0) b1 = b0 = lo;
    }
    if (b1 > b0) {
      const uint4* r4 = reinterpret_cast<const uint4*>(r + b0);
      const uint4* m4 = reinterpret_cast<const uint4*>(mask + b0);
      const int64_t n4 = (b1 - b0) / 4;
      for (int64_t i = lane; i < n4; i += kWarp)
        cnt += and_not_pop(__ldcs(r4 + i), __ldg(m4 + i));
      // head [lo, b0) and tail [b1, hi): fewer than 4 words each
      if (lane < b0 - lo) cnt += __popc(__ldcs(r + lo + lane) & ~__ldg(mask + lo + lane));
      if (lane < hi - b1) cnt += __popc(__ldcs(r + b1 + lane) & ~__ldg(mask + b1 + lane));
    } else {
      for (int64_t i = lo + lane; i < hi; i += kWarp)
        cnt += __popc(__ldcs(r + i) & ~__ldg(mask + i));
    }
    cnt = warp_sum(cnt);
    if (lane == 0) out[row * P + k] = cnt;
  }
}

// the split route's largest partition count (see the header)
constexpr int kSplitMaxParts = 1024;

// dynamic shared memory of a split-route CTA: the P+1 offsets, then each
// warp's P counts
inline size_t split_smem(int64_t P, int warps) {
  return (size_t)(P + 1) * sizeof(long long) + (size_t)warps * P * sizeof(int);
}

// add each lane's count v in partition k to the warp's counts `mine`, where
// k ascends across the lanes: a segmented inclusive sum over the lanes of
// one partition (equal k means every lane between has it too) leaves each
// partition's sum in its last lane, the one lane that writes it
__device__ __forceinline__ void flush_counts(int* mine, int v, int k, int lane) {
  for (int off = 1; off < kWarp; off <<= 1) {
    const int u = __shfl_up_sync(kFull, v, off);
    const int ku = __shfl_up_sync(kFull, k, off);
    if (lane >= off && ku == k) v += u;
  }
  const int kn = __shfl_down_sync(kFull, k, 1);
  if (lane == kWarp - 1 || kn != k) mine[k] += v;
  __syncwarp();  // the warp's counts written before any lane's next add
}

__global__ void __launch_bounds__(kMaxThreads, 1)
partition_gain_split_kernel(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ mask,
                            const long long* __restrict__ bounds,
                            int32_t* __restrict__ out, int64_t W, int P) {
  __shared__ __align__(128) uint32_t sa[kSplitChunk];
  __shared__ __align__(128) uint32_t sm[kSplitChunk];
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(16) unsigned char dyn[];
  long long* sb = reinterpret_cast<long long*>(dyn);  // [P + 1] offsets
  int* cnt = reinterpret_cast<int*>(sb + P + 1);      // [warps][P] counts
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / ctas;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % kWarp, warp = tid / kWarp, warps = nthr / kWarp;
  const uint32_t b = smem_u32(&bar);
  const uint32_t* r = a + row * W;
  const int64_t lo = min(W, rank * split_slice(W, ctas));
  const int64_t hi = min(W, lo + split_slice(W, ctas));
  // thread 0: the chunk at c0 (n words) into sa and sm, completing on bar
  auto stage = [&](int64_t c0, int n) {
    const Window wa = aligned_window(r + c0, n), wm = aligned_window(mask + c0, n);
    if (wa.n + wm.n) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(b, (uint32_t)(wa.n + wm.n) * 4);
      if (wa.n) bulk_load(smem_u32(sa), r + c0 + wa.off, wa.n * 4, b);
      if (wm.n) bulk_load(smem_u32(sm), mask + c0 + wm.off, wm.n * 4, b);
    }
  };
  if (tid == 0) {
    mbar_init(b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the first chunk is in flight while the offsets are staged
    if (lo < hi) stage(lo, (int)min((int64_t)kSplitChunk, hi - lo));
  }
  for (int i = tid; i <= P; i += nthr) sb[i] = __ldg(bounds + i);
  for (int i = tid; i < warps * P; i += nthr) cnt[i] = 0;
  __syncthreads();
  int* mine = cnt + warp * P;
  // the partition of word lo: the last k with sb[k] <= lo
  int k = 0;
  for (int top = P - 1; k < top;) {
    const int mid = (k + top + 1) / 2;
    if (sb[mid] <= lo) k = mid; else top = mid - 1;
  }
  long long end = sb[k + 1];  // the first word past partition k
  int acc = 0;                // this lane's count in partition k, not yet in `mine`
  uint32_t phase = 0;
  for (int64_t c0 = lo; c0 < hi; c0 += kSplitChunk) {
    const int n = (int)min((int64_t)kSplitChunk, hi - c0);
    const Window wa = aligned_window(r + c0, n), wm = aligned_window(mask + c0, n);
    if (wa.n + wm.n) {
      if (tid == 0 && c0 != lo) stage(c0, n);
      mbar_wait(b, phase);
      phase ^= 1;
    }
    // a warp takes 32 consecutive words at a time (i0 is warp-uniform, so
    // every lane takes part in the votes and shuffles)
    for (int i0 = warp * kWarp; i0 < n; i0 += nthr) {
      const int i = i0 + lane;
      // a lane past the chunk's end takes its last word's partition
      const int64_t g = c0 + min(i, n - 1);
      int kn = k;
      if (g >= end) {
        do ++kn;
        while (sb[kn + 1] <= g);  // sb[P] = W > g
      }
      if (__any_sync(kFull, kn != k)) {  // lanes that leave their partition flush
        flush_counts(mine, kn != k ? acc : 0, k, lane);
        if (kn != k) {
          acc = 0;
          k = kn;
          end = sb[k + 1];
        }
      }
      if (i < n) {
        const uint32_t x = wa.holds(i) ? sa[i - wa.off] : __ldg(r + c0 + i);
        const uint32_t m = wm.holds(i) ? sm[i - wm.off] : __ldg(mask + c0 + i);
        acc += __popc(x & ~m);
      }
    }
    __syncthreads();  // every read of this chunk done before the next copy
  }
  flush_counts(mine, acc, k, lane);
  __syncthreads();
  // the CTA's partials into warp 0's row: thread p alone reads column p
  for (int p = tid; p < P; p += nthr) {
    int s = 0;
    for (int w = 0; w < warps; ++w) s += cnt[w * P + p];
    cnt[p] = s;
  }
  cluster.sync();
  if (rank == 0) {
    for (int p = tid; p < P; p += nthr) {
      int s = 0;
      for (int q = 0; q < ctas; ++q) s += cluster.map_shared_rank(cnt, q)[p];
      out[row * P + p] = s;
    }
  }
  cluster.sync();  // rank 0 has read every partial before any CTA exits
}

}  // namespace repro_torch

// warps: warps per block (one row each), 1-32.
extern "C" int partition_gain_launch(const void* a, const void* mask,
                                     const void* bounds, void* out, int64_t C,
                                     int64_t W, int64_t P, int vec, int warps,
                                     void* stream) {
  using namespace repro_torch;
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div(C, warps));
  partition_gain_kernel<<<grid, warps * kWarp, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)mask, (const long long*)bounds,
      (int32_t*)out, C, W, P, vec);
  return (int)cudaGetLastError();
}

// ctas: CTAs a row's cluster (1-16); warps: warps a CTA (1-32); P at most
// kSplitMaxParts.
extern "C" int partition_gain_split_launch(const void* a, const void* mask,
                                           const void* bounds, void* out, int64_t C,
                                           int64_t W, int64_t P, int ctas, int warps,
                                           void* stream) {
  using namespace repro_torch;
  if (P < 1 || P > kSplitMaxParts || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  return split_launch_smem(partition_gain_split_kernel, C, ctas, warps, split_smem(P, warps),
                           stream, (const uint32_t*)a, (const uint32_t*)mask,
                           (const long long*)bounds, (int32_t*)out, W, (int)P);
}
