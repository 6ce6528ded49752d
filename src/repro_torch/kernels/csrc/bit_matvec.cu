// bit_matvec: out[c, r] = sum_i A[c, i] * x[i, r], with A packed as bits.
//
// Replaces the Pallas kernel repro/kernels/bit_matvec.py::bit_matvec (body
// `_kernel`), the weighted f(j|X) oracle behind SCSKProblem.f_gains
// (R = 1) and the Opt/Pes refresh on gathered rows.
//
// Bound on an H100: bytes. A is read once (C*W*4 bytes), x once
// (W*32*R*4) and out written once (C*R*4). The arithmetic is one FP32 add
// per set bit of A and column of x; the incidence matrices are sparse, so
// that work is far below the card's FP64 rate.
//
// Both routes walk only the set bits of each word with __ffs, adding
// x[word*32 + bit, r] from L2 (x is 4 MiB at the production shape). The sum
// runs on CUDA cores (never TF32) in FP64 and is rounded once to FP32, and
// the plain version does the same: the result is then the correctly
// rounded sum whatever the order (to within FP64's own rounding, which the
// weights here never reach), so the card and the CPU give the same
// f-gains and the greedy solvers pick the same clauses. (With FP32
// accumulation the lane order flipped a near-tie of the medium preset's
// greedy at step 251.) FP64 adds cost nothing here. The TPU kernel
// unpacked each tile to f32 for the MXU; on Hopper a dense unpack would
// turn a bandwidth-bound sparse sum into 32 operations per word, so the
// bits are visited instead. Two routes, picked by the wrapper from the
// shape (`tiles.gain_route`):
//
//   warp (bit_matvec_launch), many tasks: one warp per (row, column of x).
//     Lanes stream the row's words (16-byte loads when aligned, as in
//     coverage_gain). A block holds `warps` tasks (1-32; 8 unless the
//     autotuner picks another, kernels/autotune.py).
//
//   split (bit_matvec_split_launch), too few tasks to fill the card (lazy
//     greedy's exact evaluations and ingest's offers: one row, R = 1): a
//     task to a thread-block cluster of `ctas` CTAs (1-16), each a
//     contiguous slice of the row's words, brought into shared memory by
//     one thread's bulk asynchronous copy (cp.async.bulk on an mbarrier;
//     the up to 3 unaligned words at either end by plain loads). Here the
//     time is the latency of the gathers of x at the set bits, not bytes:
//     each thread holds a few words (the 2048 threads of 8 CTAs of 8 warps
//     hold 16 of a 32768-word row) and issues kAhead set-bit loads, across
//     its words, before it adds them. Each CTA's partial is a block sum in
//     FP64 in its shared memory; after a cluster barrier rank 0 adds the
//     partials of ranks 0..ctas-1 in rank order through distributed shared
//     memory, rounds once and writes; a second barrier keeps every CTA
//     resident until then. No float atomics and no global scratch: a
//     repeat is bit-equal. `warps` is the warps a CTA here.
#include <cooperative_groups.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {

constexpr int kAhead = 8;  // split route: set-bit loads a thread issues before adding

__device__ __forceinline__ double sum_bits(uint32_t bits, const float* xs,
                                           int64_t R) {
  double acc = 0.0;
  while (bits) {
    const int b = __ffs(bits) - 1;
    acc += __ldg(xs + (int64_t)b * R);
    bits &= bits - 1;
  }
  return acc;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
bit_matvec_kernel(const uint32_t* __restrict__ a, const float* __restrict__ x,
                  float* __restrict__ out, int64_t C, int64_t W, int64_t R,
                  int vec) {
  const int64_t task =
      (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (task >= C * R) return;  // whole warp leaves together
  const int64_t row = task / R;
  const int64_t col = task % R;
  const uint32_t* ar = a + row * W;
  const float* xc = x + col;
  double acc = 0.0;
  if (vec) {
    const uint4* a4 = reinterpret_cast<const uint4*>(ar);
    const int64_t n4 = W / 4;
    for (int64_t i = lane; i < n4; i += kWarp) {
      const uint4 w = __ldcs(a4 + i);
      const float* xs = xc + i * 4 * kWord * R;
      acc += sum_bits(w.x, xs, R);
      acc += sum_bits(w.y, xs + kWord * R, R);
      acc += sum_bits(w.z, xs + 2 * kWord * R, R);
      acc += sum_bits(w.w, xs + 3 * kWord * R, R);
    }
  } else {
    for (int64_t i = lane; i < W; i += kWarp)
      acc += sum_bits(__ldcs(ar + i), xc + i * kWord * R, R);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row * R + col] = (float)acc;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
bit_matvec_split_kernel(const uint32_t* __restrict__ a, const float* __restrict__ x,
                        float* __restrict__ out, int64_t W, int64_t R) {
  __shared__ __align__(128) uint32_t sa[kSplitChunk];
  __shared__ __align__(8) uint64_t bar;
  __shared__ double part[kMaxWarps];
  __shared__ double partial;
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int64_t task = blockIdx.x / ctas;
  const int64_t row = task / R, col = task % R;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const uint32_t b = smem_u32(&bar);
  if (tid == 0) {
    mbar_init(b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t* ar = a + row * W;
  const float* xc = x + col;
  const int64_t lo = min(W, rank * split_slice(W, ctas));
  const int64_t hi = min(W, lo + split_slice(W, ctas));
  double acc = 0.0;
  uint32_t phase = 0;
  for (int64_t c0 = lo; c0 < hi; c0 += kSplitChunk) {
    const int n = (int)min((int64_t)kSplitChunk, hi - c0);
    const Window wa = aligned_window(ar + c0, n);
    if (wa.n) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(b, (uint32_t)wa.n * 4);
        bulk_load(smem_u32(sa), ar + c0 + wa.off, wa.n * 4, b);
      }
      mbar_wait(b, phase);
      phase ^= 1;
    }
    // the thread's words i = tid, tid + nthr, ... of the chunk, their set
    // bits taken kAhead at a time: all kAhead loads issued, then added
    int i = tid;
    uint32_t bits = 0;
    int64_t base = 0;
    while (true) {
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        while (bits == 0 && i < n) {
          bits = wa.holds(i) ? sa[i - wa.off] : __ldg(ar + c0 + i);
          base = (c0 + i) * kWord;
          i += nthr;
        }
        v[u] = 0.f;
        if (bits) {
          v[u] = __ldg(xc + (base + __ffs(bits) - 1) * R);
          bits &= bits - 1;
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) acc += (double)v[u];
      if (bits == 0 && i >= n) break;
    }
    __syncthreads();  // every read of this chunk done before the next copy
  }
  acc = warp_sum(acc);
  if (tid % kWarp == 0) part[tid / kWarp] = acc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < nthr / kWarp; ++w) s += part[w];
    partial = s;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    double s = 0.0;
    for (int k = 0; k < ctas; ++k) s += *cluster.map_shared_rank(&partial, k);
    out[row * R + col] = (float)s;
  }
  cluster.sync();  // rank 0 has read every partial before any CTA exits
}

}  // namespace repro_torch

// warps: warps per block (one (row, column) task each), 1-32.
extern "C" int bit_matvec_launch(const void* a, const void* x, void* out,
                                 int64_t C, int64_t W, int64_t R, int vec,
                                 int warps, void* stream) {
  using namespace repro_torch;
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ceil_div(C * R, warps));
  bit_matvec_kernel<<<grid, warps * kWarp, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const float*)x, (float*)out, C, W, R, vec);
  return (int)cudaGetLastError();
}

// ctas: CTAs a (row, column) task's cluster (1-16); warps: warps a CTA (1-32).
extern "C" int bit_matvec_split_launch(const void* a, const void* x, void* out,
                                       int64_t C, int64_t W, int64_t R, int ctas,
                                       int warps, void* stream) {
  using namespace repro_torch;
  return split_launch(bit_matvec_split_kernel, C * R, ctas, warps, stream,
                      (const uint32_t*)a, (const float*)x, (float*)out, W, R);
}
