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
// Design: one warp per (row, column of x). Lanes stream the row's words
// (16-byte loads when aligned, as in coverage_gain) and walk only the set
// bits of each word with __ffs, adding x[word*32 + bit, r] from L2 (x is
// 4 MiB at the production shape). The sum runs on CUDA cores (never TF32)
// in FP64 and is rounded once to FP32, and the plain version does the same:
// the result is then the correctly rounded sum whatever the order, so the
// card and the CPU give the same f-gains and the greedy solvers pick the
// same clauses. (With FP32 accumulation the lane order flipped a near-tie
// of the medium preset's greedy at step 251.) FP64 adds cost nothing here:
// the kernel is bound by the bytes of A. The TPU kernel unpacked each tile
// to f32 for the MXU; on Hopper a dense unpack would turn a bandwidth-bound
// sparse sum into 32 operations per word, so the bits are visited instead.
//
// A block holds `warps` tasks, set at launch (1-32; 8 unless the autotuner
// picks another, kernels/autotune.py). Each task's sum is one warp's in a
// fixed lane order, so the result is the same whatever the block.
#include "common.cuh"

namespace repro_torch {

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
