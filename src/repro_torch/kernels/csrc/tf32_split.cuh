// The short-sequence attention kernels' shared pieces (flash_attention_short.cu,
// flash_backward_short.cu): split-TF32 products on mma.sync m16n8k8,
// cp.async staging, and the operands' dtype read as f32.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace repro_torch {
namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x = hi + lo: hi = x rounded to TF32 as the tile kernel rounds it (to
// nearest, ties away from zero, the low 13 bits cleared), lo = x - hi
// (exact in f32, and passed as it is: the tensor core reads its TF32
// bits). Three instructions, where rounding lo as well takes five;
// hi.hi + hi.lo + lo.hi stays within ~2^-21 of the f32 product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D[16x8] += A[16x8] . B[8x8], TF32 in, f32 accumulators. Fragments (lane =
// 4 * gr + t): a = (gr, t), (gr + 8, t), (gr, t + 4), (gr + 8, t + 4);
// b = (k t, n gr), (k t + 4, n gr); d = (gr, 2t), (gr, 2t + 1), (gr + 8, 2t),
// (gr + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(x0, hi[0], lo[0]);
  split(x1, hi[1], lo[1]);
  split(x2, hi[2], lo[2]);
  split(x3, hi[3], lo[3]);
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void sts2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
}  // namespace repro_torch
