// tier_match: the tier-selected conjunctive AND-match of a serve batch.
//   out[b, :] = AND over l with tok[b, l] >= 0 of T_b[tok[b, l], :],
// where T_b is the Tier-1 postings when sel[b] is set and the Tier-2
// postings otherwise (always Tier-2 when sel is null). A -1 token is
// skipped and a query with no valid token gets all-ones.
//
// Replaces the Pallas kernel repro/kernels/fused_match.py::_tier_match
// (body `_match_kernel`) and serves the reference engine's XLA AND-match
// repro/serve/matching.py::match_batch (sel null).
//
// Bound on an H100: bytes. Each valid (query, token) pair reads one
// postings row of W words and each query writes W words:
// (n_valid_tokens * W + B * W) * 4 bytes over 3.35 TB/s.
//
// Design: a block owns one query and a span of 256 vector lanes of words;
// each thread ANDs its uint4 of the selected rows into registers and
// stores once, so the [B, L, W] gather of the XLA path never exists. The
// tiers come in as two pointers: the TPU wrapper's [2V, W] concatenation
// would copy both tiers (32 GiB at the production shape) on every call.
// The block reads its token ids and tier bit itself, the counterpart of the
// TPU kernel's scalar prefetch. Ids outside [0, V) are skipped rather than
// read out of bounds.
#include "common.cuh"

namespace repro_torch {

constexpr int kMatchThreads = 256;

__global__ void __launch_bounds__(kMatchThreads)
tier_match_kernel(const uint32_t* __restrict__ t1,
                  const uint32_t* __restrict__ t2,
                  const bool* __restrict__ sel, const int32_t* __restrict__ tok,
                  uint32_t* __restrict__ out, int64_t L, int64_t W, int64_t V,
                  int vec) {
  const int64_t b = blockIdx.x;
  const int64_t i = (int64_t)blockIdx.y * kMatchThreads + threadIdx.x;
  const uint32_t* T = (sel != nullptr && sel[b]) ? t1 : t2;
  const int32_t* tb = tok + b * L;
  if (vec) {
    if (i >= W / 4) return;
    uint4 acc = make_uint4(~0u, ~0u, ~0u, ~0u);
    for (int64_t l = 0; l < L; ++l) {
      const int64_t t = tb[l];
      if (t < 0 || t >= V) continue;
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(T + t * W) + i);
      acc.x &= r.x; acc.y &= r.y; acc.z &= r.z; acc.w &= r.w;
    }
    reinterpret_cast<uint4*>(out + b * W)[i] = acc;
  } else {
    if (i >= W) return;
    uint32_t acc = ~0u;
    for (int64_t l = 0; l < L; ++l) {
      const int64_t t = tb[l];
      if (t < 0 || t >= V) continue;
      acc &= __ldg(T + t * W + i);
    }
    out[b * W + i] = acc;
  }
}

}  // namespace repro_torch

extern "C" int tier_match_launch(const void* t1, const void* t2,
                                 const void* sel, const void* tok, void* out,
                                 int64_t B, int64_t L, int64_t W, int64_t V,
                                 int vec, void* stream) {
  using namespace repro_torch;
  const int64_t lanes = vec ? W / 4 : W;
  const dim3 grid((unsigned)B, (unsigned)ceil_div(lanes, kMatchThreads));
  tier_match_kernel<<<grid, kMatchThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)t1, (const uint32_t*)t2, (const bool*)sel,
      (const int32_t*)tok, (uint32_t*)out, L, W, V, vec);
  return (int)cudaGetLastError();
}
