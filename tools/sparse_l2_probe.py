"""Measure what sets sparse_gain's L2 route at solve_sparse_xl's shapes.

    python3 tools/sparse_l2_probe.py [--seed 0] [--baseline-cu FILE]

Needs one CUDA card. Three measurements:
  1. `ops.sparse_gain` on solve_sparse_xl's inputs, made as `chip_smoke.py`
     makes them (2^20 sorted lists of up to 4096 doc ids over 2^28 docs, a
     32 MiB covered bitset: the L2 route), then again with every valid id
     folded into 2^24 docs (`chip_smoke.fold_ids`): the same streamed bytes
     and valid count, but a 2 MiB reach of the mask that stays in L2. The
     gap between the two is the cost of mask misses. Each time is the
     median of 10 calls by CUDA events; 512 sampled rows are checked
     against the plain version.
  2. The card's rate of random 4-byte gathers (`ld.global.nc`, plain and
     with an L2 evict_last policy) from buffers of 2 MiB to 1 GiB, warmed
     first, with the addresses made in registers (nothing else is read):
     2^30 gathers per setting, CUDA events. Valid ids over the rate at
     32 MiB is the gather floor of the L2 route. Then from 32 and 48 MiB
     with each SM held to one half of the buffer, the half picked by its
     %smid (the first or second half of the SMs, or one bit of %smid): a
     split that matches the SMs to L2's two partitions would gather at the
     rate of a buffer half the size.
  3. The rate of random 4-byte gathers from shared memory, within a block
     and across a cluster of 8 blocks (distributed shared memory, 128 KiB
     a block): what a kernel that stages doc-range slices of the mask in a
     cluster would gather at.
With --baseline-cu, FILE is another version of `csrc/sparse_gain.cu` with
the entry `sparse_gain_launch(ids, mask, out, C, M, W, vec, smem, stream)`,
built alone with nvcc and timed in turns with the current kernel (current,
baseline, baseline, current) on both inputs; its answers must be equal.
Prints one line per setting, then the card.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import nvcc_lib  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

GATHERS = 2 ** 30
BUFFER_MIB = (2, 8, 16, 24, 32, 40, 48, 64, 1024)
SPLIT_MIB = (32, 48)
GATHER_CU = r'''
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t ld_last(const uint32_t* p, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

// split 0: every SM gathers from the whole buffer; split 1: the first half
// of the SMs (by %smid) from the first half of the buffer, the rest from the
// second; split 2 + b: bit b of %smid picks the half.
template <bool kLast>
__global__ void gather_kernel(const uint32_t* __restrict__ buf, uint32_t n,
                              int iters, uint32_t* __restrict__ out, int split,
                              uint32_t sms) {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  uint32_t smid;
  asm("mov.u32 %0, %%smid;" : "=r"(smid));
  uint32_t base = 0;
  if (split) {
    n /= 2;
    base = (split == 1 ? smid >= sms / 2 : (smid >> (split - 2)) & 1u) * n;
  }
  uint32_t s = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u + 0x9e3779b9u;
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i) {
    uint32_t idx[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s ^= s << 13; s ^= s >> 17; s ^= s << 5;
      idx[j] = base + __umulhi(s, n);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += kLast ? ld_last(buf + idx[j], pol) : __ldg(buf + idx[j]);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int gather_launch(const void* buf, uint32_t n, int iters, int last,
                             int blocks, void* out, int split, uint32_t sms,
                             void* stream) {
  if (last)
    gather_kernel<true><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)buf, n, iters, (uint32_t*)out, split, sms);
  else
    gather_kernel<false><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)buf, n, iters, (uint32_t*)out, split, sms);
  return (int)cudaGetLastError();
}
'''


DSMEM_CU = r'''
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

constexpr int kCluster = 8;              // blocks of a cluster, one per SM
constexpr int kSliceWords = 32768;       // 128 KiB of shared memory each

// Random 4-byte gathers from shared memory: kRemote from the whole
// cluster's slices (a random block of the cluster each time), else from
// the block's own slice.
template <bool kRemote>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(1024)
dsmem_gather_kernel(int iters, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t slice[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < kSliceWords; i += blockDim.x) slice[i] = i * 2654435761u;
  cluster.sync();
  uint32_t s = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u + 0x9e3779b9u;
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i) {
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s ^= s << 13; s ^= s >> 17; s ^= s << 5;
      const uint32_t* p = kRemote ? cluster.map_shared_rank(slice, s >> 29) : slice;
      v[j] = p[s & (kSliceWords - 1)];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[j];
  }
  cluster.sync();                        // every slice lives until all reads end
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int dsmem_launch(int iters, int remote, int blocks, void* out,
                            void* stream) {
  const size_t smem = kSliceWords * sizeof(uint32_t);
  cudaError_t err = remote
      ? cudaFuncSetAttribute(dsmem_gather_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
      : cudaFuncSetAttribute(dsmem_gather_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (remote)
    dsmem_gather_kernel<true><<<blocks, 1024, smem, (cudaStream_t)stream>>>(
        iters, (uint32_t*)out);
  else
    dsmem_gather_kernel<false><<<blocks, 1024, smem, (cudaStream_t)stream>>>(
        iters, (uint32_t*)out);
  return (int)cudaGetLastError();
}
'''


def baseline_fn(path: Path):
    lib = nvcc_lib.load(path, "sparse-gain-baseline")
    fn = lib.sparse_gain_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    from repro_torch.kernels.sparse_gain import smem_route

    def run(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        (c, m), w = ids.shape, mask.shape[0]
        out = torch.empty(c, dtype=torch.int32, device=ids.device)
        vec = int(m % 4 == 0 and _build.aligned16(ids))
        code = fn(ids.data_ptr(), mask.data_ptr(), out.data_ptr(), c, m, w, vec,
                  int(smem_route(w)), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"baseline sparse_gain launch failed ({code})")
        return out
    return run


def time_route(name: str, ids, mask, idx, base) -> float:
    out = ops.sparse_gain(ids, mask)
    cs.check(torch.equal(out[idx], ref.sparse_gain(ids[idx], mask)),
             f"sparse_gain differs from the plain version ({name})")
    if base is None:
        ms = cs.time_ms(lambda: ops.sparse_gain(ids, mask), 10)
        print(f"sparse_gain {name}: {ms:.3f} ms", flush=True)
        return ms
    cs.check(torch.equal(base(ids, mask), out), f"baseline differs ({name})")
    t = [cs.time_ms(f, 10) for f in (lambda: ops.sparse_gain(ids, mask),
                                     lambda: base(ids, mask),
                                     lambda: base(ids, mask),
                                     lambda: ops.sparse_gain(ids, mask))]
    print(f"sparse_gain {name}: current {t[0]:.3f} / {t[3]:.3f} ms, baseline "
          f"{t[1]:.3f} / {t[2]:.3f} ms", flush=True)
    return min(t[0], t[3])


def gather_rates(dev) -> dict:
    """Random 4-byte gathers per second from warmed buffers of each size."""
    src = _build.BUILD_ROOT / "sparse_l2_probe_gather.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(GATHER_CU)
    lib = nvcc_lib.load(src, "gather")
    fn = lib.gather_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * 8
    threads = blocks * 256
    iters = GATHERS // (threads * 8)
    out = torch.empty(threads, dtype=torch.int32, device=dev)
    rates = {}
    settings = [(mib, last, 0) for mib in BUFFER_MIB for last in (0, 1)]
    settings += [(mib, 0, split) for mib in SPLIT_MIB for split in range(1, 9)]
    for mib, last, split in settings:
        n = mib * 2 ** 18
        buf = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32, device=dev)

        def run():
            code = fn(buf.data_ptr(), n, iters, last, blocks, out.data_ptr(),
                      split, sms, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"gather launch failed ({code})")
        ms = cs.time_ms(run, 5, warmup=2)
        rate = threads * 8 * iters / (ms * 1e-3)
        rates[(mib, last, split)] = rate
        how = ("evict_last" if last else "plain") + (
            "" if not split else ", halves by SM index" if split == 1
            else f", halves by bit {split - 2} of %smid")
        print(f"gathers from {mib} MiB ({how}): {ms:.3f} ms for "
              f"{threads * 8 * iters} -> {rate:.4g} per s", flush=True)
        del buf
    return rates


def dsmem_rates(dev) -> dict:
    """Random 4-byte gathers per second from shared memory: within a block,
    and across a cluster of 8 blocks (distributed shared memory), 128 KiB a
    block, one cluster per 8 SMs."""
    src = _build.BUILD_ROOT / "sparse_l2_probe_dsmem.cu"
    src.write_text(DSMEM_CU)
    lib = nvcc_lib.load(src, "dsmem")
    fn = lib.dsmem_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms // 8 * 8
    iters = GATHERS // (blocks * 1024 * 8)
    out = torch.empty(blocks * 1024, dtype=torch.int32, device=dev)
    rates = {}
    for remote in (0, 1):
        def run():
            code = fn(iters, remote, blocks, out.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"dsmem launch failed ({code})")
        ms = cs.time_ms(run, 5, warmup=2)
        rates[remote] = blocks * 1024 * 8 * iters / (ms * 1e-3)
        print(f"gathers from shared memory ({'a cluster of 8 blocks' if remote else 'the own block'}"
              f", {blocks} blocks): {ms:.3f} ms -> {rates[remote]:.4g} per s", flush=True)
    return rates


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-cu", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sparse_l2_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _build.lib()
    base = baseline_fn(args.baseline_cu) if args.baseline_cu else None
    ids, mask, idx = cs.xl_inputs(args.seed, dev)
    valid = int((ids >= 0).sum())
    (c, m), w = ids.shape, mask.shape[0]
    b_ms, b_by = cs.bound(4 * (c * m + w + c))
    print(f"solve_sparse_xl: C {c}, M {m}, W {w}, {valid} valid ids; bound "
          f"{b_ms:.3f} ms by {b_by}", flush=True)
    time_route(f"at {cs.XL_DOCS} docs", ids, mask, idx, base)
    cs.fold_ids(ids, cs.XL_FOLD_DOCS)
    time_route(f"folded into {cs.XL_FOLD_DOCS} docs", ids, mask, idx, base)
    del ids
    torch.cuda.empty_cache()
    rates = gather_rates(dev)
    for last in (0, 1):
        r = rates[(32, last, 0)]
        print(f"gather floor ({'evict_last' if last else 'plain'}, 32 MiB): "
              f"{valid} / {r:.4g} per s = {valid / r * 1e3:.3f} ms", flush=True)
    dsmem = dsmem_rates(dev)
    print(f"the same ids at the cluster-shared-memory rate: "
          f"{valid / dsmem[1] * 1e3:.3f} ms", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
