"""Where the time of the short-sequence attention backward's tensor-core
route (`csrc/flash_backward_short.cu`, `flash_backward_short_kernel`) goes,
and what the card's `mma.sync` can do.

    python3 tools/short_probe.py [--seed 0] [--reps 5]

Needs one CUDA card.

1. The ceiling: `mma.sync.m16n8k8` TF32 issued from 4, 8 and 16 warps a
   block, one block an SM, with 1, 4 and 8 independent accumulator chains
   a warp: cycles a product a SM (`clock64`) and TFLOP/s (CUDA events).
2. The split: a copy of the kernel's source with a `clock64()` reading
   after each of its barriers (thread 0 of each CTA adds the cycles since
   the last reading to one of seven counters), built alone with nvcc
   (`tools/nvcc_lib.py`), run at BERT4Rec's attention (`chip_smoke.
   RECSYS_ATTN`, f32, non-causal, made from --seed) through the wrapper
   with `short_plan`'s plan: the cycles a CTA (one unit) spends waiting
   for its rows, in step 2 (delta, S and dP), step 3 (P and dS), step 4a
   (dK and dV), step 4b (dQ), storing dQ, and storing dK and dV; beside
   the kernel's median time over --reps calls, with and without the
   readings, and its mma.sync products a unit.
Prints one line per measurement, then the card.
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
from repro_torch.kernels import _build, flash_backward, ops  # noqa: E402

MMA_BENCH = r'''
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a), "r"(a + 1), "r"(a + 2), "r"(a + 3), "r"(b0), "r"(b1));
}
template <int CH>
__global__ void bench(float* out, long long* cycles, int iters) {
  float c[CH][4] = {};
  const uint32_t a = threadIdx.x * 3 + 1, b = threadIdx.x * 7 + 2;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CH; ++k) mma(c[k], a, b + k, b);
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CH; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int mma_bench(float* out, long long* cycles, int blocks, int threads, int iters,
                         int chains) {
  if (chains == 8) bench<8><<<blocks, threads>>>(out, cycles, iters);
  else if (chains == 4) bench<4><<<blocks, threads>>>(out, cycles, iters);
  else bench<1><<<blocks, threads>>>(out, cycles, iters);
  return (int)cudaGetLastError();
}
'''

# (text after which a reading goes, counter): the kernel's barriers in order
PHASES = ("wait", "step 2", "step 3", "step 4a", "step 4b", "dQ out", "dK, dV out")
MARKS = [
    ("    cp_async_wait_all();\n    __syncthreads();\n", 0),
    ("    __syncthreads();\n    // the next group's o in flight", 1),
    ("    __syncthreads();\n\n    // 4a.", 2),
    ("    __syncthreads();\n    // the next group's Q and dO in flight", 3),
    ("    __syncthreads();\n    store<NT>(a.dq", 4),
    ("              r0, a.g, a.rows, u0, a);\n", 5),
    ("  store<NT>(a.dv, a.dv_s, Vs, nullptr, SP * a.sk, a.sk, SP, 0, 1, a.skv, u0, a);\n", 6),
]


def instrumented(src: str) -> str:
    """The kernel source with the readings; raises if a mark moved."""
    def reading(i: int) -> str:
        return (f"if (threadIdx.x == 0) {{ unsigned long long now = clock64(); "
                f"atomicAdd(&g_phase[{i}], now - phase_last); phase_last = now; }}\n")
    for mark, i in MARKS:
        if src.count(mark) != 1:
            raise RuntimeError(f"mark not found once in the kernel source: {mark!r}")
        if mark.startswith("    __syncthreads();\n"):
            head, tail = mark.split("\n", 1)
            src = src.replace(mark, head + "\n" + reading(i) + tail)
        else:
            src = src.replace(mark, mark + reading(i))
    acc = "  float acc[kKvItems][2][KS][4];"
    ns = "namespace repro_torch {\nnamespace {\n"
    if src.count(acc) != 1 or src.count(ns) != 1:
        raise RuntimeError("the kernel's accumulators or namespace moved")
    src = src.replace(acc, "  unsigned long long phase_last = clock64();\n" + acc)
    src = src.replace(ns, "__device__ unsigned long long g_phase[8];\n" + ns)
    return src + '''
extern "C" int phase_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 8);
  unsigned long long z[8] = {0};
  cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return (int)cudaGetLastError();
}
'''


def mma_ceiling() -> None:
    path = _build.BUILD_ROOT / "short_probe_mma.cu"
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    path.write_text(MMA_BENCH)
    lib = nvcc_lib.load(path, "mmabench")
    lib.mma_bench.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
    lib.mma_bench.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2000
    for chains in (1, 4, 8):
        for warps in (4, 8, 16):
            out = torch.empty(sms * warps * 32, device="cuda")
            cyc = torch.empty(sms, dtype=torch.int64, device="cuda")

            def run():
                code = lib.mma_bench(out.data_ptr(), cyc.data_ptr(), sms, warps * 32, iters,
                                     chains)
                if code:
                    raise RuntimeError(f"mma_bench launch failed ({code})")
            ms = cs.time_ms(run, 3)
            n = warps * iters * chains
            print(f"mma.sync m16n8k8 tf32, {chains} chain(s) a warp, {warps} warps an SM: "
                  f"{float(cyc.float().mean()) / n:.3f} cycles a product a SM, "
                  f"{sms * n * 2048 / ms / 1e9:.1f} TFLOP/s", flush=True)


def products(s: int, d: int, g: int, plan) -> int:
    """mma.sync products a unit of the tensor-core route, as its loops issue
    them (clamped tiles included): three a TF32 product."""
    ks, n_tiles = plan.dp // 8, -(-s // 8)
    kmt, rows = plan.s_pad // 16, s * g
    n = 0
    for r0 in range(0, rows, plan.rows):
        in_group = min(plan.rows, rows - r0)
        mts, nk = -(-in_group // 16), -(-in_group // 8)
        n += 2 * (2 * -(-mts // 2)) * (4 * -(-n_tiles // 4)) * ks   # S and dP
        n += 2 * (2 * -(-kmt // 2)) * ks * nk                      # dK and dV
        n += mts * ks * n_tiles                                     # dQ
    return 3 * n


def phase_split(seed: int, reps: int) -> None:
    src = (_build.CSRC / "flash_backward_short.cu").read_text()
    path = _build.BUILD_ROOT / "short_probe_phases.cu"
    path.write_text(instrumented(src))
    lib = nvcc_lib.load(path, "shortphases")
    fn = lib.flash_backward_short_launch
    fn.argtypes = _build._SIGNATURES["flash_backward_short_launch"]
    fn.restype = ctypes.c_int
    lib.phase_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.phase_read.restype = ctypes.c_int
    real = _build.lib
    real()

    class Instrumented:   # the wrapper's library, its short entry swapped
        flash_backward_short_launch = fn

        def __getattr__(self, name):
            return getattr(real(), name)

    b, s, h, d = cs.RECSYS_ATTN["bert4rec"]
    gen = torch.Generator("cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda") for _ in range(4))
    o = ops.flash_attention(q, k, v, causal=False)
    plan = flash_backward.short_plan(s, d, 1, q.dtype)

    def call():
        return flash_backward.flash_backward(q, k, v, o, do, causal=False)
    plain_ms = cs.time_ms(call, reps)
    _build.lib = lambda: Instrumented()
    try:
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        lib.phase_read(buf)
        call()
        torch.cuda.synchronize()
        lib.phase_read(buf)
        probed_ms = cs.time_ms(call, reps)
    finally:
        _build.lib = real
    units = b * h
    per = [buf[i] / units for i in range(len(PHASES))]
    tot = sum(per)
    mma = products(s, d, 1, plan)
    print(f"bert4rec b{b} s{s} h{h} d{d}, plan {tuple(plan)}: {plain_ms:.3f} ms "
          f"({probed_ms:.3f} with the readings); {tot:.0f} cycles a CTA (one unit), "
          f"{mma} mma.sync products a unit", flush=True)
    for name, c in zip(PHASES, per):
        print(f"  {name}: {c:.0f} cycles a CTA, {c / tot:.3f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("short_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    mma_ceiling()
    phase_split(args.seed, args.reps)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
