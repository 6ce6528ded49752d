"""Time the tensor-core attention backward (`csrc/flash_backward_tc.cu`)
at the training layers `chip_smoke.py` phase 6b times it at, split by
kernel, beside other versions of the kernel.

    python3 tools/backward_probe.py [--seed 0] [--baseline-cu FILE ...] [--reps 10]

Needs one CUDA card. Settings: `chip_smoke.BWD_SETTINGS`' layers in bf16 —
internlm2-1.8b (B 4, S 4096, Hq 16, Hkv 8, D 128), kimi-k2 (B 1, S 4096,
Hq 64, Hkv 8, D 128), gemma2-2b's global and local
layers (B 1, S 8192, Hq 8, Hkv 4, D 256, softcap 50, window 4096 on the
local one) and gemma3-12b's (B 1, S 8192, Hq 16, Hkv 8, D 256, window 1024
on the local one) — made from --seed, each forward's lse from
`flash_prefill`. Times are medians of --reps calls by CUDA events
(`chip_smoke.time_ms`), beside the bound and the kernel's own floor
(`chip_smoke.bwd_bound`; the own floor is 14*D FLOPs a pair); the split
of one call among the lse/delta pass, the dq kernel and the dK/dV kernel
comes from a `torch.profiler` trace.

Each --baseline-cu FILE is another version of `flash_backward_tc.cu` with
the same entry `flash_backward_tc_launch` (put it under `build/`, which is
copied to the card). It is built alone with nvcc (`tools/nvcc_lib.py`),
held first to `ref.flash_backward_tc` on `chip_smoke.BWD_TC_CASES` at
`chip_smoke.BWD_TC_TOL`, and timed in turns with the current kernel
(baseline, current, current, baseline) on the same inputs, its outputs
compared with the current kernel's. Prints one line per setting and
version, then the card.
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
from repro_torch.kernels import _build, flash_backward, ref  # noqa: E402

PARTS = ("stats", "dq", "dkdv")


def baseline_fn(path: Path, tag: str):
    fn = nvcc_lib.load(path, tag).flash_backward_tc_launch
    fn.argtypes = _build._SIGNATURES["flash_backward_tc_launch"]
    fn.restype = ctypes.c_int

    def run(q, k, v, o, do, lse, *, window=None, softcap=None):
        b, s, hq, d = q.shape
        hkv = k.shape[2]
        f32 = dict(dtype=torch.float32, device=q.device)
        dq = torch.empty((b, s, hq, d), **f32)
        dk = torch.empty((b, s, hkv, d), **f32)
        dv = torch.empty((b, s, hkv, d), **f32)
        stats = torch.empty((b, hq, -(-s // 64) * 64, 2), **f32)
        strides = (ctypes.c_int64 * 15)(*(x for t in (q, k, v, o, do) for x in t.stride()[:3]))
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, s, hq, hkv, d, strides,
                  flash_backward.kernel_window(window, s),
                  0.0 if softcap is None else float(softcap), 1,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{path.name}: flash_backward_tc launch failed ({code})")
        return dq, dk, dv
    return run


def split(fn) -> dict:
    """Device ms of one call by kernel: the lse/delta pass, dq, dK/dV."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(PARTS, 0.0)
    for e in prof.key_averages():
        for part in PARTS:
            if f"flash_backward_tc_{part}" in e.key:
                out[part] += e.self_device_time_total / 1e3
    if not any(out.values()):
        cs.log("the profiler saw no backward kernel: split not measured")
    return out


def check_ragged(run, name: str, gen) -> float:
    worst = 0.0
    for b, s, hq, hkv, d, window, cap in cs.BWD_TC_CASES:
        q, k, v, o, do, lse = cs.bwd_inputs(gen, b, s, hq, hkv, d, torch.bfloat16, window,
                                            cap, lse=True)
        kw = dict(window=window, softcap=cap)
        got = run(q, k, v, o, do, lse, **kw)
        r, _ = cs.bwd_agree(got, ref.flash_backward_tc(q, k, v, o, do, lse, **kw),
                            f"{name} b{b} s{s} hq{hq} hkv{hkv} d{d}", cs.BWD_TC_TOL, name)
        worst = max(worst, r)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-cu", type=Path, nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("backward_probe: no CUDA device; this probe runs only on the card",
              file=sys.stderr)
        return 1
    _build.lib()
    cuda = torch.device("cuda")
    gen = torch.Generator(cuda).manual_seed(args.seed)

    def current(q, k, v, o, do, lse, **kw):
        return flash_backward.flash_backward(q, k, v, o, do, lse=lse, **kw)
    bases = {}
    for i, path in enumerate(args.baseline_cu):
        run = baseline_fn(path, f"backward-baseline-{i}")
        for log in sorted(_build.BUILD_ROOT.glob(f"probe-backward-baseline-{i}-*/build.log")):
            for ln in cs.ptxas_lines(log.read_text()):
                if "dkdv" in ln or "_dq" in ln:
                    cs.log(f"{path.name}: ptxas {ln}")
        cs.log(f"{path.name}: {check_ragged(run, path.name, gen):.3f} of BWD_TC_TOL at worst "
               f"on {len(cs.BWD_TC_CASES)} ragged cases")
        bases[path.name] = run
    for name in cs.BWD_SETTINGS:
        b, s, hq, hkv, d, window, cap, _ = cs.BWD_SETTINGS[name]
        q, k, v, o, do, lse = cs.bwd_inputs(gen, b, s, hq, hkv, d, torch.bfloat16, window, cap,
                                            lse=True)
        kw = dict(window=window, softcap=cap)
        bound = cs.bwd_bound(b, s, hq, hkv, d, window, 2 * (3 * q.numel() + 2 * k.numel()))
        own = 1.4 * bound["flops"] / cs.BF16_TC_FLOPS * 1e3

        def cur():
            return current(q, k, v, o, do, lse, **kw)
        want = cur()
        parts = split(cur)
        cs.log(f"{name}: flash_backward_tc {cs.time_ms(cur, args.reps):.3f} ms (bound "
               f"{bound['bound_ms']:.3f}, own floor {own:.3f}); split "
               + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
        for base_name, run in bases.items():
            def base():
                return run(q, k, v, o, do, lse, **kw)
            same = all(torch.equal(x, y) for x, y in zip(base(), want))
            t = [cs.time_ms(f, args.reps) for f in (base, cur, cur, base)]
            cs.log(f"{name}: {base_name} {t[0]:.3f} / {t[3]:.3f} ms, current {t[1]:.3f} / "
                   f"{t[2]:.3f} ms in turns; outputs bit-equal: {same}; split "
                   + ", ".join(f"{k} {v:.3f}" for k, v in split(base).items()))
        del q, k, v, o, do, lse, want
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
