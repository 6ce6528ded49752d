"""Time the tile attention kernel (`csrc/flash_attention.cu`) at the
settings its route takes, beside an earlier version of the kernel.

    python3 tools/tile_probe.py [--seed 0] [--baseline-cu FILE] [--reps 3]

Needs one CUDA card. Settings: gemma2-2b's prefill head shape (B 1, S
32768, Hq 8, Hkv 4, D 256) on f32 operands made from --seed, as
`chip_smoke.py` phase 4 times the tile kernel: global and local (window
4096) layers, each with the softcap 50 and without; then bf16 at the
SMOKE configs' head shape (D 16, Hq 4, Hkv 2, so G 2) over S 4096 with
the softcap, which `flash_attention.route` also sends to the tile kernel.
Each setting is checked first: f32 rows 0..255 and the last 256 within
`chip_smoke.row_error`'s limit of the plain version, bf16 at the
reference's 2e-2. Times are medians of --reps calls by CUDA events
(`chip_smoke.time_ms`), beside the bound in split TF32 (`chip_smoke.
fa_bound`) and, for f32, on the CUDA cores.

With --baseline-cu, FILE is the tile kernel as it was before the split-TF32
redesign (`git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu
> build/flash_attention_parent.cu`; `build/` is copied to the card), with
the entry
`flash_attention_launch(q, k, v, out, B, Sq, Hq, Hkv, D, 9 strides, kv_len,
q_offset, window, cap, causal, bf16, rt, stream)` and its row tile
`rt` = 4 when Sq * G >= 256, else 1. It is built alone with nvcc
(`tools/nvcc_lib.py`), held to the same checks and timed in turns with the
current kernel (current, baseline, baseline, current). Prints one line per
setting, then the card.
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
from repro_torch.kernels.flash_attention import route  # noqa: E402

S, HQ, HKV, D, WINDOW, CAP = 32768, 8, 4, 256, 4096, 50.0
SMOKE_S, SMOKE_HQ, SMOKE_HKV, SMOKE_D = 4096, 4, 2, 16


def baseline_fn(path: Path):
    lib = nvcc_lib.load(path, "flash-attention-baseline")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 17 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q, k, v, *, window, softcap):
        b, sq, hq, d = q.shape
        hkv = k.shape[2]
        out = torch.empty_like(q)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, hq,
                  hkv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], k.shape[1],
                  0, -1 if window is None else window,
                  0.0 if softcap is None else softcap, 1, int(q.dtype == torch.bfloat16),
                  4 if sq * (hq // hkv) >= 256 else 1, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"baseline flash_attention launch failed ({code})")
        return out
    return run


def check(out, q, k, v, what, **kw) -> float:
    """The largest error over its limit (f32: rows 0..255 and the last 256
    against the plain version on those rows; bf16: the whole output at
    2e-2)."""
    if q.dtype == torch.bfloat16:
        want = ref.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2,
                                   msg=lambda m: f"{what}: {m}")
        return float((out.float() - want.float()).abs().max()) / 2e-2
    s = q.shape[1]
    worst = 0.0
    for r0 in (0, s - 256):
        want = ref.flash_attention(q[:, r0:r0 + 256], k[:, :r0 + 256], v[:, :r0 + 256],
                                   q_offset=r0, **kw)
        ratio, _ = cs.row_error(out[:, r0:r0 + 256], want, False, f"{what} rows {r0}..")
        worst = max(worst, ratio)
    return worst


def probe(name, q, k, v, base, reps, **kw) -> None:
    cs.check(route(q, k, v) == "flash_attention", f"{name}: not the tile kernel's route")
    b_ms, b_by = cs.fa_bound(q, k, True, kw["window"], 0, k.shape[1])
    extra = ""
    if q.dtype == torch.float32:
        core = cs.fa_flops(q, True, kw["window"], 0, k.shape[1]) / cs.FP32_FLOPS * 1e3
        extra = f", {core:.3f} ms on the CUDA cores"
    ratio = check(ops.flash_attention(q, k, v, **kw), q, k, v, f"{name} current", **kw)
    runs = {"current": lambda: ops.flash_attention(q, k, v, **kw)}
    if base is not None:
        check(base(q, k, v, **kw), q, k, v, f"{name} baseline", **kw)
        runs["baseline"] = lambda: base(q, k, v, **kw)
    order = list(runs) + list(runs)[::-1]
    ms = {n: [] for n in runs}
    for n in order:
        ms[n].append(cs.time_ms(runs[n], reps))
    print(f"{name}: " + ", ".join(f"{n} " + " / ".join(f"{t:.3f}" for t in v)
                                  + " ms" for n, v in ms.items())
          + f" (bound {b_ms:.3f} ms by {b_by}{extra}; error / limit {ratio:.3g})",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-cu", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tile_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.lib()
    base = baseline_fn(args.baseline_cu) if args.baseline_cu else None
    gen = torch.Generator(dev).manual_seed(args.seed + 3)
    q = torch.randn((1, S, HQ, D), generator=gen, device=dev)
    k = torch.randn((1, S, HKV, D), generator=gen, device=dev)
    v = torch.randn((1, S, HKV, D), generator=gen, device=dev)
    for layer, window in (("global", None), ("local", WINDOW)):
        for cap in (CAP, None):
            probe(f"f32 {layer} S={S} softcap={cap}", q, k, v, base, args.reps,
                  window=window, softcap=cap)
    del q, k, v
    q = torch.randn((1, SMOKE_S, SMOKE_HQ, SMOKE_D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((1, SMOKE_S, SMOKE_HKV, SMOKE_D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((1, SMOKE_S, SMOKE_HKV, SMOKE_D), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    probe(f"bf16 D={SMOKE_D} G={SMOKE_HQ // SMOKE_HKV} S={SMOKE_S} softcap={CAP}", q, k, v,
          base, max(args.reps, 20), window=None, softcap=CAP)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
