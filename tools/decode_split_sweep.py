"""Time the split-KV decode kernel at gemma2-2b's decode shapes against the
number of splits, the finding behind `flash_decode.plan`.

    python3 tools/decode_split_sweep.py

Needs one CUDA card. Builds the kernels, makes a [2, 8, 32768, 4, 256]
bf16 cache and a [8, 1, 8, 256] query from a seed, and times
`ops.flash_attention` at cur_len 32767 (global, and window 4096) with
softcap 50 and without, with the plan's own split count and with the plan
replaced by fixed counts: the median of 20 back-to-back calls by CUDA
events, and the kernels' device time per call from one torch.profiler
trace of 10 calls of every setting (a short call's event time is set by
the wrapper's host work). Prints one line per setting, and the card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

SPLITS = {None: (1, 4, 8, 9, 16, 17, 24, 32, 64), 4096: (1, 4, 8, 9, 16)}
CALLS = 10            # traced calls per setting


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_split_sweep: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    _build.lib()
    gen = torch.Generator(dev).manual_seed(3)
    ck = torch.randn((2, 8, 32768, 4, 256), generator=gen, device=dev, dtype=torch.bfloat16)
    cv = torch.randn((2, 8, 32768, 4, 256), generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((8, 1, 8, 256), generator=gen, device=dev, dtype=torch.bfloat16)
    k, v, cur = ck[1], cv[1], 32767
    own = fd.plan
    settings = []
    for window, counts in SPLITS.items():
        for cap in (50.0, None):
            for n in (None,) + counts:
                fd.plan = own if n is None else (lambda keys, ctas, slots, n=n:
                                                 ref.split_keys(keys, n))
                kw = dict(window=window, softcap=cap, q_offset=cur, kv_len=cur + 1)
                splits = fd.launch_plan(q, k, window=window, q_offset=cur,
                                        kv_len=cur + 1).n_splits
                ms = cs.time_ms(lambda: ops.flash_attention(q, k, v, **kw), 20)
                settings.append((window, cap, n, splits, kw, ms))
    # one trace for all settings: each call launches the split kernel, and
    # the combine kernel when it has more than one split
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for window, cap, n, splits, kw, ms in settings:
            fd.plan = own if n is None else (lambda keys, ctas, slots, n=n:
                                             ref.split_keys(keys, n))
            for _ in range(CALLS):
                ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
    fd.plan = own
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation and "flash_decode" in e.name),
                     key=lambda e: e.time_range.start)
    want = sum(CALLS * (1 if s[3] == 1 else 2) for s in settings)
    at = 0
    for window, cap, n, splits, kw, ms in settings:
        take = CALLS * (1 if splits == 1 else 2)
        if len(kernels) == want:
            dev_ms = f"{sum(e.time_range.elapsed_us() for e in kernels[at:at + take]) / 1e3 / CALLS:.4f} ms"
        else:
            dev_ms = f"not measured ({len(kernels)} of {want} kernels traced)"
        at += take
        print(f"window={window} softcap={cap} splits={splits}"
              f"{' (plan)' if n is None else ''}: {ms:.4f} ms by events, "
              f"device {dev_ms}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
