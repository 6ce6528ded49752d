"""How close the bf16 prefill kernel comes to the attention's row limit,
over several seeds: the margin behind `chip_smoke.py`'s model-shape check.

    python3 tools/prefill_precision.py [--seeds 0 1 2 3] [--s 8192 32768]
    PYTHONPATH=src python3 tools/prefill_precision.py --device cpu --s 512

At gemma2-2b's head shape (Hq 8, Hkv 4, D 256, softcap 50), global and
with window 4096, bf16 operands made on the device from each seed go
through `ops.flash_attention` (on the card: the `flash_prefill` kernel; on
the CPU its arithmetic `ref.flash_prefill` stands in) and are held to
`chip_smoke.py`'s rule against the plain version on f32 copies: every
element within 2e-4 x its row's rms plus the bf16 output's rounding
2^-8 |want|. Rows as `chip_smoke.py` checks them: all of them up to 8192
tokens, else four 512-query blocks. Prints the largest error over that
limit per seed and setting (above 1 fails the rule) beside the same for
the plain output rounded to bf16, the floor that rounding alone sets, then
the spread over seeds, beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import ops, ref  # noqa: E402

HQ, HKV, D, CAP, WINDOW = 8, 4, 256, 50.0, 4096


def row_blocks(s: int) -> list[tuple[int, int]]:
    return [(0, s)] if s <= 8192 else [(r, 512) for r in (0, 4096 - 256, s // 2 + 100,
                                                            s - 512)]


def limit_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    rms = want.pow(2).mean(dim=(2, 3), keepdim=True).sqrt()
    lim = 2e-4 * rms + 2.0 ** -8 * want.abs()
    return float(((got.float() - want).abs() / lim).max())


def margin(seed: int, s: int, window: int | None,
           dev: torch.device) -> tuple[float, float]:
    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn((1, s, h, D), generator=gen, device=dev, dtype=torch.bfloat16)
               for h in (HQ, HKV, HKV))
    kw = dict(causal=True, window=window, softcap=CAP)
    run = ops.flash_attention if dev.type == "cuda" else ref.flash_prefill
    got = run(q, k, v, **kw)
    worst = floor = 0.0
    for r0, n in row_blocks(s):
        want = ref.flash_attention(q[:, r0:r0 + n].float(), k[:, :r0 + n].float(),
                                   v[:, :r0 + n].float(), q_offset=r0, **kw)
        worst = max(worst, limit_ratio(got[:, r0:r0 + n], want))
        floor = max(floor, limit_ratio(want.to(torch.bfloat16), want))
    return worst, floor


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--s", type=int, nargs="+", default=[8192, 32768])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(), flush=True)
    ratios: dict[tuple[int, int | None], list[float]] = {}
    for seed in args.seeds:
        for s in args.s:
            for window in (None, WINDOW):
                r, floor = margin(seed, s, window, dev)
                ratios.setdefault((s, window), []).append(r)
                print(f"seed {seed} S={s} window={window}: error / limit {r:.4f} "
                      f"(rounding alone {floor:.4f})", flush=True)
    for (s, window), rs in ratios.items():
        print(f"S={s} window={window} over {len(rs)} seeds: error / limit min "
              f"{min(rs):.4f}, mean {sum(rs) / len(rs):.4f}, max {max(rs):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
