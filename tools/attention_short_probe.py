"""Where the recsys blocks' attention forward spends its time in BST's and
BERT4Rec's steps and serving calls, and what the forward kernels take at
their attention shapes.

    python3 tools/attention_short_probe.py [--root DIR] [--seed 0]
                                           [--parts step,serve,kernel]
                                           [--tag NAME] [--out DIR]

Needs one CUDA card. `--root` names the checkout whose `src/` and
`chip_smoke.py` are imported (default: this one), so two commits can be
compared in one call on one card: unpack the other with `git archive` into
a directory that `.gitignore` lists and run both in turns.

- `step`: BST's train step at B 65536 and BERT4Rec's at B 1024 (the
  registry's loss and optimizer, `chip_smoke.py` 7c's batches): ms a step
  (median of 3 after a warm-up, host clock with a sync), then one step
  under `torch.profiler`: the device's busy time and idle share, and its
  split into the attention forward's kernels (the tile kernel
  `flash_attention_kernel`; the short forward's `flash_attention_tiny_kernel`
  and `flash_attention_short_kernel`), the head-dim padding copies
  (`aten::constant_pad_nd`, with the kernels under it), the attention
  backward (`flash_backward*`) and the rest, beside the top kernels.
- `serve`: BST's retrieval_cand over 10^6 candidates and serve_p99 (B 512),
  and BERT4Rec's serve_p99, each timed (median of 3 by CUDA events) and
  one call profiled, split as above.
- `kernel`: at `chip_smoke.RECSYS_ATTN` (f32, non-causal): the routed
  forward (`ops.flash_attention`), the tile kernel through
  `flash_attention._tile` on operands padded to D 8 as its route pads them
  (the padding not timed), and SDPA, each the median of 10 by CUDA events,
  beside `chip_smoke.fa_bound`.

Prints one JSON line per part and writes them to
`<out>/attention_short_probe_<tag>.json` (default `build/probe`), then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

FORWARD = ("flash_attention_kernel", "flash_attention_tiny_kernel",
           "flash_attention_short_kernel")
PAD_OP = "aten::constant_pad_nd"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="step,serve,kernel")
    ap.add_argument("--tag", default="this")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[1] / "build" / "probe"))
    return ap.parse_args(argv)


def events_ms(fn, reps: int) -> float:
    """The median of `reps` calls by CUDA events, after one warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def profiled(fn) -> dict:
    """One call of fn under torch.profiler: wall ms (host clock with a
    sync), busy ms, idle share, and the busy time split into the forward
    kernels by name, the padding copies, the backward and the rest."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3

    def dev(e):
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3
    fwd = {name: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
           for name in FORWARD}
    fwd_n = {name: sum(e.count for e in kernels if name in e.key) for name in FORWARD}
    pad = sum(dev(e) for e in avg if e.key == PAD_OP)
    pad_n = sum(e.count for e in avg if e.key == PAD_OP)
    bwd = sum(e.self_device_time_total for e in kernels if "flash_backward" in e.key) / 1e3
    top = sorted(((e.key[:100], e.count, e.self_device_time_total / 1e3) for e in kernels),
                 key=lambda x: -x[2])[:15]
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall if wall else None,
                forward_ms=fwd, forward_launches=fwd_n, pad_ms=pad, pad_calls=pad_n,
                backward_ms=bwd, rest_ms=busy - sum(fwd.values()) - pad - bwd,
                top_kernels=top)


def part_step(cs, seed: int, dev) -> dict:
    from repro_torch.configs import registry as R
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import make_train_step
    out = {}
    for name in ("bst", "bert4rec"):
        arch = R.get_arch(name)
        cfg = arch.config_for("train_batch")
        b = cs.RECSYS_TRAIN_B[name]
        init_state, train_step = make_train_step(
            arch.loss_fn(cfg), OptimizerConfig(name=arch.optimizer, lr=1e-3, warmup_steps=1,
                                               decay_steps=100))
        holder = {"state": init_state(cs.recsys_init(name)(
            torch.Generator(dev).manual_seed(seed), cfg))}
        batch = cs.recsys_train_batch(name, cfg, np.random.default_rng(seed + 29), b, dev)

        def one():
            holder["state"], met = train_step(holder["state"], batch)
            return float(met["loss"])
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = one()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = dict(batch=b, ms_per_step=statistics.median(times[1:]), step_ms=times,
                         loss_finite=math.isfinite(loss), profile=profiled(one))
        del holder, batch
        torch.cuda.empty_cache()
    return dict(part="step", **out)


def part_serve(cs, seed: int, dev) -> dict:
    from repro_torch.configs import registry as R
    out = {}
    for name in ("bst", "bert4rec"):
        arch = R.get_arch(name)
        cfg = arch.config_for("serve_p99")
        with torch.no_grad():
            params = cs.recsys_init(name)(torch.Generator(dev).manual_seed(seed), cfg)
            serve, cand = cs.recsys_serve_batches(name, cfg, np.random.default_rng(seed + 23),
                                                  cs.RECSYS_SERVE_B, R.N_CANDIDATES, dev)
            calls = {"serve_p99": (arch.serve_fn(cfg, "serve_p99"), serve)}
            if name == "bst":
                calls["retrieval_cand"] = (arch.serve_fn(cfg, "retrieval_cand"), cand)
            rec = {}
            for cell, (fn, batch) in calls.items():
                rec[cell] = dict(ms=events_ms(lambda: fn(params, batch), 3),
                                 profile=profiled(lambda: fn(params, batch)))
        out[name] = rec
        del params, serve, cand
        torch.cuda.empty_cache()
    return dict(part="serve", candidates=R.N_CANDIDATES, **out)


def part_kernel(cs, seed: int, dev) -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_backward, ops
    gen = torch.Generator(dev).manual_seed(seed + 71)
    out = {}
    for arch, (b, s, h, d) in cs.RECSYS_ATTN.items():
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev) for _ in range(3))
        route = FA.route(q, k, v)
        got = ops.flash_attention(q, k, v, causal=False)
        qp, kp, vp = flash_backward.pad_head_dim(q, k, v) if d < 8 else (q, k, v)
        kw = dict(causal=False, window=None, softcap=None, q_offset=0, kv_len=s,
                  scale=1.0 / math.sqrt(d))
        tile = FA._tile(qp, kp, vp, **kw)[..., :d]
        fn, want = cs.sdpa_call(q, k, v, causal=False)
        bound, by = cs.fa_bound(q, k, False, None, 0, s)
        out[arch] = dict(
            shape=[b, s, h, d], route=route, bound_ms=bound, bound_by=by,
            routed_ms=events_ms(lambda: ops.flash_attention(q, k, v, causal=False), 10),
            tile_ms=events_ms(lambda: FA._tile(qp, kp, vp, **kw), 10),
            sdpa_ms=events_ms(fn, 10),
            routed_vs_tile=float((got - tile).abs().max()),
            routed_vs_sdpa=float((got - want.float()).abs().max()))
        del q, k, v, qp, kp, vp, got, tile, want
        torch.cuda.empty_cache()
    return dict(part="kernel", **out)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    if not torch.cuda.is_available():
        print("attention_short_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.lib()
    recs = []
    for part in args.parts.split(","):
        t = time.perf_counter()
        rec = {"step": part_step, "serve": part_serve, "kernel": part_kernel}[part](
            cs, args.seed, dev)
        rec.update(tag=args.tag, root=str(root), seconds=time.perf_counter() - t)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"attention_short_probe_{args.tag}.json").write_text(json.dumps(recs, indent=1))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
