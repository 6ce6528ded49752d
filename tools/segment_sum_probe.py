"""Where `segment_sum`'s time goes in EGNN's ogb_products step, and what its
routes can reach at ogb_products' [E, 64].

    python3 tools/segment_sum_probe.py [--root DIR] [--seed 0] [--parts step,kernel]
                                       [--tag NAME] [--out DIR]

Needs one CUDA card. `--root` names the checkout whose `src/` and
`chip_smoke.py` are imported (default: this one), so two commits can be
compared in one call on one card: unpack the other with `git archive` into
a directory that `.gitignore` lists and run both in turns.

- `step`: ogb_products' train step at full width (the registry's loss and
  AdamW, as `chip_smoke.py` 8c): ms a step (median of 2 after a warm-up),
  edges/s, peak GiB; one step with every `segment_sum` call bracketed by
  CUDA events and labelled by route (gather: a plan with a perm; stream:
  rows already in segment order), layout (thread, warp), plan (the edge
  plan's dst or src, or another) and F, and whether it continued a running
  sum (out0); one step under `torch.profiler` with shapes: busy and idle
  share, the device time of each kernel name, and of every aten op that
  reads or writes a node-sized tensor (first dim N) — the passes a chunk
  adds besides the sums.
- `kernel`: at ogb_products' [E, 64] (uniform random dst): the gather
  route over the dst plan's perm (the only route on a checkout without
  sorted plans);
  one 2^22-row chunk of the edges in the checkout's own layout, continuing
  a running sum; the gather floor (`index_select` by the same perm into a
  buffer, in two halves to bound memory) and the streaming floor (a
  contiguous copy of the rows, the same halves); on a checkout with a
  sorted plan (`segment_sum.sorted_plan`) the streaming route at [E, 64]
  with the rows taken as if in dst order, and at the chunk. Each beside
  its byte bound (3.35 TB/s).

Prints one JSON line per part and writes them to
`<out>/segment_sum_probe_<tag>.json` (default `build/probe`), then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

import torch

HBM = 3.35e12


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="step,kernel")
    ap.add_argument("--tag", default="this")
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[1] / "build" / "probe"))
    return ap.parse_args(argv)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM * 1e3


def labelled(S, names: dict):
    """Wrap `S.segment_sum` so that each call is bracketed by CUDA events
    under a label; returns (restore, records)."""
    orig = S.segment_sum
    recs: list = []

    def wrapped(rows, perm, offsets, out0=None, *args, **kw):
        route = "stream" if perm is None else "gather"
        f = rows.shape[1]
        label = (route, S.route(f), names.get(id(offsets), "other"), f,
                 "out0" if out0 is not None else "fresh")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(rows, perm, offsets, out0, *args, **kw)
        b.record()
        recs.append((label, a, b))
        return out

    S.segment_sum = wrapped
    return (lambda: setattr(S, "segment_sum", orig)), recs


def part_step(cs, seed: int, dev) -> dict:
    from repro_torch.configs import registry as R
    from repro_torch.kernels import segment_sum as S
    from repro_torch.models import egnn as G
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import make_train_step
    from torch.profiler import ProfilerActivity, profile
    shape = "ogb_products"
    arch = R.get_arch("egnn")
    cfg = arch.config_for(shape)
    n = cs.gnn_dims()[shape][0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    batch, _ = cs.gnn_batch(shape, seed, dev)
    n_edges = int(((batch["edges"][0] >= 0) & (batch["edges"][1] >= 0)).sum())
    init_state, train_step = make_train_step(
        arch.loss_fn(cfg), OptimizerConfig(name=arch.optimizer, lr=1e-3, warmup_steps=1,
                                           decay_steps=100))
    holder = {"state": init_state(G.init_params(torch.Generator(dev).manual_seed(seed),
                                                cfg))}

    def one():
        holder["state"], met = train_step(holder["state"], batch)
        return float(met["loss"])

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    # label each plan's offsets by its role
    names: dict = {}
    orig_plan = G.edge_plan

    def edge_plan(*a, **kw):
        plan = orig_plan(*a, **kw)
        for _, chunks in plan.entries:
            for ch in chunks:
                names[id(ch.dst.offsets)] = "dst"
                names[id(ch.src.offsets)] = "src"
        return plan

    G.edge_plan = edge_plan
    restore, recs = labelled(S, names)
    try:
        torch.cuda.synchronize()
        one()
        torch.cuda.synchronize()
    finally:
        restore()
        G.edge_plan = orig_plan
    split = collections.defaultdict(lambda: [0, 0.0])
    for label, a, b in recs:
        split[label][0] += 1
        split[label][1] += a.elapsed_time(b)
    seg_total = sum(v[1] for v in split.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kernel = sorted(((e.key[:90], e.count, e.self_device_time_total / 1e3)
                        for e in kernels), key=lambda x: -x[2])
    node_ops = []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type == torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        shapes = [s for s in (e.input_shapes or []) if isinstance(s, (list, tuple))]
        if any(len(s) >= 1 and s[0] == n for s in shapes):
            node_ops.append((e.key, str(shapes)[:120], e.count,
                             e.self_device_time_total / 1e3))
    node_ops.sort(key=lambda x: -x[3])
    ms = statistics.median(times[1:])
    rec = dict(part="step", shape=shape, nodes=n, valid_edges=n_edges,
               chunks=len(range(0, batch["edges"].shape[1], cfg.edge_chunk)),
               ms_per_step=ms, step_ms=times, edges_per_s=n_edges / ms * 1e3,
               peak_gib=peak, profiled_wall_ms=wall, busy_ms=busy,
               idle_share=1 - busy / wall,
               segment_sum_events_ms=seg_total, segment_sum_launches=len(recs),
               segment_sum_split=[dict(route=k[0], layout=k[1], plan=k[2], f=k[3],
                                       out0=k[4], launches=v[0], ms=v[1])
                                  for k, v in sorted(split.items())],
               kernels=by_kernel[:40], node_sized_ops=node_ops[:40])
    del holder, batch
    torch.cuda.empty_cache()
    return rec


def part_kernel(cs, seed: int, dev) -> dict:
    from repro_torch.configs import registry as R
    from repro_torch.kernels import segment_sum as S
    n, e = cs.gnn_dims()["ogb_products"][:2]
    chunk = R.get_arch("egnn").config_for("ogb_products").edge_chunk
    f = 64
    dst = cs.ogb_edges(seed, dev)[1].clone()
    gen = torch.Generator(dev).manual_seed(seed + 1)
    rows = torch.randn((e, f), generator=gen, device=dev)
    valid = dst >= 0
    rows[~valid] = 0.0
    p = S.plan(dst, n, valid)
    m = p.perm.shape[0]
    out = {}
    # the gather route at [E, 64]
    ms = cs.time_ms(lambda: S.segment_sum(rows, p.perm, p.offsets), 10)
    nbytes = m * f * 4 + m * 4 + (n + 1) * 4 + n * f * 4
    out["gather_E64"] = dict(ms=ms, bound_ms=bound_ms(nbytes), bytes=nbytes)
    # the floors, in two halves
    half = (m + 1) // 2
    buf = torch.empty((half, f), device=dev)
    perm64 = p.perm.long()

    def gather_floor():
        for lo in (0, half):
            hi = min(m, lo + half)
            torch.index_select(rows, 0, perm64[lo:hi], out=buf[:hi - lo])

    def copy_floor():
        for lo in (0, half):
            hi = min(m, lo + half)
            buf[:hi - lo].copy_(rows[lo:hi])

    gb = m * f * 4 * 2 + m * 8
    out["gather_floor"] = dict(ms=cs.time_ms(gather_floor, 5), bound_ms=bound_ms(gb),
                               bytes=gb)
    cb = m * f * 4 * 2
    out["copy_floor"] = dict(ms=cs.time_ms(copy_floor, 5), bound_ms=bound_ms(cb), bytes=cb)
    del buf, perm64
    acc = torch.randn((n, f), generator=gen, device=dev)
    c0 = (e // chunk // 2) * chunk          # a chunk in the middle of the edges
    sorted_plan = getattr(S, "sorted_plan", None)
    if sorted_plan is None:
        # a checkout without sorted plans lays a chunk out in the edges'
        # original order, with its own perm plan, continuing the running sum
        # over all N nodes
        cp = S.plan(dst[c0:c0 + chunk], n, valid[c0:c0 + chunk])
        rc = rows[c0:c0 + chunk]
        mc = cp.perm.shape[0]
        ms = cs.time_ms(lambda: S.segment_sum(rc, cp.perm, cp.offsets, acc), 10)
        cb = mc * f * 4 + mc * 4 + (n + 1) * 4 + 2 * n * f * 4
        out["chunk"] = dict(layout="original order, perm plan", ms=ms,
                            bound_ms=bound_ms(cb), bytes=cb, rows=mc, nodes=n)
    else:
        key = torch.where(valid, dst, n)
        skey = torch.sort(key).values
        sp = sorted_plan(skey, n, skey < n)
        mo = sp.bounds.tolist()
        ms = cs.time_ms(lambda: S.segment_sum(rows, None, sp.offsets, bounds=sp.bounds,
                                              out=acc), 10)
        nb = m * f * 4 + (mo[1] - mo[0] + 1) * 4 + (mo[1] - mo[0]) * f * 4   # no out0
        out["stream_E64"] = dict(ms=ms, bound_ms=bound_ms(nb), bytes=nb)
        kc = skey[c0:c0 + chunk]
        cp = sorted_plan(kc, n, kc < n)
        lo, hi = cp.bounds.tolist()
        rc = rows[c0:c0 + chunk]
        ms = cs.time_ms(lambda: S.segment_sum(rc, None, cp.offsets, acc, bounds=cp.bounds,
                                              out=acc), 10)
        mc = int((kc < n).sum())
        cb = mc * f * 4 + (hi - lo + 1) * 4 + 2 * (hi - lo) * f * 4
        out["chunk"] = dict(layout="dst order, sorted plan, in place over its range",
                            ms=ms, bound_ms=bound_ms(cb), bytes=cb, rows=mc, nodes=hi - lo)
    for k, v in out.items():
        if isinstance(v, dict) and "bound_ms" in v:
            v["share"] = v["bound_ms"] / v["ms"]
    return dict(part="kernel", shape=f"E={e} ({m} valid), N={n}, F={f}", **out)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    if not torch.cuda.is_available():
        print("segment_sum_probe: no CUDA device", file=sys.stderr)
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
        rec = {"step": part_step, "kernel": part_kernel}[part](cs, args.seed, dev)
        rec.update(tag=args.tag, root=str(root), seconds=time.perf_counter() - t)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"segment_sum_probe_{args.tag}.json").write_text(json.dumps(recs, indent=1))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
