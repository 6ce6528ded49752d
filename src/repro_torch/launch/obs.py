"""Telemetry replay/summarize CLI for `artifacts/obs/` JSONL snapshots.

    python -m repro_torch.launch.obs                   # summarize every run
    python -m repro_torch.launch.obs --run ingest      # one run, windows + totals
    python -m repro_torch.launch.obs --spans --events  # span/event detail
    python -m repro_torch.launch.obs --check \
        --require-metric serve_queries_total           # CI gate (exit 1 on miss)

`--check` asserts every run has at least one snapshot, every snapshot has the
required keys (window/ts/metrics/spans/events), and each `--require-metric`
name appears with a non-empty series in at least one snapshot — the CI
telemetry smoke gates on this. `--max-dropped-frac F` additionally gates on
span/event ring retention: any run whose final snapshot reports a dropped
fraction above F (or lacks the `rings` block entirely) fails the check.

The port's counterpart of `repro.launch.obs` (numpy + stdlib). It reads
either package's snapshots: both write the same metric names and layout.
The reference's `--diff` goes through `benchmarks.compare`, which reads
snapshots with the reference package; the port has no `--diff` until its
benchmarks are ported.
"""
from __future__ import annotations

import argparse

from repro_torch.obs import load_dir
from repro_torch.obs.render import render_line

REQUIRED_KEYS = ("window", "ts", "metrics", "spans", "events")


def _counter_total(metrics: dict, name: str) -> float:
    inst = metrics.get(name)
    if not inst or inst.get("type") != "counter":
        return 0.0
    return sum(s["value"] for s in inst.get("series", []))


def summarize_run(name: str, snaps: list[dict], *, show_spans: bool,
                  show_events: bool) -> None:
    last = snaps[-1]["metrics"] if snaps else {}
    spans = [s for snap in snaps for s in snap.get("spans", [])]
    events = [e for snap in snaps for e in snap.get("events", [])]
    print(render_line(f"[{name}]", [
        ("@n", f"{len(snaps)} snapshots"),
        ("windows", f"{snaps[0]['window']}..{snaps[-1]['window']}"
         if snaps else "-"),
        ("queries", int(_counter_total(last, "serve_queries_total"))
         or int(_counter_total(last, "cluster_queries_total"))),
        ("words", int(_counter_total(last, "serve_words_total"))
         or int(_counter_total(last, "cluster_words_total"))),
        ("refits", int(_counter_total(last, "refits_total"))),
        ("spans", len(spans)), ("events", len(events))]))
    by_kind: dict[str, int] = {}
    for e in events:
        by_kind[e.get("kind", "?")] = by_kind.get(e.get("kind", "?"), 0) + 1
    if by_kind:
        print(render_line("  events:", sorted(by_kind.items())))
    if show_spans:
        by_name: dict[str, list[float]] = {}
        for s in spans:
            by_name.setdefault(s.get("name", "?"), []).append(
                float(s.get("wall_ms", 0.0)))
        for n in sorted(by_name):
            ms = by_name[n]
            print(render_line(f"  span {n}:", [
                ("n", len(ms)), ("total_ms", sum(ms)),
                ("mean_ms", sum(ms) / max(len(ms), 1)),
                ("max_ms", max(ms))]))
    if show_events:
        for e in events:
            fields = [(k, v) for k, v in e.items()
                      if k not in ("seq", "t_s", "kind")]
            print(render_line(f"  event {e.get('kind', '?')}:", fields))


def check(runs: dict[str, list[dict]], require_metrics: list[str],
          max_dropped_frac: float | None = None) -> int:
    """Returns the number of failures (0 = pass), printing each one."""
    failures = 0
    if not runs:
        print("[obs] CHECK FAIL: no *.jsonl snapshot files found")
        return 1
    for name, snaps in runs.items():
        if not snaps:
            print(f"[obs] CHECK FAIL: run {name!r} has no snapshots")
            failures += 1
            continue
        for i, snap in enumerate(snaps):
            missing = [k for k in REQUIRED_KEYS if k not in snap]
            if missing:
                print(f"[obs] CHECK FAIL: run {name!r} snapshot {i} is "
                      f"missing keys {missing}")
                failures += 1
        if max_dropped_frac is not None:
            rings = snaps[-1].get("rings")
            if not isinstance(rings, dict):
                print(f"[obs] CHECK FAIL: run {name!r} has no 'rings' "
                      f"retention block (needed for --max-dropped-frac)")
                failures += 1
            else:
                for ring_name, ring in sorted(rings.items()):
                    seen = int(ring.get("n_seen", 0))
                    dropped = int(ring.get("n_dropped", 0))
                    frac = dropped / max(seen, 1)
                    if frac > max_dropped_frac:
                        print(f"[obs] CHECK FAIL: run {name!r} dropped "
                              f"{frac:.1%} of {ring_name} "
                              f"({dropped}/{seen}) > "
                              f"{max_dropped_frac:.1%} — raise the ring "
                              f"capacity or export more often")
                        failures += 1
    for metric in require_metrics:
        found = any(
            snap.get("metrics", {}).get(metric, {}).get("series")
            for snaps in runs.values() for snap in snaps)
        if not found:
            print(f"[obs] CHECK FAIL: metric {metric!r} has no series in "
                  f"any snapshot")
            failures += 1
    if failures == 0:
        n = sum(len(s) for s in runs.values())
        print(f"[obs] check ok: {len(runs)} run(s), {n} snapshot(s), "
              f"{len(require_metrics)} required metric(s) present")
    return failures


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default="artifacts/obs",
                    help="snapshot directory to read")
    ap.add_argument("--run", default="",
                    help="summarize only this run name (file stem)")
    ap.add_argument("--spans", action="store_true",
                    help="per-span-name timing rollup")
    ap.add_argument("--events", action="store_true",
                    help="print every event")
    ap.add_argument("--check", action="store_true",
                    help="CI gate: exit nonzero on missing snapshots/keys")
    ap.add_argument("--require-metric", action="append", default=[],
                    help="with --check: metric name that must have a "
                         "non-empty series (repeatable)")
    ap.add_argument("--max-dropped-frac", type=float, default=None,
                    help="with --check: fail any run whose final snapshot "
                         "reports a span/event ring dropped fraction above "
                         "this")
    args = ap.parse_args()

    runs = load_dir(args.dir)
    if args.run:
        runs = {k: v for k, v in runs.items() if k == args.run}
    if args.check:
        raise SystemExit(1 if check(runs, args.require_metric,
                                    args.max_dropped_frac) else 0)
    if not runs:
        print(f"[obs] no snapshots under {args.dir}")
        return
    for name in sorted(runs):
        summarize_run(name, runs[name], show_spans=args.spans,
                      show_events=args.events)


if __name__ == "__main__":
    main()
