"""Per-window JSONL snapshot exporter + reader for `launch.obs` replay.

A copy of `repro.obs.export` (numpy + stdlib).

One run writes one JSONL file under the obs directory (default
`artifacts/obs/`); each line is one window snapshot:

    {"window": i, "ts": ..., "metrics": {registry.collect()},
     "spans": [finished spans since the last snapshot],
     "events": [events since the last snapshot], ...extra}

Snapshots carry only the spans/events that finished since the previous
export (cursored by seq in `repro_torch.obs.export_window`), so a long run's
file is an append-only log, not repeated full dumps. Metrics are
cumulative registry state — downstream diffing recovers per-window rates.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

DEFAULT_DIR = "artifacts/obs"


class JsonlExporter:
    """Appends one JSON line per window snapshot to `<dir>/<run>.jsonl`."""

    def __init__(self, dir: str | os.PathLike = DEFAULT_DIR,  # noqa: A002
                 run: str | None = None, overwrite: bool = True):
        self.dir = Path(dir)
        if run is None:
            run = time.strftime("run-%Y%m%d-%H%M%S") + f"-p{os.getpid()}"
        self.run = run
        self.path = self.dir / f"{run}.jsonl"
        self.n_written = 0
        if overwrite and self.path.exists():
            self.path.unlink()           # a named run restarts its file

    def export(self, snapshot: dict) -> Path:
        self.dir.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as fh:
            fh.write(json.dumps(snapshot, default=_json_default,
                                sort_keys=True) + "\n")
        self.n_written += 1
        return self.path


def _json_default(value):
    """numpy scalars/arrays sneak into snapshots; make them JSON-able."""
    if hasattr(value, "item") and not hasattr(value, "__len__"):
        return value.item()
    if hasattr(value, "tolist"):
        return value.tolist()
    return str(value)


def read_jsonl(path: str | os.PathLike) -> list[dict]:
    """All snapshots in one run file, in write order."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def load_dir(dir: str | os.PathLike = DEFAULT_DIR  # noqa: A002
             ) -> dict[str, list[dict]]:
    """All runs in an obs directory: run name -> snapshots."""
    d = Path(dir)
    if not d.is_dir():
        return {}
    return {p.stem: read_jsonl(p) for p in sorted(d.glob("*.jsonl"))}
