"""Checkpointing with atomic commit and checksums, the counterpart of
`repro.train.checkpoint`.

Layout per checkpoint:
  <dir>/step_<N>/
    arrays.npz         every leaf, keyed by its '/'-joined path
    manifest.json      step, the tree's description, per-array crc32, the
                       dtype of each leaf numpy cannot hold, extra metadata
    COMMITTED          sentinel written last (atomic rename of tmp dir)

The keys, in sorted-key order, are the reference's; so are the arrays and
their crcs for f32 and integer leaves. numpy has no bfloat16, so a bf16
leaf (AdamW's m and v) is stored as its uint16 bits and named in the
manifest's "dtypes". The manifest's "treedef" is the port's own
description of the tree (`tree.describe`), not JAX's repr.

A save copies every leaf to the host first (the trainer updates its state
in place), then writes; `async_` writes in a thread. A restore returns each
leaf as a tensor on the device and in the dtype of the template's leaf at
the same path: saved on one device, resumed on another, which is the port's
elastic re-placement.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.train import tree

_BF16 = "bfloat16"


def _host(leaf) -> tuple[np.ndarray, str | None]:
    """(the array written for a leaf, its dtype name if numpy cannot hold it)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)     # a copy even of a CPU leaf
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), None
    return np.asarray(leaf), None


def _crcs(arrays: dict) -> dict:
    """crc32 of each array's bytes, in threads (zlib releases the GIL on
    large buffers: a 4 GB state takes seconds on one core)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        crcs = pool.map(lambda v: zlib.crc32(v.tobytes()), arrays.values())
        return dict(zip(arrays, crcs))


def save(ckpt_dir: str, step: int, state: dict, extra: dict | None = None,
         *, keep_last: int = 3, async_: bool = False) -> str:
    """state: a nested dict of tensors (e.g. {'params':..., 'opt':..., 'step':...})."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    arrays, dtypes = {}, {}
    for key, leaf in tree.leaves_with_paths(state):
        arrays[key], dt = _host(leaf)
        if dt:
            dtypes[key] = dt
    description = tree.describe(state)

    def _do():
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "extra": extra or {},
            "treedef": description,
            "dtypes": dtypes,
            "crc": _crcs(arrays),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep_last)
        return final

    if async_:
        threading.Thread(target=_do, daemon=True).start()
        return final
    return _do()


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, dtype: str | None, like) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    if dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def restore(ckpt_dir: str, template: dict, step: int | None = None,
            *, verify: bool = True):
    """Returns (step, state, extra) with state in `template`'s nesting, each
    leaf on its template leaf's device and in its dtype."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    if verify:
        for k, crc in _crcs(arrays).items():
            if crc != manifest["crc"][k]:
                raise IOError(f"checksum mismatch for {k} in {d}")
    dtypes = manifest.get("dtypes", {})
    flat = tree.leaves_with_paths(template)
    missing = [k for k, _ in flat if k not in arrays]
    if missing or len(flat) != len(arrays):
        raise KeyError(f"checkpoint {d} does not match the template: missing "
                       f"{missing[:5]}, {len(arrays)} arrays for {len(flat)} leaves")
    state = tree.unflatten_like(template, [_leaf(arrays[k], dtypes.get(k), like)
                                           for k, like in flat])
    return step, state, manifest["extra"]
