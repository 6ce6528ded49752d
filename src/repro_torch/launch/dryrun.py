"""Meta-device dry run: every (architecture x input shape x mesh) cell's
state and inputs per mesh entry, and one step's FLOPs, with no device.

The port's counterpart of `repro.launch.dryrun`. For each cell the
parameters, the optimizer state (`init` of the arch's optimizer, through
the trainer's `init_state`) and the inputs are built on
`torch.device("meta")`: shapes and dtypes, nothing allocated. Their bytes
on one entry of the production mesh (`launch.mesh.make_production_mesh`,
16 x 16 or 2 x 16 x 16) are counted under `sharding.add_fsdp(param_specs)`,
the derived optimizer-state specs and the cell's input specs
(`sharding.entry_bytes`: entry 0 holds a full-size block). One step (the
trainer's train step, or the serving / solver function) then runs on the
meta tensors under `torch.utils.flop_counter.FlopCounterMode`, which counts
the FLOPs of every matmul, convolution and attention op the step executes,
and `hlo_analysis.roofline_terms` turns the global FLOPs and bytes into
seconds on the production mesh's count of H100s.

Where the reference lowers and compiles with XLA and reads its
cost_analysis, memory_analysis and HLO collectives, the port has no
compiler: the step is the eager program on meta tensors, so there is no
memory_analysis, and no collective bytes (`hlo_analysis`). The reference's
`lm_cost_probe` is not needed: XLA's cost analysis counts a while-loop body
once, so the reference recovers the scanned layers' and microbatches' cost
from 1- and 2-layer probes; FlopCounterMode counts every op the step runs,
every layer and microbatch included. The memory term's bytes are the
state's and the inputs' (each read once), a floor on what a step moves.

The step runs as the one-entry program (no ambient mesh): the global
FLOPs, as the reference's cost_analysis reports them. Kernel wrappers
meeting meta tensors take their plain versions (shapes only), and a step's
host read of device values (`device.host_values`) reads zeros.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch gemma2-2b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --arch all
Artifacts: <out>/<mesh>/<arch>__<shape>.json (default artifacts/dryrun_torch).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry as R
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P
from repro_torch.kernels import ref
from repro_torch.launch import hlo_analysis, mesh as mesh_lib
from repro_torch.train import tree
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import make_train_step

MESHES = ("single", "multi")


def _nbytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t)
               if isinstance(x, torch.Tensor))


_PARAMS: dict = {}


def abstract_params(arch: R.ArchSpec, cfg):
    """The arch's meta parameters for `cfg`, traced once a process (a
    trillion-parameter config takes seconds to trace)."""
    key = (arch.name, repr(cfg))
    if key not in _PARAMS:
        _PARAMS[key] = arch.abstract_params(cfg)
    return _PARAMS[key]


def build_step(arch: R.ArchSpec, shape: str, mesh, smoke: bool = False):
    """(step, record): `step()` runs one step of the cell on meta tensors;
    `record` holds the state's and inputs' specs and bytes per entry.
    `smoke`: the arch's SMOKE config and smoke batch (on meta, its leading
    dimension over the data axes) in place of the cell's."""
    if smoke:
        cfg, batch, kind = arch.smoke()
        inputs = tree.map(sharding.meta_like, batch)
        dp = mesh_lib.data_axes(mesh)
        in_specs = tree.map(lambda t: P(dp, *([None] * (t.dim() - 1))) if t.dim() else P(),
                            inputs)
        serve_shape = {"tiering": "solve_dense_m"}.get(arch.family, shape)
    else:
        cfg = arch.config_for(shape)
        kind = arch.cell_for(shape).kind
        inputs, in_specs = arch.abstract_cell(shape, mesh)
        serve_shape = shape
    aparams = abstract_params(arch, cfg)
    pspecs = sharding.add_fsdp(arch.param_specs(cfg), aparams, mesh)
    rec = {"kind": kind,
           "param_bytes_per_entry": sharding.tree_entry_bytes(aparams, pspecs, mesh),
           "input_bytes_per_entry": sharding.tree_entry_bytes(inputs, in_specs, mesh),
           "param_bytes": _nbytes(aparams), "input_bytes": _nbytes(inputs)}
    if kind == "train":
        init_state, train_step = make_train_step(
            arch.loss_fn(cfg), OptimizerConfig(name=arch.optimizer),
            n_micro=1 if smoke else arch.n_micro, grad_accum_dtype=arch.grad_accum_dtype)
        state = init_state(aparams)
        opt_specs = sharding.opt_state_specs(pspecs, aparams, state["opt"])
        rec.update(opt_bytes_per_entry=sharding.tree_entry_bytes(state["opt"], opt_specs, mesh),
                   opt_bytes=_nbytes(state["opt"]))
        rec["param_specs"] = _spec_strings(pspecs)
        rec["opt_specs"] = _spec_strings(opt_specs)

        def step():
            return train_step(state, inputs)
    else:
        serve = arch.serve_fn(cfg, serve_shape)
        call = dict(inputs)
        if "cur_len" in call:         # decode: the cache filled to its length less one
            call["cur_len"] = inputs["cache"]["k"].shape[2] - 1
        rec.update(opt_bytes_per_entry=0, opt_bytes=0)
        rec["param_specs"] = _spec_strings(pspecs)

        def step():
            with torch.no_grad():
                return serve(aparams, call)
    rec["input_specs"] = _spec_strings(in_specs)
    return step, rec


def _spec_strings(specs) -> dict:
    return {path: repr(s) for path, s in tree.leaves_with_paths(specs)}


def count_flops(step) -> float:
    """One step's FLOPs as FlopCounterMode counts them. The plain versions
    work through blocks of about `ref.CHUNK_BYTES` to bound their memory;
    meta tensors hold none, so each runs in one block here (the same ops,
    far fewer of them to dispatch)."""
    prev, ref.CHUNK_BYTES = ref.CHUNK_BYTES, 1 << 62
    try:
        with FlopCounterMode(display=False) as fc:
            step()
    finally:
        ref.CHUNK_BYTES = prev
    return float(fc.get_total_flops())


def run_cell(arch: R.ArchSpec, shape: str, mesh_name: str, out_dir: str | None,
             skip_existing: bool = False) -> dict:
    """One cell's record, written to <out_dir>/<mesh>/<arch>__<shape>.json
    (`out_dir` None: not written). A cell that errors is recorded as
    "error" and the sweep goes on."""
    path = None
    if out_dir is not None:
        os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
        path = os.path.join(out_dir, mesh_name, f"{arch.name}__{shape}.json")
        if skip_existing and os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    record = {"arch": arch.name, "shape": shape, "mesh": mesh_name, "status": "ok"}
    if shape in arch.skips:
        record.update(status="skipped", reason=arch.skips[shape])
        print(f"[dryrun] SKIP {arch.name} x {shape} ({mesh_name}): "
              f"{arch.skips[shape][:60]}...")
    else:
        mesh = mesh_lib.make_production_mesh(multi_pod=(mesh_name == "multi"))
        t0 = time.time()
        try:
            step, rec = build_step(arch, shape, mesh)
            t_build = time.time() - t0
            flops = count_flops(step)
            hbm = rec["param_bytes"] + rec["opt_bytes"] + rec["input_bytes"]
            terms = hlo_analysis.roofline_terms(flops, hbm, None, mesh.size)
            record.update(rec, n_chips=mesh.size, mesh_shape=mesh.shape,
                          build_s=round(t_build, 2),
                          step_s=round(time.time() - t0 - t_build, 2),
                          flops=flops, hbm_bytes=hbm, collectives="not measured: "
                          "the port compiles no HLO (hlo_analysis)",
                          roofline=terms, dominant=hlo_analysis.dominant(terms))
            print(f"[dryrun] OK   {arch.name} x {shape} ({mesh_name}) "
                  f"GFLOPs={flops / 1e9:.1f} per entry: params "
                  f"{rec['param_bytes_per_entry'] / 2 ** 30:.3f} GiB, opt "
                  f"{rec['opt_bytes_per_entry'] / 2 ** 30:.3f} GiB, inputs "
                  f"{rec['input_bytes_per_entry'] / 2 ** 30:.3f} GiB; "
                  f"{record['dominant']}")
        except Exception as e:  # noqa: BLE001 — record and continue the sweep
            record.update(status="error", error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-2000:])
            print(f"[dryrun] FAIL {arch.name} x {shape} ({mesh_name}): "
                  f"{record['error'][:200]}")
    if path is not None:
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = R.all_archs()
    names = list(archs) if args.arch == "all" else args.arch.split(",")
    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    results = []
    for mesh_name in meshes:
        for name in names:
            arch = archs[name]
            shapes = arch.shapes if args.shape == "all" else args.shape.split(",")
            for shape in shapes:
                results.append(run_cell(arch, shape, mesh_name, args.out,
                                        args.skip_existing))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"/ {len(results)} cells")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
