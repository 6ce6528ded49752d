"""The port's sharding specs and meta-device dry run: `sharding.add_fsdp`
and `opt_state_specs` spec by spec against the reference's for every arch
at its full config on the production meshes (the reference's functions
read only `mesh.axis_names` and `mesh.shape`, so a stand-in serves for 256
or 512 devices), each entry's bytes under a spec, `launch.mesh`,
`hlo_analysis.roofline_terms`, `shard_hint`'s identity, and the dry run on
every arch's SMOKE config and on gemma2-2b's train_4k at full size, on
meta tensors."""
import functools
import json
import math
import types

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as R
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh_context import Mesh, shard_hint, use_mesh
from repro_torch.distributed.sharding import P
from repro_torch.launch import dryrun, hlo_analysis, mesh as tmesh
from repro_torch.train import tree
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer

ARCHS = sorted(R.all_archs())
META = torch.device("meta")


def stand_in(multi: bool):
    if multi:
        return types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                     shape={"pod": 2, "data": 16, "model": 16})
    return types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 16, "model": 16})


def norm(spec) -> tuple:
    """A spec (the port's P or JAX's PartitionSpec) as a tuple of entries,
    a one-name tuple as its name, trailing Nones dropped."""
    parts = []
    for p in spec:
        if isinstance(p, (tuple, list)):
            p = None if len(p) == 0 else (p[0] if len(p) == 1 else tuple(p))
        parts.append(p)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def jax_paths(t, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)

    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return {"/".join(key(k) for k in path): leaf for path, leaf in flat}


@functools.cache
def reference_state(name: str):
    """(param specs, abstract params, abstract optimizer state) of the
    reference's arch at its full config (shape-only: jax.eval_shape)."""
    from repro.configs import registry as JR
    from repro.train import optimizer as jopt
    arch = JR.get_arch(name)
    cfg = arch.config_for(arch.shapes[0])
    aparams = arch.abstract_params(cfg)
    opt = jax.eval_shape(jopt.make_optimizer(jopt.OptimizerConfig(name=arch.optimizer)).init,
                         aparams)
    return arch.param_specs(cfg), aparams, opt


@functools.cache
def port_state(name: str):
    arch = R.get_arch(name)
    cfg = arch.config_for(arch.shapes[0])
    aparams = arch.abstract_params(cfg)
    opt = make_optimizer(OptimizerConfig(name=arch.optimizer)).init(aparams)
    return arch.param_specs(cfg), aparams, opt


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ARCHS)
def test_fsdp_and_opt_specs_equal_the_reference(name, multi):
    from jax.sharding import PartitionSpec as JP
    from repro.distributed import sharding as jsh
    jspecs, jparams, jopt = reference_state(name)
    tspecs, tparams, topt = port_state(name)
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    want = jsh.add_fsdp(jspecs, jparams, stand_in(multi))
    got = sharding.add_fsdp(tspecs, tparams, mesh)
    is_p = lambda x: isinstance(x, JP)                                  # noqa: E731
    want_p, got_p = jax_paths(want, is_p), dict(tree.leaves_with_paths(got))
    assert set(want_p) == set(got_p)
    shapes = {p: tuple(a.shape) for p, a in jax_paths(jparams).items()}
    for p, spec in want_p.items():
        assert norm(got_p[p]) == norm(spec), p
        assert tuple(dict(tree.leaves_with_paths(tparams))[p].shape) == shapes[p], p
    want_o = jax_paths(jsh.opt_state_specs(want, jparams, jopt), is_p)
    got_o = dict(tree.leaves_with_paths(sharding.opt_state_specs(got, tparams, topt)))
    assert set(want_o) == set(got_o)
    for p, spec in want_o.items():
        assert norm(got_o[p]) == norm(spec), p


DTYPES = {"uint32": torch.int32, "int32": torch.int32, "float32": torch.float32,
          "bfloat16": torch.bfloat16, "bool": torch.bool}


@pytest.mark.parametrize("name", ARCHS)
def test_cells_inputs_and_specs_equal_the_reference(name):
    """Every shape's abstract inputs (shapes, dtypes) and input specs on
    both production meshes == the reference's `cell_for(shape, mesh)`."""
    from jax.sharding import PartitionSpec as JP
    from repro.configs import registry as JR
    jarch, arch = JR.get_arch(name), R.get_arch(name)
    assert jarch.shapes == arch.shapes and jarch.skips == arch.skips
    for multi in (False, True):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        for shape in arch.shapes:
            want = jarch.cell_for(shape, stand_in(multi))
            inputs, specs = arch.abstract_cell(shape, mesh)
            assert arch.cell_for(shape).kind == want.kind
            got_in, want_in = dict(tree.leaves_with_paths(inputs)), jax_paths(want.inputs)
            assert set(got_in) == set(want_in), (shape, set(got_in) ^ set(want_in))
            for p, sds in want_in.items():
                assert tuple(got_in[p].shape) == tuple(sds.shape), (shape, p)
                assert got_in[p].dtype == DTYPES[str(sds.dtype)], (shape, p)
            got_s = dict(tree.leaves_with_paths(specs))
            for p, spec in jax_paths(want.input_specs, lambda x: isinstance(x, JP)).items():
                assert norm(got_s[p]) == norm(spec), (shape, p)


def test_spec_type_and_block_arithmetic():
    assert P("a", None) == P("a") and P(("a",), None) == P("a") and P() == P(None)
    assert P(("pod", "data"), "model") != P("data", "model") and len(P(None, "m")) == 2
    mesh = tmesh.make_production_mesh(multi_pod=True)
    assert sharding.entry_shape((1000, 64), P(("pod", "data"), "model"), mesh) == (32, 4)
    # ceil blocks: 1000 rows over 32 data ranks; the last holds 1000 - 31 * 32 = 8
    last = mesh.size - 1
    assert sharding.entry_shape((1000, 64), P(("pod", "data"), "model"), mesh, last) == (8, 4)
    t = torch.empty((256000, 2304), device=META)
    assert sharding.entry_bytes(t, P("data", "model"), tmesh.make_production_mesh()) \
        == 16000 * 144 * 4
    assert sharding.entry_bytes(t, P(), mesh) == 256000 * 2304 * 4
    one = Mesh(("data", "model"), (META,), (1, 1))
    specs = {"w": P(None, "model"), "b": P(None)}
    leaves = {"w": torch.empty((8, 4), dtype=torch.bfloat16, device=META),
              "b": torch.empty(4, device=META)}
    assert sharding.tree_entry_bytes(leaves, specs, one) == 8 * 4 * 2 + 16
    named = sharding.state_shardings(one, specs, {"params": leaves, "opt": {"m": leaves},
                                                  "ef": {}, "step": None})
    assert named["params"]["w"] == (one, P(None, "model")) and named["step"] == (one, P())


def test_gemma2_entry_bytes_on_the_production_mesh():
    """gemma2-2b's parameters per entry under FSDP on 16 x 16: the tied
    embedding and every matrix split over data and model."""
    specs, params, opt = port_state("gemma2-2b")
    mesh = tmesh.make_production_mesh()
    fs = sharding.add_fsdp(specs, params, mesh)
    total = sum(x.numel() * 4 for x in tree.leaves(params))
    per = sharding.tree_entry_bytes(params, fs, mesh)
    assert total / 256 <= per < total / 256 * 1.02     # norm scales stay whole
    assert sharding.tree_entry_bytes(params, specs, mesh) > per * 10    # TP only: / 16


def test_launch_mesh():
    from repro.launch import mesh as jmesh
    single, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert all(d.type == "meta" for d in multi.devices)
    assert tmesh.data_axes(multi) == jmesh.data_axes(stand_in(True)) == ("pod", "data")
    assert norm(tmesh.batch_spec(multi)) == norm(jmesh.batch_spec(stand_in(True)))
    host = tmesh.make_host_mesh(2, "cpu", 4)
    assert host.shape == {"data": 2, "model": 2} and host.devices == (torch.device("cpu"),) * 4
    assert tmesh.make_host_mesh(8, "cpu", 4).shape == {"data": 1, "model": 4}
    with pytest.raises(ValueError):
        tmesh.make_host_mesh(3, "cpu", 4)


def test_entry_points_take_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no visible cuda device"):
        tmesh.make_host_mesh(2)
    assert tmesh.make_host_mesh(1, "cpu").size == 1


def test_roofline_terms_use_the_h100_constants():
    terms = hlo_analysis.roofline_terms(989e12 * 4, 3.35e12 * 2, None, 4)
    assert terms == {"compute_s": 1.0, "memory_s": 0.5, "collective_s": None}
    assert hlo_analysis.dominant(terms) == "compute_s"
    terms = hlo_analysis.roofline_terms(0.0, 3.35e12, 450e9 * 8, 1)
    assert math.isclose(terms["collective_s"], 8.0)
    assert hlo_analysis.dominant(terms) == "collective_s"


def test_shard_hint_is_the_identity_and_forward_equals_direct():
    from repro_torch.configs import gemma2_2b
    from repro_torch.models import transformer as T
    x = torch.randn(2, 3)
    assert shard_hint(x, ("data",), None) is x
    cfg = gemma2_2b.SMOKE
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    want, _ = T.forward(params, toks, cfg)
    with use_mesh(Mesh("data", (torch.device("cpu"),) * 2)):
        got, _ = T.forward(params, toks, cfg)
    assert torch.equal(got, want)


# -- the dry run -------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_dry_run_on_the_smoke_config(name):
    """One step of the arch's SMOKE config and smoke batch on meta."""
    arch = R.get_arch(name)
    step, rec = dryrun.build_step(arch, arch.shapes[0], tmesh.make_production_mesh(),
                                  smoke=True)
    flops = dryrun.count_flops(step)
    assert rec["kind"] == arch.smoke()[2] and rec["input_bytes"] > 0
    if arch.family != "tiering":
        assert flops > 0 and rec["param_bytes"] > 0


def test_dry_run_gemma2_train_4k_at_full_size(tmp_path):
    from repro_torch.configs import gemma2_2b
    cfg = gemma2_2b.CONFIG
    arch = R.get_arch("gemma2-2b")
    rec = dryrun.run_cell(arch, "train_4k", "multi", str(tmp_path))
    assert rec["status"] == "ok", rec.get("traceback")
    assert json.loads((tmp_path / "multi" / "gemma2-2b__train_4k.json").read_text()) == rec
    n = cfg.param_count()
    assert rec["param_bytes"] == 4 * n and rec["opt_bytes"] == 2 * 2 * n   # f32; bf16 m, v
    # FLOPs: 6 N T and remat's second forward (2 N T) at least, under the
    # plain attention's full S x S scores on top
    tokens = 256 * 4096
    assert 8 * n * tokens < rec["flops"] < 16 * n * tokens
    assert rec["input_bytes_per_entry"] == 2 * (256 // 32) * 4096 * 4
    assert rec["dominant"] == "compute_s" and rec["n_chips"] == 512


def test_dry_run_cli_records_and_skips(tmp_path, capsys):
    for arch, shape in (("tiering-scsk", "solve_sparse_xl"), ("internlm2-1.8b", "long_500k")):
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                     "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "1 ok, 0 skipped, 0 errors / 1 cells" in out
    assert "0 ok, 1 skipped, 0 errors / 1 cells" in out
    rec = json.loads((tmp_path / "single" / "internlm2-1.8b__long_500k.json").read_text())
    assert rec["status"] == "skipped"
    rec = json.loads((tmp_path / "single" / "tiering-scsk__solve_sparse_xl.json").read_text())
    assert rec["status"] == "ok" and rec["input_bytes_per_entry"] < rec["input_bytes"]
    # the ids [2^20, 4096] int32 are split over the 16 data ranks
    assert rec["input_bytes"] - rec["input_bytes_per_entry"] >= 15 * 2 ** 20 * 4096 * 4 // 16
    dryrun.main(["--arch", "tiering-scsk", "--shape", "solve_sparse_xl", "--mesh", "single",
                 "--out", str(tmp_path), "--skip-existing"])
    assert "1 ok" in capsys.readouterr().out


def test_dry_run_cell_error_exits_1(tmp_path, monkeypatch):
    arch = R.get_arch("tiering-scsk")
    monkeypatch.setitem(R.ARCHS, "tiering-scsk", type(arch)(**{
        **arch.__dict__, "abstract_cell": lambda shape, mesh: 1 / 0}))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "tiering-scsk", "--shape", "solve_dense_m", "--mesh",
                     "single", "--out", str(tmp_path)])
    assert e.value.code == 1


def test_kernel_wrappers_on_meta_propagate_shapes():
    """The wrappers take a shape-only path for meta tensors."""
    from repro_torch.kernels import ops, segment_sum as S
    a = torch.empty((64, 8), dtype=torch.int32, device=META)
    x = torch.empty((256, 2), device=META)
    assert ops.bit_matvec(a, x).shape == (64, 2)
    assert ops.coverage_gain(a, torch.empty(8, dtype=torch.int32, device=META)).shape == (64,)
    q = torch.empty((2, 8, 4, 16), device=META)
    k = torch.empty((2, 8, 2, 16), device=META)
    assert ops.flash_attention(q, k, k).shape == q.shape
    rows = torch.empty((10, 3), device=META)
    perm = torch.empty(10, dtype=torch.int32, device=META)
    off = torch.empty(6, dtype=torch.int32, device=META)
    assert S.segment_sum(rows, perm, off).shape == (5, 3)
    np.testing.assert_array_equal(
        S.segment_sum(torch.ones(4, 2), torch.arange(4, dtype=torch.int32),
                      torch.tensor([0, 1, 4], dtype=torch.int32)).numpy(),
        [[1, 1], [3, 3]])
