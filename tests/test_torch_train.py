"""The port's trainer, optimizers, checkpoint/restart and gradient
compression, mirroring tests/test_trainer.py's cases on the same numpy
data, then one update of each optimizer from a reference train state
carried over by `convert.train_state_from_numpy`, against the reference's
own step: allclose at rtol 1e-6, not bit for bit, since the schedule's
cosine and the bias corrections' powers are f32 ops that torch and XLA may
round an ulp apart. Last, the launcher: killed after a checkpoint, then
relaunched, it resumes and prints the reference's loss line."""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro.train import optimizer as joptim
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.distributed.compression import CompressionConfig, compress_grads, \
    init_error_state
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
from repro_torch.train.trainer import DriverConfig, TrainingDriver, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _quadratic_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _np_batch(rng, n=64, d=8):
    x = rng.standard_normal((n, d)).astype(np.float32)
    w_true = np.arange(d, dtype=np.float32)
    y = x @ w_true + 0.1
    return {"x": x, "y": y}


def _make_batch(rng, n=64, d=8):
    return {k: torch.from_numpy(v) for k, v in _np_batch(rng, n, d).items()}


def _params(d=8):
    return {"w": torch.zeros(d), "b": torch.zeros(())}


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_optimizers_reduce_loss(opt_name):
    rng = np.random.default_rng(0)
    batch = _make_batch(rng)
    lr = 0.2 if opt_name == "sgd" else 0.1
    init_state, train_step = make_train_step(
        _quadratic_loss,
        OptimizerConfig(name=opt_name, lr=lr, warmup_steps=1, weight_decay=0.0,
                        grad_clip=0.0 if opt_name == "sgd" else 1.0))
    state = init_state(_params())
    first = None
    for _ in range(100):
        state, m = train_step(state, batch)
        first = first or float(m["loss"])
    assert float(m["loss"]) < 0.2 * first


def test_grad_accumulation_matches_full_batch():
    rng = np.random.default_rng(1)
    batch = _make_batch(rng, n=64)
    micro = {k: v.reshape(4, 16, *v.shape[1:]) for k, v in batch.items()}
    opt = OptimizerConfig(name="sgd", lr=0.1, warmup_steps=1, grad_clip=0.0)
    i1, s1 = make_train_step(_quadratic_loss, opt)
    i4, s4 = make_train_step(_quadratic_loss, opt, n_micro=4)
    st1, _ = s1(i1(_params()), batch)
    st4, _ = s4(i4(_params()), micro)
    np.testing.assert_allclose(st1["params"]["w"].detach().numpy(),
                               st4["params"]["w"].detach().numpy(), rtol=1e-5)


def test_adamw_bf16_states():
    init_state, _ = make_train_step(
        _quadratic_loss, OptimizerConfig(name="adamw", state_dtype="bfloat16"))
    state = init_state(_params())
    assert state["opt"]["m"]["w"].dtype == torch.bfloat16
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


def test_adafactor_factored_shapes():
    opt = make_optimizer(OptimizerConfig(name="adafactor", min_dim_factored=4))
    params = {"w": torch.zeros((8, 16)), "b": torch.zeros(16)}
    st = opt.init(params)
    assert st["fac"]["w"]["vr"].shape == (8,)
    assert st["fac"]["w"]["vc"].shape == (16,)
    assert st["fac"]["b"]["v"].shape == (16,)


# -----------------------------------------------------------------------------
# checkpointing / fault tolerance
# -----------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """Every leaf back bit for bit in its dtype (a bf16 leaf through its
    uint16 bits); keys, arrays and crcs of the f32 and int leaves are the
    reference's."""
    state = {"params": _params(), "step": torch.tensor(7, dtype=torch.int32),
             "nested": {"a": torch.arange(5, dtype=torch.int32)},
             "m": torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)}
    ckpt.save(str(tmp_path / "port"), 7, state, extra={"note": "hi"})
    step, restored, extra = ckpt.restore(str(tmp_path / "port"), state)
    assert step == 7 and extra["note"] == "hi"
    for (p, a), b in zip(tree.leaves_with_paths(state), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    # the reference's layout for the leaves numpy holds
    from repro.train import checkpoint as jckpt
    jstate = {"params": {"w": jnp.zeros(8), "b": jnp.zeros(())}, "step": jnp.int32(7),
              "nested": {"a": jnp.arange(5)}}
    jpath = jckpt.save(str(tmp_path / "ref"), 7, jstate)
    import json
    with open(os.path.join(jpath, "manifest.json")) as f:
        jcrc = json.load(f)["crc"]
    with open(os.path.join(tmp_path / "port", "step_00000007", "manifest.json")) as f:
        man = json.load(f)
    assert {k: man["crc"][k] for k in jcrc} == jcrc
    assert man["dtypes"] == {"m": "bfloat16"}


def test_checkpoint_detects_corruption(tmp_path):
    state = {"w": torch.arange(10, dtype=torch.float32)}
    path = ckpt.save(str(tmp_path), 1, state)
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["w"] = data["w"] + 1
    np.savez(npz, **data)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path), state)


def test_checkpoint_gc_keeps_last(tmp_path):
    state = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, state, keep_last=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert len(sorted(os.listdir(tmp_path))) == 2


def test_checkpoint_async_save(tmp_path):
    """`async_` writes in a thread from a host copy made before it returns:
    an in-place update right after the call does not reach the file."""
    state = {"w": torch.arange(6, dtype=torch.float32)}
    ckpt.save(str(tmp_path), 2, state, async_=True)
    state["w"].add_(100)
    for _ in range(200):
        if ckpt.latest_step(str(tmp_path)) == 2:
            break
        time.sleep(0.01)
    _, restored, _ = ckpt.restore(str(tmp_path), state)
    assert torch.equal(restored["w"], torch.arange(6, dtype=torch.float32))


def test_driver_restart_after_injected_failure(tmp_path):
    """Train 30 steps with a crash at step 20: the relaunched driver resumes
    from the last checkpoint and finishes; loss history is contiguous."""
    rng = np.random.default_rng(2)
    batch = _make_batch(rng)

    def batches():
        while True:
            yield batch

    init_state, train_step = make_train_step(
        _quadratic_loss, OptimizerConfig(name="sgd", lr=0.05, warmup_steps=1))
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=10, max_steps=30,
                       fail_at_step=20)
    driver = TrainingDriver(init_state, train_step, cfg)
    with pytest.raises(RuntimeError, match="injected failure"):
        driver.run(_params, batches())
    assert ckpt.latest_step(str(tmp_path)) == 20

    cfg2 = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=10, max_steps=30)
    driver2 = TrainingDriver(init_state, train_step, cfg2)
    state, history = driver2.run(_params, batches())
    assert int(state["step"]) == 30
    assert len(history) == 10          # resumed at 20, ran 10 more
    # the uninterrupted run ends in the same state, bit for bit
    whole, hist_w = TrainingDriver(init_state, train_step, DriverConfig(
        ckpt_dir=str(tmp_path / "whole"), ckpt_every=100, max_steps=30)).run(
        _params, batches())
    assert [h["loss"] for h in history] == [h["loss"] for h in hist_w[20:]]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(state), tree.leaves(whole)))


def test_elastic_replacement_roundtrip(tmp_path):
    """Saved from one layout, restored onto another: the leaves come back
    on the template's device, in its dtype and contiguous, with the saved
    values (a transposed view saved, a contiguous template restored)."""
    w = torch.arange(16.0).reshape(4, 4)
    ckpt.save(str(tmp_path), 3, {"w": w.T})
    _, restored, _ = ckpt.restore(str(tmp_path), {"w": torch.zeros(4, 4)})
    assert restored["w"].is_contiguous()
    np.testing.assert_array_equal(restored["w"].numpy(), w.T.numpy())
    _, meta, _ = ckpt.restore(str(tmp_path), {"w": torch.empty(4, 4, device="meta",
                                                               dtype=torch.float64)})
    assert meta["w"].device.type == "meta" and meta["w"].dtype == torch.float64


def test_restore_refuses_a_template_that_does_not_match(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(3)})
    with pytest.raises(KeyError, match="does not match"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(3), "v": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"w": torch.zeros(3)})


def test_straggler_policy_skips_slow_batches(tmp_path):
    import itertools
    rng = np.random.default_rng(3)
    batch = _make_batch(rng)

    def batches():
        for i in itertools.count():
            if i == 2:
                time.sleep(0.05)       # one straggler
            yield batch

    init_state, train_step = make_train_step(
        _quadratic_loss, OptimizerConfig(name="sgd", lr=0.01))
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=100, max_steps=5,
                       batch_deadline_s=0.02)
    driver = TrainingDriver(init_state, train_step, cfg)
    state, history = driver.run(_params, batches())
    assert driver.straggler.skipped >= 1
    assert int(state["step"]) == 5


# -----------------------------------------------------------------------------
# gradient compression
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressed_training_converges(kind):
    rng = np.random.default_rng(4)
    batch = _make_batch(rng)
    init_state, train_step = make_train_step(
        _quadratic_loss,
        OptimizerConfig(name="sgd", lr=0.05, warmup_steps=1),
        compression=CompressionConfig(kind=kind, topk_frac=0.5))
    state = init_state(_params())
    first = None
    for _ in range(200):
        state, m = train_step(state, batch)
        first = first or float(m["loss"])
    assert float(m["loss"]) < 0.6 * first


def test_error_feedback_accumulates():
    cfg = CompressionConfig(kind="topk", topk_frac=0.34)
    grads = {"w": torch.tensor([1.0, 0.5, 0.01])}
    ef = init_error_state(cfg, grads)
    comp, ef = compress_grads(cfg, grads, ef)
    assert float(comp["w"][0]) == 1.0
    assert float(comp["w"][2]) == 0.0           # dropped...
    assert float(ef["ef"]["w"][2]) == pytest.approx(0.01)  # ...but remembered
    comp2, ef = compress_grads(cfg, {"w": torch.zeros(3)}, ef)
    assert float(ef["ef"]["w"][2]) > 0 or float(comp2["w"][2]) > 0


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_matches_reference(kind):
    """Compressed gradients and residuals equal the reference's over three
    rounds of error feedback (round half to even, the k-th largest kept)."""
    cfg_t = CompressionConfig(kind=kind, topk_frac=0.25)
    cfg_j = jcomp.CompressionConfig(kind=kind, topk_frac=0.25)
    rng = np.random.default_rng(9)
    g = [{"w": rng.standard_normal((6, 5)).astype(np.float32)} for _ in range(3)]
    ef_t = init_error_state(cfg_t, {"w": torch.zeros(6, 5)})
    ef_j = jcomp.init_error_state(cfg_j, {"w": jnp.zeros((6, 5))})
    for gi in g:
        ct, ef_t = compress_grads(cfg_t, {"w": torch.from_numpy(gi["w"])}, ef_t)
        cj, ef_j = jcomp.compress_grads(cfg_j, {"w": jnp.asarray(gi["w"])}, ef_j)
        np.testing.assert_allclose(ct["w"].numpy(), np.asarray(cj["w"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ef_t["ef"]["w"].numpy(), np.asarray(ef_j["ef"]["w"]),
                                   rtol=1e-6, atol=1e-7)


# -----------------------------------------------------------------------------
# one update from a converted reference state
# -----------------------------------------------------------------------------

def _wide_loss_t(params, batch):
    pred = (batch["x"] @ params["m"]) @ params["w"] + params["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


def _wide_loss_j(params, batch):
    pred = (batch["x"] @ params["m"]) @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"mse": loss}


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor", "sgd"])
def test_update_from_converted_reference_state(opt_name):
    """Two reference steps, then the state carried over: one more step in
    each package from identical states gives the same parameters, optimizer
    state and metrics at rtol 1e-6 (AdamW's bf16 m and v equal, Adafactor
    factored at a 6 x 8 matrix). Each leaf also gets an atol of 1e-6 x its
    largest value: the gradients themselves are f32 sums that XLA and torch
    take in different orders, and a parameter near 0 moves by an update of
    the leaf's scale."""
    rng = np.random.default_rng(12)
    raw = _np_batch(rng, n=32, d=6)
    opt = dict(name=opt_name, lr=0.05, warmup_steps=3, decay_steps=10,
               min_dim_factored=4)
    init_j, step_j = jtrainer.make_train_step(_wide_loss_j, joptim.OptimizerConfig(**opt))
    params = {"m": jnp.asarray(rng.standard_normal((6, 8)).astype(np.float32) / 3),
              "w": jnp.asarray(rng.standard_normal(8).astype(np.float32)),
              "b": jnp.zeros(())}
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    state = init_j(params)
    step = jax.jit(step_j)
    for _ in range(2):
        state, _ = step(state, jb)
    ported = convert.train_state_from_numpy(jax.tree.map(np.asarray, state), device="cpu")
    want, want_m = step(state, jb)
    _, step_t = make_train_step(_wide_loss_t, OptimizerConfig(**opt))
    got, got_m = step_t(ported, {k: torch.from_numpy(v) for k, v in raw.items()})
    want_flat = dict(tree.leaves_with_paths(jax.tree.map(np.asarray, want)))
    got_flat = dict(tree.leaves_with_paths(got))
    assert got_flat.keys() == want_flat.keys()
    for path, w in want_flat.items():
        g = got_flat[path].detach()
        if g.dtype == torch.bfloat16:
            w = w.astype(np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()), err_msg=path)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-6, err_msg=k)


# -----------------------------------------------------------------------------
# the launcher
# -----------------------------------------------------------------------------

def _launch(tmp_path, *extra, steps):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "internlm2-1.8b",
            "--steps", str(steps), "--device", "cpu", "--ckpt-dir", str(tmp_path),
            *extra], env


def test_launcher_resumes_after_a_kill(tmp_path):
    """The launcher killed (SIGKILL) once a checkpoint is committed, then
    relaunched with --steps 6: it resumes from that checkpoint, runs the
    remaining steps and prints the reference's loss line."""
    ckpt_dir = tmp_path / "internlm2-1.8b"
    cmd, env = _launch(tmp_path, "--ckpt-every", "2", "--seq", "256", steps=1000)
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while ckpt.latest_step(str(ckpt_dir)) is None:
            assert proc.poll() is None and time.time() < deadline, proc.communicate()
            time.sleep(0.005)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == -signal.SIGKILL
    done = ckpt.latest_step(str(ckpt_dir))
    assert done is not None and done < 6, done
    cmd, env = _launch(tmp_path, "--ckpt-every", "2", steps=6)
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith(f"[train] internlm2-1.8b: {6 - done} steps this run, loss ")
    a, b = (float(x) for x in line.split("loss ")[1].split(" -> "))
    assert np.isfinite(a) and np.isfinite(b)
    assert ckpt.latest_step(str(ckpt_dir)) == 6


@pytest.mark.parametrize("arch", ["deepfm", "egnn"])
def test_launcher_refuses_the_families_not_ported(arch, monkeypatch):
    """The reference's recsys and EGNN archs train there; the port's
    launcher trains the recsys ones (registered in the port's registry) and
    refuses EGNN, naming the ROADMAP item that ports it."""
    from repro.configs import registry as jregistry
    from repro_torch.configs import registry as tregistry
    from repro_torch.launch import train as launch
    assert set(launch.UNPORTED) == {n for n, a in jregistry.all_archs().items()
                                    if a.family == "gnn"}
    if jregistry.get_arch(arch).family == "recsys":
        assert arch not in launch.UNPORTED
        assert tregistry.get_arch(arch).family == "recsys"
        return
    assert jregistry.get_arch(arch).family == launch.UNPORTED[arch]
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 9c"):
        launch.main()
