"""The trainer, the counterpart of `repro.train.trainer`: gradient
accumulation, the compression hook and a fault-tolerant loop.

`make_train_step(loss_fn, opt_cfg, ...)` builds train_step(state, batch) ->
(state, metrics) where state = {params, opt, ef, step}: plain eager
PyTorch on the device of the parameters (a batch's leaves are moved
there). The state is donated, as the reference's driver donates it to its
jitted step: the parameters are updated in place and the returned state
holds them, the new optimizer state and the next step. With n_micro > 1 the
batch's leaves are [n_micro, ...]; the microbatches' gradients are summed
in `grad_accum_dtype` and divided by n_micro, one microbatch's activations
live at a time.

`TrainingDriver` is the host-side loop: auto-resume from the newest
committed checkpoint, failure injection for tests and a deadline on the
data iterator (a late batch is dropped).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.distributed import compression as comp
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import tree
from repro_torch.train.optimizer import OptimizerConfig, make_optimizer


def _to_device(batch, device: torch.device):
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.as_tensor(np.asarray(x), device=device)
    return tree.map(leaf, batch)


def make_train_step(
    loss_fn: Callable,                   # (params, batch) -> (loss, metrics)
    opt_cfg: OptimizerConfig,
    *,
    n_micro: int = 1,
    compression: comp.CompressionConfig = comp.CompressionConfig(),
    grad_accum_dtype: str = "float32",
):
    opt = make_optimizer(opt_cfg)

    def init_state(params):
        device = tree.leaves(params)[0].device
        return {
            "params": params,
            "opt": opt.init(params),
            "ef": comp.init_error_state(compression, params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def grad_fn(params, leaves, batch):
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state, batch):
        params = state["params"]
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = _to_device(batch, leaves[0].device)

        if n_micro == 1:
            loss, metrics, grads = grad_fn(params, leaves, batch)
        else:
            acc_dt = getattr(torch, grad_accum_dtype)
            acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(n_micro):
                mb_loss, metrics, g = grad_fn(params, leaves,
                                              tree.map(lambda x: x[i], batch))
                for a, gi in zip(acc, g):
                    a.add_(gi.to(acc_dt))
                del g
                loss = loss + mb_loss
            grads = [a / n_micro for a in acc]
            del acc
            loss = loss / n_micro
        grads = tree.unflatten_like(params, list(grads))

        grads, ef = comp.compress_grads(compression, grads, state["ef"])
        updates, opt_state, opt_metrics = opt.update(
            grads, state["opt"], params, state["step"])
        del grads
        with torch.no_grad():
            for p, u in zip(leaves, tree.leaves(updates)):
                p.add_(u)
        new_state = {"params": params, "opt": opt_state, "ef": ef,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return init_state, train_step


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    max_steps: int = 200
    fail_at_step: int = -1          # failure injection (tests)
    batch_deadline_s: float | None = None   # straggler policy


class StragglerStats:
    def __init__(self):
        self.skipped = 0
        self.fetch_times: list[float] = []


class TrainingDriver:
    """Fault-tolerant host loop around train_step."""

    def __init__(self, init_state, train_step, cfg: DriverConfig):
        self.init_state = init_state
        self.train_step = train_step
        self.cfg = cfg
        self.straggler = StragglerStats()

    def run(self, params_init: Callable[[], Any],
            batches: Iterator[Any]) -> tuple[dict, list[dict]]:
        cfg = self.cfg
        os.makedirs(cfg.ckpt_dir, exist_ok=True)
        state = self.init_state(params_init())
        if ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
            _, state, _ = ckpt_lib.restore(cfg.ckpt_dir, state)

        history: list[dict] = []
        while int(state["step"]) < cfg.max_steps:
            t0 = time.perf_counter()
            batch = next(batches)
            fetch = time.perf_counter() - t0
            self.straggler.fetch_times.append(fetch)
            if (cfg.batch_deadline_s is not None
                    and fetch > cfg.batch_deadline_s):
                # straggler mitigation: drop the late batch, take the next
                self.straggler.skipped += 1
                continue
            state, metrics = self.train_step(state, batch)
            step = int(state["step"])
            history.append({k: float(v) for k, v in metrics.items()})
            if step % cfg.ckpt_every == 0 or step == cfg.max_steps:
                ckpt_lib.save(cfg.ckpt_dir, step, state, keep_last=cfg.keep_last)
            if cfg.fail_at_step == step:
                raise RuntimeError(f"injected failure at step {step}")
        return state, history
