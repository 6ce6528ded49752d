"""Optimizers, the counterparts of `repro.train.optimizer`: AdamW with m and
v in a configurable dtype (bf16 by default), Adafactor (factored second
moment, momentum-free, the RMS update clip) and SGD, each with the
reference's global-norm clip folded into the per-leaf update as a scalar
and its warm-up + cosine schedule.

Trees are nested dicts of tensors (`train.tree`); the step is a 0-d int32
tensor and every scalar (lr, the bias corrections, Adafactor's beta2) an
f32 0-d tensor on its device, computed with the reference's operations in
its order. `torch.pow` and `torch.cos` may differ from XLA's by an ulp, so
an update agrees with the reference's to rounding, not bit for bit.

`scan_update_axis0` is the reference's `lax.scan` over axis 0 of big
stacked leaves, here a loop over axis-0 slices into preallocated outputs:
the same numbers (Adafactor's RMS clip is per slice there too) with one
slice of f32 temporaries live at a time.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch

from repro_torch.train import tree


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    state_dtype: str = "bfloat16"    # adamw m/v dtype
    min_dim_factored: int = 128      # adafactor: factor only matrices >= this
    scan_update_axis0: bool = False
    scan_update_min_bytes: int = 1 << 28


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to 0.1 x lr (f32)."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.decay_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _global_norm(grads) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tree.leaves(grads))
    return torch.sqrt(sq)


def clip_scale(grads, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(the global-norm clip as a scalar, the norm): folded into each leaf's
    update, so no scaled copy of the gradient tree is made."""
    norm = _global_norm(grads)
    if max_norm <= 0:
        return torch.ones((), dtype=torch.float32, device=norm.device), norm
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _maybe_scan_axis0(cfg: OptimizerConfig, fn, args: tuple):
    """`fn(*args)`, or for a big stacked leaf (when `scan_update_axis0`)
    `fn` on each axis-0 slice, written into outputs made from the first."""
    lead = args[0]
    big = lead.numel() * lead.element_size() >= cfg.scan_update_min_bytes
    same_lead = all(a.dim() >= 1 and a.shape[:1] == lead.shape[:1] for a in args)
    if not (cfg.scan_update_axis0 and big and lead.dim() >= 3 and same_lead
            and lead.shape[0] > 1):
        return fn(*args)
    outs = None
    for i in range(lead.shape[0]):
        got = fn(*(a[i] for a in args))
        if outs is None:
            outs = tuple(torch.empty((lead.shape[0],) + o.shape, dtype=o.dtype,
                                     device=o.device) for o in got)
        for o, x in zip(outs, got):
            o[i] = x
    return outs


# -----------------------------------------------------------------------------
# AdamW
# -----------------------------------------------------------------------------

def adamw_init(cfg: OptimizerConfig, params):
    dt = getattr(torch, cfg.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree.map(zeros, params), "v": tree.map(zeros, params)}


def adamw_update(cfg: OptimizerConfig, grads, state, params, step: torch.Tensor):
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    lr = schedule(cfg, step)
    c1 = 1.0 - cfg.b1 ** (step.float() + 1)
    c2 = 1.0 - cfg.b2 ** (step.float() + 1)
    dt = getattr(torch, cfg.state_dtype)

    def upd_elem(g, m, v, p):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (-lr * delta).to(p.dtype), m32.to(dt), v32.to(dt)

    def upd(g, m, v, p):
        return tuple(_maybe_scan_axis0(cfg, upd_elem, (g, m, v, p)))

    updates, m, v = tree.unzip(tree.map(upd, grads, state["m"], state["v"], params), 3)
    return updates, {"m": m, "v": v}, {"grad_norm": gnorm, "lr": lr}


# -----------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), momentum-free
# -----------------------------------------------------------------------------

def _factored(cfg: OptimizerConfig, shape) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_factored
            and shape[-2] >= cfg.min_dim_factored)


def adafactor_init(cfg: OptimizerConfig, params):
    def init_one(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(cfg, p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    return {"fac": tree.map(init_one, params)}


def adafactor_update(cfg: OptimizerConfig, grads, state, params, step: torch.Tensor):
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    lr = schedule(cfg, step)
    beta2 = 1.0 - (step.float() + 1) ** -0.8

    def _core(g, p, vr=None, vc=None, v=None):
        g32 = g.float() * scale
        sq = g32 * g32 + 1e-30
        if vr is not None:
            vr = beta2 * vr + (1 - beta2) * sq.mean(dim=-1)
            vc = beta2 * vc + (1 - beta2) * sq.mean(dim=-2)
            denom = (vr[..., :, None] / torch.clamp(
                vr.mean(dim=-1, keepdim=True)[..., :, None], min=1e-30)) \
                * vc[..., None, :]
            pre = g32 * torch.rsqrt(torch.clamp(denom, min=1e-30))
        else:
            v = beta2 * v + (1 - beta2) * sq
            pre = g32 * torch.rsqrt(torch.clamp(v, min=1e-30))
        # update clipping by RMS (Adafactor's d=1.0)
        rms = torch.sqrt(torch.mean(pre * pre) + 1e-30)
        pre = pre / torch.clamp(rms, min=1.0)
        delta = pre + cfg.weight_decay * p.float()
        if vr is not None:
            return (-lr * delta).to(p.dtype), vr, vc
        return (-lr * delta).to(p.dtype), v

    def upd(g, s, p):
        if "vr" in s:
            delta, vr, vc = _maybe_scan_axis0(
                cfg, lambda g_, p_, vr_, vc_: _core(g_, p_, vr=vr_, vc=vc_),
                (g, p, s["vr"], s["vc"]))
            return delta, {"vr": vr, "vc": vc}
        delta, v = _maybe_scan_axis0(
            cfg, lambda g_, p_, v_: _core(g_, p_, v=v_), (g, p, s["v"]))
        return delta, {"v": v}

    out = tree.map(upd, grads, state["fac"], params)
    updates, fac = tree.unzip(out, 2)
    return updates, {"fac": fac}, {"grad_norm": gnorm, "lr": lr}


# -----------------------------------------------------------------------------
# registry
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Any
    update: Any


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "adamw":
        return Optimizer(init=functools.partial(adamw_init, cfg),
                         update=functools.partial(adamw_update, cfg))
    if cfg.name == "adafactor":
        return Optimizer(init=functools.partial(adafactor_init, cfg),
                         update=functools.partial(adafactor_update, cfg))
    if cfg.name == "sgd":
        def sgd_init(params):
            return {}

        def sgd_update(grads, state, params, step):
            scale, gnorm = clip_scale(grads, cfg.grad_clip)
            lr = schedule(cfg, step)
            ups = tree.map(lambda g, p: (-lr * scale * g.float()).to(p.dtype),
                           grads, params)
            return ups, state, {"grad_norm": gnorm, "lr": lr}
        return Optimizer(init=sgd_init, update=sgd_update)
    raise ValueError(cfg.name)
