"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Runs an arch's SMOKE config end to end through `TrainingDriver`: the
trainer with the arch's optimizer, checkpoint/restart (a relaunch resumes
from the newest committed checkpoint under `--ckpt-dir/<arch>`), the
straggler policy and optional gradient compression. An LM trains on the
reference's numpy token stream (`synthetic_lm_batches`, labels = tokens),
a recsys arch (deepfm, bst, bert4rec, two-tower-retrieval) or egnn on its
SMOKE batch repeated, as the reference's launcher does. Parameters are
random from seed 0 on the device (`transformer.init_params`,
`recsys.*_init`, `egnn.init_params`: the reference's distributions, not its
numbers). The card unless `--device` names another. `--fail-at-step N`
raises after step N's checkpoint (a restart's first half, for tests and
`chip_smoke.py`); `run` returns the final state and the steps' metrics.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def synthetic_lm_batches(cfg, batch: int, seq: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64)
        yield {"tokens": toks.astype(np.int32),
               "labels": toks.astype(np.int32)}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda, ...; the card when not given")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="raise after this step's checkpoint (restart tests)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """Train as `args` say; (the final state, each step's metrics)."""
    import torch

    from repro_torch.configs import registry as R
    from repro_torch.device import resolve_device
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.models import egnn as G
    from repro_torch.models import recsys as M
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import DriverConfig, TrainingDriver, \
        make_train_step

    arch = R.get_arch(args.arch)
    if arch.loss_fn is None:
        raise ValueError(f"{args.arch} has no loss to train (its cells are "
                         f"{arch.family} rounds, run by its serve_fn); "
                         f"launch.train takes an arch with a loss_fn")
    cfg, smoke_batch, kind = arch.smoke()
    assert kind == "train", f"{args.arch} has no training smoke path"
    device = resolve_device(args.device)

    init_state, train_step = make_train_step(
        arch.loss_fn(cfg),
        OptimizerConfig(name=arch.optimizer, lr=args.lr,
                        warmup_steps=10, decay_steps=args.steps),
        compression=CompressionConfig(kind=args.compression))

    def params_init():
        gen = torch.Generator(device).manual_seed(0)
        if arch.family == "lm":
            return T.init_params(gen, cfg)
        if arch.family == "gnn":
            return G.init_params(gen, cfg)
        init = {"deepfm": M.deepfm_init, "bst": M.bst_init, "bert4rec": M.bert4rec_init,
                "two-tower-retrieval": M.twotower_init}[args.arch]
        return init(gen, cfg)

    def repeat(batch):
        while True:
            yield batch

    driver = TrainingDriver(init_state, train_step, DriverConfig(
        ckpt_dir=os.path.join(args.ckpt_dir, args.arch),
        ckpt_every=args.ckpt_every, max_steps=args.steps,
        fail_at_step=args.fail_at_step))
    batches = (synthetic_lm_batches(cfg, args.batch, args.seq) if arch.family == "lm"
               else repeat(smoke_batch))
    return driver.run(params_init, batches)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    state, history = run(args)
    print(f"[train] {args.arch}: {len(history)} steps this run, "
          f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
