"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

Runs an arch's SMOKE config end to end through `TrainingDriver`: the
trainer with the arch's optimizer, checkpoint/restart (a relaunch resumes
from the newest committed checkpoint under `--ckpt-dir/<arch>`), the
straggler policy and optional gradient compression, on the reference's
numpy token stream (`synthetic_lm_batches`, labels = tokens). Parameters
are random from seed 0 on the device (`transformer.init_params`: the
reference's distributions, not its numbers). The card unless `--device`
names another. Only the LM family is ported.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


# the reference's other trainable archs, whose models the port has not yet
UNPORTED = {"egnn": "gnn", "bert4rec": "recsys", "bst": "recsys",
            "deepfm": "recsys", "two-tower-retrieval": "recsys"}


def synthetic_lm_batches(cfg, batch: int, seq: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64)
        yield {"tokens": toks.astype(np.int32),
               "labels": toks.astype(np.int32)}


def main() -> None:
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
    args = ap.parse_args()

    import torch

    from repro_torch.configs import registry as R
    from repro_torch.device import resolve_device
    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import DriverConfig, TrainingDriver, \
        make_train_step

    if args.arch in UNPORTED:
        raise NotImplementedError(
            f"{args.arch} is a {UNPORTED[args.arch]} arch: the recsys and EGNN models "
            "and their training are not ported yet (ROADMAP queue 1, item 9)")
    arch = R.get_arch(args.arch)
    cfg, _, kind = arch.smoke()
    assert kind == "train", f"{args.arch} has no training smoke path"
    device = resolve_device(args.device)

    init_state, train_step = make_train_step(
        arch.loss_fn(cfg),
        OptimizerConfig(name=arch.optimizer, lr=args.lr,
                        warmup_steps=10, decay_steps=args.steps),
        compression=CompressionConfig(kind=args.compression))

    def params_init():
        return T.init_params(torch.Generator(device).manual_seed(0), cfg)

    driver = TrainingDriver(init_state, train_step, DriverConfig(
        ckpt_dir=os.path.join(args.ckpt_dir, args.arch),
        ckpt_every=args.ckpt_every, max_steps=args.steps))
    state, history = driver.run(params_init,
                                synthetic_lm_batches(cfg, args.batch, args.seq))

    print(f"[train] {args.arch}: {len(history)} steps this run, "
          f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
