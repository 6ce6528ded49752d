"""EGNN on batched small molecules (the `molecule` shape) on the PyTorch port:
train 150 steps on a synthetic E(n)-invariant target and check that the
prediction is invariant to a rotation plus a translation of the coordinates,
the property EGNN buys by construction. The twin of `egnn_molecule.py`; the
same batch from numpy seed 0, the port's own initial weights.

Run: python examples/egnn_molecule_torch.py [--device cpu]   (the card by default)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import egnn as G  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

STEPS = 150
INVARIANCE_TOL = 1e-3


def make_batch(rng, n_graphs=32, n_nodes=12, n_edges=40, d_feat=8) -> dict:
    """The reference example's batch as numpy arrays: graphs of n_nodes with
    n_edges random edges each, the target each graph's mean edge length."""
    nodes = n_graphs * n_nodes
    feat = rng.standard_normal((nodes, d_feat)).astype(np.float32)
    coords = rng.standard_normal((nodes, 3)).astype(np.float32)
    graph_ids = np.repeat(np.arange(n_graphs), n_nodes)
    src = np.concatenate([rng.integers(0, n_nodes, n_edges) + g * n_nodes
                          for g in range(n_graphs)])
    dst = np.concatenate([rng.integers(0, n_nodes, n_edges) + g * n_nodes
                          for g in range(n_graphs)])
    edges = np.stack([src, dst]).astype(np.int32)
    d = np.linalg.norm(coords[src] - coords[dst], axis=1)
    targets = np.array([d[g * n_edges:(g + 1) * n_edges].mean()
                        for g in range(n_graphs)], np.float32)
    return {"node_feat": feat, "coords": coords, "edges": edges,
            "graph_ids": graph_ids, "targets": targets}


def run(device: torch.device) -> dict:
    """Train on `device`; the first and last loss and the largest change of a
    prediction under rotation (0.7 rad about z) plus translation (+3)."""
    cfg = G.EGNNConfig(n_layers=3, d_hidden=32, d_feat=8, n_classes=1, task="graph_reg")
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_batch(np.random.default_rng(0)).items()}
    init_state, train_step = make_train_step(
        lambda p, b: G.loss_fn(p, b, cfg),
        OptimizerConfig(lr=2e-3, warmup_steps=10, decay_steps=STEPS))
    state = init_state(G.init_params(torch.Generator(device).manual_seed(0), cfg))
    losses = []
    for _ in range(STEPS):
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
    theta = 0.7
    q = torch.tensor([[np.cos(theta), -np.sin(theta), 0],
                      [np.sin(theta), np.cos(theta), 0], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    rot = dict(batch, coords=batch["coords"] @ q.T + 3.0)
    with torch.no_grad():
        out1, _ = G.serve_step(state["params"], batch, cfg)
        out2, _ = G.serve_step(state["params"], rot, cfg)
    return dict(first=losses[0], last=losses[-1],
                err=float(torch.max(torch.abs(out1 - out2))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, cuda, ...; the card when not given")
    r = run(resolve_device(ap.parse_args().device))
    print(f"train mse: {r['first']:.4f} -> {r['last']:.4f}")
    assert r["last"] < r["first"]
    print(f"rotation+translation invariance error: {r['err']:.2e}")
    assert r["err"] < INVARIANCE_TOL
    print("EGNN example OK")


if __name__ == "__main__":
    main()
