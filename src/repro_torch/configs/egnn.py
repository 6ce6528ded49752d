"""egnn [gnn]: n_layers=4 d_hidden=64 E(n)-equivariant [arXiv:2102.09844].

d_feat / n_classes / task vary with the shape (cora / reddit-sampled /
ogb-products / batched molecules): `config_for(shape)`. Citation graphs carry
synthetic 3D positions (EGNN needs coordinates). The minibatch_lg shape is
the static padding of the neighbour sampler in `models/sampler.py` (fanout
15-10, 1024 seeds).
"""
import numpy as np

from repro_torch.configs import registry as R
from repro_torch.distributed import sharding
from repro_torch.models import egnn as G

SMOKE = G.EGNNConfig(n_layers=2, d_hidden=16, d_feat=8, n_classes=3)


def config_for(shape: str) -> G.EGNNConfig:
    n, e, d, c, task = R.GNN_DIMS[shape]
    return G.EGNNConfig(n_layers=4, d_hidden=64, d_feat=d, n_classes=c, task=task)


def _smoke():
    """(SMOKE, the reference's numpy batch from seed 0 as CPU tensors, "train")."""
    rng = np.random.default_rng(0)
    batch = {"node_feat": rng.standard_normal((24, 8)).astype(np.float32),
             "coords": rng.standard_normal((24, 3)).astype(np.float32),
             "edges": rng.integers(0, 24, (2, 64)).astype(np.int32),
             "labels": rng.integers(0, 3, 24).astype(np.int32)}
    return SMOKE, R.as_tensors(batch), "train"


R.register(R.ArchSpec(
    name="egnn", family="gnn", shapes=R.GNN_SHAPES, skips={},
    config_for=config_for,
    cell_for=lambda shape: R.gnn_cell(config_for(shape), shape),
    serve_fn=lambda cfg, shape: (lambda p, b: G.serve_step(p, b, cfg)),
    loss_fn=lambda cfg: (lambda p, b: G.loss_fn(p, b, cfg)),
    optimizer="adamw", smoke=_smoke, smoke_cfg=SMOKE,
    abstract_params=lambda cfg: R.abstract(G.init_params, cfg),
    param_specs=lambda cfg: sharding.replicated(R.abstract(G.init_params, cfg)),
    abstract_cell=lambda shape, mesh: R.dims_cell(
        R.gnn_cell(config_for(shape), shape), mesh,
        f32=("node_feat", "coords", "targets"),
        replicated=("node_feat", "coords", "labels", "graph_ids", "targets"),
        dim1=("edges",))))
