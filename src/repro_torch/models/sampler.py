"""Layer-wise uniform neighbour sampler (GraphSAGE-style, fanout e.g. 15-10),
the port's own copy of `repro.models.sampler`.

Host-side numpy over a CSR adjacency: the data pipeline of the
`minibatch_lg` shape, producing statically padded subgraph batches for the
EGNN step. It makes the same `rng` calls in the same order as the
reference's, so one `np.random.Generator` seed gives the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray      # [N+1]
    indices: np.ndarray     # [E]
    n_nodes: int

    @classmethod
    def from_edges(cls, edges: np.ndarray, n_nodes: int) -> "CSRGraph":
        """edges: [2, E] (src, dst) -> CSR over outgoing src->dst."""
        src, dst = edges
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr=indptr, indices=dst, n_nodes=n_nodes)


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
    *,
    pad_nodes: int | None = None,
    pad_edges: int | None = None,
):
    """(node_ids [N'], edges_local [2, E'], seed_mask [N']): the sampled
    edges (neighbour -> node) remapped to subgraph-local ids, padded with -1
    (nodes, edges) and False (the mask) to static shapes."""
    frontier = np.unique(seeds)
    all_nodes = [frontier]
    all_src, all_dst = [], []
    for fanout in fanouts:
        next_front = []
        for u in frontier:
            nbrs = graph.indices[graph.indptr[u]:graph.indptr[u + 1]]
            if len(nbrs) == 0:
                continue
            take = nbrs if len(nbrs) <= fanout else rng.choice(
                nbrs, size=fanout, replace=False)
            all_src.append(take)
            all_dst.append(np.full(len(take), u, np.int64))
            next_front.append(take)
        frontier = (np.unique(np.concatenate(next_front))
                    if next_front else np.empty(0, np.int64))
        all_nodes.append(frontier)
    nodes = np.unique(np.concatenate(all_nodes))
    src = np.concatenate(all_src) if all_src else np.empty(0, np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.empty(0, np.int64)
    remap = -np.ones(graph.n_nodes, np.int64)
    remap[nodes] = np.arange(len(nodes))
    edges = np.stack([remap[src], remap[dst]]).astype(np.int32)
    seed_mask = np.isin(nodes, seeds)

    if pad_nodes is not None:
        assert len(nodes) <= pad_nodes, (len(nodes), pad_nodes)
        nodes = np.pad(nodes, (0, pad_nodes - len(nodes)), constant_values=-1)
        seed_mask = np.pad(seed_mask, (0, pad_nodes - len(seed_mask)))
    if pad_edges is not None:
        assert edges.shape[1] <= pad_edges, (edges.shape[1], pad_edges)
        edges = np.pad(edges, ((0, 0), (0, pad_edges - edges.shape[1])),
                       constant_values=-1)
    return nodes, edges, seed_mask
