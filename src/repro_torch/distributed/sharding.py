"""Sharding specs: FSDP-augmented parameter specs, optimizer-state specs,
and the per-entry blocks a spec gives a tensor on a mesh.

The port's counterpart of `repro.distributed.sharding`. `P` is the port's
PartitionSpec: one entry per leading dimension, each an axis name, a tuple
of names, or None (replicated); missing trailing entries are None. Model
modules publish tensor-parallel (`"model"`-axis) specs (`param_specs`);
`add_fsdp` shards the big matrices' first free dimension over the data
axes on top; `opt_state_specs` derives the optimizer state's specs from
the parameters' by shape (Adafactor's factored `vr` / `vc` drop one axis).

`block_slices`, `entry_shape` and `entry_bytes` are the spec arithmetic
the rest of the port shares: a dimension sharded over axes (a1, a2) is
cut into ceil(n / (|a1| |a2|))-sized blocks, the block of an entry its
row-major rank over (a1, a2), as JAX pads an uneven dimension and splits
it (trailing entries may hold fewer rows, or none).
`distributed.plan.place` cuts a matrix into its entries' blocks by them,
and the dry run (`launch.dryrun`) counts each entry's bytes by them.

`named` and `state_shardings` keep the reference's names: the port has
no NamedSharding, so a named spec is the pair (mesh, spec).
"""
from __future__ import annotations

import math

import torch

from repro_torch.train import tree


class P:
    """A PartitionSpec: `P(("pod", "data"), None, "model")`. Not a tuple,
    so that tree walks (`train.tree`) treat it as one leaf."""
    __slots__ = ("parts",)

    def __init__(self, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                if len(p) == 0:
                    p = None
                elif len(p) == 1:
                    p = p[0]
            norm.append(p)
        self.parts = tuple(norm)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and _trim(self.parts) == _trim(other.parts)

    def __hash__(self) -> int:
        return hash(_trim(self.parts))

    def __repr__(self) -> str:
        return f"P{self.parts!r}"


def _trim(parts: tuple) -> tuple:
    """Parts without trailing Nones (P("a") == P("a", None), as in JAX)."""
    parts = list(parts)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def axes_of(part) -> tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _parts(spec: P, ndim: int) -> list:
    parts = list(spec) + [None] * (ndim - len(spec))
    if len(parts) != ndim:
        raise ValueError(f"{spec} has {len(spec)} entries for a rank-{ndim} tensor")
    return parts


def n_blocks(part, mesh) -> int:
    """How many blocks one spec entry cuts its dimension into on `mesh`."""
    return math.prod(mesh.shape[a] for a in axes_of(part))


def block_slices(shape, spec: P, mesh, entry: int) -> tuple[slice, ...]:
    """The slice of each dimension that mesh entry `entry` holds under
    `spec`: a ceil-sized block at the entry's row-major rank over the
    dimension's axes."""
    coords = mesh.coords(entry)
    out = []
    for n, part in zip(shape, _parts(spec, len(shape))):
        k = n_blocks(part, mesh)
        rank = 0
        for a in axes_of(part):
            rank = rank * mesh.shape[a] + coords[a]
        per = -(-n // k) if k else n
        out.append(slice(min(rank * per, n), min((rank + 1) * per, n)))
    return tuple(out)


def entry_shape(shape, spec: P, mesh, entry: int = 0) -> tuple[int, ...]:
    """The shape of entry `entry`'s block (entry 0 holds a full-size one)."""
    return tuple(s.stop - s.start for s in block_slices(shape, spec, mesh, entry))


def entry_bytes(leaf, spec: P, mesh, entry: int = 0) -> int:
    """Bytes of `leaf`'s block on mesh entry `entry` under `spec` (`leaf`:
    any tensor, a meta one too)."""
    return math.prod(entry_shape(tuple(leaf.shape), spec, mesh, entry)) \
        * leaf.element_size()


def tree_entry_bytes(leaves_tree, spec_tree, mesh, entry: int = 0) -> int:
    """Sum of `entry_bytes` over a tree of tensors and its tree of specs."""
    specs = dict(tree.leaves_with_paths(spec_tree))
    return sum(entry_bytes(leaf, specs[path], mesh, entry)
               for path, leaf in tree.leaves_with_paths(leaves_tree))


def add_fsdp(specs, abstract_params, mesh, *, min_size: int = 2 ** 20):
    """Shard the first currently-unsharded dim that divides the data axes,
    for every param with >= min_size elements (the reference's rule, dim
    >= 128 keeping the stacked layer axis and small tensors whole)."""
    if "data" not in mesh.axis_names:
        return specs
    dp = tuple(a for a in mesh.axis_names if a != "model")   # ('pod', 'data')
    n_data = math.prod(mesh.shape[a] for a in dp)

    def one(spec: P, leaf):
        shape = tuple(leaf.shape)
        if math.prod(shape) < min_size:
            return spec
        parts = _parts(spec, len(shape))
        for i, (dim, pspec) in enumerate(zip(shape, parts)):
            if pspec is None and dim % n_data == 0 and dim >= 128:
                parts[i] = dp if len(dp) > 1 else dp[0]
                return P(*parts)
        return spec

    return tree.map(one, specs, abstract_params)


def opt_state_specs(param_specs, abstract_params, abstract_opt):
    """Match every optimizer-state leaf to its param's spec by shape (in
    leaf order, a later parameter of the same shape wins, as in the
    reference's dict)."""
    p_specs = {tuple(leaf.shape): s for s, leaf in zip(
        tree.leaves(param_specs), tree.leaves(abstract_params))}

    def one(leaf):
        shape = tuple(leaf.shape)
        if shape in p_specs:
            return p_specs[shape]
        # factored second moments: param spec minus one trailing axis
        for pshape, spec in p_specs.items():
            parts = list(spec) + [None] * (len(pshape) - len(spec))
            if shape == pshape[:-1]:                      # vr
                return P(*parts[:-1])
            if shape == pshape[:-2] + pshape[-1:]:        # vc
                return P(*(parts[:-2] + parts[-1:]))
        return P()                                        # scalars etc.

    return tree.map(one, abstract_opt)


def named(mesh, spec_tree):
    """Each spec of `spec_tree` bound to `mesh`: (mesh, spec) pairs."""
    return tree.map(lambda s: (mesh, s), spec_tree)


def state_shardings(mesh, param_specs, abstract_state):
    """Specs for a trainer state {params, opt, ef, step}, bound to `mesh`."""
    out = {
        "params": param_specs,
        "opt": opt_state_specs(param_specs, abstract_state["params"],
                               abstract_state["opt"]),
        "ef": opt_state_specs(param_specs, abstract_state["params"],
                              abstract_state["ef"]),
        "step": P(),
    }
    return tree.map(lambda s: (mesh, s), out)


def replicated(abstract_tree):
    """P() for every leaf of a tree (EGNN's parameters, the tiering cells'
    empty ones)."""
    return tree.map(lambda _: P(), abstract_tree)


def meta_like(t: torch.Tensor) -> torch.Tensor:
    """A meta tensor of `t`'s shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")
