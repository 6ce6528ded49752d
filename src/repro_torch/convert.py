"""Carry the reference's state into the port.

The counterpart of a weight converter: each function takes a reference
object's arrays as numpy (uint32 words, f32 weights, bool masks) and builds
the port's object on a given device, so both packages can compute on
identical operands.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.problem import SCSKProblem
from repro_torch.core.state import SolverState
from repro_torch.core.tiering import ClauseTiering
from repro_torch.device import resolve_device


def problem_from_numpy(clause_query_bits: np.ndarray,
                       clause_doc_bits: np.ndarray,
                       query_weights: np.ndarray, test_weights: np.ndarray,
                       n_queries: int, n_docs: int,
                       device=None) -> SCSKProblem:
    """An `SCSKProblem` from a reference problem's arrays (words uint32,
    weights f32 already padded to Wq*32)."""
    dev = resolve_device(device)
    return SCSKProblem(
        clause_query_bits=bitset.to_tensor(clause_query_bits, dev),
        clause_doc_bits=bitset.to_tensor(clause_doc_bits, dev),
        query_weights=torch.as_tensor(np.asarray(query_weights, np.float32),
                                      device=dev),
        test_weights=torch.as_tensor(np.asarray(test_weights, np.float32),
                                     device=dev),
        n_queries=int(n_queries), n_docs=int(n_docs))


def state_from_numpy(covered_q: np.ndarray, covered_d: np.ndarray,
                     selected: np.ndarray, g_used: float, step: int,
                     device=None) -> SolverState:
    """A `SolverState` from a reference state's arrays."""
    dev = resolve_device(device)
    return SolverState(
        covered_q=bitset.to_tensor(covered_q, dev),
        covered_d=bitset.to_tensor(covered_d, dev),
        selected=torch.as_tensor(np.asarray(selected, bool), device=dev),
        g_used=torch.tensor(np.float32(g_used), device=dev),
        step=int(step))


def tiering_from_numpy(clauses, clause_vocab_bits: np.ndarray,
                       tier1_docs: np.ndarray, vocab_size: int) -> ClauseTiering:
    """A `ClauseTiering` from a reference tiering's fields (host arrays)."""
    return ClauseTiering(
        clauses=[tuple(int(t) for t in c) for c in clauses],
        clause_vocab_bits=np.asarray(clause_vocab_bits, np.uint32),
        tier1_docs=np.asarray(tier1_docs, bool),
        vocab_size=int(vocab_size))


def _tensor_leaf(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype (bfloat16, numpy's
    ml_dtypes, carried through float32, which holds it exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn) for v in tree)
    return fn(tree)


def tensors_from_numpy(tree, dtype: torch.dtype = torch.float32, device=None):
    """Nested dicts, lists and tuples of numpy arrays as tensors of `dtype`
    on `device`, the nesting kept."""
    dev = resolve_device(device)
    return _walk(tree, lambda a: _tensor_leaf(a, dev).to(dtype))


def transformer_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The port's transformer parameters from the reference's
    `init_params` tree as numpy arrays (the same nesting and stacked [L]
    leaves, an MoE layer's [L, E, D, F] experts among them), in
    `cfg.param_dtype` on `device`."""
    return tensors_from_numpy(tree, cfg.pdtype, device)


def recsys_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The port's parameters of a recsys arch (DeepFM, BST, BERT4Rec,
    two-tower) from the reference's `*_init` tree as numpy arrays: the same
    keys, the MLP and block lists kept as lists, in `cfg.dtype` on
    `device`."""
    return tensors_from_numpy(tree, getattr(torch, cfg.dtype), device)


def train_state_from_numpy(state: dict, device=None) -> dict:
    """The port's train state {params, opt, ef, step} from a reference train
    state as numpy (`jax.tree.map(np.asarray, state)`): AdamW's m and v,
    Adafactor's vr / vc / v, the error-feedback residual and the step, each
    leaf in its own dtype (bf16 parameters or states stay bf16) on
    `device`."""
    dev = resolve_device(device)
    out = _walk(state, lambda a: _tensor_leaf(a, dev))
    out["step"] = out["step"].to(torch.int32)
    return out
