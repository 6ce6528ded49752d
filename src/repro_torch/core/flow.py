"""Query-selection (flow) baselines from Leung et al. [17], paper §2.3/§5.2.

The port's counterpart of `repro.core.flow`. All three parameterize tiering
by a document set D₁ + the memorized query set X^flow = {q ∈ Q_n : m(q) ⊆
D₁} (eq. 6/7) — so unseen queries always route to Tier 2, which is exactly
the generalization failure the paper demonstrates.

  popularity : doc score = P_{q~Qn}[d ∈ m(q)]; take top-B docs (numpy)
  flow-max   : doc score = max_{q: d∈m(q)} P[q]; take top-B docs (numpy)
  flow-sgd   : smooth-min convex relaxation of (5), minibatch SGD over doc
               logits + budget penalty, λ-regularized (drop rare queries);
               the logits and the match bitsets live on the device and the
               gradient comes from `torch.autograd`. The minibatches are
               numpy draws from `default_rng(seed)`, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.device import resolve_device

if typing.TYPE_CHECKING:  # avoid circular import (data imports core.bitset)
    from repro_torch.data.incidence import TieringData


@dataclasses.dataclass
class FlowResult:
    name: str
    tier1_docs: np.ndarray          # bool [n_docs]
    eligible_queries: np.ndarray    # bool [Nq]  (X^flow membership)
    train_coverage: float
    test_coverage: float
    wall_seconds: float
    doc_scores: np.ndarray | None = None   # f64 [n_docs] the top-B ranking


def _doc_scores_popularity(data: "TieringData", chunk: int = 1024) -> np.ndarray:
    score = np.zeros(data.n_docs, np.float64)
    w = data.log.train_weights
    for s in range(0, data.n_queries, chunk):
        blk = bitset.np_unpack(data.query_doc_bits[s:s + chunk], data.n_docs)
        score += w[s:s + chunk] @ blk
    return score


def _doc_scores_flowmax(data: "TieringData", chunk: int = 1024) -> np.ndarray:
    score = np.zeros(data.n_docs, np.float64)
    w = data.log.train_weights
    for s in range(0, data.n_queries, chunk):
        blk = bitset.np_unpack(data.query_doc_bits[s:s + chunk], data.n_docs)
        score = np.maximum(score, (w[s:s + chunk, None] * blk).max(axis=0))
    return score


def _finalize(name: str, data: "TieringData", doc_scores: np.ndarray,
              budget: int, t0: float, lam: float = 0.0) -> FlowResult:
    top = np.argsort(-doc_scores)[:budget]
    tier1 = np.zeros(data.n_docs, bool)
    tier1[top] = True
    t1_bits = bitset.np_pack(tier1)
    # X^flow: training queries (freq >= λ) whose match set fits in tier 1
    contained = ~np.any(data.query_doc_bits & ~t1_bits[None, :], axis=1)
    eligible = contained & (data.log.train_weights >= max(lam, 1e-300))
    return FlowResult(
        name=name,
        tier1_docs=tier1,
        eligible_queries=eligible,
        train_coverage=float(data.log.train_weights[eligible].sum()),
        test_coverage=float(data.log.test_weights[eligible].sum()),
        wall_seconds=time.perf_counter() - t0,
        doc_scores=doc_scores,
    )


def popularity(data: "TieringData", budget: int) -> FlowResult:
    t0 = time.perf_counter()
    return _finalize("popularity", data, _doc_scores_popularity(data), budget, t0)


def flow_max(data: "TieringData", budget: int) -> FlowResult:
    t0 = time.perf_counter()
    return _finalize("flow-max", data, _doc_scores_flowmax(data), budget, t0)


def sgd_loss(theta: torch.Tensor, q_bits: torch.Tensor, q_w: torch.Tensor,
             budget: float, tau: float, mu: float, n_docs: int) -> torch.Tensor:
    """The smooth-min coverage relaxation of eq. 5 plus the budget penalty."""
    z = torch.sigmoid(theta)                                        # [D]
    memb = bitset.unpack(q_bits, n_docs).to(torch.float32)          # [B, D]
    # smooth min over m(q): -tau * logsumexp(-z/tau) restricted to members
    neg = (-z[None, :] / tau) * memb + (1.0 - memb) * (-1e9)
    y = -tau * torch.logsumexp(neg, dim=1)                          # [B]
    cover = torch.sum(q_w * y)
    over = torch.relu(torch.sum(z) - budget)
    return -cover + mu * over * over / budget


def flow_sgd(data: "TieringData", budget: int, *, lam: float = 0.0,
             steps: int = 300, batch: int = 256, lr: float = 0.5,
             tau: float = 0.05, mu: float = 10.0, seed: int = 0,
             device=None) -> FlowResult:
    t0 = time.perf_counter()
    dev = resolve_device(device)
    w = data.log.train_weights.copy()
    w[w < lam] = 0.0                               # λ-regularization (paper)
    keep = np.nonzero(w > 0)[0]
    probs = w[keep] / w[keep].sum()
    rng = np.random.default_rng(seed)
    theta = torch.zeros(data.n_docs, dtype=torch.float32, device=dev)
    q_bits_all = bitset.to_tensor(data.query_doc_bits, dev)
    for _ in range(steps):
        idx = keep[rng.choice(len(keep), size=min(batch, len(keep)), p=probs)]
        theta.requires_grad_(True)
        loss = sgd_loss(theta, q_bits_all[torch.from_numpy(idx).to(dev)],
                        torch.full((len(idx),), 1.0 / len(idx),
                                   dtype=torch.float32, device=dev),
                        float(np.float32(budget)), float(np.float32(tau)),
                        float(np.float32(mu)), data.n_docs)
        (g,) = torch.autograd.grad(loss, theta)
        theta = (theta - float(np.float32(lr)) * g).detach()
    return _finalize(f"flow-sgd(λ={lam:g})", data,
                     theta.cpu().numpy().astype(np.float64), budget, t0,
                     lam=lam)
