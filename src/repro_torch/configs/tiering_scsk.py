"""tiering-scsk — the paper's own architecture: SCSK solver rounds and the
two-tier serving path at production scale (paper §4: |D| 10^6..10^12,
|X̄| 10^4..10^6).

The port's counterpart of `repro.configs.tiering_scsk`. Shapes:
  solve_dense_m   dense bitset round, C=128k clauses, 1M queries, 8M docs
  solve_dense_l   dense bitset round, C=1M, 4M queries, 64M docs
  solve_optpes_l  Opt/Pes batched bound-refresh round at the _l scale
  solve_sparse_xl sparse-id round, C=1M, m(c) padded to 4096, 256M docs
  serve_route     two-tier classify+match, 4096-query batch

Sharding (`abstract_cell`'s specs): the clause axis over the data axes
('pod', 'data'); the query- and doc-word axes over 'model' for the gains
(`distributed.model_gains`: f partials by `bit_matvec`, g partials by
`coverage_gain`, summed over 'model'); covered masks replicated. Packed
words are int32 here, as everywhere in the port (the reference's uint32).
The cells have no parameters and no loss: `launch.train` refuses them.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry as R
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class TieringScaleConfig:
    name: str = "tiering-scsk"
    refresh_k: int = 4096          # Opt/Pes batch width


CONFIG = TieringScaleConfig()

SHAPES = {
    # C, n_queries, n_docs, sparse M (or None)
    "solve_dense_m": (131072, 2 ** 20, 2 ** 23, None),
    "solve_dense_l": (2 ** 20, 2 ** 22, 2 ** 26, None),
    "solve_optpes_l": (2 ** 20, 2 ** 22, 2 ** 26, None),
    "solve_sparse_xl": (2 ** 20, 2 ** 22, 2 ** 28, 4096),
    "serve_route": None,
}
# serve_route: B bounded, as a packed-postings AND-scan reads L * Wd words a
# query (production match uses compressed postings); this cell sizes the
# packed-Tier-1 regime (4M docs): batch, vocabulary, docs, candidate clauses
SERVE_ROUTE = (4096, 2 ** 17, 2 ** 22, 2 ** 16)


def _inputs(shape: str) -> dict:
    """name -> (shape, dtype, spec with "dp" for the data axes)."""
    if shape == "serve_route":
        b, v, nd, k = SERVE_ROUTE
        wv, wd = v // 32, nd // 32
        return {"tokens": ((b, 8), torch.int32, P("dp", None)),
                "clause_vocab_bits": ((k, wv), torch.int32, P("dp", None)),
                "postings": ((v, wd), torch.int32, P(None, "model")),
                "tier1_mask": ((wd,), torch.int32, P(None))}
    c, nq, nd, m = SHAPES[shape]
    wq, wd = nq // 32, nd // 32
    out = {"clause_query_bits": ((c, wq), torch.int32, P("dp", "model")),
           "query_weights": ((nq,), torch.float32, P(None)),
           "covered_q": ((wq,), torch.int32, P(None)),
           "covered_d": ((wd,), torch.int32, P(None)),
           "selected": ((c,), torch.bool, P("dp")),
           "g_used": ((), torch.float32, P()),
           "budget": ((), torch.float32, P())}
    if m is not None:
        out["clause_doc_ids"] = ((c, m), torch.int32, P("dp", None))
    else:
        out["clause_doc_bits"] = ((c, wd), torch.int32, P("dp", "model"))
    if shape == "solve_optpes_l":
        for nm in ("fbar", "flow"):
            out[nm] = ((c,), torch.float32, P("dp"))
        for nm in ("gbar", "glow"):           # per-partition bounds [C, P]
            out[nm] = ((c, 1), torch.float32, P("dp", None))
    return out


def _cell(shape: str) -> R.Cell:
    return R.Cell("solve", {k: v[0] for k, v in _inputs(shape).items()})


def abstract_cell(shape: str, mesh):
    """The cell's inputs as meta tensors and their specs on `mesh`."""
    dp = mesh_lib.data_axes(mesh)
    inputs, specs = {}, {}
    for name, (dims, dtype, spec) in _inputs(shape).items():
        inputs[name] = R.meta(dims, dtype)
        specs[name] = P(*(dp if p == "dp" else p for p in spec))
    return inputs, specs


def solve_fn(shape: str):
    """fn(batch) for the shape: one solver round, or one serve batch."""
    from repro_torch import distributed
    from repro_torch.core import bitset
    from repro_torch.core.greedy import ratio_of
    from repro_torch.core.sparse_step import sparse_greedy_step
    from repro_torch.kernels import ops

    if shape == "serve_route":
        def route(batch):
            """(match words [B, Wd]: Tier-1's where the query is eligible,
            else the full index's; eligible [B])."""
            toks = batch["tokens"]
            wv = batch["clause_vocab_bits"].shape[1]
            qbits = bitset.pack_tokens(toks, wv * 32)   # queries over the vocabulary
            sub = ops.clause_match(qbits, batch["clause_vocab_bits"])
            m2 = ops.match_batch(batch["postings"], toks)
            m1 = m2 & batch["tier1_mask"][None, :]
            return torch.where(sub[:, None], m1, m2), sub
        return route

    if shape == "solve_sparse_xl":
        def sparse(batch):
            return sparse_greedy_step(
                batch["clause_doc_ids"], batch["clause_query_bits"],
                batch["query_weights"], batch["covered_q"],
                batch["covered_d"], batch["selected"], batch["g_used"],
                float(batch["budget"]) if not batch["budget"].is_meta else 0.0)
        return sparse

    if shape == "solve_optpes_l":
        def optpes(batch):
            """(the round's state, selected this round, any feasible, j);
            the state's tensors are the batch's, updated in place."""
            from repro_torch.core.constraint import GlobalBudget
            from repro_torch.core.optpes import RoundState, optpes_round
            from repro_torch.core.problem import SCSKProblem
            a_q = batch["clause_query_bits"]
            wq, nq = a_q.shape[1], batch["query_weights"].shape[0]
            wpad = torch.zeros(wq * 32, dtype=torch.float32, device=a_q.device)
            wpad[:nq] = batch["query_weights"]
            prob = SCSKProblem(
                clause_query_bits=a_q, clause_doc_bits=batch["clause_doc_bits"],
                query_weights=wpad, test_weights=wpad,
                n_queries=nq, n_docs=batch["covered_d"].shape[0] * 32)
            rs = RoundState(
                covered_q=batch["covered_q"], covered_d=batch["covered_d"],
                selected=batch["selected"], g_part=batch["g_used"].reshape(1),
                fbar=batch["fbar"], flow=batch["flow"], gbar=batch["gbar"],
                glow=batch["glow"],
                f_val=torch.zeros((), dtype=torch.float32, device=a_q.device))
            budget = 0.0 if batch["budget"].is_meta else float(batch["budget"])
            did, any_feasible, j = optpes_round(prob, rs, GlobalBudget(budget),
                                                k=CONFIG.refresh_k)
            return rs, did, any_feasible, j
        return optpes

    def dense(batch):
        """One cost-ratio greedy round: (covered_q, covered_d, selected, j)
        with the argmax clause's rows ORed in and its bit set, as the
        reference's round does (no feasibility stop). Over a `"model"` mesh
        the gains are summed from each entry's (data rows x model words)
        block and the rows are owner-local (`distributed.model_gains`,
        `distributed.owner_row`); j stays on the card."""
        a_q, a_d = batch["clause_query_bits"], batch["clause_doc_bits"]
        nq = batch["query_weights"].shape[0]
        x = (batch["query_weights"] * (
            1.0 - bitset.unpack(batch["covered_q"]).to(torch.float32)[:nq]))[:, None]
        if distributed.current_plan().model_fused:
            fg, gg = distributed.model_gains(a_q, x, a_d, batch["covered_d"])
        else:
            fg = ops.bit_matvec(a_q, x)[:, 0]
            gg = ops.coverage_gain(a_d, batch["covered_d"]).to(torch.float32)
        feasible = (~batch["selected"]) & \
            (batch["g_used"] + gg <= batch["budget"]) & (fg > 0.0)
        score = torch.where(feasible, ratio_of(fg, gg), float("-inf"))
        j = torch.argmax(score)
        covered_q = batch["covered_q"] | distributed.owner_row(a_q, j, w_axis="model")
        covered_d = batch["covered_d"] | distributed.owner_row(a_d, j, w_axis="model")
        selected = batch["selected"].index_fill(0, j.reshape(1), True)
        return covered_q, covered_d, selected, j
    return dense


def _smoke():
    """(CONFIG, the reference's tiny dense round from seed 0 as CPU tensors,
    "solve"): its uint32 words as int32."""
    rng = np.random.default_rng(0)
    c, nq, nd = 64, 256, 512
    batch = {
        "clause_query_bits": rng.integers(0, 2 ** 32, (c, nq // 32), dtype=np.uint32),
        "clause_doc_bits": rng.integers(0, 2 ** 32, (c, nd // 32), dtype=np.uint32),
        "query_weights": rng.random(nq).astype(np.float32),
        "covered_q": np.zeros(nq // 32, np.uint32),
        "covered_d": np.zeros(nd // 32, np.uint32),
        "selected": np.zeros(c, bool),
        "g_used": np.float32(0),
        "budget": np.float32(nd),
    }
    batch = {k: torch.from_numpy(np.asarray(v).view(np.int32) if np.asarray(v).dtype == np.uint32
                                 else np.asarray(v)) for k, v in batch.items()}
    return CONFIG, batch, "solve"


R.register(R.ArchSpec(
    name="tiering-scsk", family="tiering",
    shapes=tuple(SHAPES), skips={},
    config_for=lambda shape: CONFIG,
    cell_for=_cell,
    serve_fn=lambda cfg, shape: (lambda params, batch: solve_fn(shape)(batch)),
    loss_fn=None, optimizer="adamw", smoke=_smoke, smoke_cfg=CONFIG,
    abstract_params=lambda cfg: {},
    param_specs=lambda cfg: {},
    abstract_cell=abstract_cell,
))
