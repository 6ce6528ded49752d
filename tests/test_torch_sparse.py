"""The port's sparse greedy round against the reference's.

`sparse_gain` (plain version) against the reference's Pallas body and its
`ref`; `bitset.from_indices` / `bit_get` against the reference's;
`sparse_greedy_step` step for step against the reference's on `tiny`, and
against the port's own dense `greedy_step` on the same problem. Weights are
rescaled to a power-of-two denominator as in `test_torch_solvers.py`.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitset as jbitset
from repro.core import sparse_step as jsparse
from repro.data import incidence as jincidence
from repro.data import synthetic as jsynthetic
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import bitset
from repro_torch.core.greedy import greedy_step
from repro_torch.core.sparse_step import sparse_greedy_step
from repro_torch.data import incidence
from repro_torch.kernels import ops


def _ids(rng, c, m, universe, pad=0.3):
    ids = rng.integers(0, universe, size=(c, m)).astype(np.int32)
    ids[rng.random((c, m)) < pad] = -1        # padding at random places
    return ids


@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("c,m,universe", [(1, 4, 64), (5, 7, 100),
                                          (33, 40, 2048), (128, 65, 512),
                                          (9, 1, 33)])
def test_sparse_gain_matches_reference(backend, c, m, universe):
    rng = np.random.default_rng(c + m)
    ids = _ids(rng, c, m, universe)
    covered = jbitset.np_pack(rng.random(universe) < 0.5)
    want = jops.sparse_gain(jnp.asarray(ids), jnp.asarray(covered),
                            backend=backend)
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(jref.sparse_gain(jnp.asarray(ids),
                                                      jnp.asarray(covered))))
    got = ops.sparse_gain(torch.from_numpy(ids), bitset.to_tensor(covered, "cpu"))
    assert got.dtype == torch.int32 and got.shape == (c,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sparse_gain_all_padding_and_bit31():
    ids = np.array([[-1, -1, -1], [31, 63, -1], [-1, 0, 32]], np.int32)
    mask = np.array([0x80000000, 0], np.uint32)     # only doc 31 covered
    got = ops.sparse_gain(torch.from_numpy(ids), bitset.to_tensor(mask, "cpu"))
    assert got.tolist() == [0, 1, 2]


def test_sparse_gain_agrees_with_dense_path():
    rng = np.random.default_rng(0)
    universe = 300
    rows = rng.random((20, universe)) < 0.05
    covered = bitset.to_tensor(bitset.np_pack(rng.random(universe) < 0.4), "cpu")
    packed = bitset.np_pack(rows)
    ids = incidence.padded_id_lists(packed, universe)
    np.testing.assert_array_equal(
        ops.sparse_gain(torch.from_numpy(ids), covered).numpy(),
        ops.coverage_gain(bitset.to_tensor(packed, "cpu"), covered).numpy())


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("n_bits,u", [(64, 10), (100, 40), (1000, 200),
                                      (33, 5)])
def test_from_indices_matches_reference(unique, n_bits, u):
    rng = np.random.default_rng(n_bits + u)
    if unique:
        idx = rng.permutation(n_bits)[:u].astype(np.int32)
    else:
        idx = rng.integers(0, n_bits, size=u).astype(np.int32)
        idx[: u // 2] = idx[-(u // 2):]               # duplicates
    valid = rng.random(u) < 0.7
    for v in (None, valid):
        want = jbitset.from_indices(
            jnp.asarray(idx), n_bits, None if v is None else jnp.asarray(v),
            unique=unique)
        got = bitset.from_indices(
            torch.from_numpy(idx), n_bits,
            None if v is None else torch.from_numpy(v), unique=unique)
        assert got.dtype == torch.int32
        assert bitset.to_numpy(got).tobytes() == np.asarray(want).tobytes()
    bits = bitset.bit_get(got, torch.from_numpy(idx))
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jbitset.bit_get(want, jnp.asarray(idx))))


def test_from_indices_duplicates_or_not_add():
    idx = torch.tensor([3, 3, 3, 35, 35], dtype=torch.int32)
    got = bitset.from_indices(idx, 64)
    assert bitset.to_numpy(got).tolist() == [8, 8]


# -- the sparse greedy round ------------------------------------------------------

@pytest.fixture(scope="module")
def sparse_problem():
    corpus, log = jsynthetic.make_tiering_dataset(0, "tiny")
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))
    data = jincidence.build_tiering_data(corpus, log, min_support=1e-3)
    wq = data.clause_query_bits.shape[1]
    w = np.zeros(wq * 32, np.float32)
    w[:data.n_queries] = data.log.train_weights
    ids = incidence.padded_id_lists(data.clause_doc_bits, data.n_docs)
    prob = convert.problem_from_numpy(data.clause_query_bits,
                                      data.clause_doc_bits, w, w,
                                      data.n_queries, data.n_docs, device="cpu")
    return data, w, ids, prob


def test_padded_id_lists_match_reference(sparse_problem):
    data, _, ids, _ = sparse_problem
    want = jincidence.padded_id_lists(data.clause_doc_bits, data.n_docs)
    assert ids.tobytes() == want.tobytes()


def test_sparse_greedy_step_matches_reference(sparse_problem):
    data, w, ids, prob = sparse_problem
    budget = float(int(data.n_docs * 0.5))
    c = data.clause_query_bits.shape[0]
    js = (jnp.zeros(prob.wq, jnp.uint32), jnp.zeros(prob.wd, jnp.uint32),
          jnp.zeros(c, bool), jnp.float32(0.0))
    ts = (*prob.empty_state(), torch.zeros(c, dtype=torch.bool),
          torch.zeros((), dtype=torch.float32))
    for _ in range(5):
        *js, j_ref, stop_ref = jsparse.sparse_greedy_step(
            jnp.asarray(ids), jnp.asarray(data.clause_query_bits),
            jnp.asarray(w), *js, jnp.float32(budget))
        *ts, j, stop = sparse_greedy_step(
            torch.from_numpy(ids), prob.clause_query_bits, prob.query_weights,
            *ts, budget)
        assert (j, stop) == (int(j_ref), bool(stop_ref))
        assert bitset.to_numpy(ts[1]).tobytes() == np.asarray(js[1]).tobytes()
        assert bitset.to_numpy(ts[0]).tobytes() == np.asarray(js[0]).tobytes()
        np.testing.assert_array_equal(ts[2].numpy(), np.asarray(js[2]))
        assert float(ts[3]) == float(js[3])
    assert not stop


def test_sparse_round_equals_dense_greedy(sparse_problem):
    """The sparse round and the dense greedy step select the same clauses
    and cover the same docs, up to the stop; a small budget makes it stop."""
    data, _, ids, prob = sparse_problem
    budget = 60.0
    ids_t = torch.from_numpy(ids)
    state = prob.init_state()
    sp = (state.covered_q, state.covered_d, state.selected, state.g_used)
    for step in range(prob.n_clauses):
        state, j, stop = greedy_step(prob, state, budget)
        *sp, js, sstop = sparse_greedy_step(
            ids_t, prob.clause_query_bits, prob.query_weights, *sp, budget)
        assert (js, sstop) == (j, stop)
        assert torch.equal(sp[1], state.covered_d)
        assert torch.equal(sp[2], state.selected)
        assert float(sp[3]) == float(state.g_used)
        if stop:
            break
    assert stop and step > 3
