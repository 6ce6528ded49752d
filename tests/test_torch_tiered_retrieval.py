"""The port's tiered retrieval (`repro_torch.models.tiered_retrieval`)
against the reference's (`repro.models.tiered_retrieval`) at `tiny`.

`build_tiered_index` runs each package's pipeline (mine -> optpes ->
tiering). For the port's Tier-1 ids to equal the reference's, the query
log's weights are first rescaled to counts over a power-of-two denominator
(exact f32 sums, ROADMAP fault 1's rule: otherwise an f32 near-tie between
two clauses' gains may break otherwise in the two packages). Online,
Theorem 3.1: an eligible query's top-k over matching items from the Tier-1
rows alone equals the whole corpus's (the reference's test_models.py
check), and both equal the reference's `tiered_retrieval_scores`."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import bitset as jbitset
from repro.models import tiered_retrieval as JT
from repro_torch import api as tapi
from repro_torch.models import tiered_retrieval as TT


def _dyadic(log):
    """Weights as counts over a power-of-two denominator (exact f32 sums)."""
    for name, n in (("train_weights", log.n_train_samples),
                    ("test_weights", log.n_test_samples)):
        counts = np.rint(getattr(log, name) * n)
        setattr(log, name, counts / 2.0 ** math.ceil(math.log2(n)))


def _dyadic_from_synthetic(cls):
    orig = cls.from_synthetic.__func__

    def build(klass, *args, **kw):
        pipe = orig(klass, *args, **kw)
        _dyadic(pipe.log)
        return pipe
    return classmethod(build)


@pytest.fixture(scope="module")
def indexes():
    """(reference index, port index) at tiny, budget 0.5, optpes, both
    built on dyadic weights through `build_tiered_index`."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(japi.TieringPipeline, "from_synthetic",
                   _dyadic_from_synthetic(japi.TieringPipeline))
        mp.setattr(tapi.TieringPipeline, "from_synthetic",
                   _dyadic_from_synthetic(tapi.TieringPipeline))
        return (JT.build_tiered_index(seed=0, scale="tiny", budget_frac=0.5),
                TT.build_tiered_index(seed=0, scale="tiny", budget_frac=0.5, device="cpu"))
    finally:
        mp.undo()


def test_tier1_ids_equal_the_reference(indexes):
    jidx, tidx = indexes
    np.testing.assert_array_equal(tidx.tier1_ids, jidx.tier1_ids)
    assert tidx.tier1_frac == jidx.tier1_frac
    assert 0 < tidx.tier1_frac <= 0.5
    assert tidx.tiering.clauses == [tuple(c) for c in jidx.tiering.clauses]


def test_tiered_retrieval_preserves_topk(indexes):
    """The reference's test_models.py check on the port's index: for 20
    eligible queries the Tier-1 path's top-5 matching ids equal the full
    path's, and (values, ids) of both equal the reference's."""
    jidx, tidx = indexes
    data = tidx.data
    rng = np.random.default_rng(0)
    cand = rng.standard_normal((data.n_docs, 16)).astype(np.float32)
    t1 = torch.from_numpy(tidx.tier1_ids)
    elig = tidx.tiering.classify_queries(data.log.query_bits)
    np.testing.assert_array_equal(elig, jidx.tiering.classify_queries(jidx.data.log.query_bits))
    checked = 0
    for qi in np.nonzero(elig)[0][:20]:
        match = jbitset.np_unpack(jidx.data.query_doc_bits[qi], data.n_docs)
        user = rng.standard_normal(16).astype(np.float32)
        args = (torch.from_numpy(user), torch.from_numpy(cand), t1)
        v1, i1 = TT.tiered_retrieval_scores(*args, True, torch.from_numpy(match), k=5)
        v2, i2 = TT.tiered_retrieval_scores(*args, torch.tensor(False),
                                            torch.from_numpy(match), k=5)
        valid = np.isfinite(v1.numpy())
        np.testing.assert_array_equal(i1.numpy()[valid], i2.numpy()[valid])
        jv, ji = JT.tiered_retrieval_scores(jnp.asarray(user), jnp.asarray(cand),
                                            jnp.asarray(jidx.tier1_ids), True,
                                            jnp.asarray(match), k=5)
        np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v1.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
        checked += 1
    assert checked > 0
