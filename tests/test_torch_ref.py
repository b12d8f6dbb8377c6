"""The port's own configuration, stream generator, exact-PPR reference and
metrics (pprx_torch.config, .graph.io, .ref.exact, .eval.metrics) against
the JAX package's NumPy modules they stand in for."""

import dataclasses

import numpy as np
import pytest
import torch

import pprx.config as jcfg
import pprx_torch.config as tcfg
from pprx.eval import metrics as jmetrics
from pprx.graph.io import synthetic_powerlaw_stream as jax_stream
from pprx.ref.exact import exact_ppr as np_exact_ppr
from pprx.ref.exact import exact_ppr_matrix
from pprx_torch.eval import metrics as tmetrics
from pprx_torch.graph.io import synthetic_powerlaw_stream
from pprx_torch.ref.exact import exact_ppr, exact_ppr_columns, reverse_invariant_gap

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["PprConfig", "StreamConfig"])
def test_config_fields_match(name):
    fields = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, name))]


@pytest.mark.parametrize(
    "kind,kw",
    [
        ("PprConfig", dict(alpha=0.0)),
        ("PprConfig", dict(alpha=1.0)),
        ("PprConfig", dict(eps=0.0)),
        ("PprConfig", dict(max_rounds=0)),
        ("StreamConfig", dict(window=0, slide=1)),
        ("StreamConfig", dict(window=5, slide=6)),
    ],
)
def test_config_checks_match(kind, kw):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            getattr(mod, kind)(**kw)


@pytest.mark.parametrize("n,m,seed,exponent", [(35, 500, 11, 0.8), (2000, 20_000, 7, 0.8),
                                               (50, 3000, 2, 1.2)])
def test_stream_is_the_reference_stream(n, m, seed, exponent):
    got = synthetic_powerlaw_stream(n, m, seed=seed, exponent=exponent)
    ref = jax_stream(n, m, seed=seed, exponent=exponent)
    assert got[2] == ref[2]
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert not (got[0] == got[1]).any()


def test_exact_ppr_matches_reference():
    """Batched power iteration in torch against the scipy one, on a graph
    with parallel edges and dangling vertices; atol 1e-12 (both iterate to
    an L1 step of 1e-13)."""
    rng = np.random.default_rng(5)
    n = 60
    src = rng.integers(0, n - 10, size=400)  # vertices n-10.. are dangling
    dst = rng.integers(0, n, size=400)
    src, dst = np.concatenate([src, src[:30]]), np.concatenate([dst, dst[:30]])
    sources = [0, 7, n - 3]  # the last one is dangling
    got = exact_ppr(src, dst, n, sources, 0.15, tol=1e-13, device="cpu")
    assert got.shape == (3, n) and got.dtype == np.float64
    for row, s in zip(got, sources):
        ref = np_exact_ppr(src, dst, n, s, 0.15, tol=1e-13)
        np.testing.assert_allclose(row, ref, rtol=0, atol=1e-12)
        assert abs(row.sum() - 1.0) < 1e-12


def test_exact_ppr_columns_match_the_matrix():
    """The reverse oracle: column t of M = alpha (I - (1-alpha) P)^-1 by
    batched iteration against the dense inverse, on a graph with parallel
    edges and dangling vertices (one of them a target); and the rows
    against the same matrix. atol 1e-12 (iterated to an L1 step of 1e-14)."""
    rng = np.random.default_rng(6)
    n = 50
    src = rng.integers(0, n - 8, size=300)  # vertices n-8.. are dangling
    dst = rng.integers(0, n, size=300)
    src, dst = np.concatenate([src, src[:25]]), np.concatenate([dst, dst[:25]])
    M = exact_ppr_matrix(src, dst, n, 0.15)
    targets = [0, 9, n - 2, 9]  # a dangling one and a repeat
    cols = exact_ppr_columns(src, dst, n, targets, 0.15, tol=1e-14, device="cpu")
    assert cols.shape == (4, n) and cols.dtype == np.float64
    np.testing.assert_allclose(cols, M[:, targets].T, rtol=0, atol=1e-12)
    rows = exact_ppr(src, dst, n, targets, 0.15, tol=1e-14, device="cpu")
    np.testing.assert_allclose(rows, M[targets], rtol=0, atol=1e-12)
    assert np.abs(cols - rows).max() > 1e-3  # columns are not rows


def test_reverse_invariant_gap_matches_the_matrix():
    """``max |p + M r - M e_t|`` by one batched solve against the same
    expression from the dense inverse: on a random (p, r), whose gap is
    large, and on a state that holds the invariant, whose gap is 0; extra
    rows past n (the phantom row) are not read. atol 1e-12."""
    rng = np.random.default_rng(8)
    n = 50
    src = rng.integers(0, n - 8, size=300)  # vertices n-8.. are dangling
    dst = rng.integers(0, n, size=300)
    M = exact_ppr_matrix(src, dst, n, 0.15)
    targets = [3, n - 1, 17]
    p = rng.random((n + 1, 3))
    r = rng.random((n + 1, 3)) - 0.5
    want = np.abs(p[:n] + M @ r[:n] - M[:, targets]).max()
    got = reverse_invariant_gap(src, dst, n, targets, torch.from_numpy(p),
                                torch.from_numpy(r), 0.15, tol=1e-14)
    assert want > 0.1 and abs(got - want) < 1e-12
    p[:n] = M[:, targets] - M @ r[:n]
    assert reverse_invariant_gap(src, dst, n, targets, torch.from_numpy(p),
                                 torch.from_numpy(r), 0.15, tol=1e-14) < 1e-12


def test_metrics_match_reference():
    rng = np.random.default_rng(9)
    for _ in range(5):
        exact = rng.random(500).round(2)  # many ties at the k-th score
        approx = exact + rng.normal(scale=1e-2, size=500)
        pred = np.argsort(-approx)
        for k in (1, 10, 100):
            assert tmetrics.precision_at_k(pred, exact, k) == jmetrics.precision_at_k(
                pred, exact, k)
        assert tmetrics.l1_error(approx, exact) == jmetrics.l1_error(approx, exact)


def test_max_error_and_tie_aware_recall_match_reference():
    """The last two functions of pprx/eval/metrics.py: ``max_error``, and
    ``recall_at_k_ties`` on rankings with many ties at the k-th score,
    where tied vertices must not stand in for a missed better one."""
    rng = np.random.default_rng(11)
    for _ in range(5):
        exact = rng.random(500).round(2)
        approx = exact + rng.normal(scale=1e-2, size=500)
        pred = np.argsort(-approx)
        assert tmetrics.max_error(approx, exact) == jmetrics.max_error(approx, exact)
        for k in (1, 10, 100):
            assert tmetrics.recall_at_k_ties(pred, exact, k) == jmetrics.recall_at_k_ties(
                pred, exact, k)
    # a tied boundary at k: 2 strictly above, 3 tied for the last 2 slots
    exact = np.array([0.9, 0.8, 0.5, 0.5, 0.5, 0.1])
    for pred, want in (([0, 1, 2, 3], 1.0), ([2, 3, 4, 5], 0.5), ([0, 2, 3, 4], 0.75)):
        got = tmetrics.recall_at_k_ties(np.array(pred), exact, 4)
        assert got == jmetrics.recall_at_k_ties(np.array(pred), exact, 4) == want
