"""The plain reference, the generator and the arithmetic, held to the port
and to themselves on the CPU at tiny sizes."""

import numpy as np
import pytest
import torch

from benchmark import kernels
from benchmark.reference import checks, exact, perf
from benchmark.traffic.powerlaw import powerlaw_edges


def _edges(n, m, seed, exponent=0.8):
    return tuple(e.numpy() for e in powerlaw_edges(n, m, seed, exponent, "cpu"))


@pytest.mark.parametrize("n,m,seed,exponent", [(300, 5000, 7, 0.8), (1000, 20000, 2**31 + 5, 0.8),
                                                (50, 400, 11, 1.2)])
def test_the_generator_is_seeded_and_draws_no_self_loops(n, m, seed, exponent):
    src, dst = _edges(n, m, seed, exponent)
    again = _edges(n, m, seed, exponent)
    other = _edges(n, m, seed + 1, exponent)
    assert np.array_equal(src, again[0]) and np.array_equal(dst, again[1])
    assert not np.array_equal(src, other[0])
    assert src.dtype == dst.dtype == np.int32 and src.shape == dst.shape == (m,)
    assert src.min() >= 0 and max(src.max(), dst.max()) < n and not (src == dst).any()


@pytest.mark.parametrize("exponent", [0.8, 1.2])
def test_the_generator_draws_the_ports_popularity(exponent):
    """Each endpoint's popularity is rank^-exponent over some permutation:
    the sorted counts of ``src`` lie within a few deviations of m times the
    sorted popularity, as the port's draw (``synthetic_powerlaw_stream``)
    does."""
    from pprx_torch.graph.io import synthetic_powerlaw_stream as ported

    n, m = 200, 400_000
    want = np.arange(1, n + 1, dtype=np.float64) ** -exponent
    want = m * want / want.sum()
    for src in (_edges(n, m, 3, exponent)[0], ported(n, m, 3, exponent)[0]):
        got = np.sort(np.bincount(src, minlength=n))[::-1]
        assert np.all(np.abs(got - want) <= 5 * np.sqrt(want) + 5)


def test_solve_is_the_dense_solution():
    n, alpha = 60, 0.15
    src, dst = _edges(n, 500, 5)
    deg = exact.out_degree(src, n)
    P = np.zeros((n, n))
    np.add.at(P, (src, dst), 1.0 / deg[src])
    P[deg == 0, deg == 0] = 1.0  # a vertex without out-edges keeps its mass
    M = alpha * np.linalg.inv(np.eye(n) - (1 - alpha) * P)
    rhs = np.random.default_rng(0).standard_normal((n, 4))
    got = exact.solve(exact.transition_t(src, dst, n, "cpu"), torch.from_numpy(rhs), alpha)
    np.testing.assert_allclose(got.numpy(), (rhs.T @ M).T, rtol=0, atol=1e-11)


def test_window_edges_is_the_repeated_streams_window():
    src, dst = np.arange(10), np.arange(10) + 100
    s, d = exact.window_edges(src, dst, head=23, window=6)
    long = np.resize(src, 30)
    assert np.array_equal(s, long[17:23]) and np.array_equal(d, np.resize(dst, 30)[17:23])


def test_the_reference_agrees_with_the_ports_state_after_a_few_slides():
    """The port's fast driver on the CPU in f64: its state holds the push
    invariant against the reference's own window, is fresh, and its top-k
    after a refine misses no exact mass beyond near-ties."""
    from pprx_torch.config import PprConfig, StreamConfig
    from pprx_torch.graph.fast_stream import FastStreamDriver
    from pprx_torch.retrieve.topk import topk_candidates

    n, w, b, slides, alpha, k = 300, 3000, 150, 5, 0.15, 20
    src, dst = _edges(n, w + (slides + 1) * b, 4)
    sources = np.array([3, 40, 77, 150])
    drv = FastStreamDriver(src, dst, n, sources.tolist(), PprConfig(alpha=alpha, eps=1e-6),
                           StreamConfig(window=w, slide=b), rebuild_every=2,
                           dtype=torch.float64, device="cpu")
    drv.seed()
    assert len(list(drv.run(slides))) == slides
    p, r = drv.state.p.numpy(), drv.state.r.numpy()
    wsrc, wdst = exact.window_edges(src, dst, w + slides * b, w)
    pt = exact.transition_t(wsrc, wdst, n, "cpu")
    assert checks.inv_gap(pt, p, r, sources, alpha) < 1e-11
    assert checks.fresh(r, exact.out_degree(wsrc, n), 1e-6) <= 1.0
    drv.refine(1e-10)
    _, ids = topk_candidates(drv.state.p, k)
    pi = exact.solve(pt, exact.unit_columns(n, sources, "cpu"), alpha).numpy()
    assert checks.topk_ties(pi, ids.numpy(), k) < 1e-8  # against the exact top-k
    assert checks.topk_ties(drv.state.p[:n].numpy(), ids.numpy(), k) == 0.0


def test_the_top_k_numbers():
    scores = np.array([[0.5], [0.2], [0.2], [0.05], [0.05]])
    assert checks.topk_ties(scores, np.array([[0, 2]]), 2) == 0.0  # a tie either way
    assert checks.topk_ties(scores, np.array([[0, 0]]), 2) == pytest.approx(0.2)  # a repeat
    assert checks.topk_ties(scores, np.array([[0, 3]]), 2) == pytest.approx(0.15)
    assert checks.topk_ties(scores, np.array([[0, 9]]), 2) == pytest.approx(0.2)  # out of range


def test_fresh_is_the_largest_residual_over_its_threshold():
    r = np.array([[1e-6, -3e-6], [0.0, 1e-7], [5e-7, 0.0]], np.float32)
    assert checks.fresh(r, np.array([3, 4, 0]), 1e-6, block=2) == pytest.approx(1.0, rel=1e-6)


def test_the_arithmetic():
    assert perf.updates_per_s(10, 160_000, 2.0) == 1.6e6
    assert perf.idle_share(750.0, 1000.0) == pytest.approx(25.0)
    src = np.array([0, 2, 2, 1]); dst = np.array([1, 0, 2, 0])
    gat, off = kernels.forward_view(src, dst, 3, "cpu")
    assert gat.tolist() == [2, 1, 0, 2] and off.tolist() == [0, 2, 3, 4]
    assert kernels.k1_bytes(gat, 3, 8) == 3 * 8 * 4 + 4 * 4 + 2 * 3 * 8 * 4 + 4 * 4
    share = kernels.k1_share({"ms": 1.0, "bytes": 3.35e9})
    assert share == pytest.approx(100.0) and kernels.k1_share(None) is None
