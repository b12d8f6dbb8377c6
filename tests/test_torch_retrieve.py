"""Port of the top-k head (pprx_torch.retrieve.topk): the cases of
tests/test_retrieve.py on a state converged by the port's wl2 engine, and
the CPU head (the kernel's plain version) on ``_topk_cases``' grid; the
kernel's own cases are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from pprx.config import PprConfig
from pprx.eval.metrics import l1_error, precision_at_k
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.ref.exact import exact_ppr
from pprx_torch.engine.state import FORWARD, init_state
from pprx_torch.engine.wl2 import build_kill_graph, make_tiers2, push_to_convergence_wl2
from pprx_torch.graph.dynamic import WindowGraph
from pprx_torch.retrieve.topk import plan, retrieve, topk_candidates

import _topk_cases  # tests/ is on the path

torch.set_num_threads(1)

ALPHA = 0.15
CFG = PprConfig(alpha=ALPHA, eps=1e-9, max_rounds=10_000)


def test_topk_matches_exact_ranking():
    n, m = 120, 900
    src, dst, _ = synthetic_powerlaw_stream(n, m, seed=4)
    kg = build_kill_graph(WindowGraph.from_coo(src, dst, n, device="cpu"), FORWARD, fring=8)
    queries = [0, 3, 17, 50]
    state = init_state(n, queries, mode=FORWARD, dtype=torch.float64, device="cpu")
    # c0ok=False: the first round is a scan, as refine starts
    state, stats = push_to_convergence_wl2(
        state, kg, CFG, torch.full((8,), n, dtype=torch.int32), 0, False,
        make_tiers2(n, m, 8, 512),
    )
    assert stats.rounds > 0
    k = 20
    scores, ids = retrieve(state, k=k)
    assert scores.shape == (len(queries), k) and ids.shape == (len(queries), k)
    for j, q in enumerate(queries):
        pi = exact_ppr(src, dst, n, q, ALPHA)
        assert precision_at_k(ids[j].numpy(), pi, k) == 1.0
        # forward-push L1 bound: sum_v |r(v)| <= eps * E
        assert l1_error(state.p.numpy()[:n, j], pi) < CFG.eps * m
        assert (np.diff(scores[j].numpy()) <= 1e-15).all()


def test_approx_head_is_exact():
    """torch has no approx_max_k: exact=False gives the exact answer, and
    the ids hold the returned scores (duplicate scores included)."""
    rng = np.random.default_rng(11)
    p = rng.random((1001, 4)).astype(np.float32)
    p[50:60, :] = 0.5
    p = torch.from_numpy(p)
    sc, ids = topk_candidates(p, k=7, exact=False)
    ref = torch.topk(p[:-1].T, 7, dim=1).values
    np.testing.assert_array_equal(sc.numpy(), ref.numpy())
    got = np.take_along_axis(p[:-1].T.numpy(), ids.numpy(), axis=1)
    np.testing.assert_array_equal(got, sc.numpy())
    assert int(ids.max()) < 1000  # the phantom row is never a candidate


N_PLAIN = 600


@pytest.mark.parametrize("k", _topk_cases.TOPS)
@pytest.mark.parametrize("s", _topk_cases.SHAPES)
def test_plain_head_grid(s, k):
    """The CPU head (``topk_plain``) against numpy's lexsort: ties at the
    k-th position and an all-zero column go to the lowest ids, negative
    scores order as floats, the phantom row (+inf) is never a candidate,
    and the scores are p's own bits (-0.0 stays -0.0)."""
    k = k or N_PLAIN
    p = _topk_cases.state(N_PLAIN, s, k)
    got = topk_candidates(p, k)
    assert got[0].shape == (s, k) and got[1].shape == (s, k)
    _topk_cases.same_bits(got, _topk_cases.expected(p, k))
    assert int(got[1].max()) < N_PLAIN


@pytest.mark.parametrize("n,k", [(1, 1), (5, 5), (600, 1), (600, 100), (50_000, 100),
                                 (300_000, 100), (8_000_000, 100), (8_000_000, 10),
                                 (4_847_571, 100), (2**31 - 2, 2**20)])
def test_kernel_plan(n, k):
    """The kernel's sample and list sizes: at least k sampled rows, all
    below N; the list holds the sample, at most N, and more than k wherever
    it is below N (so that a column that overflows it sheds ranks on every
    pass it takes again)."""
    pl = plan(n, k)
    assert pl.m >= k and (pl.m - 1) * pl.stride < n <= pl.m * pl.stride
    assert pl.m <= pl.cap <= n
    assert pl.cap == n or pl.cap > k


def test_head_refuses_what_it_does_not_take():
    p = torch.zeros(11, 3)
    for k in (0, 11):
        with pytest.raises(ValueError, match="k must be"):
            topk_candidates(p, k)
    with pytest.raises(ValueError, match="must be"):
        topk_candidates(torch.zeros(11), 1)
