"""Port of the top-k head (pprx_torch.retrieve.topk): the cases of
tests/test_retrieve.py on a state converged by the port's wl2 engine."""

import numpy as np
import torch

from pprx.config import PprConfig
from pprx.eval.metrics import l1_error, precision_at_k
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.ref.exact import exact_ppr
from pprx_torch.engine.state import FORWARD, init_state
from pprx_torch.engine.wl2 import build_kill_graph, make_tiers2, push_to_convergence_wl2
from pprx_torch.graph.dynamic import WindowGraph
from pprx_torch.retrieve.topk import retrieve, topk_candidates

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
