"""Port of the dense engine and its driver (pprx_torch.engine.push,
pprx_torch.graph.stream) against the JAX package in f64: element by element
at 1e-12 with equal rounds (the same arithmetic in the same order on the
CPU), and against the exact-PPR matrix, both modes. The loop's round
(``dense_round_``: K2's and K1's plain versions over the window's
delivery-sorted view) against the reference's ``push_round``, and the loop
(K4's plain steps on the host) against its ``push_to_convergence``, with
its edge cases: a converged start and the round cap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pprx_torch.engine.update as tupdate
from pprx.config import PprConfig, StreamConfig
from pprx.engine.push import push_round as jax_push_round
from pprx.engine.push import push_to_convergence as jax_push_to_convergence
from pprx.engine.state import init_state as jax_init_state
from pprx.graph.dynamic import WindowGraph as JaxWindow
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.graph.stream import StreamDriver as JaxStreamDriver
from pprx.ref.exact import exact_ppr_matrix
import pprx_torch.engine.push as tpush
from pprx_torch.engine.push import (
    dense_round_,
    push_round,
    push_to_convergence,
)
from pprx_torch.engine.state import FORWARD, REVERSE, init_state
from pprx_torch.graph.dynamic import WindowGraph, delivery_view
from pprx_torch.graph.stream import StreamDriver
from tests.conftest import random_multigraph

torch.set_num_threads(1)

ALPHA = 0.2
CFG = PprConfig(alpha=ALPHA, eps=1e-7, max_rounds=10_000)
MODES = [FORWARD, REVERSE]


def _graph(seed, n=25, m=120, dangling=(3, 11)):
    """A multigraph in which the ``dangling`` vertices have no out-edge
    (one of them is a query below), in a ring with phantom padding."""
    rng = np.random.default_rng(seed)
    src, dst = random_multigraph(rng, n, m)
    for v in dangling:
        src[src == v] = (v + 1) % n
    dst[src == dst] = (dst[src == dst] + 1) % n
    return src, dst, n


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_push_to_convergence_matches_jax(mode, seed):
    src, dst, n = _graph(seed)
    queries = [0, 3, 7, 7, 24]  # a dangling query and a duplicate
    jst, jstats = jax_push_to_convergence(
        jax_init_state(n, queries, mode=mode, dtype=jnp.float64),
        JaxWindow.from_coo(src, dst, n, capacity=130), CFG)
    tst, tstats = push_to_convergence(
        init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu"),
        WindowGraph.from_coo(src, dst, n, capacity=130, device="cpu"), CFG)
    assert tstats.rounds == int(jstats.rounds) > 0
    assert tstats.syncs == tstats.rounds + 1
    assert tstats.pushes == float(jstats.pushes)
    assert tstats.edge_pushes == float(jstats.edge_pushes)
    np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=0, atol=1e-12)
    assert tst.p[-1].abs().sum() == 0 and tst.r[-1].abs().sum() == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_push_matches_exact_and_invariant(mode, seed):
    """The tests of tests/test_push_jax.py on the port: the invariant to
    1e-10 and p within eps * n of the exact matrix."""
    src, dst, n = _graph(seed)
    queries = [0, 3, 7, 7, 24]
    st, stats = push_to_convergence(
        init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu"),
        WindowGraph.from_coo(src, dst, n, device="cpu"), CFG)
    assert stats.rounds > 0 and stats.pushes > 0
    M = exact_ppr_matrix(src, dst, n, ALPHA)
    p, r = st.p.numpy()[:n], st.r.numpy()[:n]
    for j, q in enumerate(queries):
        if mode == FORWARD:
            lhs, tgt = p[:, j] + r[:, j] @ M, M[q]
        else:
            lhs, tgt = p[:, j] + M @ r[:, j], M[:, q]
        np.testing.assert_allclose(lhs, tgt, rtol=0, atol=1e-10)
        assert np.abs(p[:, j] - tgt).max() < CFG.eps * n


@pytest.mark.parametrize("block_edges", [1, 9, 10**6])
@pytest.mark.parametrize("mode", MODES)
def test_push_round_in_edge_blocks_matches_jax(monkeypatch, mode, block_edges):
    """One round from a mid-push state with the ring cut into edge blocks of
    any size: the state and both counts are the reference's."""
    src, dst, n = _graph(2)
    queries = [0, 3, 9]
    cfg = PprConfig(alpha=ALPHA, eps=1e-3)
    jw = JaxWindow.from_coo(src, dst, n, capacity=128)
    tw = WindowGraph.from_coo(src, dst, n, capacity=128, device="cpu")
    jst = jax_init_state(n, queries, mode=mode, dtype=jnp.float64)
    tst = init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu")
    monkeypatch.setattr(tupdate, "EDGE_BLOCK_BYTES", block_edges * len(queries) * 8)
    for _ in range(3):
        jst, jna, jew = jax_push_round(jst, jw, cfg)
        tst, tna, tew = push_round(tst, tw, cfg)
        assert int(tna) == float(jna) and int(tew) == float(jew) and int(tew) > 0
        np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [2, 4])
def test_dense_round_matches_jax_push_round(mode, seed):
    """Three of the loop's rounds (``dense_round_``: the plain K2 and K1 in
    place over the delivery-sorted view) from the initial state, with
    dangling rows and a ring above its edge count: p and r the reference's
    ``push_round``'s at 1e-12, the active pairs and edge pushes equal."""
    src, dst, n = _graph(seed)
    queries = [0, 3, 9, 11]  # 3 and 11 dangling
    cfg = PprConfig(alpha=ALPHA, eps=1e-3)
    jw = JaxWindow.from_coo(src, dst, n, capacity=137)
    tw = WindowGraph.from_coo(src, dst, n, capacity=137, device="cpu")
    assert int((tw.deg[:n] == 0).sum()) >= 2
    jst = jax_init_state(n, queries, mode=mode, dtype=jnp.float64)
    tst = init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu")
    view = delivery_view(tw, mode)
    counts = torch.zeros(2, dtype=torch.int64)
    for _ in range(3):
        jst, jna, jew = jax_push_round(jst, jw, cfg)
        dense_round_(tst, tw.deg, [(view.gat, view.off)], cfg, counts)
        assert counts.tolist() == [float(jna), float(jew)] and int(jew) > 0
        np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=0, atol=1e-12)
        assert tst.p[-1].abs().sum() == 0 and tst.r[-1].abs().sum() == 0


@pytest.mark.parametrize("mode", MODES)
def test_delivery_view_sorts_the_ring_stably(mode):
    """The view holds every edge once, grouped by the receiving endpoint in
    ring order, each beside its other endpoint; the phantom padding sorts
    past the real rows."""
    src, dst, n = _graph(5)
    tw = WindowGraph.from_coo(src, dst, n, capacity=130, device="cpu")
    view = delivery_view(tw, mode)
    sca, gat = (dst, src) if mode == FORWARD else (src, dst)
    order = np.argsort(sca, kind="stable")
    assert view.off.dtype == view.gat.dtype == torch.int32 and view.off.shape == (n + 1,)
    np.testing.assert_array_equal(view.gat.numpy()[:len(src)], gat[order])
    np.testing.assert_array_equal(view.gat.numpy()[len(src):], n)
    np.testing.assert_array_equal(view.off.numpy(),
                                  np.searchsorted(sca[order], np.arange(n + 1)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["converged", "capped"])
def test_push_to_convergence_edge_cases_match_jax(monkeypatch, mode, case):
    """From a converged state the loop runs no round, as the reference's
    (its first count is 0), and leaves the state alone; under a round cap
    it stops at the cap with the reference's state. Neither runs the
    ring's round (``push_round``)."""
    def ring_round(*a, **k):
        raise AssertionError("the loop ran the ring's round")

    monkeypatch.setattr(tpush, "push_round", ring_round)
    src, dst, n = _graph(1)
    queries = [0, 3, 7]
    jw = JaxWindow.from_coo(src, dst, n, capacity=130)
    tw = WindowGraph.from_coo(src, dst, n, capacity=130, device="cpu")
    jst = jax_init_state(n, queries, mode=mode, dtype=jnp.float64)
    tst = init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu")
    cfg = CFG
    if case == "converged":
        jst, _ = jax_push_to_convergence(jst, jw, CFG)
        tst, _ = push_to_convergence(tst, tw, CFG)
    else:
        cfg = PprConfig(alpha=ALPHA, eps=1e-7, max_rounds=4)
    jst, jstats = jax_push_to_convergence(jst, jw, cfg)
    before = (tst.p.clone(), tst.r.clone())
    tst, tstats = push_to_convergence(tst, tw, cfg)
    want = {"converged": 0, "capped": 4}[case]
    assert tstats.rounds == int(jstats.rounds) == want
    assert tstats.syncs == want + 1
    assert (tstats.pushes, tstats.edge_pushes) == (float(jstats.pushes),
                                                   float(jstats.edge_pushes))
    if case == "converged":
        assert torch.equal(tst.p, before[0]) and torch.equal(tst.r, before[1])
    else:
        assert tstats.pushes > 0
    np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=0, atol=1e-12)


def _drivers(mode, scfg, seed=11, n=35, total=500, queries=(0, 6, 17)):
    src, dst, _ = synthetic_powerlaw_stream(n, total, seed=seed)
    cfg = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)
    a = JaxStreamDriver(src, dst, n, list(queries), cfg, scfg, mode=mode, dtype=jnp.float64)
    b = StreamDriver(src, dst, n, list(queries), cfg, scfg, mode=mode, dtype=torch.float64,
                     device="cpu")
    return a, b, src, dst


@pytest.mark.parametrize("mode", MODES)
def test_dense_stream_matches_jax(mode):
    a, b, _, _ = _drivers(mode, StreamConfig(window=250, slide=25))
    assert b.seed().rounds == int(a.seed().rounds)
    assert b.steps_available == a.steps_available == 10
    ra = [int(s.rounds) for s in a.run(10)]
    rb = [s.rounds for s in b.run(10)]
    assert ra == rb
    np.testing.assert_allclose(b.state.p.numpy(), np.asarray(a.state.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.state.r.numpy(), np.asarray(a.state.r), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(b.graph.deg.numpy(), np.asarray(a.graph.deg))
    np.testing.assert_array_equal(b.graph.src.numpy(), np.asarray(a.graph.src))
    assert (b.head, b.step_idx, b.steps_available) == (a.head, a.step_idx, 0)
    assert list(b.run()) == []  # the stream has ended


def test_dense_reverse_slides_take_their_row_sums_from_the_view(monkeypatch):
    """In reverse each slide's old row sums are K1 over the driver's held
    delivery view (still the old window's): equal to ``out_row_sums`` of
    the ring at 1e-12 on every slide, which the driver no longer calls, and
    the stream matches the reference at 1e-12 with equal rounds."""
    import pprx_torch.graph.stream as tstream

    seen = []
    apply, row_sums = tstream.apply_edge_batch_, tupdate.out_row_sums

    def spy(state, graph, *args, rowsum=None, **kw):
        assert rowsum is not None
        np.testing.assert_allclose(rowsum.numpy(), row_sums(state.p, graph).numpy(), rtol=0,
                                   atol=1e-12)
        seen.append(float(rowsum.abs().sum()))
        return apply(state, graph, *args, rowsum=rowsum, **kw)

    monkeypatch.setattr(tstream, "apply_edge_batch_", spy)
    a, b, _, _ = _drivers(REVERSE, StreamConfig(window=250, slide=25))
    a.seed(), b.seed()
    monkeypatch.setattr(tupdate, "out_row_sums", None)  # a call would raise
    ra = [int(st.rounds) for st in a.run(4)]
    rb = [st.rounds for st in b.run(4)]
    assert ra == rb and len(seen) == 4 and min(seen) > 0
    np.testing.assert_allclose(b.state.p.numpy(), np.asarray(a.state.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.state.r.numpy(), np.asarray(a.state.r), rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_dense_stream_per_edge_mode(mode):
    """``slide=1``: every edge event is absorbed before the next is read.
    Equal to the JAX driver after 40 events, and exact on the final window
    to eps * n."""
    n, w = 20, 60
    a, b, src, dst = _drivers(mode, StreamConfig(window=w, slide=1), seed=2, n=n, total=100,
                              queries=(1, 4))
    a.seed(), b.seed()
    ra = [int(s.rounds) for s in a.run(40)]
    rb = [s.rounds for s in b.run(40)]
    assert ra == rb and b.head == w + 40
    np.testing.assert_allclose(b.state.p.numpy(), np.asarray(a.state.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.state.r.numpy(), np.asarray(a.state.r), rtol=0, atol=1e-12)
    M = exact_ppr_matrix(src[40 : w + 40], dst[40 : w + 40], n, 0.2)
    p = b.state.p.numpy()[:n]
    for j, q in enumerate((1, 4)):
        tgt = M[q] if mode == FORWARD else M[:, q]
        assert np.abs(p[:, j] - tgt).max() < 1e-8 * n


def test_dense_driver_refuses_a_short_stream():
    src, dst, _ = synthetic_powerlaw_stream(20, 50, seed=1)
    with pytest.raises(ValueError, match="shorter"):
        StreamDriver(src, dst, 20, [0], CFG, StreamConfig(window=60, slide=5), device="cpu")
