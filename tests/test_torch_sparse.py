"""Port of the hybrid engine's rounds and loops (pprx_torch.engine.frontier,
pprx_torch.engine.sparse) against the JAX package in f64, both modes.

The round-level cases feed both engines the JAX driver's mid-stream graph
(a snapshot two slides stale and a live overlay of their 100 changes),
carried with ``pprx_torch.convert.hybrid_graph_from_arrays``: p and r at
1e-12 and equal counts. Index work (snapshot, expansion, compaction,
deduplication, the next candidates and their bounds) is held element for
element. The loops are held to equal rounds and counters.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pprx.engine.frontier as jfrontier
import pprx.engine.sparse as jsparse
from pprx.config import PprConfig, StreamConfig
from pprx.engine.push import push_to_convergence as jax_push_to_convergence
from pprx.engine.state import init_state as jax_init_state
from pprx.graph.dynamic import WindowGraph as JaxWindow
from pprx.graph.hybrid_stream import HybridStreamDriver as JaxHybridDriver
from pprx.graph.io import synthetic_powerlaw_stream
from pprx_torch.convert import hybrid_graph_from_arrays, hybrid_graph_to_arrays
from pprx_torch.engine import frontier, sparse
from pprx_torch.engine.push import _active_mask, push_round
from pprx_torch.engine.state import FORWARD, REVERSE, PprState, init_state
from pprx_torch.graph.dynamic import WindowGraph
from tests.conftest import random_multigraph

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)
LOOSE = PprConfig(alpha=0.2, eps=1e-10, max_rounds=10_000)  # rounds with work to do
MODES = [FORWARD, REVERSE]
N = 35


def jax_graph_arrays(g) -> dict:
    """A JAX HybridGraph as the arrays ``hybrid_graph_from_arrays`` takes."""
    parts = {"": g.window, "snap_": g.snap, "ov_": g.ov}
    keys = {"": ("src", "dst", "deg"), "snap_": ("offsets", "nbr", "row_len"),
            "ov_": ("src", "dst", "sign")}
    return {f"{p}{k}": np.asarray(getattr(obj, k)) for p, obj in parts.items() for k in keys[p]}


def port_state(jstate) -> PprState:
    return PprState(p=torch.from_numpy(np.array(jstate.p)),
                    r=torch.from_numpy(np.array(jstate.r)), mode=int(jstate.mode))


def assert_state(tst, jst, atol=1e-12):
    np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=0, atol=atol)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=0, atol=atol)


@functools.lru_cache(maxsize=None)
def jax_mid_stream(mode, slide):
    """The JAX hybrid driver on tests/test_wl2.py's stream after 2 slides
    (rebuild_every=3: no rebuild yet): (state, graph), a snapshot of the
    first window and an overlay of 2b changes a slide. JAX arrays are
    immutable, so the pair is shared between tests."""
    src, dst, _ = synthetic_powerlaw_stream(N, 500, seed=11)
    drv = JaxHybridDriver(src, dst, N, [0, 6, 17], CFG, StreamConfig(window=250, slide=slide),
                          mode=mode, dtype=jnp.float64, rebuild_every=3)
    drv.seed()
    list(drv.run(2))
    return drv.state, drv.graph


def mid_stream(mode):
    """(JAX state, JAX graph, the port's copy of the graph) mid-stream."""
    jst, jg = jax_mid_stream(mode, 25)
    return jst, jg, hybrid_graph_from_arrays(jax_graph_arrays(jg), device="cpu")


def test_graph_arrays_cross_both_ways():
    _, jg, tg = mid_stream(FORWARD)
    arrays = jax_graph_arrays(jg)
    assert int((arrays["ov_sign"] != 0).sum()) == 100  # a live overlay
    back = hybrid_graph_to_arrays(tg)
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == np.int32, k
        np.testing.assert_array_equal(back[k], v, k)


@pytest.mark.parametrize("mode", MODES)
def test_build_snapshot_matches_jax(mode):
    rng = np.random.default_rng(3)
    n, m = 30, 150
    src, dst = random_multigraph(rng, n, m)
    jw = JaxWindow.from_coo(src, dst, n, capacity=170)  # phantom padding too
    tw = WindowGraph.from_coo(src, dst, n, capacity=170, device="cpu")
    jh = jsparse.HybridGraph.build(jw, mode, overlay_cap=16)
    th = sparse.HybridGraph.build(tw, mode, overlay_cap=16)
    for k in ("offsets", "nbr", "row_len"):
        got, want = getattr(th.snap, k), np.asarray(getattr(jh.snap, k))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, k)
    for k in ("src", "dst", "sign"):
        np.testing.assert_array_equal(getattr(th.ov, k).numpy(), np.asarray(getattr(jh.ov, k)))


FRONTIERS = [
    # rows longer than ecap, empty rows, phantom padding, a row cut mid-way
    ([3, 0, 7, 12, 35, 35], 8),
    ([3, 0, 7, 12, 35, 35], 64),
    ([35, 35, 35], 4),  # nothing but padding
    ([12, 5, 5, 20], 3),  # a repeated row
    (list(range(35)), 256),
]


@pytest.mark.parametrize("fidx,ecap", FRONTIERS)
def test_expand_matches_jax(fidx, ecap):
    _, jg, tg = mid_stream(FORWARD)
    assert int(tg.snap.row_len[:N].max()) > 8  # a row longer than the smaller ecaps
    f = np.asarray(fidx, np.int32)
    want = jfrontier.expand(jnp.asarray(f), jg.snap, ecap)
    got = frontier.expand(torch.from_numpy(f), tg.snap, ecap)
    for g, w, k in zip(got, want, ("t", "nbr", "valid", "total")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), k)


@pytest.mark.parametrize("fcap", [1, 6, 36, 50])
def test_compact_frontier_matches_jax(fcap):
    mask = np.random.default_rng(fcap).random(N + 1) < 0.3
    mask[N] = True  # the phantom row is never a frontier row
    want = jfrontier.compact_frontier(jnp.asarray(mask), fcap, N)
    got = frontier.compact_frontier(torch.from_numpy(mask), fcap, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ids,cap", [
    ([5, 3, 5, 35, 0, 3, 35, 12], 8),
    ([5, 3, 5, 35, 0, 3, 35, 12], 3),  # the count exceeds cap: cut
    ([35, 35], 4),
    (list(range(35, -1, -1)), 40),
])
def test_dedup_compact_matches_jax(ids, cap):
    a = np.asarray(ids, np.int32)
    w_ids, w_n = jsparse._dedup_compact(jnp.asarray(a), cap, N)
    t_ids, t_n = sparse._dedup_compact(torch.from_numpy(a), cap, N)
    assert int(t_n) == int(w_n)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(w_ids))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rebuilt", [False, True], ids=["stale", "rebuilt"])
def test_sparse_round_matches_jax(mode, rebuilt):
    """One sparse round over the stale snapshot and the live overlay, and
    after a rebuild (the overlay folded in): the JAX round's p, r and
    counts, and the dense round over the live window."""
    jst, jg, tg = mid_stream(mode)
    if rebuilt:
        jg, tg = jsparse.rebuild_snapshot(jg, mode), sparse.rebuild_snapshot(tg, mode)
        assert int(tg.ov.sign.abs().sum()) == 0
    j2, jna, jew = jsparse.sparse_round(jst, jg, LOOSE, N + 1, 400)
    t2, tna, tew = sparse.sparse_round(port_state(jst), tg, LOOSE, N + 1, 400)
    assert int(tna) == float(jna) > 0 and int(tew) == float(jew)
    assert_state(t2, j2)
    d2, dna, _ = push_round(port_state(jst), tg.window, LOOSE)
    assert int(dna) == int(tna)
    np.testing.assert_allclose(t2.p.numpy(), d2.p.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t2.r.numpy(), d2.r.numpy(), rtol=0, atol=1e-12)


def test_frontier_edge_count_matches_jax():
    jst, jg, tg = mid_stream(FORWARD)
    want = jsparse.frontier_edge_count(jst, jg, LOOSE, N + 1)
    got = sparse.frontier_edge_count(port_state(jst), tg, LOOSE, N + 1)
    assert [int(x) for x in got] == [int(x) for x in want]


def sparse_front(mode, budget=60):
    """A mid-stream graph whose overlay is small beside the window (slides
    of 10: 40 live entries in a capacity of 60), and the JAX driver's state
    with its residual kept only at a few rows that gather overlay entries,
    at most ``budget`` snapshot edges in all (the shape of a frontier after
    a slide): (JAX state, JAX graph, port graph)."""
    jst, jg = jax_mid_stream(mode, 10)
    arrays = jax_graph_arrays(jg)
    gat = arrays["ov_src" if mode == FORWARD else "ov_dst"][arrays["ov_sign"] != 0]
    rows, used = [], 0
    for v in dict.fromkeys(gat.tolist()):
        if used + arrays["snap_row_len"][v] <= budget:
            rows.append(v)
            used += arrays["snap_row_len"][v]
    r = np.zeros_like(np.asarray(jst.r))
    r[rows] = np.asarray(jst.r)[rows] + 1e-3  # above every threshold
    return jst.replace(r=jnp.asarray(r)), jg, hybrid_graph_from_arrays(arrays, device="cpu")


def with_overlay_cap(jg, tg, cap):
    """Both graphs with their live overlay in a ring of ``cap`` entries."""
    def pad(a, fill):
        return np.concatenate([a, np.full(cap - a.shape[0], fill, np.int32)])

    arrays = hybrid_graph_to_arrays(tg)
    for k, fill in (("ov_src", N), ("ov_dst", N), ("ov_sign", 0)):
        arrays[k] = pad(arrays[k], fill)
    jov = jfrontier.Overlay(*(jnp.asarray(arrays[f"ov_{k}"]) for k in ("src", "dst", "sign")))
    return jg.replace(ov=jov), hybrid_graph_from_arrays(arrays, device="cpu")


# (tiers, overlay capacity, the branch the round must take)
ADAPTIVE = [
    (((36, 400),), None, "sparse"),
    (((2, 8), (36, 400)), None, "sparse"),  # tier 0 too small: tier 1
    (((36, 400), (36, 800)), None, "sparse"),  # tier 0
    (((36, 4),), None, "dense"),  # tiny ecap: the dense fallback
    (((1, 400),), None, "dense"),  # frontier rows over fcap
    (((36, 400),), 400, "dense"),  # a big overlay: not worth it
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tiers,ovcap,branch", ADAPTIVE)
def test_adaptive_round_tiered_matches_jax(mode, tiers, ovcap, branch):
    """Each branch of the tiered scan round on a stale snapshot and a live
    overlay: the JAX round's state and counts. The branch shows in
    ``edge_work``: snapshot row lengths (sparse) or degrees (dense)."""
    jst, jg, tg = sparse_front(mode)
    if ovcap is not None:
        jg, tg = with_overlay_cap(jg, tg, ovcap)
    j2, jna, jew = jsparse.adaptive_round_tiered(jst, jg, LOOSE, tiers)
    t2, tna, tew = sparse.adaptive_round_tiered(port_state(jst), tg, LOOSE, tiers)
    assert (int(tna), int(tew)) == (float(jna), float(jew))
    assert_state(t2, j2)
    act = _active_mask(port_state(jst), tg.window, LOOSE)
    assert 1 < int(act.any(dim=1).sum()) <= 36
    sparse_ew = int((act.sum(dim=1) * tg.snap.row_len).sum())
    dense_ew = int(push_round(port_state(jst), tg.window, LOOSE)[2])
    assert dense_ew != sparse_ew
    assert int(tew) == (dense_ew if branch == "dense" else sparse_ew)


def test_adaptive_round_is_the_single_tier():
    jst, jg, tg = mid_stream(FORWARD)
    j2, jna, _ = jsparse.adaptive_round(jst, jg, LOOSE, N + 1, 2)
    t2, tna, _ = sparse.adaptive_round(port_state(jst), tg, LOOSE, N + 1, 2)
    assert int(tna) == float(jna)
    assert_state(t2, j2)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fcap,ecap,ovacap", [(36, 400, 0), (36, 400, 120), (12, 200, 30)])
def test_worklist_round_matches_jax(mode, fcap, ecap, ovacap):
    """A worklist round from a candidate list of every row holding residual
    and some that do not: the state, the next list, its count and bounds."""
    jst, jg, tg = mid_stream(mode)
    rows = np.flatnonzero(np.abs(np.asarray(jst.r)[:N]).max(axis=1) > 0)
    ids = np.concatenate([rows, [1, 2, 3]]).astype(np.int32)
    cand, _ = jsparse._dedup_compact(jnp.asarray(ids), 48, N)
    jout = jsparse.worklist_round(jst, jg, LOOSE, cand, fcap, ecap, ovacap)
    tout = sparse.worklist_round(port_state(jst), tg, LOOSE,
                                 torch.from_numpy(np.array(cand)), fcap, ecap, ovacap)
    assert_state(tout[0], jout[0])
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert [int(x) for x in tout[2:5]] == [int(jout[2]), float(jout[3]), float(jout[4])]
    assert int(tout[2]) > 0 and int(tout[3]) > 0
    assert {k: int(v) for k, v in tout[5].items()} == {k: int(v) for k, v in jout[5].items()}
    assert int(tout[5]["live_ub"]) > 0  # the overlay sweep had live entries


def test_make_tiers_matches_jax():
    for args in ((32_768, 65_536, 8192), (640_000, 1_280_000, 640_000), (64, 512, 16),
                 (10_000, 20_000, 4096)):
        for n_tiers in (1, 3, 5):
            assert sparse.make_tiers(*args, n_tiers=n_tiers) == jsparse.make_tiers(
                *args, n_tiers=n_tiers)


def _stats(s) -> tuple:
    return tuple(int(getattr(s, k)) for k in ("rounds", "pushes", "edge_pushes", "wl_rounds",
                                              "scans_cand", "scans_fed", "scans_liv"))


LOOP_TIERS = [
    ((64, 512, 16),),  # comfortable: every round but the seed scan a worklist round
    ((8, 512, 16),),  # candidate overflow -> scans
    ((64, 8, 16),),  # expansion overflow -> scans
    ((64, 512, 1),),  # overlay-live overflow -> scans
    ((8, 64, 4), (64, 512, 16)),  # a two-tier ladder
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tiers", LOOP_TIERS)
@pytest.mark.parametrize("start", ["scan", "list"])
def test_worklist_loop_matches_jax(mode, tiers, start):
    """push_to_convergence_worklist on the mid-stream graph from the JAX
    state (``start="list"``: seeded with every row holding residual, as a
    slide seeds it; ``"scan"``: no list), at ``LOOSE``: the same rounds,
    counters, p and r."""
    jst, jg, tg = mid_stream(mode)
    wcap = tiers[-1][0]
    if start == "list":
        rows = np.flatnonzero(np.abs(np.asarray(jst.r)[:N]).max(axis=1) > 0).astype(np.int32)
        cand0, c0n = jsparse._dedup_compact(jnp.asarray(rows), wcap, N)
        ok = int(c0n) <= wcap
    else:
        cand0, ok = jnp.full(wcap, N, jnp.int32), False
    scan = (N + 1, 120)
    j2, js = jsparse.push_to_convergence_worklist(jst, jg, LOOSE, cand0, ok, tiers, *scan)
    t2, ts = sparse.push_to_convergence_worklist(
        port_state(jst), tg, LOOSE, torch.from_numpy(np.array(cand0)), ok, tiers, *scan)
    assert _stats(ts) == _stats(js)
    assert_state(t2, j2)
    # the host loop: one read after the prologue and one after each arm,
    # a round or a count of the frontier (before a scan that follows a
    # worklist round)
    assert ts.syncs == ts.rounds + ts.arms["count"] + 1
    assert ts.rounds > 0


@pytest.mark.parametrize("mode", MODES)
def test_worklist_loop_counters_are_exercised(mode):
    """Across LOOP_TIERS the loop takes every branch: worklist rounds at
    both tiers and scans for each reason."""
    jst, _, tg = mid_stream(mode)
    seen = np.zeros(4, int)
    for tiers in LOOP_TIERS:
        wcap = tiers[-1][0]
        rows = np.flatnonzero(np.abs(np.asarray(jst.r)[:N]).max(axis=1) > 0).astype(np.int32)
        cand0, _ = sparse._dedup_compact(torch.from_numpy(rows), wcap, N)
        _, ts = sparse.push_to_convergence_worklist(port_state(jst), tg, LOOSE, cand0, True,
                                                    tiers, N + 1, 120)
        seen += [ts.wl_rounds, ts.scans_cand, ts.scans_fed, ts.scans_liv]
    assert (seen > 0).all(), seen


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tiers", [
    ((8, 512, 16), (64, 512, 16)),
    ((8, 64, 16), (24, 512, 16), (64, 512, 16)),
])
def test_multitier_overflow_does_not_drop_candidates(mode, tiers):
    """tests/test_worklist.py's case on the port: a star graph whose hub,
    pushed from a one-row frontier at the smallest tier, activates more
    leaves than that tier's wcap. The list must be judged cut against the
    tier used: the JAX loop's rounds and state, every residual under its
    threshold."""
    n, hub = 30, 0
    src = np.array([hub] * (n - 1) + list(range(1, n)), dtype=np.int64)
    dst = np.array(list(range(1, n)) + [hub] * (n - 1), dtype=np.int64)
    queries = [hub, 5]
    wcap = tiers[-1][0]
    jh = jsparse.HybridGraph.build(JaxWindow.from_coo(src, dst, n), mode, overlay_cap=8)
    cand0, _ = jsparse._dedup_compact(jnp.asarray(queries, jnp.int32), wcap, n)
    j2, js = jsparse.push_to_convergence_worklist(
        jax_init_state(n, queries, mode=mode, dtype=jnp.float64), jh, CFG, cand0, True, tiers,
        n + 1, len(src) + 20)
    th = sparse.HybridGraph.build(WindowGraph.from_coo(src, dst, n, device="cpu"), mode, 8)
    t2, ts = sparse.push_to_convergence_worklist(
        init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu"), th, CFG,
        torch.from_numpy(np.array(cand0)), True, tiers, n + 1, len(src) + 20)
    assert _stats(ts) == _stats(js) and ts.scans_cand > 0
    assert_state(t2, j2, atol=1e-13)
    deg = np.bincount(src, minlength=n + 1)
    thresh = (CFG.eps * np.maximum(deg, 1))[:, None] if mode == FORWARD else CFG.eps
    assert (np.abs(t2.r.numpy()) <= thresh).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ecap", [400, 6])
def test_hybrid_loop_matches_jax(mode, ecap):
    """push_to_convergence_hybrid from a cold state (the seed's loop) and
    from the mid-stream state: rounds, counters, p and r; one read a round
    and one before the first. ``ecap`` 6 sends the big rounds dense."""
    jst, jg, tg = mid_stream(mode)
    queries = [0, 6, 17]
    cold = (jax_init_state(N, queries, mode=mode, dtype=jnp.float64),
            init_state(N, queries, mode=mode, dtype=torch.float64, device="cpu"))
    for js0, ts0, cfg in ((jst, port_state(jst), LOOSE), (*cold, CFG)):
        j2, js = jsparse.push_to_convergence_hybrid(js0, jg, cfg, N + 1, ecap)
        t2, ts = sparse.push_to_convergence_hybrid(ts0, tg, cfg, N + 1, ecap)
        assert _stats(ts) == _stats(js) and ts.rounds > 0
        assert ts.syncs == ts.rounds + 1
        assert_state(t2, j2)


@pytest.mark.parametrize("mode", MODES)
def test_loops_agree_with_the_dense_engine(mode):
    """On a fresh snapshot (empty overlay) both loops reach the dense
    engine's state in its number of rounds (tests/test_sparse.py and
    tests/test_worklist.py's check, against the JAX dense loop)."""
    rng = np.random.default_rng(5)
    n, m = 40, 220
    src, dst = random_multigraph(rng, n, m)
    queries = [0, 11, 22]
    jd, jds = jax_push_to_convergence(jax_init_state(n, queries, mode=mode, dtype=jnp.float64),
                                      JaxWindow.from_coo(src, dst, n), CFG)
    th = sparse.HybridGraph.build(WindowGraph.from_coo(src, dst, n, device="cpu"), mode, 8)

    def cold():
        return init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu")

    for st, stats in (
        sparse.push_to_convergence_hybrid(cold(), th, CFG, n + 1, m + 20),
        sparse.push_to_convergence_worklist(cold(), th, CFG, torch.full((64,), n, dtype=torch.int32),
                                            False, ((64, 512, 16),), n + 1, m + 20),
    ):
        assert stats.rounds == int(jds.rounds)
        assert_state(st, jd, atol=1e-13)


def test_idle_list_runs_no_round():
    """A valid list with no candidate is an idle slide: 0 rounds, 1 read."""
    _, _, tg = mid_stream(FORWARD)
    st = init_state(N, [0], dtype=torch.float64, device="cpu")
    st.r.zero_()
    _, ts = sparse.push_to_convergence_worklist(
        st, tg, CFG, torch.full((64,), N, dtype=torch.int32), True, ((64, 512, 16),), N + 1, 120)
    assert (ts.rounds, ts.syncs) == (0, 1)
