"""The hybrid engine's two convergence loops (pprx_torch.engine.sparse) on the
port's host loop of K4's hybrid steps, against the JAX package's jitted
loops (pprx.engine.sparse) on tests/test_torch_sparse.py's mid-stream
graph, f64: p and r at 1e-12; rounds, pushes, edge pushes, wl rounds and the
scans by reason equal; the arms each case is built to take; a read after
the prologue and after each arm; the loop's log replays through the plain
``decide``. On the card the same arms run inside one loop graph
(tests/test_torch_cuda.py, chip_smoke.py phase 16)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pprx.engine.sparse as jsparse
from pprx.engine.state import init_state as jax_init_state
from pprx.graph.dynamic import WindowGraph as JaxWindow
from pprx_torch.engine import graphs, loop, sparse
from pprx_torch.engine.state import FORWARD, REVERSE, init_state
from pprx_torch.graph.dynamic import WindowGraph
from tests.test_torch_sparse import (
    CFG,
    LOOSE,
    N,
    assert_state,
    mid_stream,
    port_state,
    sparse_front,
)

torch.set_num_threads(1)

MODES = [FORWARD, REVERSE]
COUNTERS = ("rounds", "pushes", "edge_pushes", "wl_rounds", "scans_cand", "scans_fed",
            "scans_liv")
SCAN = (N + 1, 120)  # the worklist loop's top scan tier


@functools.partial(jax.jit, static_argnames=("cfg", "tiers", "scan_fcap", "scan_ecap"))
def jax_worklist(state, graph, cand0, ok, cfg, tiers, scan_fcap, scan_ecap):
    return jsparse.push_to_convergence_worklist(state, graph, cfg, cand0, ok, tiers, scan_fcap,
                                                scan_ecap)


@functools.partial(jax.jit, static_argnames=("cfg", "fcap", "ecap"))
def jax_hybrid(state, graph, cfg, fcap, ecap):
    return jsparse.push_to_convergence_hybrid(state, graph, cfg, fcap, ecap)


def _stats(s) -> tuple:
    return tuple(int(getattr(s, k)) for k in COUNTERS)


def _residual_rows(jst, wcap: int):
    """Every row holding residual, deduplicated into a list of ``wcap``."""
    rows = np.flatnonzero(np.abs(np.asarray(jst.r)[:N]).max(axis=1) > 0).astype(np.int32)
    return jsparse._dedup_compact(jnp.asarray(rows), wcap, N)


def _held(ts, table_rule=loop.HYBRID) -> list:
    """The loop's logged rounds replay as made; returns the sink's loops."""
    recs = graphs.LOG_SINK
    assert len(recs) == 1 and recs[0]["table"].rule == table_rule
    rec = recs[0]
    assert rec["rounds"] == ts.rounds == len(rec["rows"])
    assert loop.replay_log(rec["rows"], rec["table"], rec["max_rounds"]) == loop.logged(
        rec["rows"], rec["table"])
    return rec["rows"]


@pytest.fixture(autouse=True)
def sink(monkeypatch):
    monkeypatch.setattr(graphs, "LOG_SINK", [])


# (case, tiers, start, max_rounds, state): the worklist loop's cases on the
# mid-stream graph (``mid``: every scan dense, the overlay is too big beside
# the window) or on the small-overlay graph (``front``: scans sparse)
WORKLIST = [
    ("list", ((64, 512, 16),), "list", None, "mid"),
    ("scan", ((64, 512, 16),), "scan", None, "mid"),
    ("list_cut", ((8, 512, 16),), "list", None, "mid"),
    ("ladder", ((8, 64, 4), (64, 512, 16)), "list", None, "mid"),
    ("tier_overflow", ((8, 512, 16), (64, 512, 16)), "list", None, "mid"),
    ("edge_bound", ((64, 8, 16),), "list", None, "mid"),
    ("live_bound", ((64, 512, 1),), "list", None, "mid"),
    ("sparse_scans", ((8, 64, 4), (64, 512, 16)), "scan", None, "front"),
    ("sparse_after_list", ((4, 16, 2), (16, 64, 8)), "list", None, "front"),
    ("cap", ((8, 512, 16),), "list", 3, "mid"),
    ("invalid_list", ((8, 512, 16), (64, 512, 16)), "invalid", None, "mid"),
]


def _worklist_case(mode, tiers, start, max_rounds, state):
    jst, jg, tg = mid_stream(mode) if state == "mid" else sparse_front(mode)
    cfg = LOOSE if max_rounds is None else LOOSE.__class__(
        alpha=LOOSE.alpha, eps=LOOSE.eps, max_rounds=max_rounds)
    wcap = tiers[-1][0]
    if start == "scan":
        cand0, ok = jnp.full(wcap, N, jnp.int32), False
    else:
        cand0, c0n = _residual_rows(jst, wcap)
        ok = int(c0n) <= wcap
        if start == "invalid":
            ok = False
    return jst, jg, tg, cfg, cand0, ok


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case,tiers,start,max_rounds,state", WORKLIST,
                         ids=[c[0] for c in WORKLIST])
def test_worklist_loop_matches_jitted_jax(mode, case, tiers, start, max_rounds, state):
    jst, jg, tg, cfg, cand0, ok = _worklist_case(mode, tiers, start, max_rounds, state)
    j2, js = jax_worklist(jst, jg, cand0, jnp.asarray(ok), cfg=cfg, tiers=tiers,
                          scan_fcap=SCAN[0], scan_ecap=SCAN[1])
    # a list the caller says is not valid: with a list of the port's
    # ``invalid`` case the validity is a device bool, read on the device
    ok_t = torch.tensor(False) if start == "invalid" else ok
    t2, ts = sparse.push_to_convergence_worklist(
        port_state(jst), tg, cfg, torch.from_numpy(np.array(cand0)), ok_t, tiers, *SCAN)
    assert _stats(ts) == _stats(js) and ts.rounds > 0
    assert_state(t2, j2)
    arms = ts.arms
    assert arms["wl"] == ts.wl_rounds and arms["wl"] + arms["sparse"] + arms["dense"] == ts.rounds
    assert ts.syncs == ts.rounds + arms["count"] + 1
    _held(ts)
    # each case takes what it is built to take
    if case == "list":
        assert ts.wl_rounds > 0 and arms["count"] > 0
    if case in ("scan", "sparse_scans"):
        assert ts.scans_cand >= 1
    if case in ("list_cut", "tier_overflow"):
        assert ts.rounds > ts.wl_rounds > 0
    if case == "invalid_list":
        assert ts.scans_cand > 0 and arms["count"] > 0
    if case == "edge_bound":
        assert ts.scans_fed > 0
    if case == "live_bound":
        assert ts.scans_liv > 0
    if state == "mid":
        assert arms["sparse"] == 0 and arms["dense"] > 0
    else:
        assert arms["sparse"] > 0
    if case == "sparse_after_list":
        assert arms["wl"] > 0 and arms["count"] > 0
    if case == "cap":
        assert ts.rounds == 3
    if case == "invalid_list":
        # the list is counted first, and that count stands for the prime
        assert _held(ts)[0][0] != 0 and arms["count"] >= 1


@pytest.mark.parametrize("mode", MODES)
def test_invalid_list_that_counts_no_row_runs_no_round(mode):
    """A list the caller marks not valid on the device, on a converged
    state: the count that stands for the prime finds no row, and the loop
    runs no round (the reference's prime counts 0 active pairs), after one
    count and two reads."""
    _, _, tg = mid_stream(mode)
    st = init_state(N, [0], dtype=torch.float64, device="cpu", mode=mode)
    st.r.zero_()
    cand0 = torch.arange(64, dtype=torch.int32).clamp(max=N)
    _, ts = sparse.push_to_convergence_worklist(st, tg, CFG, cand0, torch.tensor(False),
                                                ((64, 512, 16),), *SCAN)
    assert (ts.rounds, ts.arms["count"], ts.syncs) == (0, 1, 2)


@pytest.mark.parametrize("mode", MODES)
def test_idle_list_runs_no_round(mode):
    """A valid list with no candidate is an idle slide: no round, no arm,
    one read (the prologue's), as the jitted reference."""
    _, jg, tg = mid_stream(mode)
    jst = jax_init_state(N, [0], mode=mode, dtype=jnp.float64)
    jst = jst.replace(r=jnp.zeros_like(jst.r))
    cand0 = jnp.full(64, N, jnp.int32)
    _, js = jax_worklist(jst, jg, cand0, jnp.asarray(True), cfg=CFG, tiers=((64, 512, 16),),
                         scan_fcap=SCAN[0], scan_ecap=SCAN[1])
    _, ts = sparse.push_to_convergence_worklist(port_state(jst), tg, CFG,
                                                torch.from_numpy(np.array(cand0)), True,
                                                ((64, 512, 16),), *SCAN)
    assert _stats(ts) == _stats(js) and ts.rounds == 0
    assert ts.syncs == 1 and not any(ts.arms[k] for k in ("wl", "sparse", "dense", "count"))


def test_star_tier_overflow_matches_jitted_jax():
    """A star graph whose hub, pushed from a one-row list at the smallest
    tier, marks more leaves than that tier's w: the list is cut, the next
    round counts the frontier and scans (tests/test_worklist.py's case),
    both modes."""
    n, hub = 30, 0
    src = np.array([hub] * (n - 1) + list(range(1, n)), dtype=np.int64)
    dst = np.array(list(range(1, n)) + [hub] * (n - 1), dtype=np.int64)
    tiers = ((8, 64, 16), (24, 512, 16), (64, 512, 16))
    for mode in MODES:
        jh = jsparse.HybridGraph.build(JaxWindow.from_coo(src, dst, n), mode, overlay_cap=8)
        cand0, _ = jsparse._dedup_compact(jnp.asarray([hub, 5], jnp.int32), 64, n)
        js0 = jax_init_state(n, [hub, 5], mode=mode, dtype=jnp.float64)
        j2, js = jax_worklist(js0, jh, cand0, jnp.asarray(True), cfg=CFG, tiers=tiers,
                              scan_fcap=n + 1, scan_ecap=len(src) + 20)
        th = sparse.HybridGraph.build(WindowGraph.from_coo(src, dst, n, device="cpu"), mode, 8)
        graphs.LOG_SINK.clear()
        t2, ts = sparse.push_to_convergence_worklist(
            init_state(n, [hub, 5], mode=mode, dtype=torch.float64, device="cpu"), th, CFG,
            torch.from_numpy(np.array(cand0)), True, tiers, n + 1, len(src) + 20)
        assert _stats(ts) == _stats(js) and ts.scans_cand > 0 and ts.arms["count"] > 0
        assert_state(t2, j2, atol=1e-13)
        _held(ts)


# (fcap, ecap, start, max_rounds, state) of the loop without a worklist
HYBRID = [
    (N + 1, 400, "mid", None, "mid"),
    (N + 1, 6, "mid", None, "mid"),
    (N + 1, 400, "cold", None, "mid"),
    (N + 1, 400, "front", None, "front"),
    (4, 400, "front", None, "front"),
    (N + 1, 400, "mid", 2, "mid"),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fcap,ecap,start,max_rounds,state", HYBRID)
def test_hybrid_loop_matches_jitted_jax(mode, fcap, ecap, start, max_rounds, state):
    """``push_to_convergence_hybrid`` (every round a scan: sparse where the
    frontier fits ``fcap`` and ``ecap`` and is worth it, else dense): the
    reference's rounds, pushes and edge pushes and state; no count arm
    (each scan leaves the next exact counts), one read a round and one for
    the prologue."""
    jst, jg, tg = mid_stream(mode) if state == "mid" else sparse_front(mode)
    cfg = CFG if start == "cold" else LOOSE
    if max_rounds is not None:
        cfg = cfg.__class__(alpha=cfg.alpha, eps=cfg.eps, max_rounds=max_rounds)
    if start == "cold":
        jst = jax_init_state(N, [0, 6, 17], mode=mode, dtype=jnp.float64)
    j2, js = jax_hybrid(jst, jg, cfg=cfg, fcap=fcap, ecap=ecap)
    t2, ts = sparse.push_to_convergence_hybrid(port_state(jst), tg, cfg, fcap, ecap)
    assert _stats(ts)[:3] == _stats(js)[:3] and ts.rounds > 0
    assert _stats(ts)[3:] == (0, 0, 0, 0)
    assert_state(t2, j2)
    assert ts.arms["count"] == 0 and ts.syncs == ts.rounds + 1
    assert ts.arms["sparse"] + ts.arms["dense"] == ts.rounds
    _held(ts)
    if state == "front" and fcap > 4:
        assert ts.arms["sparse"] > 0
    if ecap == 6 or state == "mid":
        assert ts.arms["dense"] > 0
    if max_rounds is not None:
        assert ts.rounds == max_rounds
