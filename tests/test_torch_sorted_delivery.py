"""The sorted deliveries of the hybrid engine's worklist rounds and sparse
scans, and of ``wlp``'s group sum (``sorted_bucket_rows``), against the JAX
package in f64 on the CPU, where the segment sum runs its plain version.

A hybrid arm delivers its snapshot and overlay lanes in one sorted call
(``sparse._deliver_`` through ``sorted_deliver_``), which a spy on
``sorted_deliver_`` counts. p and r at 1e-12, equal counts and next lists,
and forward mode's mass (sum of p and r over the real rows) conserved
where a round's capacities hold its work.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pprx.dist.wl as jwl
import pprx.engine.sparse as jsparse
from pprx.engine.state import init_state as jax_init_state
from pprx.graph.dynamic import WindowGraph as JaxWindow
from pprx_torch.dist import wl as twl
from pprx_torch.engine import sparse
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


@pytest.fixture
def calls(monkeypatch):
    """The call sites of ``sorted_deliver_``'s calls from the hybrid
    engine, in order (a spy that calls through)."""
    seen = []
    deliver = sparse.sorted_deliver_

    def spy(*args, **kw):
        seen.append(kw.get("site"))
        return deliver(*args, **kw)

    monkeypatch.setattr(sparse, "sorted_deliver_", spy)
    return seen


def mass(st) -> np.ndarray:
    """Per column, the sum of p and r over the real rows (the phantom row
    is zero)."""
    p, r = (np.asarray(x, dtype=np.float64) for x in (st.p, st.r))
    return p[:-1].sum(axis=0) + r[:-1].sum(axis=0)


def held_round(tout, jout, jst, mode, conserves=True):
    """A worklist round's outputs against the JAX round's, and forward
    mode's mass where the round's capacities hold its work."""
    assert_state(tout[0], jout[0])
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert [int(x) for x in tout[2:5]] == [int(jout[2]), float(jout[3]), float(jout[4])]
    assert {k: int(v) for k, v in tout[5].items()} == {k: int(v) for k, v in jout[5].items()}
    if mode == FORWARD and conserves:
        np.testing.assert_allclose(mass(tout[0]), mass(jst), rtol=0, atol=1e-12)


def mid_stream_list(mode):
    """The mid-stream pair and a candidate list of every row holding
    residual and some that do not (``test_worklist_round_matches_jax``'s)."""
    jst, jg, tg = mid_stream(mode)
    rows = np.flatnonzero(np.abs(np.asarray(jst.r)[:N]).max(axis=1) > 0)
    ids = np.concatenate([rows, [1, 2, 3]]).astype(np.int32)
    cand, _ = jsparse._dedup_compact(jnp.asarray(ids), 48, N)
    return jst, jg, tg, cand


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fcap,ecap,ovacap", [(36, 400, 0), (12, 200, 30), (48, 1000, 200),
                                              (48, 4000, 0)])
def test_worklist_round_sorted(calls, mode, fcap, ecap, ovacap):
    """The mid-stream graph (a stale snapshot, an overlay of expiries and
    insertions), phantom rows past the frontier and lanes past its edges:
    the JAX round's state, next list, counts and bounds; one sorted call.
    (12, 200, 30) is too small for the round's work, which it cuts as the
    reference does, and conserves no mass."""
    jst, jg, tg, cand = mid_stream_list(mode)
    jout = jsparse.worklist_round(jst, jg, LOOSE, cand, fcap, ecap, ovacap)
    tout = sparse.worklist_round(port_state(jst), tg, LOOSE, torch.from_numpy(np.array(cand)),
                                 fcap, ecap, ovacap)
    held_round(tout, jout, jst, mode, conserves=fcap != 12)
    assert calls == ["worklist"]


@pytest.mark.parametrize("mode", MODES)
def test_worklist_round_delivers_expiries(calls, mode):
    """Live overlay lanes of sign -1 carry mass in the sorted round: the
    expiries' cancellations go through the segment sum too."""
    jst, jg, tg, cand = mid_stream_list(mode)
    fcap = 36
    forward = mode == FORWARD
    gat, sign = (tg.ov.src if forward else tg.ov.dst), tg.ov.sign
    r0 = torch.from_numpy(np.array(jst.r))
    act = (r0.abs() > LOOSE.eps * (tg.window.deg.clamp(min=1)[:, None] if forward else 1)).any(1)
    assert bool((act[gat.long()] & (sign < 0)).any()), "no live expiry in the round"
    jout = jsparse.worklist_round(jst, jg, LOOSE, cand, fcap, 400, 0)
    tout = sparse.worklist_round(port_state(jst), tg, LOOSE, torch.from_numpy(np.array(cand)),
                                 fcap, 400, 0)
    held_round(tout, jout, jst, mode)
    assert calls == ["worklist"]


def star(mode, leaves=40):
    """A star whose leaves all point at the hub (and the hub at each leaf),
    every leaf holding residual: a round whose lanes mostly key one row.
    (JAX state, JAX graph, port graph, candidate list of the leaves)."""
    n, hub = leaves + 1, 0
    src = np.array([hub] * leaves + list(range(1, n)), dtype=np.int64)
    dst = np.array(list(range(1, n)) + [hub] * leaves, dtype=np.int64)
    queries = list(range(1, n))
    jh = jsparse.HybridGraph.build(JaxWindow.from_coo(src, dst, n), mode, overlay_cap=8)
    th = sparse.HybridGraph.build(WindowGraph.from_coo(src, dst, n, device="cpu"), mode, 8)
    jst = jax_init_state(n, queries, mode=mode, dtype=jnp.float64)
    cand, _ = jsparse._dedup_compact(jnp.asarray(queries, jnp.int32), 64, n)
    return jst, jh, th, cand


@pytest.mark.parametrize("mode", MODES)
def test_worklist_round_many_lanes_on_one_row(calls, mode):
    """Forty leaves push into the hub in one round (forward: every leaf's
    one edge keys the hub)."""
    jst, jg, tg, cand = star(mode)
    jout = jsparse.worklist_round(jst, jg, CFG, cand, 64, 128, 0)
    tout = sparse.worklist_round(port_state(jst), tg, CFG, torch.from_numpy(np.array(cand)),
                                 64, 128, 0)
    held_round(tout, jout, jst, mode)
    if mode == FORWARD:
        assert int(tout[2]) == 1  # the next list is the hub alone
    assert calls == ["worklist"]


@pytest.mark.parametrize("mode", MODES)
def test_worklist_round_empty_frontier(calls, mode):
    """No active pair: the round moves nothing."""
    jst, jg, tg, cand = mid_stream_list(mode)
    jst = jst.replace(r=jnp.asarray(np.asarray(jst.r) * 1e-12))  # under every threshold
    jout = jsparse.worklist_round(jst, jg, LOOSE, cand, 36, 400, 0)
    tout = sparse.worklist_round(port_state(jst), tg, LOOSE, torch.from_numpy(np.array(cand)),
                                 36, 400, 0)
    held_round(tout, jout, jst, mode)
    assert int(tout[3]) == 0
    np.testing.assert_array_equal(tout[0].r.numpy(), np.asarray(jst.r))
    assert calls == ["worklist"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rebuilt", [False, True], ids=["stale", "rebuilt"])
@pytest.mark.parametrize("ecap", [400, 60])
def test_sparse_round_sorted(calls, mode, rebuilt, ecap):
    """A sparse scan over every row of the stale snapshot and the whole
    overlay, or after a rebuild (an overlay of unused slots, keyed the
    phantom row); ``ecap`` 60 cuts the expansion, as a too-small tier
    would: the JAX round's state and counts; one sorted call."""
    jst, jg, tg = mid_stream(mode)
    if rebuilt:
        jg, tg = jsparse.rebuild_snapshot(jg, mode), sparse.rebuild_snapshot(tg, mode)
    j2, jna, jew = jsparse.sparse_round(jst, jg, LOOSE, N + 1, ecap)
    t2, tna, tew = sparse.sparse_round(port_state(jst), tg, LOOSE, N + 1, ecap)
    assert int(tna) == float(jna) > 0 and int(tew) == float(jew)
    assert_state(t2, j2)
    if mode == FORWARD and ecap == 400:
        np.testing.assert_allclose(mass(t2), mass(jst), rtol=0, atol=1e-12)
    assert calls == ["sparse_scan"]


def _stats(s) -> tuple:
    return tuple(int(getattr(s, k)) for k in ("rounds", "pushes", "edge_pushes", "wl_rounds",
                                              "scans_cand", "scans_fed", "scans_liv"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tiers", [((64, 512, 16),), ((8, 64, 4), (64, 512, 16))])
def test_worklist_loop_sorted(calls, mode, tiers):
    """``push_to_convergence_worklist``: the JAX loop's rounds, counters, p
    and r; one sorted call a worklist round and a sparse scan."""
    jst, jg, tg = mid_stream(mode)
    wcap = tiers[-1][0]
    rows = np.flatnonzero(np.abs(np.asarray(jst.r)[:N]).max(axis=1) > 0).astype(np.int32)
    cand0, c0n = jsparse._dedup_compact(jnp.asarray(rows), wcap, N)
    ok = int(c0n) <= wcap
    j2, js = jsparse.push_to_convergence_worklist(jst, jg, LOOSE, cand0, ok, tiers, N + 1, 120)
    t2, ts = sparse.push_to_convergence_worklist(
        port_state(jst), tg, LOOSE, torch.from_numpy(np.array(cand0)), ok, tiers, N + 1, 120)
    assert _stats(ts) == _stats(js)
    assert_state(t2, j2)
    assert calls.count("worklist") == ts.wl_rounds > 0
    assert calls.count("sparse_scan") == ts.arms["sparse"]


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_loop_sorted(calls, mode):
    """``push_to_convergence_hybrid`` from a state whose frontier is a few
    rows beside a small overlay (``sparse_front``) and from a cold one: the
    JAX loop's rounds, counters, p and r; one sorted call a sparse scan."""
    jst, jg, tg = sparse_front(mode)
    queries = [0, 6, 17]
    cold = (jax_init_state(N, queries, mode=mode, dtype=jnp.float64),
            init_state(N, queries, mode=mode, dtype=torch.float64, device="cpu"))
    sparse_scans = 0
    for js0, ts0, cfg in ((jst, port_state(jst), LOOSE), (*cold, CFG)):
        del calls[:]
        j2, js = jsparse.push_to_convergence_hybrid(js0, jg, cfg, N + 1, 400)
        t2, ts = sparse.push_to_convergence_hybrid(ts0, tg, cfg, N + 1, 400)
        assert _stats(ts) == _stats(js) and ts.rounds > 0
        assert_state(t2, j2)
        assert calls == ["sparse_scan"] * ts.arms["sparse"]
        sparse_scans += ts.arms["sparse"]
    assert sparse_scans > 0


# (K, ccap, n_local, ids): heavy duplicates, every id n_pad, L = 1
BUCKETS = [
    (1, 64, 30, "dups"),
    (4, 8, 30, "dups"),
    (4, 2, 30, "dups"),
    (2, 4, 30, "pad"),
    (4, 8, 30, "one"),
    (1, 4, 30, "one_pad"),
]


def bucket_lanes(kind: str, n_pad: int, rng) -> np.ndarray:
    if kind == "dups":  # 300 lanes on 5 ids and the pad
        return rng.choice(np.array([0, 3, 3, 17, n_pad - 1, n_pad]), size=300).astype(np.int32)
    if kind == "pad":
        return np.full(50, n_pad, np.int32)
    return np.array([n_pad if kind == "one_pad" else 7], np.int32)


@pytest.mark.parametrize("k,ccap,n_local,kind", BUCKETS)
def test_sorted_bucket_rows_matches_jax(k, ccap, n_local, kind):
    """The group sum through the segment sum's gather entry: the JAX
    function's send buffers, carry and pending count, lanes naming rows of
    a smaller ``moving`` in any order."""
    rng = np.random.default_rng(len(kind) * 10 + k)
    n_pad = n_local * k
    ids = bucket_lanes(kind, n_pad, rng)
    length = ids.shape[0]
    moving = rng.random((12, 3)) - 0.5
    rows = rng.integers(0, 12, size=length).astype(np.int32)
    ccarry = min(length, n_pad)
    got = twl.sorted_bucket_rows(torch.from_numpy(ids), torch.from_numpy(rows),
                                 torch.from_numpy(moving), k, n_local, n_pad, ccap, ccarry)
    want = jwl.sorted_bucket_rows(jnp.asarray(ids), jnp.asarray(rows), jnp.asarray(moving), k,
                                  n_local, n_pad, ccap, ccarry, jnp.float64)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)
    assert int(got[4]) == int(want[4])
    # the mass that reaches a real id is every valid lane's: sent or carried
    live = ids < n_pad
    total = moving[rows[live]].sum(axis=0)
    np.testing.assert_allclose(got[1].numpy().sum(axis=0) + got[3].numpy().sum(axis=0), total,
                               rtol=0, atol=1e-12)


def test_sorted_bucket_rows_group_sum_is_the_gather_entry(monkeypatch):
    """The group sum is one call of the gather entry under the
    ``group_sum`` site, over the sorted lanes, into a zero ``[L, S]``."""
    from pprx_torch.engine import segsum

    seen = []
    gather = segsum.segsum_gather_add_

    def spy(rin, table, gat, row_off, row_scale=None, site="other"):
        seen.append((tuple(rin.shape), bool(rin.any()), gat.dtype, site, row_scale))
        return gather(rin, table, gat, row_off, row_scale, site)

    monkeypatch.setattr(twl, "segsum_gather_add_", spy)
    ids = torch.tensor([5, 2, 5, 60, 2, 2], dtype=torch.int32)
    twl.sorted_bucket_rows(ids, torch.arange(6), torch.rand(6, 4, dtype=torch.float64), 2, 30,
                           60, 4, 6)
    assert seen == [((6, 4), False, torch.int64, "group_sum", None)]
