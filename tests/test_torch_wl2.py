"""Port of the wl2 engine (pprx_torch.engine.wl2) against the JAX engine on
the graph and tier ladders of tests/test_wl2.py, both modes, f64.

The JAX side runs with segsum=False, the XLA path whose scatters do the
same arithmetic as the port's plain segment sum on the CPU (in reverse mode
both factor the receiver's 1/d_out out of the row's sum). The JAX engines
agree with each other at 1e-12/1e-13 (tests/test_wl2.py), so p and r are
held at 1e-12, and the round schedule must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pprx.engine.wl2 as jwl2
import pprx_torch.engine.wl2 as twl2
from pprx.config import PprConfig, StreamConfig
from pprx.engine.state import init_state as jax_init_state
from pprx.graph.dynamic import WindowGraph as JaxWindow
from pprx.graph.io import synthetic_powerlaw_stream
from pprx_torch.engine.segsum import compact, segment_ids
from pprx_torch.engine.push import push_to_convergence
from pprx_torch.engine.state import FORWARD, REVERSE, init_state
from pprx_torch.engine.wl2 import make_tiers2, rld_expand
from pprx_torch.graph.dynamic import WindowGraph
from tests.conftest import random_multigraph

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)
TIERS = [
    ((64, 512, 16),),                 # comfortable single tier
    ((8, 32, 4), (64, 512, 16)),      # two-tier ladder
    ((16, 16, 4),),                   # expansion overflow -> scans
    ((4, 512, 16),),                  # emission overflow -> scan reseeds
]


def _case(tiers, mode=FORWARD):
    rng = np.random.default_rng(7)
    n, m = 40, 200
    src, dst = random_multigraph(rng, n, m)
    queries = [0, 13, 26]
    q = np.unique(np.asarray(queries, np.int32))
    cand0 = np.concatenate([q, np.full(8 - q.size, n, np.int32)])

    kg = jwl2.build_kill_graph(JaxWindow.from_coo(src, dst, n), mode, fring=8)
    st = jax_init_state(n, queries, mode=mode, dtype=jnp.float64)
    st, js = jwl2.push_to_convergence_wl2(
        st, kg, CFG, jnp.asarray(cand0), jnp.asarray(q.size, jnp.int32), True, tiers
    )

    tkg = twl2.build_kill_graph(
        WindowGraph.from_coo(src, dst, n, device="cpu"), mode, fring=8
    )
    tst = init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu")
    tst, ts = twl2.push_to_convergence_wl2(
        tst, tkg, CFG, torch.from_numpy(cand0), q.size, True, tiers
    )

    np.testing.assert_allclose(tst.p.numpy(), np.asarray(st.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(st.r), rtol=0, atol=1e-12)
    assert ts.rounds == int(js.rounds)
    assert ts.wl_rounds == int(js.wl_rounds)
    assert ts.edge_pushes == float(js.edge_pushes)  # feeds the stats-skip rule
    # one read-back per round + the first, + the light scans' second reads
    assert ts.syncs == ts.rounds + 1 + ts.stats_reads
    assert ts.stats_reads <= ts.rounds - ts.wl_rounds  # at most one a scan round
    assert ts.wl_rounds > 0  # every ladder runs compact rounds too
    # and the port's own dense engine on the same graph: the same schedule
    dst_, dstats = push_to_convergence(
        init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu"),
        WindowGraph.from_coo(src, dst, n, device="cpu"), CFG)
    assert dstats.rounds == ts.rounds
    np.testing.assert_allclose(tst.p.numpy(), dst_.p.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tst.r.numpy(), dst_.r.numpy(), rtol=0, atol=1e-12)
    return ts


@pytest.mark.parametrize("tiers", TIERS)
def test_wl2_convergence_matches_jax(tiers):
    _case(tiers)


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
@pytest.mark.parametrize("tiers", TIERS[:2])
def test_small_compact_rounds_deliver_sorted_against_the_scatter(monkeypatch, tiers, mode):
    """Compact rounds far below the reference's ``SORT_DELIVER_MIN`` lanes,
    where it scatters: the port sorts each round's lanes and sums them
    through K1 (one ``sorted_deliver_`` a round), and matches at 1e-12."""
    lanes = []
    deliver = twl2.sorted_deliver_

    def spy(rin, keys, table, *args, **kw):
        lanes.append(keys.shape[0])
        return deliver(rin, keys, table, *args, **kw)

    monkeypatch.setattr(twl2, "sorted_deliver_", spy)
    ts = _case(tiers, mode)
    assert len(lanes) == ts.wl_rounds > 0
    assert max(lanes) < jwl2.SORT_DELIVER_MIN == 131_072


@pytest.mark.parametrize("tiers", TIERS)
def test_wl2_reverse_convergence_matches_jax(tiers):
    _case(tiers, REVERSE)


@pytest.mark.parametrize("tiers", TIERS)
def test_wl2_reverse_sorted_delivery_matches_jax(monkeypatch, tiers):
    """Reverse mode with every compact round on the sorted delivery (the
    reference's ``SORT_DELIVER_MIN`` lowered; the port sorts at every size):
    the lanes carry their receiver's 1/d_out and the residual removal at
    the candidates goes unscaled in the same sum."""
    monkeypatch.setattr(jwl2, "SORT_DELIVER_MIN", 1)
    _case(tiers, REVERSE)


def test_reverse_scan_round_matches_jax_with_kills_and_fresh_edges():
    """One reverse scan round on a kill graph mid-stream (killed snapshot
    slots, a part-filled fresh ring) against both forms of the reference:
    ``segsum=False`` factors 1/d_out out, ``segsum=True`` folds it into
    every edge before its kernel (interpret mode). State and both counts."""
    from pprx.graph.fast_stream import FastStreamDriver as JaxDriver
    from pprx_torch.graph.fast_stream import FastStreamDriver

    n = 35
    src, dst, _ = synthetic_powerlaw_stream(n, 500, seed=11)
    scfg = StreamConfig(window=250, slide=25)
    kw = dict(mode=REVERSE, rebuild_every=3, e_top=64, n_tiers=3)
    a = JaxDriver(src, dst, n, [0, 6, 17], CFG, scfg, dtype=jnp.float64, segsum=False, **kw)
    b = FastStreamDriver(src, dst, n, [0, 6, 17], CFG, scfg, dtype=torch.float64,
                         device="cpu", **kw)
    a.seed(), b.seed()
    list(a.run(5)), list(b.run(5))  # a rebuild, then two slides of kills
    assert b.fcnt == 50 and int((b.graph.d_gat == n).sum()) == 50
    loose = PprConfig(alpha=0.2, eps=1e-10)
    t2, tna, tew = twl2.dense_round_sorted(b.state, b.graph, loose)
    assert int(tna) > 0 and int(tew) > 0
    for segsum in (False, True):
        j2, jna, jew = jwl2.dense_round_sorted(a.state, a.graph, loose, segsum=segsum)
        assert (int(tna), int(tew)) == (float(jna), float(jew))
        np.testing.assert_allclose(t2.p.numpy(), np.asarray(j2.p), rtol=0, atol=1e-12)
        np.testing.assert_allclose(t2.r.numpy(), np.asarray(j2.r), rtol=0, atol=1e-12)


@pytest.mark.parametrize("tiers", TIERS)
def test_wl2_sorted_delivery_matches_jax(monkeypatch, tiers):
    """Every compact round on the sorted segment-sum delivery, in both
    packages (the reference's ``SORT_DELIVER_MIN`` lowered; the port sorts
    at every size)."""
    monkeypatch.setattr(jwl2, "SORT_DELIVER_MIN", 1)
    _case(tiers)


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_kill_graph_matches_jax(mode):
    rng = np.random.default_rng(3)
    n, m = 30, 150
    src, dst = random_multigraph(rng, n, m)
    jkg = jwl2.build_kill_graph(JaxWindow.from_coo(src, dst, n, capacity=160), mode, fring=8)
    tkg = twl2.build_kill_graph(
        WindowGraph.from_coo(src, dst, n, capacity=160, device="cpu"), mode, fring=8
    )
    for f in ("offsets", "nbr", "row_len", "snap_pos", "d_pos", "f_off", "f_len"):
        np.testing.assert_array_equal(getattr(tkg, f).numpy(), np.asarray(getattr(jkg, f)), f)
    # the reference pads the delivery-sorted view for its TPU kernel
    np.testing.assert_array_equal(tkg.d_gat.numpy(), np.asarray(jkg.d_gat)[:160])
    # the port keeps the sorted scatter ids d_sca as per-row offsets d_off
    np.testing.assert_array_equal(
        segment_ids(tkg.d_off).numpy(), np.asarray(jkg.d_sca)[:160]
    )
    counts = np.bincount(np.asarray(jkg.d_sca)[:160], minlength=n + 1)
    np.testing.assert_array_equal(np.diff(tkg.d_off.numpy()), counts)


def test_compact_matches_nonzero():
    rng = np.random.default_rng(0)
    mask = rng.random(50) < 0.3
    for size, fill in ((100, 50), (5, 7), (int(mask.sum()), 0)):
        (ref,) = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=fill)
        got = compact(torch.from_numpy(mask), size, fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_rld_expand_matches_jax():
    starts = np.array([5, 0, 9, 3, 20], np.int32)
    lens = np.array([2, 0, 3, 0, 4], np.int32)
    for ecap in (4, 9, 16):
        jt, jp, jv = (np.asarray(x) for x in jwl2.rld_expand(
            jnp.asarray(starts), jnp.asarray(lens), ecap))
        tt, tp, tv = (x.numpy() for x in rld_expand(
            torch.from_numpy(starts), torch.from_numpy(lens), ecap))
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tt[tv], jt[jv])


@pytest.mark.parametrize(
    "args",
    [(40, 200, 8, 65_536), (200_000, 2_000_000, 320_000, 262_144), (1000, 5000, 100, 4096)],
)
def test_make_tiers2_matches_jax(args):
    assert make_tiers2(*args) == jwl2.make_tiers2(*args)
    assert make_tiers2(*args, n_tiers=3) == jwl2.make_tiers2(*args, n_tiers=3)


def _push_both(tiers, mode, c0ok=True):
    """``_case``'s graph pushed by both engines: (port state, port stats,
    reference state, reference stats); ``c0ok=False`` starts with a scan."""
    rng = np.random.default_rng(7)
    n, m = 40, 200
    src, dst = random_multigraph(rng, n, m)
    queries = [0, 13, 26]
    q = np.unique(np.asarray(queries, np.int32))
    cand0 = np.concatenate([q, np.full(8 - q.size, n, np.int32)])
    kg = jwl2.build_kill_graph(JaxWindow.from_coo(src, dst, n), mode, fring=8)
    st, js = jwl2.push_to_convergence_wl2(
        jax_init_state(n, queries, mode=mode, dtype=jnp.float64), kg, CFG,
        jnp.asarray(cand0), jnp.asarray(q.size, jnp.int32), c0ok, tiers)
    tkg = twl2.build_kill_graph(WindowGraph.from_coo(src, dst, n, device="cpu"), mode, fring=8)
    tst, ts = twl2.push_to_convergence_wl2(
        init_state(n, queries, mode=mode, dtype=torch.float64, device="cpu"), tkg, CFG,
        torch.from_numpy(cand0), q.size, c0ok, tiers)
    np.testing.assert_allclose(tst.p.numpy(), np.asarray(st.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(st.r), rtol=0, atol=1e-12)
    assert (ts.rounds, ts.wl_rounds) == (int(js.rounds), int(js.wl_rounds))
    return tst, ts, st, js


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_wider_tier_reads_n_past_a_narrower_emit(monkeypatch, mode):
    """The candidate list crosses rounds in one static buffer. A round at
    the bottom tier of a three-tier ladder emits a list 8 wide; the next
    round's edge counts fit only the top tier, which reads 64 entries: the
    56 past the emitted list must read ``n`` (what the reference's ``_fit``
    pads with), and the push stays the reference's."""
    from pprx_torch.engine.graphs import RoundGraphs

    tiers = ((4, 16, 4), (8, 64, 8), (64, 512, 16))
    n = 40
    seen, last = [], [None]
    emit, step = RoundGraphs.emit, twl2._compact_step

    def spy_emit(g, cand2):
        emit(g, cand2)
        last[0] = cand2.shape[0]

    def spy_step(state, kg, cfg, g, tier, emit_w, rescan):
        if last[0] is not None and tier[0] > last[0]:
            seen.append(g.cand[last[0]:tier[0]].tolist())
        step(state, kg, cfg, g, tier, emit_w, rescan)

    monkeypatch.setattr(RoundGraphs, "emit", spy_emit)
    monkeypatch.setattr(twl2, "_compact_step", spy_step)
    _push_both(tiers, mode)
    assert seen and all(v == [n] * len(v) for v in seen)


def test_candidate_buffer_pads_with_n():
    """``RoundGraphs``' list buffer: a seed list longer than the buffer is
    cut, a shorter one and every emitted list are followed by ``n``; the
    counters land at their offsets."""
    from pprx_torch.engine.graphs import RoundGraphs

    g = RoundGraphs(9, 6, "cpu")
    assert g.cand.tolist() == [9] * 10
    g.cand.fill_(3)
    g.emit(torch.tensor([1, 2], dtype=torch.int32))
    assert g.cand.tolist() == [1, 2] + [9] * 8
    g.cand.fill_(3)
    g.seed(torch.arange(12, dtype=torch.int32), torch.tensor(4))
    assert g.cand.tolist() == list(range(10)) and int(g.c0n) == 4
    g.seed(torch.tensor([5, 9], dtype=torch.int32), 1)
    assert g.cand.tolist() == [5] + [9] * 9 and int(g.c0n) == 1
    g.put(3, torch.tensor(7), torch.tensor(8))
    assert g.read() == [0, 0, 0, 7, 8]
    assert RoundGraphs(4, 64, "cpu").cand.shape == (64,)


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
@pytest.mark.parametrize(
    "tiers,c0ok", [(t, True) for t in TIERS[2:]] + [(t, False) for t in TIERS])
def test_stats_run_only_for_light_scans(monkeypatch, tiers, c0ok, mode):
    """A scan round's next-frontier stats (F1) run after a first read and
    only for a light scan, as the reference's ``lax.cond`` skips them: the
    round schedule and the push are the reference's, a light scan round
    reads twice, and the stats run in no more rounds than there are scans
    (forward from a valid list: fewer, some scans are heavy). ``c0ok=False``
    starts every ladder with a scan."""
    runs = []
    stats_step = twl2._stats_step
    monkeypatch.setattr(twl2, "_stats_step", lambda *a: (runs.append(1), stats_step(*a)))
    _, ts, _, _ = _push_both(tiers, mode, c0ok)
    scans = ts.rounds - ts.wl_rounds
    assert scans > 0
    assert len(runs) == ts.stats_reads <= scans and ts.syncs == ts.rounds + 1 + len(runs)
    assert mode == REVERSE or not c0ok or len(runs) < scans


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_rounds_update_the_state_in_place(mode):
    """A scan round and a compact round write into the state's own tensors
    (a captured round reads fixed addresses) and return the same state."""
    from pprx_torch.engine.graphs import RoundGraphs

    rng = np.random.default_rng(7)
    n = 40
    src, dst = random_multigraph(rng, n, 200)
    kg = twl2.build_kill_graph(WindowGraph.from_coo(src, dst, n, device="cpu"), mode, fring=8)
    st = init_state(n, [0, 13, 26], mode=mode, dtype=torch.float64, device="cpu")
    ptrs = (st.p.data_ptr(), st.r.data_ptr())
    st2, na, _ = twl2.dense_round_sorted(st, kg, CFG)
    assert st2 is st and int(na) == 3 and (st.p.data_ptr(), st.r.data_ptr()) == ptrs
    g = RoundGraphs(n, 64, "cpu")
    twl2._stats_step(st, kg, CFG, g)
    r0 = st.r.clone()
    twl2._compact_step(st, kg, CFG, g, (64, 512, 16), n + 1, True)
    assert (st.p.data_ptr(), st.r.data_ptr()) == ptrs and not torch.equal(st.r, r0)


def test_copy_into_refuses_other_shapes():
    from pprx_torch.engine.graphs import copy_into_
    from pprx_torch.engine.state import PprState

    a = PprState(p=torch.zeros(3, 2), r=torch.zeros(3, 2))
    copy_into_(a, PprState(p=torch.ones(3, 2), r=torch.full((3, 2), 2.0)))
    assert float(a.p.sum()) == 6 and float(a.r.sum()) == 12
    with pytest.raises(ValueError, match="cannot copy"):
        copy_into_(a, PprState(p=torch.ones(1, 2), r=torch.ones(3, 2)))
