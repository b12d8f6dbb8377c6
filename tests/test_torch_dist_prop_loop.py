"""The sharded engine's memory-proportional loop (``wlp``,
``ShardedWlEngine(proportional=True)``) in a world of one shard: its rounds
as the branches of ``RoundGraphs.loop`` (each tier's compact round, the
drain, the rescan), chosen by K4's plain steps under the proportional rule
(pprx_torch.engine.loop), which on the CPU run through
``RoundGraphs.host_loop``, the loop the card captures as one conditional
graph.

Held against the JAX package's proportional ShardedWlEngine on a 1x1 mesh,
in f64: pushes from the one-hot state (unseeded, whose first round is a
rescan; seeded with the query rows; seeded with an empty valid list, whose
one round the reference runs; each in full and cut at three rounds), drain
rounds on the star with a quota of 2, and six forward and six reverse
slides across rebuilds: equal rounds, wl rounds, pushes and edge pushes,
p and r within 1e-12, equal degrees. The round kinds are those of the
port's host loop (``_prop_loop``, which the engine runs at more than one
shard) on the same inputs; every loop's round log replays through
``loop.replay_log`` under the engine's proportional table, and no loop runs
but through ``RoundGraphs.loop``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pprx.dist.wl as jwl
from pprx.config import PprConfig, StreamConfig
from pprx.dist.mesh import make_row_mesh as jax_row_mesh
from pprx.dist.stream import ShardedStreamDriver as JaxDriver
from pprx_torch.config import PprConfig as TorchConfig
from pprx_torch.config import StreamConfig as TorchStreamConfig
from pprx_torch.dist import wl as twl
from pprx_torch.dist.mesh import make_row_mesh
from pprx_torch.dist.stream import ShardedStreamDriver
from pprx_torch.engine import graphs, loop
from pprx_torch.engine.graphs import RoundGraphs
from pprx_torch.engine.state import FORWARD, REVERSE
from tests._torch_dist_worker import graph, stream

torch.set_num_threads(1)

MODES = [FORWARD, REVERSE]
QUERIES = (0, 7, 13, 25, 31, 44, 7, 2)
TALLIES = ("rounds", "wl_rounds", "pushes", "edge_pushes")
PROP_LOOP = twl.ShardedWlEngine._prop_loop  # the engine's host loop


@pytest.fixture
def loops(monkeypatch):
    """Every loop's log (``graphs.LOG_SINK``) and the host loops run; the
    engine's own host loop must not run."""
    sink, ran = [], []
    host_loop = RoundGraphs.host_loop

    def counted(self, *args, **kw):
        ran.append(1)
        return host_loop(self, *args, **kw)

    def refused(*args, **kw):
        raise AssertionError("the proportional loop ran outside RoundGraphs.loop")

    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    monkeypatch.setattr(RoundGraphs, "host_loop", counted)
    monkeypatch.setattr(twl.ShardedWlEngine, "_prop_loop", refused)
    return sink, ran


def _replayed(sink, rounds):
    """Each loop logged its rounds (the first ``loop.LOG_CAP``), under the
    proportional table, and its branches are the plain steps' on the counts
    it logged."""
    assert [len(rec["rows"]) for rec in sink] == [min(r, loop.LOG_CAP) for r in rounds]
    for rec in sink:
        assert rec["table"].proportional
        rows = rec["rows"]
        assert loop.replay_log(rows, rec["table"], rec["max_rounds"]) == [
            (row[0], row[7]) for row in rows]


def _push(eng_cls, mesh, src, dst, n, mode, cfg, dtype, seeded, ccap=64, queries=QUERIES,
          **dev):
    eng = eng_cls(mesh, n, len(queries), ecap=src.size, bcap=8, cfg=cfg, mode=mode,
                  dtype=dtype, ccap=ccap, proportional=True, **dev)
    p, r = eng.init_state(list(queries))
    deg, _, _, _, _, snap = eng.device_graph_wl(src, dst)
    cand0, ok0 = None, 0
    if seeded is not None:
        rows = np.full((1, eng.wcarry), eng.n_local, np.int32)
        if seeded:
            q = sorted(set(queries))
            rows[0, :len(q)] = q
        cand0, ok0 = eng.cand0_rows(rows), 1
    return eng, eng.push_wl(p, r, deg, snap, cand0, ok0)


def _host_kinds(monkeypatch, *args, **kw):
    """The same push through the engine's host loop (``_prop_loop``, not on
    graphs): its round kinds and its six values."""
    with monkeypatch.context() as m:
        m.setattr(twl.ShardedWlEngine, "on_graphs", property(lambda self: False))
        m.setattr(twl.ShardedWlEngine, "_prop_loop", PROP_LOOP)
        eng, out = _push(twl.ShardedWlEngine, *args, **kw)
    assert eng.round_graphs is None
    return eng.round_kinds, out


def _same(got, want):
    assert [int(x) for x in got[2:]] == [int(x) for x in want[2:]]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)


@pytest.mark.parametrize("max_rounds", [10_000, 3])
@pytest.mark.parametrize("seeded", [None, True, False])
@pytest.mark.parametrize("mode", MODES)
def test_wlp_push_matches_jax_through_the_host_loop(monkeypatch, loops, mode, seeded,
                                                    max_rounds):
    """``push_wl`` from the one-hot state: unseeded (a rescan first),
    seeded with the query rows, and seeded with an empty valid list (one
    empty round: the loop starts with work 1); in full and cut at three
    rounds. Its round kinds are the host loop's."""
    sink, ran = loops
    src, dst, n = graph("random", 0, 50, 300)
    cfg = dict(alpha=0.15, eps=1e-8, max_rounds=max_rounds)
    _, want = _push(jwl.ShardedWlEngine, jax_row_mesh(1, 1), src, dst, n, mode,
                    PprConfig(**cfg), jnp.float64, seeded)
    args = (make_row_mesh(1, 1), src, dst, n, mode, TorchConfig(**cfg), torch.float64, seeded)
    eng, got = _push(twl.ShardedWlEngine, *args, device="cpu")
    assert eng.on_graphs and len(ran) == 1
    _same(got, want)
    rounds = int(got[2])
    if seeded is False:
        assert rounds == 1
    elif max_rounds == 3:
        assert rounds == 3
    assert int(got[5]) == rounds  # every round is a wl round
    assert sum(eng.round_kinds.values()) == rounds and eng.round_kinds["dense"] == 0
    if seeded is None:
        assert eng.round_kinds["rescan"] >= 1
    kinds, host = _host_kinds(monkeypatch, *args, device="cpu")
    assert kinds == eng.round_kinds
    _same(got, host)
    _replayed(sink, [rounds])


@pytest.mark.parametrize("mode", MODES)
def test_wlp_drain_rounds_match_jax(monkeypatch, loops, mode):
    """The star with a quota of 2: the hub's emission overflows into the
    compact carry, which drain rounds ship (the drain taken over a valid
    list), never a dense round; the reference's schedule and state."""
    sink, _ = loops
    src, dst, n = graph("star", n=64)
    cfg = dict(alpha=0.15, eps=1e-8, max_rounds=10_000)
    _, want = _push(jwl.ShardedWlEngine, jax_row_mesh(1, 1), src, dst, n, mode,
                    PprConfig(**cfg), jnp.float64, None, ccap=2, queries=(3, 0))
    args = (make_row_mesh(1, 1), src, dst, n, mode, TorchConfig(**cfg), torch.float64, None)
    eng, got = _push(twl.ShardedWlEngine, *args, ccap=2, queries=(3, 0), device="cpu")
    _same(got, want)
    assert eng.round_kinds["drain"] > 0, "the quota never overflowed"
    kinds, host = _host_kinds(monkeypatch, *args, ccap=2, queries=(3, 0), device="cpu")
    assert kinds == eng.round_kinds
    _same(got, host)
    rows = sink[0]["rows"]
    drain = len(eng.tiers)
    # a drain runs while the carry is pending, whatever the list
    assert all(row[6] > 0 for row in rows if row[0] == drain)
    assert any(row[0] == drain and row[1] == 1 for row in rows)
    _replayed(sink, [int(got[2])])


@pytest.mark.parametrize("mode", MODES)
def test_wlp_slides_match_jax_through_the_host_loop(loops, mode):
    """A seed and six slides of a 300-edge window, slides of 25 and a fresh
    ring of 60 (a rebuild every two slides); forward, the corrections' pairs
    seed the loop's carry: each loop's tallies, then the state and the
    degrees; the blocks are the tensors the loops were bound to."""
    sink, ran = loops
    src, dst, n = stream(2)
    queries = [0, 5, 11, 33]
    kw = dict(engine="wlp", ccap=64, fring=60)
    a = JaxDriver(src, dst, n, queries, PprConfig(alpha=0.15, eps=1e-8, max_rounds=10_000),
                  StreamConfig(300, 25), jax_row_mesh(1, 1), mode=mode, dtype=jnp.float64, **kw)
    b = ShardedStreamDriver(src, dst, n, queries,
                            TorchConfig(alpha=0.15, eps=1e-8, max_rounds=10_000),
                            TorchStreamConfig(300, 25), make_row_mesh(1, 1), mode=mode,
                            dtype=torch.float64, device="cpu", **kw)
    p0, r0, deg0, snap0 = b.p, b.r, b.deg, b.snap
    ja = [a.seed(), *a.run(6)]
    tb = [b.seed(), *b.run(6)]
    assert len(ran) == 7
    for sa, sb in zip(ja, tb, strict=True):
        assert {k: sb[k] for k in TALLIES} == {k: sa[k] for k in TALLIES}
    assert (b.p, b.r, b.deg, b.snap) == (p0, r0, deg0, snap0)
    np.testing.assert_allclose(b.host_p(), a.host_p(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.host_r(), a.host_r(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(b.host_deg(), np.asarray(a.deg))
    assert sum(b.eng.round_kinds.values()) == sum(st["rounds"] for st in tb)
    _replayed(sink, [st["rounds"] for st in tb])


def test_the_proportional_table_is_the_engines():
    """The table the loop runs under: the engine's ladder (its top tier
    covers every row), each tier's list ``wcarry`` wide, the proportional
    rule: the tiers, the drain and the rescan as the SWITCH's arms, no
    stats; the carry's buffers are the engine's ``ccarry`` wide."""
    src, dst, n = graph("random", 0, 50, 300)
    eng = twl.ShardedWlEngine(make_row_mesh(1, 1), n, 4, ecap=src.size, bcap=8,
                              cfg=TorchConfig(), proportional=True, device="cpu")
    t = eng.loop_table()
    k = len(eng.tiers)
    assert (t.tiers, t.emit, t.proportional, t.has_stats) == (
        eng.tiers, (eng.wcarry,) * k, True, False)
    assert (t.scan, t.stop, t.n_branches) == (k, k + 2, k + 2)
    assert eng.tiers[-1][0] == eng.n_local + 1 and eng.on_graphs
    assert eng._cids.shape == (eng.ccarry,) and eng._cmass.shape == (eng.ccarry, 4)
    assert eng.round_graphs.counts.shape == (loop.N_COUNTS,)
