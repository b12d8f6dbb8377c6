"""The sharded wl engine's convergence loop in a world of one shard
(pprx_torch.dist.wl with a 1x1 mesh): its rounds as the branches of
``RoundGraphs.loop``, chosen by K4's plain steps under the sharded rule
(pprx_torch.engine.loop), which on the CPU run through
``RoundGraphs.host_loop``, the loop the card captures as one conditional
graph.

Held against the JAX package's ShardedWlEngine on a 1x1 mesh, in f64: a
push from the one-hot state (unseeded, seeded with the query rows, seeded
with an empty valid list, whose one round the reference runs, and cut at
three rounds, where the last round's stats are skipped), six forward and
six reverse slides across rebuilds: equal rounds, wl rounds, pushes and
edge pushes, p and r within 1e-12, equal degrees. Every loop's round log
replays through ``loop.replay_log`` with the engine's sharded table, and
no loop runs but through ``RoundGraphs.loop``.
"""

import dataclasses

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


@pytest.fixture
def loops(monkeypatch):
    """Every loop's log (``graphs.LOG_SINK``) and the host loops run."""
    sink, ran = [], []
    host_loop = RoundGraphs.host_loop

    def counted(self, *args, **kw):
        ran.append(1)
        return host_loop(self, *args, **kw)

    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    monkeypatch.setattr(RoundGraphs, "host_loop", counted)
    return sink, ran


def _replayed(sink, rounds):
    """Each loop logged every round, under the sharded table, and its
    branches are the plain steps' on the counts it logged."""
    assert [len(rec["rows"]) for rec in sink] == list(rounds)
    for rec in sink:
        assert rec["table"].sharded
        rows = rec["rows"]
        assert loop.replay_log(rows, rec["table"], rec["max_rounds"]) == [
            (row[0], row[7]) for row in rows]


def _push(eng_cls, mesh, src, dst, n, mode, cfg, dtype, seeded, **dev):
    eng = eng_cls(mesh, n, len(QUERIES), ecap=src.size, bcap=8, cfg=cfg, mode=mode,
                  dtype=dtype, ccap=64, **dev)
    p, r = eng.init_state(list(QUERIES))
    deg, _, _, _, _, snap = eng.device_graph_wl(src, dst)
    cand0, ok0 = None, 0
    if seeded is not None:
        rows = np.full((1, eng.wcarry), eng.n_local, np.int32)
        if seeded:
            q = sorted(set(QUERIES))
            rows[0, :len(q)] = q
        cand0, ok0 = eng.cand0_rows(rows), 1
    return eng, eng.push_wl(p, r, deg, snap, cand0, ok0)


@pytest.mark.parametrize("max_rounds", [10_000, 3])
@pytest.mark.parametrize("seeded", [None, True, False])
@pytest.mark.parametrize("mode", MODES)
def test_push_matches_jax_through_the_host_loop(loops, mode, seeded, max_rounds):
    """``push_wl`` from the one-hot state: unseeded (a dense first round),
    seeded with the query rows, and seeded with an empty valid list (one
    empty round, as the reference's loop starts with work 1); in full and
    cut at three rounds."""
    sink, ran = loops
    src, dst, n = graph("random", 0, 50, 300)
    cfg = dict(alpha=0.15, eps=1e-8, max_rounds=max_rounds)
    _, want = _push(jwl.ShardedWlEngine, jax_row_mesh(1, 1), src, dst, n, mode,
                    PprConfig(**cfg), jnp.float64, seeded)
    eng, got = _push(twl.ShardedWlEngine, make_row_mesh(1, 1), src, dst, n, mode,
                     TorchConfig(**cfg), torch.float64, seeded, device="cpu")
    assert eng.on_graphs and len(ran) == 1
    assert [int(x) for x in got[2:]] == [int(x) for x in want[2:]]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    rounds = int(got[2])
    if seeded is False:
        assert rounds == 1
    elif max_rounds == 3:
        assert rounds == 3
    assert eng.round_kinds["compact"] + eng.round_kinds["dense"] == rounds
    assert eng.round_kinds["compact"] == int(got[5])
    _replayed(sink, [rounds])


@pytest.mark.parametrize("mode", MODES)
def test_slides_match_jax_through_the_host_loop(loops, mode):
    """A seed and six slides of a 300-edge window, slides of 25 and a fresh
    ring of 60 (a rebuild every two slides): each loop's tallies, then the
    state and the degrees."""
    sink, ran = loops
    src, dst, n = stream(11)
    queries = [0, 5, 9, 17]
    kw = dict(engine="wl", ccap=64, fring=60)
    a = JaxDriver(src, dst, n, queries, PprConfig(alpha=0.15, eps=1e-8, max_rounds=10_000),
                  StreamConfig(300, 25), jax_row_mesh(1, 1), mode=mode, dtype=jnp.float64, **kw)
    b = ShardedStreamDriver(src, dst, n, queries,
                            TorchConfig(alpha=0.15, eps=1e-8, max_rounds=10_000),
                            TorchStreamConfig(300, 25), make_row_mesh(1, 1), mode=mode,
                            dtype=torch.float64, device="cpu", **kw)
    rebuilds = []
    rebuild_ = b.eng.rebuild_

    def counted(*args):
        rebuilds.append(b.step_idx)
        return rebuild_(*args)

    b.eng.rebuild_ = counted
    p0, r0, deg0, snap0 = b.p, b.r, b.deg, b.snap
    ja = [a.seed(), *a.run(6)]
    tb = [b.seed(), *b.run(6)]
    assert len(rebuilds) >= 2 and len(ran) == 7
    for sa, sb in zip(ja, tb, strict=True):
        assert {k: sb[k] for k in TALLIES} == {k: sa[k] for k in TALLIES}
    # the blocks and the snapshot are the tensors the loops were bound to
    assert (b.p, b.r, b.deg, b.snap) == (p0, r0, deg0, snap0)
    np.testing.assert_allclose(b.host_p(), a.host_p(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.host_r(), a.host_r(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(b.host_deg(), np.asarray(a.deg))
    _replayed(sink, [st["rounds"] for st in tb])


def test_the_loop_table_is_the_engines():
    """The table the loop runs under: the engine's ladder, each tier's list
    ``wcarry`` wide (always valid at K = 1), the engine's stats-skip
    threshold (read when the loop runs) and the sharded rule; the
    proportional loop's has its own rule (tests/test_torch_dist_prop_loop.py)."""
    src, dst, n = graph("random", 0, 50, 300)
    eng = twl.ShardedWlEngine(make_row_mesh(1, 1), n, 4, ecap=src.size, bcap=8,
                              cfg=TorchConfig(), device="cpu")
    t = eng.loop_table()
    assert (t.tiers, t.emit, t.heavy_ew, t.sharded) == (
        eng.tiers, (eng.wcarry,) * len(eng.tiers), eng.heavy_ew, True)
    eng.heavy_ew = 7
    assert eng.loop_table() == dataclasses.replace(t, heavy_ew=7)
    assert eng.round_graphs.counts.shape == (loop.N_COUNTS,)
    wlp = twl.ShardedWlEngine(make_row_mesh(1, 1), n, 4, ecap=src.size, bcap=8,
                              cfg=TorchConfig(), proportional=True, device="cpu")
    assert wlp.on_graphs and wlp.loop_table().rule == loop.PROPORTIONAL


def test_rebound_blocks_are_refused():
    """A push on tensors other than the ones the engine's loop was bound to
    raises: a captured graph reads its buffers where they lie."""
    src, dst, n = graph("random", 0, 50, 300)
    eng = twl.ShardedWlEngine(make_row_mesh(1, 1), n, 4, ecap=src.size, bcap=8,
                              cfg=TorchConfig(), device="cpu")
    p, r = eng.init_state([0, 7, 13, 25])
    deg, _, _, _, _, snap = eng.device_graph_wl(src, dst)
    eng.push_wl(p, r, deg, snap)
    with pytest.raises(RuntimeError, match="rebound"):
        eng.push_wl(p.clone(), r, deg, snap)
