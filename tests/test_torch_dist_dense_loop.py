"""The sharded dense engine in a world of one shard (pprx_torch.dist.sharded
with a 1x1 mesh under ``dense_rs``): its loop as ``RoundGraphs.loop`` under
K4's dense rule (pprx_torch.engine.loop), rounds of ``push.dense_round_``
(K2, then K1's gather entry) over ``slot_view``, the window's live slots in
delivery order; on the CPU through ``RoundGraphs.host_loop``, the loop the
card captures as one conditional graph.

Held against the JAX package's ShardedEngine on a 1x1 mesh, in f64: a push
from the one-hot state, a push from a converged state (no round), a push
cut at three rounds, and six forward and six reverse slides: equal rounds,
pushes and edge pushes, p and r within 1e-12, equal degrees. The round's
edge pushes are the reference's count over the live slots on the engine's
degrees; the slot view is a brute-force sort of the live slots after random
clears and writes, and its dead and trash slots deliver nothing; a window
whose slots are not 0 or 1 is refused. Every loop's round log replays
through ``loop.replay_log`` under the dense table, and no loop runs but
through ``RoundGraphs.loop``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pprx.config import PprConfig, StreamConfig
from pprx.dist.mesh import make_row_mesh as jax_row_mesh
from pprx.dist.sharded import ShardedEngine as JaxEngine
from pprx.dist.stream import ShardedStreamDriver as JaxDriver
from pprx_torch.config import PprConfig as TorchConfig
from pprx_torch.config import StreamConfig as TorchStreamConfig
from pprx_torch.dist import sharded as tsh
from pprx_torch.dist.mesh import make_row_mesh
from pprx_torch.dist.stream import ShardedStreamDriver
from pprx_torch.engine import graphs, loop
from pprx_torch.engine.graphs import RoundGraphs
from pprx_torch.engine.push import dense_round_
from pprx_torch.engine.segsum import segsum_gather_add_
from pprx_torch.engine.state import FORWARD, REVERSE, PprState
from tests._torch_dist_worker import graph, stream

torch.set_num_threads(1)

MODES = [FORWARD, REVERSE]
QUERIES = (0, 7, 13, 25, 31, 44, 7, 2)


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
        raise AssertionError("the sharded dense loop ran outside RoundGraphs.loop")

    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    monkeypatch.setattr(RoundGraphs, "host_loop", counted)
    monkeypatch.setattr(tsh.ShardedEngine, "_host_push", refused)
    return sink, ran


def _replayed(sink, rounds):
    """Each loop logged every round under the dense table, and replays."""
    assert [len(rec["rows"]) for rec in sink] == list(rounds)
    for rec in sink:
        assert rec["table"] == loop.DENSE_TABLE
        assert loop.replay_log(rec["rows"], rec["table"], rec["max_rounds"]) == [
            (0, 0)] * len(rec["rows"])


def _engine(cls, mesh, src, n, mode, cfg, dtype, **dev):
    return cls(mesh, n, len(QUERIES), ecap=src.size, bcap=8, cfg=cfg, mode=mode, dtype=dtype,
               **dev)


@pytest.mark.parametrize("max_rounds", [10_000, 3])
@pytest.mark.parametrize("mode", MODES)
def test_push_matches_jax_through_the_host_loop(loops, mode, max_rounds):
    """A push from the one-hot state, in full and cut at three rounds, then
    a push from the state it reached: from a converged state no round
    runs, from a cut one the rest of the rounds."""
    sink, ran = loops
    src, dst, n = graph("dangling", 0, 50, 300)
    cfg = dict(alpha=0.15, eps=1e-8, max_rounds=max_rounds)
    a = _engine(JaxEngine, jax_row_mesh(1, 1), src, n, mode, PprConfig(**cfg), jnp.float64)
    b = _engine(tsh.ShardedEngine, make_row_mesh(1, 1), src, n, mode, TorchConfig(**cfg),
                torch.float64, device="cpu")
    assert b.on_graphs and b.n_local == n + 1
    ja, tb = a.init_state(list(QUERIES)), b.init_state(list(QUERIES))
    gja, gtb = a.device_graph(src, dst), b.device_graph(src, dst)
    rounds = []
    for _ in range(2):
        pa, ra, *want = a.push(*ja, *gja[:4])
        pb, rb, *got = b.push(*tb, *gtb[:4])
        assert [int(x) for x in got] == [int(x) for x in want]
        assert pb is tb[0] and rb is tb[1]  # in place
        np.testing.assert_allclose(pb.numpy(), np.asarray(pa), rtol=0, atol=1e-12)
        np.testing.assert_allclose(rb.numpy(), np.asarray(ra), rtol=0, atol=1e-12)
        ja = (pa, ra)
        rounds.append(int(got[0]))
    if max_rounds == 3:
        assert rounds == [3, 3]
    else:
        assert rounds[0] > 3 and rounds[1] == 0
    assert len(ran) == 2
    _replayed(sink, rounds)


@pytest.mark.parametrize("mode", MODES)
def test_slides_match_jax_through_the_host_loop(loops, mode):
    """A seed and six slides of a 300-edge window, slides of 25: each loop's
    rounds, pushes and edge pushes, then the state and the degrees; the
    blocks and the window are the tensors the loops were bound to, and the
    view is the live window's after every slide."""
    sink, ran = loops
    src, dst, n = stream(2)
    queries = [0, 5, 11, 33]
    cfg = dict(alpha=0.15, eps=1e-8, max_rounds=10_000)
    a = JaxDriver(src, dst, n, queries, PprConfig(**cfg), StreamConfig(300, 25),
                  jax_row_mesh(1, 1), mode=mode, dtype=jnp.float64)
    b = ShardedStreamDriver(src, dst, n, queries, TorchConfig(**cfg),
                            TorchStreamConfig(300, 25), make_row_mesh(1, 1), mode=mode,
                            dtype=torch.float64, device="cpu")
    held = (b.p, b.r, b.deg, b.egl, b.eog, b.eva)
    keys = ("rounds", "pushes", "edge_pushes")
    seed_a, seed_b = a.seed(), b.seed()
    assert {k: seed_b[k] for k in keys} == {k: seed_a[k] for k in keys}
    ja, tb = list(a.run(6)), []
    for sa, sb in zip(ja, b.run(6)):
        assert {k: sb[k] for k in keys} == {k: sa[k] for k in keys}
        view = b.eng._view
        want = tsh.slot_view(b.egl, b.eog, b.eva, n)
        assert torch.equal(view.gat, want.gat) and torch.equal(view.off, want.off)
        tb.append(sb["rounds"])
    assert len(ran) == 7 and len(tb) == 6
    assert (b.p, b.r, b.deg, b.egl, b.eog, b.eva) == held
    np.testing.assert_allclose(b.host_p(), a.host_p(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.host_r(), a.host_r(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(b.host_deg(), np.asarray(a.deg))
    _replayed(sink, [seed_b["rounds"]] + tb)


def _slotted_window(seed: int, n: int = 40, ecap: int = 120):
    """A window's slots after random clears and writes: ``egl``, ``eog``,
    ``eva`` [ecap + 1] (the trash slot last), about a third dead."""
    rng = np.random.default_rng(seed)
    egl = rng.integers(0, n, ecap + 1).astype(np.int32)
    eog = rng.integers(0, n, ecap + 1).astype(np.int32)
    eva = (rng.random(ecap + 1) < 0.7).astype(np.int32)
    egl, eog, eva = (torch.from_numpy(x) for x in (egl, eog, eva))
    clear = torch.from_numpy(rng.choice(ecap, 20, replace=False))
    write = torch.from_numpy(rng.choice(ecap, 15, replace=False)).int()
    new = [torch.from_numpy(rng.integers(0, n, 15).astype(np.int32)) for _ in range(2)]
    tsh.write_window_(egl, eog, eva, clear, write, *new, torch.ones(15, dtype=torch.int32))
    return egl, eog, eva


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_view_is_the_sorted_live_slots(seed):
    """``slot_view`` against a brute-force sort: each row's live slots, in
    slot order; dead and trash slots sort past ``off[n]`` and gather the
    zero row ``n``, so a delivery through the view is the live window's."""
    n = 40
    egl, eog, eva = _slotted_window(seed, n)
    view = tsh.slot_view(egl, eog, eva, n)
    live = [i for i in range(eva.shape[0]) if eva[i] > 0]
    want = sorted(live, key=lambda i: (int(eog[i]), i))
    assert view.off.dtype == view.gat.dtype == torch.int32
    assert view.off.shape == (n + 1,) and int(view.off[-1]) == len(want)
    assert view.gat[:len(want)].tolist() == [int(egl[i]) for i in want]
    assert (view.gat[len(want):] == n).all()
    for w in range(n):
        rows = view.gat[view.off[w]:view.off[w + 1]].tolist()
        assert rows == [int(egl[i]) for i in live if int(eog[i]) == w]
    gen = torch.Generator().manual_seed(1)
    table = torch.rand((n + 1, 3), dtype=torch.float64, generator=gen)
    table[n] = 0.0
    got = torch.zeros((n, 3), dtype=torch.float64)
    segsum_gather_add_(got, table, view.gat, view.off)
    direct = torch.zeros((n, 3), dtype=torch.float64)
    keep = eva > 0
    direct.index_add_(0, eog[keep].long(), table[egl[keep].long()])
    torch.testing.assert_close(got, direct, rtol=0, atol=1e-15)


@pytest.mark.parametrize("mode", MODES)
def test_round_counts_are_the_reference_edge_pushes(mode):
    """``dense_round_`` over the slot view on the engine's degrees (the live
    out-degrees) counts the reference's edge pushes, ``(act[egl] &
    live).sum()`` over the slots: forward each active pair's out-degree,
    reverse each live slot's active pairs at its ``egl``."""
    n, s = 40, 4
    egl, eog, eva = _slotted_window(3, n)
    src = eog if mode == REVERSE else egl  # the slot's source
    keep = eva > 0
    deg = torch.zeros(n + 1, dtype=torch.int32).index_add_(
        0, src[keep].long(), torch.ones(int(keep.sum()), dtype=torch.int32))
    gen = torch.Generator().manual_seed(5)
    r = torch.rand((n + 1, s), dtype=torch.float64, generator=gen) * 2e-8
    r[n] = 0.0
    cfg = TorchConfig(alpha=0.15, eps=1e-8)
    th = cfg.eps * deg.clamp(min=1).double()[:, None] if mode == FORWARD else cfg.eps
    act = r.abs() > th
    want = int((act[egl.long()] & keep[:, None]).sum())
    state = PprState(p=torch.zeros_like(r), r=r.clone(), mode=mode)
    view = tsh.slot_view(egl, eog, eva, n)
    counts = torch.zeros(2, dtype=torch.int64)
    dense_round_(state, deg, [(view.gat, view.off)], cfg, counts)
    assert counts.tolist() == [int(act.sum()), want] and want > 0


def test_a_window_of_other_slot_values_is_refused():
    """K1 takes no per-edge weight: a window built or handed over with a
    slot value other than 0 or 1 is refused, not reweighted, and so are a
    slide's new edges."""
    src, dst, n = graph("random", 0, 50, 300)
    eng = _engine(tsh.ShardedEngine, make_row_mesh(1, 1), src, n, FORWARD, TorchConfig(),
                  torch.float64, device="cpu")
    p, r = eng.init_state(list(QUERIES))
    deg, egl, eog, eva, _ = eng.device_graph(src, dst)
    bad = eva.clone()
    bad[3] = 2
    with pytest.raises(ValueError, match="0 or 1"):
        eng.push(p, r, deg, egl, eog, bad)
    with pytest.raises(ValueError, match="0 or 1"):
        tsh.check_slot_values(np.array([0, 1, -1]), "the window")
    eng.push(p, r, deg, egl, eog, eva)
    batch = [torch.zeros(8, dtype=torch.int32) for _ in range(8)]
    batch[5] = torch.full((8,), 3, dtype=torch.int32)  # ins_v
    with pytest.raises(ValueError, match="0 or 1"):
        eng.slide(p, r, deg, egl, eog, eva, *batch)


def test_more_shards_or_the_a2a_exchange_keep_the_host_loop():
    """The device loop is for a world of one shard under ``dense_rs``: the
    ``a2a`` exchange (a capped carry) keeps the host loop, and so does a
    round that holds collectives (more than one shard)."""
    src, dst, n = graph("random", 0, 50, 300)
    a2a = tsh.ShardedEngine(make_row_mesh(1, 1), n, 4, ecap=src.size, bcap=8, cfg=TorchConfig(),
                            exchange="a2a", device="cpu")
    assert not a2a.on_graphs
    p, r = a2a.init_state([0, 7, 13, 25])
    a2a.push(p, r, *a2a.device_graph(src, dst)[:4])
    assert a2a.round_graphs is None
