"""Port of the hybrid stream driver (pprx_torch.graph.hybrid_stream) against
the JAX HybridStreamDriver on the same stream, f64, both modes and both
``worklist`` settings, with rebuild_every=3 over 10 slides (3 snapshot
rebuilds): equal per-slide rounds and counters, p and r at 1e-12, equal
degrees, and the same window, snapshot and overlay. Against the port's own
dense StreamDriver as tests/test_hybrid_stream.py holds the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pprx.config import PprConfig, StreamConfig
from pprx.graph.hybrid_stream import HybridStreamDriver as JaxHybridDriver
from pprx.graph.io import synthetic_powerlaw_stream
from pprx_torch.convert import hybrid_graph_to_arrays
from pprx_torch.engine.state import FORWARD, REVERSE, PushStats
from pprx_torch.graph.hybrid_stream import TUNING, HybridStreamDriver, hybrid_slide_step
from pprx_torch.graph.stream import StreamDriver
from tests.test_torch_sparse import jax_graph_arrays

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.15, eps=1e-8)
QUERIES = [0, 6, 17]
N = 35
MODES = [FORWARD, REVERSE]
# default: the driver's own capacities (every scan round dense: the overlay
# is too big beside the window); tight: slides of 5 and ecap 16, so that
# scan rounds run sparse and the worklist falls back on its edge bound
SHAPES = {"default": (25, {}), "tight": (5, {"ecap": 16})}
COUNTERS = ("rounds", "pushes", "edge_pushes", "wl_rounds", "scans_cand", "scans_fed",
            "scans_liv")


def _stats(s) -> tuple:
    return tuple(int(getattr(s, k)) for k in COUNTERS)


def _drivers(mode, worklist, shape):
    slide, kw = SHAPES[shape]
    src, dst, _ = synthetic_powerlaw_stream(N, 500, seed=11)
    scfg = StreamConfig(window=250, slide=slide)
    kw = dict(mode=mode, rebuild_every=3, worklist=worklist, **kw)
    a = JaxHybridDriver(src, dst, N, QUERIES, CFG, scfg, dtype=jnp.float64, **kw)
    b = HybridStreamDriver(src, dst, N, QUERIES, CFG, scfg, dtype=torch.float64, device="cpu",
                           **kw)
    return a, b


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("worklist", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_hybrid_stream_matches_jax(mode, worklist, shape):
    a, b = _drivers(mode, worklist, shape)
    for attr in TUNING:
        assert getattr(b, attr) == getattr(a, attr), attr
    assert _stats(b.seed()) == _stats(a.seed())
    sa = [_stats(s) for s in a.run(10)]
    sb = list(b.run(10))
    assert [_stats(s) for s in sb] == sa
    for s in sb:
        # the host loop: a read after the prologue, one after each arm (a
        # round, or a count of the frontier)
        assert s.syncs == s.rounds + s.arms["count"] + 1
    np.testing.assert_allclose(b.state.p.numpy(), np.asarray(a.state.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.state.r.numpy(), np.asarray(a.state.r), rtol=0, atol=1e-12)
    assert (b.head, b.step_idx, b.ov_count) == (a.head, a.step_idx, a.ov_count)
    want, got = jax_graph_arrays(a.graph), hybrid_graph_to_arrays(b.graph)
    for k in want:  # window, degrees, snapshot and overlay
        np.testing.assert_array_equal(got[k], want[k], k)
    total = np.sum(sa, axis=0)
    assert total[0] > 0
    if worklist:
        assert total[3] > 0
    if shape == "tight" and worklist:
        assert total[5] > 0  # scans on the edge bound


@pytest.mark.parametrize("worklist", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_hybrid_stream_matches_dense_stream(mode, worklist):
    """The port's hybrid driver and its dense StreamDriver: the same rounds
    a slide and the same state, across snapshot rebuilds."""
    src, dst, _ = synthetic_powerlaw_stream(N, 500, seed=11)
    scfg = StreamConfig(window=250, slide=25)
    a = StreamDriver(src, dst, N, QUERIES, CFG, scfg, mode=mode, dtype=torch.float64,
                     device="cpu")
    b = HybridStreamDriver(src, dst, N, QUERIES, CFG, scfg, mode=mode, dtype=torch.float64,
                           rebuild_every=3, worklist=worklist, device="cpu")
    a.seed(), b.seed()
    assert [s.rounds for s in a.run(10)] == [s.rounds for s in b.run(10)]
    np.testing.assert_allclose(b.state.p.numpy(), a.state.p.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.state.r.numpy(), a.state.r.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(b.graph.window.deg.numpy(), a.graph.deg.numpy())


def test_overlay_overflow_is_refused():
    """The reference's overlay write clamps its start where the 2b entries
    do not fit; the port refuses (the driver rebuilds before that)."""
    _, b = _drivers(FORWARD, True, "default")
    b.seed()
    cap = b.graph.ov.src.shape[0]
    new = torch.zeros(25, dtype=torch.int32)
    slots = torch.arange(25, dtype=torch.int32)
    with pytest.raises(ValueError, match="overlay overflow"):
        hybrid_slide_step(b.state, b.graph, new, new + 1, slots, cap - 49, b.cfg, b.fcap,
                          b.ecap, b.scan_ecap, b.tiers)


def test_driver_rebuilds_before_the_overlay_fills():
    """rebuild_every=3: the overlay holds 3 slides; the 4th rebuilds first."""
    _, b = _drivers(FORWARD, True, "default")
    b.seed()
    fills = []
    for _ in b.run(7):
        fills.append((b.ov_count, int((b.graph.ov.sign != 0).sum())))
    assert fills == [(50, 50), (100, 100), (150, 150), (50, 50), (100, 100), (150, 150),
                     (50, 50)]


def test_reverse_slides_take_their_row_sums_from_the_view(monkeypatch):
    """In reverse each slide's old row sums are K1 over the driver's held
    delivery view (still the old window's, across a rebuild): equal to
    ``out_row_sums`` of the ring at 1e-12 on every slide, which the driver
    no longer calls, and the stream matches the reference at 1e-12 with
    equal rounds."""
    import pprx_torch.engine.update as tupdate
    import pprx_torch.graph.hybrid_stream as thybrid

    seen = []
    apply, row_sums = thybrid.apply_edge_batch_, tupdate.out_row_sums

    def spy(state, graph, *args, rowsum=None, **kw):
        assert rowsum is not None
        np.testing.assert_allclose(rowsum.numpy(), row_sums(state.p, graph).numpy(), rtol=0,
                                   atol=1e-12)
        seen.append(float(rowsum.abs().sum()))
        return apply(state, graph, *args, rowsum=rowsum, **kw)

    monkeypatch.setattr(thybrid, "apply_edge_batch_", spy)
    a, b = _drivers(REVERSE, True, "default")
    a.seed(), b.seed()
    monkeypatch.setattr(tupdate, "out_row_sums", None)  # a call would raise
    ra = [_stats(st) for st in a.run(4)]
    rb = [_stats(st) for st in b.run(4)]
    assert ra == rb and len(seen) == 4 and min(seen) > 0
    np.testing.assert_allclose(b.state.p.numpy(), np.asarray(a.state.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.state.r.numpy(), np.asarray(a.state.r), rtol=0, atol=1e-12)


def test_idle_slide_runs_no_round():
    """A slide that re-inserts the edges it expires changes nothing: its
    candidate list holds only rows under their thresholds, and the loop
    stops after one round of no work, as the reference's does."""
    src, dst, _ = synthetic_powerlaw_stream(N, 250, seed=11)
    src, dst = np.concatenate([src, src[:25]]), np.concatenate([dst, dst[:25]])
    scfg = StreamConfig(window=250, slide=25)
    a = JaxHybridDriver(src, dst, N, QUERIES, CFG, scfg, dtype=jnp.float64)
    b = HybridStreamDriver(src, dst, N, QUERIES, CFG, scfg, dtype=torch.float64, device="cpu")
    a.seed(), b.seed()
    (sa,), (sb,) = list(a.run(1)), list(b.run(1))
    assert _stats(sb) == _stats(sa) and isinstance(sb, PushStats)
    assert sb.rounds == 1 and sb.pushes == 0 and sb.syncs == 2


@pytest.mark.parametrize("mode", MODES)
def test_captured_steps_take_nothing_from_the_host(monkeypatch, mode):
    """Every step the driver captures on the card (the seed's first count,
    the slide's prologue, the worklist tiers, the sparse and dense scans,
    the count, the rebuild) runs here under the dispatch mode that finds
    host values (tests/test_torch_fast_stream.py's): a capture on the card
    refuses them. Both loops, on streams whose scans run sparse and dense,
    over rebuilds: every step kind, none takes a host value."""
    from pprx_torch.engine.graphs import RoundGraphs
    from tests.test_torch_fast_stream import _HostValues

    watch = _HostValues()
    kinds = set()
    run = RoundGraphs.run

    def watched(g, key, fn):
        kinds.update(k for k in key if isinstance(k, str))
        with watch:
            run(g, key, fn)

    monkeypatch.setattr(RoundGraphs, "run", watched)
    for worklist, shape in ((True, "tight"), (True, "default"), (False, "tight")):
        _, b = _drivers(mode, worklist, shape)
        b.seed()
        list(b.run(4))
    assert kinds == {"hybrid", "first", "slide", "tier", "scan", "dense", "count", "rebuild"}
    assert watch.taken == []
