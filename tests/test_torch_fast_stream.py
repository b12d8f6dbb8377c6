"""Port of the fast stream driver (pprx_torch.graph.fast_stream) against the
JAX FastStreamDriver and the dense drivers on the same stream, both modes,
and against exact PPR."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pprx.config import PprConfig, StreamConfig
from pprx.eval.metrics import l1_error
from pprx.graph.fast_stream import FastStreamDriver as JaxDriver
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.graph.stream import StreamDriver as JaxDenseDriver
from pprx.ref.exact import exact_ppr
from pprx.retrieve.topk import topk_candidates as jax_topk
from pprx_torch.engine.state import FORWARD, REVERSE
from pprx_torch.engine.update import out_row_sums, window_row_sums
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.stream import StreamDriver
from pprx_torch.ref.exact import exact_ppr_columns
from pprx_torch.retrieve.topk import topk_candidates

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)
SCFG = StreamConfig(window=250, slide=25)
QUERIES = [0, 6, 17]
N = 35


def _pair(mode=FORWARD):
    """The JAX and port drivers on tests/test_wl2.py's stream, f64,
    rebuild_every=3 (several snapshot rebuilds in 10 slides)."""
    src, dst, _ = synthetic_powerlaw_stream(N, 500, seed=11)
    kw = dict(mode=mode, rebuild_every=3, e_top=64, n_tiers=3)
    a = JaxDriver(src, dst, N, QUERIES, CFG, SCFG, dtype=jnp.float64, segsum=False, **kw)
    b = FastStreamDriver(src, dst, N, QUERIES, CFG, SCFG, dtype=torch.float64, device="cpu", **kw)
    return a, b


def assert_same_state(a, b, atol=1e-12):
    np.testing.assert_allclose(b.state.p.numpy(), np.asarray(a.state.p), rtol=0, atol=atol)
    np.testing.assert_allclose(b.state.r.numpy(), np.asarray(a.state.r), rtol=0, atol=atol)
    np.testing.assert_array_equal(b.graph.window.deg.numpy(), np.asarray(a.graph.window.deg))


def test_fast_stream_matches_jax():
    a, b = _pair()
    assert b.tiers == a.tiers
    sa, sb = a.seed(), b.seed()
    assert sb.rounds == int(sa.rounds)
    ra = [(int(s.rounds), int(s.wl_rounds)) for s in a.run(10)]
    rb = [(s.rounds, s.wl_rounds) for s in b.run(10)]
    assert ra == rb
    assert_same_state(a, b)
    # the port keeps the ring and its host mirror as the reference does
    np.testing.assert_array_equal(b.hsrc, a.hsrc)
    np.testing.assert_array_equal(b.graph.window.src.numpy(), np.asarray(a.graph.window.src))


def test_fast_stream_reverse_matches_jax():
    a, b = _pair(REVERSE)
    assert b.tiers == a.tiers
    sa, sb = a.seed(), b.seed()
    assert sb.rounds == int(sa.rounds)
    ra = [(int(s.rounds), int(s.wl_rounds)) for s in a.run(10)]
    rb = [(s.rounds, s.wl_rounds) for s in b.run(10)]
    assert ra == rb and sum(wl for _, wl in rb) > 0
    assert_same_state(a, b)
    np.testing.assert_array_equal(b.hsrc, a.hsrc)
    # the reverse kill graph gathers by dst: the fresh ring holds (dst, src)
    np.testing.assert_array_equal(b.graph.fr_gat.numpy(), np.asarray(a.graph.fr_gat))
    np.testing.assert_array_equal(b.graph.fr_sca.numpy(), np.asarray(a.graph.fr_sca))
    np.testing.assert_array_equal(b.graph.f_len.numpy(), np.asarray(a.graph.f_len))


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_fast_stream_matches_dense_stream(mode):
    """tests/test_wl2.py's test of the same name on the port: the fast
    driver against the port's dense driver and the JAX dense driver, equal
    rounds per slide, p/r at 1e-12, ``deg`` equal."""
    src, dst, _ = synthetic_powerlaw_stream(N, 500, seed=11)
    j = JaxDenseDriver(src, dst, N, QUERIES, CFG, SCFG, mode=mode, dtype=jnp.float64)
    a = StreamDriver(src, dst, N, QUERIES, CFG, SCFG, mode=mode, dtype=torch.float64,
                     device="cpu")
    b = FastStreamDriver(src, dst, N, QUERIES, CFG, SCFG, mode=mode, dtype=torch.float64,
                         rebuild_every=3, e_top=64, n_tiers=3, device="cpu")
    j.seed(), a.seed(), b.seed()
    rj = [int(s.rounds) for s in j.run(10)]
    ra = [s.rounds for s in a.run(10)]
    rb = [s.rounds for s in b.run(10)]
    assert rj == ra == rb
    for ref_p, ref_r, ref_deg in ((a.state.p.numpy(), a.state.r.numpy(), a.graph.deg.numpy()),
                                  (np.asarray(j.state.p), np.asarray(j.state.r),
                                   np.asarray(j.graph.deg))):
        np.testing.assert_allclose(b.state.p.numpy(), ref_p, rtol=0, atol=1e-12)
        np.testing.assert_allclose(b.state.r.numpy(), ref_r, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(b.graph.window.deg.numpy(), ref_deg)


def test_reverse_rowsum_routes_agree_on_every_slide():
    """The reverse corrections' old row sums by both routes, before every
    slide of a stream that crosses three rebuilds: from the kill graph's
    delivery views through the segment sum (killed snapshot slots, a fresh
    ring that is empty, part-filled and full) against the COO sweep of the
    ring, f64, 1e-12."""
    _, b = _pair(REVERSE)
    b.seed()
    seen = set()
    for _ in range(10):
        kg = b.graph
        views = window_row_sums(b.state.p, [(kg.d_gat, kg.d_off[:N + 1]),
                                            (kg.fd_gat, kg.fd_off[:N + 1])])
        sweep = out_row_sums(b.state.p, b.graph.window)
        np.testing.assert_allclose(views.numpy(), sweep.numpy(), rtol=0, atol=1e-12)
        assert float(sweep.abs().sum()) > 0
        seen.add((b.fcnt, int((b.graph.d_gat == N).sum())))
        assert len(list(b.run(1))) == 1
    # (ring fill, killed slots) before each slide: 1, 2 and 3 slides after a
    # rebuild (the driver rebuilds, back to (0, 0), inside the slide that
    # finds the ring full): three rebuilds in 10 slides
    assert seen == {(0, 0), (25, 25), (50, 50), (75, 75)} and b.step_idx == 10


def test_reverse_stream_against_exact_columns():
    """The reverse contract after a stream and a refine: max_v |p[v, j] -
    M[v, t_j]| <= eps in f64 (|r| <= eps and the rows of M sum to 1)."""
    a, b = _pair(REVERSE)
    a.seed(), b.seed()
    list(a.run(7)), list(b.run(7))
    cols = exact_ppr_columns(b.hsrc, b.hdst, N, QUERIES, CFG.alpha, tol=1e-14, device="cpu")
    p = b.state.p.numpy()[:N]
    assert np.abs(p - cols.T).max() <= CFG.eps
    assert float(b.state.r.abs().max()) <= CFG.eps
    sa, sb = a.refine(5e-10), b.refine(5e-10)
    assert sb.rounds == int(sa.rounds) > 0
    assert_same_state(a, b)
    assert np.abs(b.state.p.numpy()[:N] - cols.T).max() <= 5e-10


def test_fast_stream_sorted_compact_delivery_matches_jax(monkeypatch):
    """The reference's ``SORT_DELIVER_MIN`` lowered, so every compact round
    of the stream sorts its lanes and delivers through the segment sum, as
    the port's rounds do at every size (the gather entry on ``vals`` under
    the sort order, ``segsum.sorted_deliver_``). Scan rounds deliver
    through the dense engine's round (``push.dense_round_``)."""
    import pprx.engine.wl2 as jwl2
    import pprx_torch.engine.push as tpush
    import pprx_torch.engine.segsum as tsegsum

    monkeypatch.setattr(jwl2, "SORT_DELIVER_MIN", 1)
    calls = []
    fused = tsegsum.segsum_gather_add_
    for mod in (tsegsum, tpush):
        monkeypatch.setattr(
            mod, "segsum_gather_add_",
            lambda rin, table, gat, off, **kw: (
                calls.append(gat.dtype), fused(rin, table, gat, off, **kw))[1],
        )
    a, b = _pair()
    a.seed(), b.seed()
    ra = [(int(s.rounds), int(s.wl_rounds)) for s in a.run(6)]
    rb = [(s.rounds, s.wl_rounds) for s in b.run(6)]
    assert ra == rb and sum(wl for _, wl in rb) > 0
    assert_same_state(a, b)
    # compact rounds hand over torch.sort's int64 order, scan rounds int32 views
    assert torch.int64 in calls and torch.int32 in calls


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_slides_hand_their_corrections_over_sorted(monkeypatch, mode):
    """Each slide sorts both batches by the row their corrections add to
    and tells ``apply_edge_batch_`` so (``keys_sorted``): K1 takes the
    lanes as they lie, no second sort. The keys are ascending and repeat,
    and ten slides match the reference at 1e-12 with equal rounds."""
    import pprx_torch.graph.fast_stream as tfast

    keys = []
    apply = tfast.apply_edge_batch_

    def spy(state, graph, ins_src, ins_dst, del_src, del_dst, cfg, **kw):
        assert kw.pop("keys_sorted") is True
        forward = state.mode == FORWARD
        keys.extend([ins_dst if forward else ins_src, del_dst if forward else del_src])
        return apply(state, graph, ins_src, ins_dst, del_src, del_dst, cfg, keys_sorted=True,
                     **kw)

    monkeypatch.setattr(tfast, "apply_edge_batch_", spy)
    a, b = _pair(mode)
    a.seed(), b.seed()
    ra = [(int(st.rounds), int(st.wl_rounds)) for st in a.run(10)]
    rb = [(st.rounds, st.wl_rounds) for st in b.run(10)]
    assert ra == rb and len(keys) == 20
    assert all(bool((k[1:] >= k[:-1]).all()) for k in keys)
    assert any(k.unique().numel() < k.numel() for k in keys)
    assert_same_state(a, b)


def test_refine_then_topk_matches_jax():
    a, b = _pair()
    a.seed(), b.seed()
    list(a.run(4)), list(b.run(4))
    # 50x below the maintained eps, as bench.py's 5e-8 is below its 1e-6
    sa, sb = a.refine(5e-10), b.refine(5e-10)
    assert sb.rounds == int(sa.rounds)
    assert_same_state(a, b)
    k = 10
    js, ji = (np.asarray(x) for x in jax_topk(a.state.p, k, exact=True))
    ts, ti = (x.numpy() for x in topk_candidates(b.state.p, k))
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-12)
    # ids agree wherever the score is not tied with a neighbour
    distinct = np.ones_like(js, dtype=bool)
    gap = np.abs(np.diff(js, axis=1)) > 1e-12
    distinct[:, 1:] &= gap
    distinct[:, :-1] &= gap
    assert distinct.any()
    np.testing.assert_array_equal(ti[distinct], ji[distinct])


def test_bf16_delivery_conserves_mass():
    """bf16 scan-round delivery (residual removal stays exact): the stream
    conserves mass to the bf16 rounding of the delivered increments and
    tracks the f32 engine (tolerances of tests/test_wl2.py)."""
    n = 60
    src, dst, _ = synthetic_powerlaw_stream(n, 900, seed=4)
    scfg = StreamConfig(window=600, slide=60)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=5000)

    def run(bf16d):
        drv = FastStreamDriver(
            src, dst, n, [0, 5, 11], cfg, scfg, dtype=torch.float32,
            rebuild_every=3, bf16d=bf16d, device="cpu",
        )
        drv.seed()
        list(drv.run(4))
        return drv.state.p.numpy(), drv.state.r.numpy()

    p32, _ = run(False)
    p16, r16 = run(True)
    np.testing.assert_allclose(p16[:n].sum(axis=0) + r16[:n].sum(axis=0), 1.0, atol=1e-2)
    np.testing.assert_allclose(p16, p32, atol=1e-2)


def test_bf16_mass_loss_is_the_references():
    """bf16 delivery against the reference's (its kernel in interpret mode,
    as tests/test_wl2.py runs it), forward, f32, slide by slide: the mass
    each loses. At the seed the two agree within 2e-5 (f32 sums in another
    order over some 60 rounds); once f32
    knife-edges part their round schedules they stay within 1e-3 of each
    other, and both within the documented 2^-9-relative rounding of 1. The
    loss is inherited, not the port's."""
    n = 60
    src, dst, _ = synthetic_powerlaw_stream(n, 1200, seed=4)
    scfg = StreamConfig(window=600, slide=60)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=5000)
    queries = [0, 5, 11]
    a = JaxDriver(src, dst, n, queries, cfg, scfg, dtype=jnp.float32, rebuild_every=3,
                  segsum=True, bf16d=True)
    b = FastStreamDriver(src, dst, n, queries, cfg, scfg, dtype=torch.float32, rebuild_every=3,
                         bf16d=True, device="cpu")

    def mass(drv):
        p, r = (np.asarray(t, np.float64)[:n] for t in (drv.state.p, drv.state.r))
        return p.sum(0) + r.sum(0)

    a.seed()
    b.seed()
    np.testing.assert_allclose(mass(b), mass(a), rtol=0, atol=2e-5)
    assert np.abs(mass(a) - 1.0).max() > 1e-4  # bf16 loses mass in both
    for _ in zip(a.run(6), b.run(6)):
        np.testing.assert_allclose(mass(b), mass(a), rtol=0, atol=1e-3)
        for drv in (a, b):
            np.testing.assert_allclose(mass(drv), 1.0, atol=1e-2)


def test_f32_stream_against_exact_ppr():
    """f32 at n=2000, W=20k, b=2k, S=16: the eps-approximation contract
    (L1 <= eps * E per source) and mass conservation."""
    n, w, b = 2000, 20_000, 2_000
    src, dst, _ = synthetic_powerlaw_stream(n, w + 5 * b, seed=5)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=5000)
    queries = list(range(0, 2000, 125))
    drv = FastStreamDriver(
        src, dst, n, queries, cfg, StreamConfig(window=w, slide=b),
        dtype=torch.float32, rebuild_every=3, device="cpu",
    )
    drv.seed()
    stats = list(drv.run(4))
    assert all(s.rounds > 0 and s.syncs == s.rounds + 1 + s.stats_reads for s in stats)
    p = drv.state.p.numpy().astype(np.float64)
    r = drv.state.r.numpy().astype(np.float64)
    np.testing.assert_allclose(p[:n].sum(0) + r[:n].sum(0), 1.0, atol=1e-4)
    for j, q in enumerate(queries):
        pi = exact_ppr(drv.hsrc, drv.hdst, n, q, cfg.alpha, tol=1e-12)
        assert l1_error(p[:n, j], pi) <= cfg.eps * w


def test_driver_refuses_bad_configs():
    src, dst, _ = synthetic_powerlaw_stream(N, 500, seed=11)
    with pytest.raises(ValueError, match="rebuild_every"):
        FastStreamDriver(src, dst, N, QUERIES, CFG, SCFG, rebuild_every=11, device="cpu")
    with pytest.raises(ValueError, match="shorter"):
        FastStreamDriver(src[:100], dst[:100], N, QUERIES, CFG, SCFG, device="cpu")



def _buffer_ptrs(drv):
    """The addresses a captured round reads: p, r, and every tensor of the
    kill graph and its window (deg among them)."""
    from pprx_torch.engine.graphs import tensor_ptrs

    return tensor_ptrs(drv.state) + tensor_ptrs(drv.graph)


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_driver_buffers_keep_their_addresses(mode):
    """The precondition of the card's captured rounds: ``data_ptr()`` of
    ``p``, ``r``, ``deg`` and every ``KillGraph`` tensor is the same across
    slides, across rebuilds (rebuild_every=3: three in 10 slides), after a
    refine and after ``headline.restore``, and the state still follows the
    reference's through all of them."""
    from pprx_torch.bench import headline

    a, b = _pair(mode)
    a.seed(), b.seed()
    ptrs = _buffer_ptrs(b)
    assert len(ptrs) == 2 + 3 + 14  # p, r; the window's src, dst, deg; 14 kill-graph views
    rebuilds, snap = 0, None
    for step in range(10):
        if step == 7:
            snap = headline.snapshot(b)
        fcnt = b.fcnt
        list(a.run(1)), list(b.run(1))
        rebuilds += b.fcnt < fcnt
        assert _buffer_ptrs(b) == ptrs
    assert rebuilds == 3
    assert_same_state(a, b)
    sa, sb = a.refine(5e-10), b.refine(5e-10)
    assert sb.rounds == int(sa.rounds) > 0 and _buffer_ptrs(b) == ptrs
    assert_same_state(a, b)
    headline.restore(b, snap)
    assert _buffer_ptrs(b) == ptrs
    np.testing.assert_array_equal(b.state.p.numpy(), snap[0].p.numpy())
    np.testing.assert_array_equal(b.graph.d_gat.numpy(), snap[1].d_gat.numpy())
    assert len(list(b.run(1))) == 1 and _buffer_ptrs(b) == ptrs


def test_rebound_state_is_refused():
    """A state rebound to new tensors after the rounds were bound raises
    (on the card its captured graphs would read the old ones)."""
    from pprx_torch.engine.state import PprState

    _, b = _pair()
    b.seed()
    b.state = PprState(p=b.state.p.clone(), r=b.state.r.clone(), mode=b.state.mode)
    with pytest.raises(RuntimeError, match="rebound"):
        list(b.run(1))


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_rebound_pack_is_refused(mode):
    """``wl2_slide_step`` with the driver's round graphs and a batch in a
    new tensor raises: the captured prologue reads the pack it was bound
    to, and a graph a pack would pile up without bound. The driver's own
    pack, with the next batch uploaded into it, goes through."""
    from pprx_torch.graph.fast_stream import wl2_slide_step

    _, b = _pair(mode)
    b.seed()
    list(b.run(1))
    with pytest.raises(RuntimeError, match="pack was rebound"):
        wl2_slide_step(b.state, b.graph, b._pack.clone(), b.fcnt, b.cfg, b.tiers,
                       graphs=b.round_graphs)
    assert len(list(b.run(1))) == 1


class _HostValues:
    """A dispatch mode that records ops taking a tensor made from a Python
    value (``lift_fresh``), ``fill_`` apart: on the card such a value is
    copied from the host, which a CUDA graph capture refuses."""

    def __new__(cls):
        import weakref

        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        class Mode(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.lifted = weakref.WeakValueDictionary()
                self.taken = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func is not torch.ops.aten.fill_.Tensor:
                    self.taken += [str(func) for a in tree_leaves((args, kwargs))
                                   if isinstance(a, torch.Tensor) and self.lifted.get(id(a)) is a]
                out = func(*args, **kwargs)
                if func is torch.ops.aten.lift_fresh.default:
                    self.lifted[id(out)] = out
                return out

        return Mode()


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_captured_steps_take_nothing_from_the_host(monkeypatch, mode):
    """Every step a driver captures on the card (the rounds, a seed's first
    count, the slide's prologue, the rebuild) runs here under a dispatch
    mode that finds host values: ``x[idx] = True``, or ``x[i] = 0`` where
    ``x[i]`` is one element, copy their value from the host, and a capture
    on the card refuses that. Seed, 4 slides (a rebuild among them) and a
    refine: every step kind, none takes a host value."""
    from pprx_torch.engine.graphs import RoundGraphs

    watch = _HostValues()
    with watch:
        x = torch.zeros(4, dtype=torch.int32)
        x[2] = 0  # the detector finds what it looks for
    assert watch.taken == ["aten.copy_.default"]
    watch.taken.clear()
    kinds = set()
    run = RoundGraphs.run

    def watched(g, key, fn):
        kinds.add(next(k for k in key if isinstance(k, str)))
        with watch:
            run(g, key, fn)

    monkeypatch.setattr(RoundGraphs, "run", watched)
    _, b = _pair(mode)
    b.seed()
    list(b.run(4))
    b.refine(5e-10)
    assert kinds == {"first", "compact", "scan", "stats", "slide", "rebuild"}
    assert watch.taken == []
