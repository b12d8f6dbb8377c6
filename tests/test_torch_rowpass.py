"""The row passes (pprx_torch.engine.rowpass) and the in-place corrections
(pprx_torch.engine.update.apply_edge_batch_) against the JAX package, both
modes, f64, on the CPU, where the wrappers run their plain versions.

- A scan round (``dense_round_sorted``, its elementwise work through
  ``scan_pass_``) against the reference's ``dense_round_sorted(segsum=False)``
  on a kill graph mid-stream (killed snapshot slots, a part-filled fresh
  ring, dangling rows) at several widths, with entries exactly at the push
  threshold: p and r within 1e-12 (the same arithmetic; the delivery's
  summation order may differ), both counts equal.
- The rescan (``_frontier_stats`` through ``frontier_rows``) against the
  reference's: a big compact round's emitted list and counts, and a light
  scan's stats step on its own, all equal.
- The corrections in place and out of place against the reference's
  ``apply_edge_batch`` at 1e-12.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pprx.engine.wl2 as jwl2
import pprx_torch.engine.wl2 as twl2
from pprx.config import PprConfig, StreamConfig
from pprx.engine.push import _active_mask as jax_active_mask
from pprx.engine.state import PprState as JaxState
from pprx.engine.update import apply_edge_batch as jax_apply
from pprx.graph.dynamic import WindowGraph as JaxWindow
from pprx.graph.fast_stream import FastStreamDriver as JaxDriver
from pprx_torch.engine import rowpass
from pprx_torch.engine.graphs import RoundGraphs
from pprx_torch.engine.rowpass import (
    frontier_rows,
    frontier_rows_plain,
    scan_pass_,
    scan_pass_plain,
)
from pprx_torch.engine.state import FORWARD, REVERSE, PprState
from pprx_torch.engine.update import (
    apply_edge_batch,
    apply_edge_batch_,
    out_row_sums,
    window_row_sums,
)
from pprx_torch.graph.dynamic import WindowGraph
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.io import synthetic_powerlaw_stream
from tests.conftest import random_multigraph

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)
LOOSE = PprConfig(alpha=0.2, eps=1e-4)  # a crafted state's threshold: many pairs active
N = 35
WIDTHS = [1, 3, 8, 16]
MODES = [FORWARD, REVERSE]


@functools.cache
def _drivers(mode: int):
    """Both packages' fast drivers on one stream after a rebuild and two
    slides of kills: killed snapshot slots, a part-filled fresh ring, and
    vertices with no out-edge in the window."""
    src, dst, _ = synthetic_powerlaw_stream(N, 500, seed=11)
    scfg = StreamConfig(window=250, slide=25)
    kw = dict(mode=mode, rebuild_every=3, e_top=64, n_tiers=3)
    a = JaxDriver(src, dst, N, [0, 6, 17], CFG, scfg, dtype=jnp.float64, segsum=False, **kw)
    b = FastStreamDriver(src, dst, N, [0, 6, 17], CFG, scfg, dtype=torch.float64,
                         device="cpu", **kw)
    a.seed(), b.seed()
    list(a.run(5)), list(b.run(5))
    deg = b.graph.window.deg
    assert b.fcnt == 50 < b.fring and int((b.graph.d_gat == N).sum()) == 50
    assert int((deg[:N] == 0).sum()) >= 2
    np.testing.assert_array_equal(np.asarray(a.graph.window.deg), deg.numpy())
    return a, b


def _state(mode: int, s: int, deg: np.ndarray, seed: int):
    """A crafted ``[N+1, s]`` f64 state: p >= 0, signed r around the push
    threshold, a few entries exactly at it and a few just above it, dangling
    rows with mass, the phantom row zero. Returns (p, r) as numpy."""
    rng = np.random.default_rng(seed)
    p = np.abs(rng.normal(size=(N + 1, s))) * 1e-2
    r = rng.normal(size=(N + 1, s)) * 4e-4
    th = LOOSE.eps * np.maximum(deg, 1).astype(np.float64) if mode == FORWARD else \
        np.full(N + 1, LOOSE.eps)
    rows = rng.integers(0, N, size=12)
    cols = rng.integers(0, s, size=12)
    sign = rng.choice([-1.0, 1.0], size=12)
    r[rows[:6], cols[:6]] = sign[:6] * th[rows[:6]]  # at the threshold: not active
    r[rows[6:], cols[6:]] = sign[6:] * np.nextafter(th[rows[6:]], 1.0)  # just above it
    dangling = np.flatnonzero(deg[:N] == 0)
    r[dangling] = np.where(rng.random((dangling.size, s)) < 0.5, 3e-3, -3e-3)
    r[rng.integers(0, N, size=4)] = 0.0
    p[-1] = r[-1] = 0.0
    return p, r


def _pair(mode: int, s: int, seed: int):
    """The same crafted state for both packages, on each driver's graph."""
    a, b = _drivers(mode)
    p, r = _state(mode, s, b.graph.window.deg.numpy(), seed)
    jst = JaxState(p=jnp.asarray(p), r=jnp.asarray(r), mode=mode)
    tst = PprState(p=torch.from_numpy(p.copy()), r=torch.from_numpy(r.copy()), mode=mode)
    return a.graph, jst, b.graph, tst


@pytest.mark.parametrize("s", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_scan_round_matches_jax(mode, s):
    """``dense_round_sorted`` through ``scan_pass_`` against the
    reference's XLA form: the state within 1e-12, n_active and the edge
    pushes equal, and the pass's own counts (active pairs, each row's in
    reverse) equal to the mask's."""
    jkg, jst, tkg, tst = _pair(mode, s, seed=s)
    act = np.asarray(jax_active_mask(jst, jkg.window, LOOSE))
    assert 0 < act.sum() < act.size
    j2, jna, jew = jwl2.dense_round_sorted(jst, jkg, LOOSE, segsum=False)
    t2, tna, tew = twl2.dense_round_sorted(tst, tkg, LOOSE)
    assert t2 is tst
    assert (int(tna), int(tew)) == (float(jna), float(jew))
    assert int(tna) == act.sum()
    np.testing.assert_allclose(t2.p.numpy(), np.asarray(j2.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t2.r.numpy(), np.asarray(j2.r), rtol=0, atol=1e-12)


@pytest.mark.parametrize("s", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_scan_pass_outputs(mode, s):
    """``scan_pass_`` on its own, against the reference's arithmetic written
    out: p and r in place, ``moving`` (f64, and bf16 as the f32 pass rounds
    it), the counts added to what ``counts`` held, each row's count; no
    kernel is launched on the CPU."""
    jkg, jst, tkg, tst = _pair(mode, s, seed=10 + s)
    deg = tkg.window.deg
    act = np.asarray(jax_active_mask(jst, jkg.window, LOOSE))
    p0, r0 = tst.p.clone(), tst.r.clone()
    moving = torch.empty_like(tst.r)
    counts = torch.tensor([5, 7])
    row_act = torch.full((N + 1,), -1, dtype=torch.int32)
    before = dict(rowpass.LAUNCHES)
    scan_pass_(tst.p, tst.r, deg, moving, counts, row_act, eps=LOOSE.eps, alpha=LOOSE.alpha,
               forward=mode == FORWARD)
    assert rowpass.LAUNCHES == before
    a, d = LOOSE.alpha, deg.numpy()
    m = np.where(act, r0.numpy(), 0.0)
    dang = (d == 0)[:, None]
    np.testing.assert_array_equal(tst.r.numpy(), r0.numpy() - m)
    np.testing.assert_array_equal(tst.p.numpy(), p0.numpy() + np.where(dang, m, a * m))
    if mode == FORWARD:
        want = (1 - a) * m / np.maximum(d, 1)[:, None]
        assert counts.tolist() == [5 + act.sum(), 7 + (act * d[:, None]).sum()]
    else:
        want = np.where(dang, (1 - a) / a * m, (1 - a) * m)
        assert counts.tolist() == [5 + act.sum(), 7]
    np.testing.assert_allclose(moving.numpy(), want, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(row_act.numpy(), act.sum(axis=1))
    # f32 with bf16 moving: the f32 pass's moving, rounded to nearest even
    p32, r32 = p0.float(), r0.float()
    m32 = torch.empty_like(r32)
    scan_pass_plain(p32.clone(), r32.clone(), deg, m32, torch.zeros(2, dtype=torch.int64),
                    eps=LOOSE.eps, alpha=a, forward=mode == FORWARD)
    m16 = torch.empty_like(r32, dtype=torch.bfloat16)
    scan_pass_(p32, r32, deg, m16, torch.zeros(2, dtype=torch.int64), eps=LOOSE.eps, alpha=a,
               forward=mode == FORWARD)
    assert torch.equal(m16, m32.to(torch.bfloat16))


@pytest.mark.parametrize("s", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_frontier_rows_match_the_mask(mode, s):
    """``frontier_rows`` on ``r[:n]``: the rows whose mask has an active
    pair, and their count and edge totals."""
    jkg, jst, tkg, tst = _pair(mode, s, seed=20 + s)
    any2 = np.asarray(jax_active_mask(jst, jkg.window, LOOSE))[:N].any(axis=1)
    got = frontier_rows(tst.r[:N], tkg.window.deg[:N], tkg.row_len[:N], tkg.f_len[:N],
                        eps=LOOSE.eps, forward=mode == FORWARD)
    np.testing.assert_array_equal(got[0].numpy(), any2)
    assert [int(x) for x in got[1:]] == [
        any2.sum(), tkg.row_len[:N].numpy()[any2].sum(), tkg.f_len[:N].numpy()[any2].sum()]
    assert all(x.dtype == torch.int64 and x.dim() == 0 for x in got[1:])


@pytest.mark.parametrize("s", [3, 16])
@pytest.mark.parametrize("mode", MODES)
def test_compact_round_rescan_matches_jax(mode, s):
    """A compact round that emits by rescan (``_frontier_stats``, through
    ``frontier_rows``) against the reference's (``wl2.py:506-516``): the
    state within 1e-12, the emitted list and its counts equal."""
    jkg, jst, tkg, tst = _pair(mode, s, seed=30 + s)
    act = np.asarray(jax_active_mask(jst, jkg.window, LOOSE))
    live = np.flatnonzero(act[:N].any(axis=1)).astype(np.int32)
    cand = np.concatenate([live, np.full(N + 1 - live.size, N, np.int32)])
    e_cap, g_cap, emit_w = int(tkg.nbr.shape[0]), int(tkg.fr_gat.shape[0]), N + 1
    j2, jc, jcn, jfed, jfre, jok, jna, jew = jwl2._compact_round(
        jst, jkg, LOOSE, jnp.asarray(cand), e_cap, g_cap, emit_w, True)
    t2, tc, tcn, tfed, tfre, tna, tew = twl2._compact_round(
        tst, tkg, LOOSE, torch.from_numpy(cand), e_cap, g_cap, emit_w, True)
    assert bool(jok)
    np.testing.assert_allclose(t2.p.numpy(), np.asarray(j2.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t2.r.numpy(), np.asarray(j2.r), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert [int(x) for x in (tcn, tfed, tfre, tna, tew)] == [
        int(jcn), int(jfed), int(jfre), float(jna), float(jew)]
    assert 0 < int(tcn) < N


@pytest.mark.parametrize("mode", MODES)
def test_stats_step_matches_the_reference_rescan(mode):
    """A light scan's stats step on its own (``_stats_step``: the list and
    counts into the round buffers) against the reference's ``full_stats``
    (``pprx/engine/wl2.py:639-649``) on the same post-scan state."""
    jkg, jst, tkg, tst = _pair(mode, 8, seed=40)
    jst, _, _ = jwl2.dense_round_sorted(jst, jkg, LOOSE, segsum=False)
    twl2.dense_round_sorted(tst, tkg, LOOSE)
    any2 = jnp.any(jax_active_mask(jst, jkg.window, LOOSE)[:N], axis=1)
    (idx2,) = jnp.nonzero(any2, size=N + 1, fill_value=N)
    want = [int(jnp.sum(any2)), int(jnp.sum(jnp.where(any2, jkg.row_len[:N], 0))),
            int(jnp.sum(jnp.where(any2, jkg.f_len[:N], 0)))]
    g = RoundGraphs(N, N + 1, "cpu")
    g.bind(tst, tkg)
    g.counts.fill_(-1)
    twl2._stats_step(tst, tkg, LOOSE, g)
    np.testing.assert_array_equal(g.cand.numpy(), np.asarray(idx2))
    assert g.counts[:3].tolist() == want and g.counts[3:].tolist() == [-1, -1]
    assert 0 < want[0] < N


# ---- the corrections in place


def _batch(rng, n, src, dst, b):
    """A valid delete batch that removes every out-edge of one vertex (to
    degree 0), the repeated edges of a multigraph among the rest, and an
    insert batch with edges from that vertex and from a vertex with no
    out-edges (both from dangling after the deletes), one edge inserted
    three times, and phantom padding at the end of both."""
    hub = int(np.bincount(src, minlength=n).argmax())
    own = np.flatnonzero(src == hub)
    rest = rng.choice(np.flatnonzero(src != hub), size=b - own.size - 3, replace=False)
    sel = np.concatenate([own, rest])
    del_src = np.full(b, n, np.int32)
    del_dst = np.full(b, n, np.int32)
    del_src[:sel.size], del_dst[:sel.size] = src[sel], dst[sel]
    dangling = int(np.flatnonzero(np.bincount(src, minlength=n + 1)[:n] == 0)[0])
    ins_src = rng.integers(0, n, size=b).astype(np.int32)
    ins_dst = ((ins_src + 1 + rng.integers(0, n - 1, size=b)) % n).astype(np.int32)
    ins_src[:3], ins_src[3:5] = hub, dangling
    ins_dst[:5] = (ins_src[:5] + 1) % n
    ins_src[5:8], ins_dst[5:8] = ins_src[8], ins_dst[8]  # one edge four times
    ins_src[-2:] = ins_dst[-2:] = n
    return ins_src, ins_dst, del_src, del_dst


def _graph_and_state(seed: int, s: int = 4):
    rng = np.random.default_rng(seed)
    n, m = 30, 160
    src, dst = random_multigraph(rng, n, m)
    src[src == 7] = 8  # vertex 7 starts with no out-edges
    dst[src == dst] = (dst[src == dst] + 1) % n
    src = np.concatenate([src, src[:6]])  # repeated edges
    dst = np.concatenate([dst, dst[:6]])
    batch = _batch(rng, n, src, dst, 30)
    p = np.abs(rng.normal(size=(n + 1, s))) * 1e-2
    r = rng.normal(size=(n + 1, s)) * 1e-3
    p[-1] = r[-1] = 0.0
    return n, src, dst, batch, p, r


@pytest.mark.parametrize("route", ["none", "given"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_corrections_in_place_match_jax(mode, seed, route):
    """``apply_edge_batch_`` (updates the state's and the window's tensors
    themselves) and ``apply_edge_batch`` (leaves its inputs as they were)
    against the reference at 1e-12, degrees equal. Reverse: the old row
    sums summed inside (``none``) or handed in (``given``, from the kill
    graph's delivery views), left as they were."""
    n, src, dst, batch, p, r = _graph_and_state(seed)
    jst, jw = jax_apply(JaxState(p=jnp.asarray(p), r=jnp.asarray(r), mode=mode),
                        JaxWindow.from_coo(src, dst, n), *(jnp.asarray(x) for x in batch), CFG)
    ins_src, _, del_src, _ = batch
    deg0 = np.bincount(src, minlength=n + 1)
    deg1 = deg0 - np.bincount(del_src, minlength=n + 1)
    # a delete to degree 0, inserts from dangling rows (one dangling from
    # the start), and phantom padding in both batches
    assert (deg0[:n] > 0).sum() > (deg1[:n] > 0).sum() - (deg0[:n] == 0).sum()
    assert ((deg1[:n] == 0) & (deg0[:n] > 0))[ins_src[ins_src < n]].any()
    assert (deg0[:n] == 0)[ins_src[ins_src < n]].any()
    assert del_src[-1] == ins_src[-1] == n
    tb = [torch.from_numpy(x) for x in batch]

    def fresh():
        st = PprState(p=torch.from_numpy(p.copy()), r=torch.from_numpy(r.copy()), mode=mode)
        return st, WindowGraph.from_coo(src, dst, n, device="cpu")

    def rowsum(st, w):
        if route == "none" or mode == FORWARD:
            return None
        kg = twl2.build_kill_graph(w, mode, fring=4)
        return window_row_sums(st.p, [(kg.d_gat, kg.d_off[:n + 1]), (kg.fd_gat, kg.fd_off[:n + 1])])

    st, w = fresh()
    rs = rowsum(st, w)
    kept = None if rs is None else rs.clone()
    ptrs = (st.p.data_ptr(), st.r.data_ptr(), w.deg.data_ptr())
    st2, w2 = apply_edge_batch_(st, w, *tb, CFG, rowsum=rs)
    assert st2 is st and w2 is w
    assert (st.p.data_ptr(), st.r.data_ptr(), w.deg.data_ptr()) == ptrs
    if rs is not None:
        assert torch.equal(rs, kept)
    ins, outs = fresh(), None
    rs = rowsum(*ins)
    outs = apply_edge_batch(*ins, *tb, CFG, rowsum=rs)
    # the out-of-place form leaves its inputs alone
    assert np.array_equal(ins[0].p.numpy(), p) and np.array_equal(ins[0].r.numpy(), r)
    np.testing.assert_array_equal(ins[1].deg.numpy(), deg0.astype(np.int32))
    for got_st, got_w in ((st, w), outs):
        np.testing.assert_allclose(got_st.p.numpy(), np.asarray(jst.p), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got_st.r.numpy(), np.asarray(jst.r), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got_w.deg.numpy(), np.asarray(jw.deg))
    if mode == REVERSE:
        assert np.array_equal(st.p.numpy(), p)  # reverse corrections move r alone


@pytest.mark.parametrize("mode", MODES)
def test_corrections_in_place_agree_with_the_sweep(mode):
    """The in-place form with the row sums from ``out_row_sums`` equals the
    out-of-place form bit for bit: one implementation."""
    n, src, dst, batch, p, r = _graph_and_state(5, s=3)
    tb = [torch.from_numpy(x) for x in batch]
    outs = []
    for in_place in (True, False):
        st = PprState(p=torch.from_numpy(p.copy()), r=torch.from_numpy(r.copy()), mode=mode)
        w = WindowGraph.from_coo(src, dst, n, device="cpu")
        rs = None if mode == FORWARD else out_row_sums(st.p, w)
        fn = apply_edge_batch_ if in_place else apply_edge_batch
        outs.append(fn(st, w, *tb, CFG, rowsum=rs))
    (a, aw), (b, bw) = outs
    assert torch.equal(a.p, b.p) and torch.equal(a.r, b.r) and torch.equal(aw.deg, bw.deg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reverse_corrections_round_as_the_out_of_place_form(dtype):
    """Reverse mode in place gives the bits of the out-of-place arithmetic it
    replaced (``r + beta * (pp_new - pp_old)``, each mean a division), in f32
    and f64: the same roundings in the same order, in one temporary."""
    n, src, dst, batch, p, r = _graph_and_state(6, s=5)
    ins_src, ins_dst, del_src, del_dst = (torch.from_numpy(x).long() for x in batch)
    p_t, r_t = torch.from_numpy(p).to(dtype), torch.from_numpy(r).to(dtype)
    w = WindowGraph.from_coo(src, dst, n, device="cpu")
    rowsum = out_row_sums(p_t, w)
    d0 = w.deg
    deg_new = d0 - torch.bincount(del_src, minlength=n + 1) + torch.bincount(ins_src, minlength=n + 1)
    deg_new[-1] = 0
    beta = (1.0 - CFG.alpha) / CFG.alpha
    pp_old = torch.where((d0 == 0)[:, None], p_t, rowsum / d0.clamp(min=1).to(dtype)[:, None])
    s_new = rowsum.index_add(0, del_src, p_t[del_dst], alpha=-1)
    s_new.index_add_(0, ins_src, p_t[ins_dst])
    pp_new = torch.where((deg_new == 0)[:, None], p_t,
                         s_new / deg_new.clamp(min=1).to(dtype)[:, None])
    want = r_t + beta * (pp_new - pp_old)
    want[-1] = 0.0
    st = PprState(p=p_t.clone(), r=r_t.clone(), mode=REVERSE)
    apply_edge_batch_(st, w, *(torch.from_numpy(x) for x in batch), CFG, rowsum=rowsum)
    assert torch.equal(st.r, want) and torch.equal(st.p, p_t)


# ---- the wrappers' checks


def _operands(s: int = 8, rows: int = 10):
    p = torch.zeros(rows, s)
    r = torch.zeros(rows, s)
    deg = torch.ones(rows, dtype=torch.int32)
    return p, r, deg, torch.empty(rows, s), torch.zeros(2, dtype=torch.int64)


@pytest.mark.parametrize("case", [
    "moving_shape", "deg_shape", "deg_float", "row_act_shape", "counts_dtype", "counts_shape",
    "r_1d", "device_mix"])
def test_scan_pass_refuses(case):
    p, r, deg, moving, counts = _operands()
    row_act = None
    if case == "moving_shape":
        moving = torch.empty(10, 4)
    elif case == "deg_shape":
        deg = deg[:9]
    elif case == "deg_float":
        deg = deg.float()
    elif case == "row_act_shape":
        row_act = torch.zeros(11, dtype=torch.int32)
    elif case == "counts_dtype":
        counts = counts.int()
    elif case == "counts_shape":
        counts = torch.zeros(3, dtype=torch.int64)
    elif case == "r_1d":
        r = r[:, 0]
    elif case == "device_mix":
        moving = moving.to("meta")
    with pytest.raises((ValueError, TypeError)):
        scan_pass_(p, r, deg, moving, counts, row_act, eps=1e-6, alpha=0.15, forward=True)


@pytest.mark.parametrize("case", ["deg_shape", "row_len_float", "f_len_shape", "device_mix",
                                  "meta_device"])
def test_frontier_rows_refuses(case):
    r = torch.zeros(10, 8)
    deg = row_len = f_len = torch.ones(10, dtype=torch.int32)
    if case == "deg_shape":
        deg = torch.ones(11, dtype=torch.int32)
    elif case == "row_len_float":
        row_len = row_len.float()
    elif case == "f_len_shape":
        f_len = f_len[:5]
    elif case == "device_mix":
        f_len = f_len.to("meta")
    elif case == "meta_device":
        r, deg, row_len, f_len = (t.to("meta") for t in (r, deg, row_len, f_len))
    with pytest.raises((ValueError, TypeError)):
        frontier_rows(r, deg, row_len, f_len, eps=1e-6, forward=True)


@pytest.mark.parametrize("case", ["f64_r", "bf16_p", "int64_deg", "f16_moving", "int64_row_act",
                                  "strided_r", "misaligned_moving", "int64_row_len"])
def test_what_the_kernels_take(case):
    """The checks a CUDA call meets before its launch (``_check_kernel``),
    on CPU tensors: dtypes, contiguity and 16-byte alignment."""
    p, r, deg, moving, _ = _operands()
    row_act = torch.zeros(10, dtype=torch.int32)
    row_len = torch.ones(10, dtype=torch.int32)
    f32, i32 = rowpass.F32, rowpass.I32
    ok = {"p": (p, f32), "r": (r, f32), "moving": (moving, (torch.float32, torch.bfloat16)),
          "deg": (deg, i32), "row_act": (row_act, i32), "row_len": (row_len, i32)}
    rowpass._check_kernel("x", ok, ("p", "r", "moving"))  # as they are: taken
    bad = dict(ok)
    name = {"f64_r": "r", "bf16_p": "p", "int64_deg": "deg", "f16_moving": "moving",
            "int64_row_act": "row_act", "int64_row_len": "row_len"}.get(case)
    if name is not None:
        t, dtypes = ok[name]
        other = {"f64_r": torch.float64, "bf16_p": torch.bfloat16, "f16_moving": torch.float16
                 }.get(case, torch.int64)
        bad[name] = (t.to(other), dtypes)
    elif case == "strided_r":
        bad["r"] = (torch.zeros(10, 16)[:, ::2], f32)
    else:
        bad["moving"] = (torch.zeros(10 * 8 + 1)[1:].view(10, 8), ok["moving"][1])
    with pytest.raises((ValueError, TypeError)):
        rowpass._check_kernel("x", bad, ("p", "r", "moving"))


def test_plain_versions_on_strided_views():
    """On CPU tensors the plain versions take non-contiguous views and give
    what they give on contiguous copies."""
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.normal(size=(12, 16)) * 1e-3)
    deg = torch.from_numpy(rng.integers(0, 5, 12).astype(np.int32))
    views = [big[:, ::2].clone(), big[:, ::2]]
    assert views[0].is_contiguous() and not views[1].is_contiguous()
    outs = [frontier_rows_plain(v, deg, deg, deg, eps=1e-4, forward=True) for v in views]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    states = []
    for r in (big.clone()[:, ::2].contiguous(), big.clone()[:, ::2]):
        p = torch.zeros_like(r)
        moving, counts = torch.empty(r.shape, dtype=r.dtype), torch.zeros(2, dtype=torch.int64)
        scan_pass_(p, r, deg, moving, counts, eps=1e-4, alpha=0.15, forward=True)
        states.append((p, r, moving, counts))
    assert all(torch.equal(a, b) for a, b in zip(*states))
