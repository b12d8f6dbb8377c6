"""The port's sharded compact-frontier engine (pprx_torch.dist.wl) and its
slides in both modes through ShardedStreamDriver(engine='wl'), against the
JAX package's ShardedWlEngine on its virtual 8-device CPU mesh of the same
shape, and the reverse slide's row-sum sweep against the reference's
scatter form (its anomaly (ii)).

The port runs in real gloo process groups, one world per mesh shape for the
module (tests/_torch_dist_worker.py), f64 unless stated. Without overflow
p and r are held at 1e-12 with equal rounds, counts and wl rounds; where a
tiny quota sends mass to the carry, deliveries reorder, and the state is
held to the accuracy bound m * eps and forward mass at 1e-9, as
tests/test_dist_wl.py holds the reference. On the CPU the reference's
sharded engine delivers by sorted scatters (its kernel is TPU-only there);
the port's plain segment sum stands where its kernel runs on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pprx.dist.wl as jwl
from pprx.config import PprConfig, StreamConfig
from pprx.dist.mesh import make_row_mesh
from pprx.dist.stream import ShardedStreamDriver
from pprx.engine.push import push_to_convergence
from pprx.engine.state import FORWARD, REVERSE, init_state
from pprx.graph.dynamic import WindowGraph
from pprx.ref.exact import exact_ppr
from pprx_torch.config import PprConfig as TorchConfig
from pprx_torch.dist import wl as twl
from pprx_torch.ref.exact import exact_ppr_columns
from tests._torch_dist_worker import graph, stream, worlds

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.15, eps=1e-8, max_rounds=10_000)
MODES = [FORWARD, REVERSE]
SHAPES = [(1, 1), (2, 1), (4, 1), (2, 2)]
Q8 = (0, 7, 13, 25, 31, 44, 7, 2)
# the stats-skip pin: a graph where the port's threshold 2 * (e_top + g_top)
# and the reference's 2 * e_top classify a dense round apart
PIN = dict(seed=0, n=200, m=2000, eps=1e-4, e_top=32, fring=32, queries=(0, 7, 13, 25))

# name -> (shapes, worker case, kwargs)
CASES = {
    **{f"push-{mode}": (SHAPES, "wl_push", dict(mode=mode)) for mode in MODES},
    **{f"carry-{mode}": ([(4, 1)], "wl_push", dict(mode=mode, ccap=3, seed=4, n=40, m=200,
                                                   queries=(0, 9, 21, 33))) for mode in MODES},
    **{f"sorted-{mode}": ([(4, 1)], "wl_push", dict(mode=mode, queries=(0, 7, 13, 25),
                                                    sort_bucket_min=1)) for mode in MODES},
    **{f"k1ccap-{mode}": ([(1, 1)], "wl_push", dict(mode=mode, ccap=2, kind="star",
                                                    n=64, queries=(3, 0))) for mode in MODES},
    "star": ([(4, 1)], "wl_push", dict(mode=FORWARD, ccap=2, kind="star", n=64, queries=(3, 0))),
    "seeded": ([(4, 1)], "wl_push", dict(mode=FORWARD, seed=7, queries=(0, 7, 13, 25),
                                         seeded=True)),
    "bf16": ([(2, 1)], "wl_push", dict(mode=FORWARD, seed=2, queries=(0, 7, 13, 25),
                                       dtype="f32", eps=1e-6, bf16d=True)),
    "pin": ([(1, 1)], "wl_push", dict(mode=FORWARD, **PIN)),
    "pin_ref": ([(1, 1)], "wl_push", dict(mode=FORWARD, heavy_ew=2 * PIN["e_top"], **PIN)),
    "slide": (SHAPES, "slides", dict(engine="wl", ccap=64, fring=60)),
    "slide_rev": (SHAPES, "slides", dict(engine="wl", mode=REVERSE, ccap=64, fring=60)),
    "slide_carry_rev": ([(4, 1)], "slides", dict(engine="wl", mode=REVERSE, ccap=3, fring=60,
                                                 seed=3, queries=(0, 5))),
    **{f"sweep_s{s}": ([(1, 1), (2, 1)], "rowsum_sweeps", dict(s=s)) for s in (8, 128)},
    "slide_carry": ([(4, 1)], "slides", dict(engine="wl", ccap=3, fring=60, seed=3,
                                             queries=(0, 5))),
    "slide_s8": ([(2, 1)], "slides", dict(engine="wl", ccap=64, fring=60,
                                          queries=(0, 5, 11, 33, 2, 17, 23, 39))),
}


def _shape_cases(shape):
    return {name: (fn, kw) for name, (shapes, fn, kw) in CASES.items() if shape in shapes}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """shape -> {case: arrays}; every shape's world starts with the module."""
    return worlds(SHAPES, _shape_cases, tmp_path_factory, "wl")


def _jax_push(shape, mode=FORWARD, ccap=64, kind="random", seed=0, n=50, m=300, queries=Q8,
              dtype="f64", eps=1e-8, bf16d=False, seeded=False, sort_bucket_min=None,
              e_top=None, fring=None, heavy_ew=None):
    """The reference's push_wl on the same inputs (``heavy_ew`` is the
    port's knob and has no counterpart there)."""
    del heavy_ew
    src, dst, n = graph(kind, seed, n, m)
    cfg = PprConfig(alpha=0.15, eps=eps, max_rounds=10_000)
    eng = jwl.ShardedWlEngine(make_row_mesh(*shape), n, len(queries), ecap=src.size, bcap=8,
                              cfg=cfg, mode=mode,
                              dtype=jnp.float64 if dtype == "f64" else jnp.float32,
                              ccap=ccap, bf16d=bf16d, e_top=e_top, fring=fring)
    p, r = eng.init_state(list(queries))
    deg, egl, eog, eva, counts, snap = eng.device_graph_wl(src, dst)
    cand0, ok0 = None, 0
    if seeded:
        rows = np.full((eng.n_rows, eng.wcarry), eng.n_local, np.int32)
        for q in sorted(set(queries)):
            k, loc = divmod(q, eng.n_local)
            rows[k][int((rows[k] != eng.n_local).sum())] = loc
        cand0, ok0 = eng.cand0_rows(rows), 1
    if sort_bucket_min is not None:
        old, jwl.SORT_BUCKET_MIN = jwl.SORT_BUCKET_MIN, sort_bucket_min
    try:
        out = eng.push_wl(p, r, deg, snap, cand0=cand0, ok0=ok0)
    finally:
        if sort_bucket_min is not None:
            jwl.SORT_BUCKET_MIN = old
    p, r, rounds, pushes, epushes, wl_rounds = out
    return {"p": np.asarray(p), "r": np.asarray(r), "rounds": int(rounds),
            "pushes": float(pushes), "epushes": float(epushes), "wl_rounds": int(wl_rounds),
            "n": n, "src": src, "dst": dst, "queries": list(queries)}


def _single_device(src, dst, n, queries, mode):
    state = init_state(n, list(queries), mode=mode, dtype=jnp.float64)
    state, _ = push_to_convergence(state, WindowGraph.from_coo(src, dst, n), CFG)
    return np.asarray(state.p)[:n], np.asarray(state.r)[:n]


def _held(got, want, exact: bool, m: int, eps: float = CFG.eps, forward: bool = True):
    n = want["n"]
    if exact:
        assert (int(got["rounds"]), int(got["wl_rounds"]), float(got["pushes"]),
                float(got["epushes"])) == (want["rounds"], want["wl_rounds"], want["pushes"],
                                           want["epushes"])
    tol = 1e-12 if exact else m * eps
    np.testing.assert_allclose(got["p"][:n], want["p"][:n], atol=tol)
    np.testing.assert_allclose(got["r"][:n], want["r"][:n], atol=tol)
    assert np.abs(got["p"][n:]).max(initial=0.0) == 0.0  # padding rows stay zero
    if forward:
        np.testing.assert_allclose(got["p"][:n].sum(0) + got["r"][:n].sum(0), 1.0, atol=1e-9)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_push_matches_jax(world, shape, mode):
    want = _jax_push(shape, mode)
    got = world(shape)[f"push-{mode}"]
    _held(got, want, exact=True, m=300, forward=mode == FORWARD)
    assert int(got["wl_rounds"]) > 0, "worklist rounds never engaged"


@pytest.mark.parametrize("mode", MODES)
def test_carry_and_dense_flush(world, mode):
    """ccap=3 at (4, 1): leftovers wait in the carry and dense rounds flush
    them; the bound, and no mass dropped."""
    want = _jax_push((4, 1), mode, ccap=3, seed=4, n=40, m=200, queries=(0, 9, 21, 33))
    got = world((4, 1))[f"carry-{mode}"]
    assert int(got["ccaps"].max()) == 3 < int(got["n_local"]) * 4
    assert int(got["rounds"]) < CFG.max_rounds
    _held(got, want, exact=False, m=200, forward=mode == FORWARD)


@pytest.mark.parametrize("mode", MODES)
def test_sorted_bucket_path(world, mode):
    """Every K > 1 compact round through sorted_bucket_rows."""
    want = _jax_push((4, 1), mode, queries=(0, 7, 13, 25), sort_bucket_min=1)
    got = world((4, 1))[f"sorted-{mode}"]
    _held(got, want, exact=True, m=300, forward=mode == FORWARD)


def test_skewed_star(world):
    """One shard owns the hub that fans out to every other shard; with
    ccap=2 one shard pair overflows persistently."""
    want = _jax_push((4, 1), ccap=2, kind="star", n=64, queries=(3, 0))
    got = world((4, 1))["star"]
    _held(got, want, exact=False, m=126)


@pytest.mark.parametrize("mode", MODES)
def test_k1_explicit_ccap_loses_no_mass(world, mode):
    """At K = 1 compact rounds deliver the whole deduplicated emission: an
    explicit ccap sizes no wire, so it cannot send mass to the carry."""
    want = _jax_push((1, 1), mode, ccap=2, kind="star", n=64, queries=(3, 0))
    got = world((1, 1))[f"k1ccap-{mode}"]
    _held(got, want, exact=True, m=126, forward=mode == FORWARD)


def test_seeded_candidates_never_scan(world):
    want = _jax_push((4, 1), seed=7, queries=(0, 7, 13, 25), seeded=True)
    got = world((4, 1))["seeded"]
    _held(got, want, exact=True, m=300)
    assert int(got["wl_rounds"]) == int(got["rounds"]), "a seeded run should never scan"


def test_bf16_delivery_close(world):
    """F4, sharded (2x1, f32, eps=1e-6): both packages' bf16 delivery
    converge and track exact PPR within the documented 2^-9-relative
    rounding. The port also rounds its dense rounds' deliveries (the
    reference rounds those only on its TPU kernel, and on the CPU only the
    all-to-all's mass), so it loses more mass here: 8e-4 more at most on
    this graph, held within 5e-3 of the reference's."""
    want = _jax_push((2, 1), seed=2, queries=(0, 7, 13, 25), dtype="f32", eps=1e-6, bf16d=True)
    got = world((2, 1))["bf16"]
    n = want["n"]
    p_ref, _ = _single_device(want["src"], want["dst"], n, (0, 7, 13, 25), FORWARD)
    for st in (got, want):
        assert int(st["rounds"]) < 5000
        np.testing.assert_allclose(st["p"][:n], p_ref, atol=1e-2)
        np.testing.assert_allclose(st["p"][:n].sum(0) + st["r"][:n].sum(0), 1.0, atol=1e-2)
    mass = [st["p"][:n].sum(0) + st["r"][:n].sum(0) for st in (got, want)]
    np.testing.assert_allclose(mass[0], mass[1], atol=5e-3)


def test_stats_skip_threshold_pinned(world):
    """The port's stats-skip threshold is 2 * (e_top + g_top), the
    reference's 2 * e_top (a fault not copied). On this graph they part:
    with the reference's threshold the port follows the reference's
    schedule exactly; with its own it runs another compact round in place
    of a scan, and holds the contract (the bound, and mass)."""
    want = _jax_push((1, 1), **PIN)
    res = world((1, 1))
    m, eps = PIN["m"], PIN["eps"]
    _held(res["pin_ref"], want, exact=True, m=m, eps=eps)
    assert int(res["pin"]["wl_rounds"]) != want["wl_rounds"]
    _held(res["pin"], want, exact=False, m=m, eps=eps)


def _jax_slides(shape, ccap=64, fring=60, seed=2, queries=(0, 5, 11, 33), steps=6,
                mode=FORWARD):
    src, dst, n = stream(seed)
    drv = ShardedStreamDriver(src, dst, n, list(queries), CFG, StreamConfig(300, 25),
                              make_row_mesh(*shape), mode=mode, dtype=jnp.float64, engine="wl",
                              ccap=ccap, fring=fring)
    st = [drv.seed()] + list(drv.run(steps))
    return drv, st, src, dst, n


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_slides_match_jax(world, shape):
    """Six forward slides with fring=60 (a rebuild every two slides):
    per-slide rounds and wl rounds, the state and the degrees."""
    drv, st, src, dst, n = _jax_slides(shape)
    got = world(shape)["slide"]
    np.testing.assert_array_equal(got["rounds"], [s["rounds"] for s in st])
    np.testing.assert_array_equal(got["wl_rounds"], [s["wl_rounds"] for s in st])
    assert got["wl_rounds"].sum() > 0
    np.testing.assert_allclose(got["p"][:n], drv.host_p()[:n], atol=1e-12)
    np.testing.assert_allclose(got["r"][:n], drv.host_r()[:n], atol=1e-12)
    np.testing.assert_array_equal(got["deg"], drv.host_deg())


@pytest.mark.parametrize("shape", SHAPES)
def test_reverse_slides_match_jax(world, shape):
    """Six reverse slides across rebuilds (fring=60), the counterpart of
    tests/test_dist_wl.py's reverse slide: per-slide rounds and wl rounds
    equal, the state at 1e-12, the degrees; the touched-row seed keeps the
    compact rounds going."""
    drv, st, src, dst, n = _jax_slides(shape, mode=REVERSE)
    got = world(shape)["slide_rev"]
    np.testing.assert_array_equal(got["rounds"], [s["rounds"] for s in st])
    np.testing.assert_array_equal(got["wl_rounds"], [s["wl_rounds"] for s in st])
    assert got["wl_rounds"][1:].sum() > 0
    np.testing.assert_allclose(got["p"][:n], drv.host_p()[:n], atol=1e-12)
    np.testing.assert_allclose(got["r"][:n], drv.host_r()[:n], atol=1e-12)
    np.testing.assert_array_equal(got["deg"], drv.host_deg())


def test_reverse_slides_with_carry_hold_the_reverse_contract(world):
    """ccap=3 at (4, 1) in reverse: carried deliveries and dense flushes
    reorder the stream, so the final state is held to the reverse contract
    on its window: every |r| <= eps, and |p - M e_t| <= eps (f64, the rows
    of M sum to 1)."""
    got = world((4, 1))["slide_carry_rev"]
    src, dst, n = stream(3)
    head = int(got["head"])
    cols = exact_ppr_columns(src[head - 300:head], dst[head - 300:head], n, [0, 5], CFG.alpha,
                             tol=1e-14, device="cpu")
    assert np.abs(got["r"][:n]).max() <= CFG.eps
    assert np.abs(got["p"][:n] - cols.T).max() <= CFG.eps
    assert np.abs(got["p"][n:]).max(initial=0.0) == 0.0


def _scatter_sweep(eng, p, snap) -> np.ndarray:
    """The reference's reverse row-sum sweep in its scatter form
    (pprx/dist/wl.py:1515-1570), shard by shard over its global arrays:
    each shard's local-destination edges into its rows, the rest into the
    global rows, summed as its reduce-scatter sums them."""
    k_rows, nl, n_pad = eng.n_rows, eng.n_local, eng.n_pad
    p = jnp.asarray(p)
    s = p.shape[1]
    total = jnp.zeros((n_pad, s), p.dtype)
    for k in range(k_rows):
        base = k * nl
        p_ext = jnp.concatenate([p[base:base + nl], jnp.zeros((1, s), p.dtype)])
        s_loc, acc = jnp.zeros((nl, s), p.dtype), jnp.zeros((n_pad, s), p.dtype)
        for v in ("d", "fd"):
            sca = jnp.split(snap[f"{v}_sca"], k_rows)[k]
            contrib = p_ext[jnp.split(snap[f"{v}_gat"], k_rows)[k]]
            inn = ((sca >= base) & (sca < base + nl))[:, None].astype(p.dtype)
            s_loc = s_loc.at[jnp.clip(sca - base, 0, nl - 1)].add(contrib * inn)
            acc = acc.at[jnp.clip(sca, 0, n_pad - 1)].add(contrib * (1 - inn))
        total = total.at[base:base + nl].add(s_loc) + acc
    return np.asarray(total)


@pytest.mark.parametrize("s", [8, 128])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
def test_reverse_rowsum_sweep_equals_the_scatter_form(world, shape, s):
    """Anomaly (ii): the reference keeps its reverse row-sum sweep off its
    kernel after a mid-stream mismatch. The port's sweep runs through the
    segment sum's local-first views; on every slide of a reverse stream
    (kills, a part-filled fresh view, rebuilds) its plain version equals
    the reference's scatter form over the reference's own views, and both
    equal the window's row sums of p, at K = 1 and K = 2."""
    queries = [i % 40 for i in range(s)]
    src, dst, n = stream(2)
    drv = ShardedStreamDriver(src, dst, n, queries, CFG, StreamConfig(300, 25),
                              make_row_mesh(*shape), mode=REVERSE, dtype=jnp.float64,
                              engine="wl", ccap=64, fring=60)
    want, direct = [], []
    slide = drv.eng.slide_wl

    def recording(p, r, deg, egl, eog, eva, snap, *rest):
        want.append(_scatter_sweep(drv.eng, p, snap))
        lo, ph = drv.head - 300, np.asarray(p)
        rows = np.zeros_like(ph)
        np.add.at(rows, src[lo:drv.head], ph[dst[lo:drv.head]])
        direct.append(rows)
        return slide(p, r, deg, egl, eog, eva, snap, *rest)

    drv.eng.slide_wl = recording
    st = [drv.seed()] + list(drv.run(6))
    got = world(shape)[f"sweep_s{s}"]
    np.testing.assert_array_equal(got["rounds"], [x["rounds"] for x in st])
    assert got["s_old"].shape == (6, drv.eng.n_pad, s)
    for i in range(6):
        np.testing.assert_allclose(got["s_old"][i], want[i], rtol=0, atol=1e-12, err_msg=str(i))
        np.testing.assert_allclose(want[i][:n], direct[i][:n], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["p"][:n], drv.host_p()[:n], atol=1e-12)


def test_slides_with_carry_stay_within_bound(world):
    """ccap=3 during a stream: carry and dense-flush rounds reorder
    deliveries; exact PPR on the final window, and mass."""
    got = world((4, 1))["slide_carry"]
    src, dst, n = stream(3)
    head = int(got["head"])
    for qi, q in enumerate((0, 5)):
        pi = exact_ppr(src[head - 300:head], dst[head - 300:head], n, q, CFG.alpha, tol=1e-13)
        assert np.abs(got["p"][:n, qi] - pi).max() < 50 * CFG.eps
    np.testing.assert_allclose(got["p"][:n].sum(0) + got["r"][:n].sum(0), 1.0, atol=1e-9)


def test_narrow_state_at_two_shards(world):
    """S=8 at K=2: the reference gates its lane-padded TPU kernel off here
    (nondeterministic reads in interpret mode) and delivers by sorted
    scatter; the port's segment sum agrees with that path at 1e-12."""
    queries = (0, 5, 11, 33, 2, 17, 23, 39)
    drv, st, src, dst, n = _jax_slides((2, 1), queries=queries)
    got = world((2, 1))["slide_s8"]
    np.testing.assert_array_equal(got["rounds"], [s["rounds"] for s in st])
    np.testing.assert_allclose(got["p"][:n], drv.host_p()[:n], atol=1e-12)
    np.testing.assert_allclose(got["r"][:n], drv.host_r()[:n], atol=1e-12)


@pytest.mark.parametrize("n_rows", [2, 4])
def test_local_and_remote_segments_deliver_each_edge_once(n_rows):
    """A K-row mesh's delivery views (built shard by shard, no collective
    runs): each shard's local segment into its rows plus its remote segment
    into the global rows, over all shards, equal the window delivered edge
    by edge. The reference keeps its remote accumulator off its TPU kernel
    (a boundary chunk could add local edges twice); the port's segment sum
    reads exact ranges, so both segments go through it."""
    from pprx_torch.dist.mesh import RowMesh
    from pprx_torch.engine.segsum import segsum_gather_add_

    src, dst, n = stream(2, n=400, total=3000)
    total = direct = None
    for rank in range(n_rows):
        mesh = RowMesh(n_rows, 1, rank, None, None, tuple(range(n_rows)))
        eng = twl.ShardedWlEngine(mesh, n, 3, ecap=src.size, bcap=8, cfg=TorchConfig(),
                                  dtype=torch.float64, device="cpu")
        snap = eng.device_graph_wl(src, dst)[-1]
        if total is None:
            total = torch.zeros((eng.n_pad, 3), dtype=torch.float64)
            direct = torch.zeros_like(total)
        table = torch.rand((eng.n_local + 1, 3), generator=torch.Generator().manual_seed(rank),
                           dtype=torch.float64)
        table[-1] = 0  # the zero row dead edges gather
        lo, hi = eng.row0, eng.row0 + eng.n_local
        segsum_gather_add_(total[lo:hi], table, snap["d_gat"], snap["d_loff"])
        assert int(snap["d_roff"][0]) == int(snap["d_loff"][-1])  # remote after local
        segsum_gather_add_(total, table, snap["d_gat"], snap["d_roff"])
        mine = (src >= lo) & (src < hi)
        direct.index_add_(0, torch.from_numpy(dst[mine].astype(np.int64)),
                          table[torch.from_numpy((src[mine] - lo).astype(np.int64))])
    np.testing.assert_allclose(total.numpy(), direct.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("args", [
    (50, 300, 60, 64, 512), (13, 300, 60, 64, 512), (200_001, 2_000_000, 320_000, 65_536, 32_768),
    (50_001, 500_000, 80_000, 65_536, 32_768), (1000, 5000, 16, 4096, 2048),
])
def test_tiers_match_jax(args):
    assert twl.make_wl_tiers(*args) == jwl.make_wl_tiers(*args)


@pytest.mark.parametrize("k,ccap,length", [(1, 64, 300), (4, 8, 300), (4, 2, 50)])
def test_sorted_bucket_matches_jax(k, ccap, length):
    rng = np.random.default_rng(k * 100 + ccap)
    n_local = 30
    n_pad = n_local * k
    ids = rng.integers(0, n_pad + 1, size=length).astype(np.int32)  # n_pad: invalid
    vals = rng.random((length, 3))
    ccarry = min(length, n_pad)
    got = twl.sorted_bucket(torch.from_numpy(ids), torch.from_numpy(vals), k, n_local, n_pad,
                            ccap, ccarry)
    want = jwl.sorted_bucket(jnp.asarray(ids), jnp.asarray(vals), k, n_local, n_pad, ccap,
                             ccarry, jnp.float64)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)
    assert int(got[4]) == int(want[4])
    with pytest.raises(ValueError, match="carry contract"):
        twl.sorted_bucket(torch.from_numpy(ids), torch.from_numpy(vals), k, n_local, n_pad,
                          ccap, ccarry - 1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ["wl", "wlp"])
def test_one_shard_corrections_sum_sorted_and_match_jax(monkeypatch, engine, mode):
    """At mesh 1x1 (in this process, no group) a slide's corrections sum
    through K1 over sorted keys (forward the pairs into ``r``, ``wlp``'s
    after its bucketing; reverse the batch's delta of row sums): some
    slide's live lanes meet in a row, and a seed and four slides match the
    reference at 1e-12 with equal tallies. (``wlp`` forward sums the pairs
    that meet in its bucketing's group sum, K1 too, and delivers unique
    rows.)"""
    from pprx_torch.config import StreamConfig as TorchStreamConfig
    from pprx_torch.dist.mesh import make_row_mesh as torch_row_mesh
    from pprx_torch.dist.stream import ShardedStreamDriver as TorchDriver

    met = []
    deliver = twl.sorted_deliver_

    def spy(rin, keys, table, rows=None, row_scale=None, site="other"):
        if site == "corrections":
            vals = table if rows is None else table[rows]
            live = keys[(keys < rin.shape[0]) & vals.ne(0).any(dim=1)]
            met.append(live.unique().numel() < live.numel())
        return deliver(rin, keys, table, rows, row_scale, site)

    monkeypatch.setattr(twl, "sorted_deliver_", spy)
    src, dst, n = stream(11)
    queries = [0, 5, 9, 17]
    kw = dict(engine=engine, ccap=64, fring=60)
    a = ShardedStreamDriver(src, dst, n, queries, CFG, StreamConfig(300, 25), make_row_mesh(1, 1),
                            mode=mode, dtype=jnp.float64, **kw)
    b = TorchDriver(src, dst, n, queries, TorchConfig(alpha=0.15, eps=1e-8, max_rounds=10_000),
                    TorchStreamConfig(300, 25), torch_row_mesh(1, 1), mode=mode,
                    dtype=torch.float64, device="cpu", **kw)
    ja, tb = [a.seed(), *a.run(4)], [b.seed(), *b.run(4)]
    # a sorted call a forward slide, two a reverse one (deletions, insertions)
    assert len(met) == 4 * (1 if mode == FORWARD else 2)
    assert any(met) == (engine == "wl" or mode == REVERSE)
    for sa, sb in zip(ja, tb, strict=True):
        assert {k: sb[k] for k in ("rounds", "pushes")} == {k: sa[k] for k in ("rounds", "pushes")}
    np.testing.assert_allclose(b.host_p(), a.host_p(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.host_r(), a.host_r(), rtol=0, atol=1e-12)
