"""The port's memory-proportional sharded loop (ShardedWlEngine with
``proportional=True``, the 'wlp' engine) against the JAX package's, the
counterpart of tests/test_dist_wlp.py: push in both modes, drain rounds,
slides in both modes, and the per-shard memory budget with the reverse
slide's pinned gap.

The port runs in gloo process groups, one world per mesh shape for the
module (tests/_torch_dist_worker.py), in f64. The reference's tests run at
8x1 and 4x2; these run at 4x1 and 2x2 with the reference's bounds, and hold
the port to the reference on the same mesh: equal rounds and wl rounds,
p and r at 1e-12."""

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
from pprx.graph.stream import StreamDriver
from tests._torch_dist_worker import graph, stream, worlds

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.15, eps=1e-8, max_rounds=10_000)
MODES = [FORWARD, REVERSE]
SHAPES = [(4, 1), (2, 2)]
Q8 = (0, 7, 13, 25, 31, 44, 7, 2)
STAR = dict(kind="star", n=64, queries=(3, 0))

# name -> (shapes, worker case, kwargs)
CASES = {
    **{f"push-{mode}": (SHAPES, "wl_push", dict(mode=mode, proportional=True)) for mode in MODES},
    **{f"sorted-{mode}": ([(4, 1)], "wl_push", dict(mode=mode, proportional=True,
                                                    queries=(0, 7, 13, 25), sort_bucket_min=1))
       for mode in MODES},
    **{f"drain-{ccap}": ([(4, 1)], "wl_push", dict(mode=FORWARD, ccap=ccap, proportional=True,
                                                   **STAR)) for ccap in (64, 2)},
    **{f"slide-{mode}": (SHAPES, "slides", dict(engine="wlp", mode=mode, ccap=64, fring=60))
       for mode in MODES},
    **{f"mem-{prop}": ([(4, 1)], "membound", dict(proportional=prop)) for prop in (False, True)},
    "gap": ([(4, 1)], "membound", dict(proportional=True, reverse_slide=True, seed=3)),
}


def _shape_cases(shape):
    return {name: (fn, kw) for name, (shapes, fn, kw) in CASES.items() if shape in shapes}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """shape -> {case: arrays}; every shape's world starts with the module."""
    return worlds(SHAPES, _shape_cases, tmp_path_factory, "wlp")


def _jax_push(shape, mode=FORWARD, ccap=64, kind="random", seed=0, n=50, m=300, queries=Q8,
              sort_bucket_min=None):
    """The reference's proportional push_wl on the same inputs."""
    src, dst, n = graph(kind, seed, n, m)
    eng = jwl.ShardedWlEngine(make_row_mesh(*shape), n, len(queries), ecap=src.size, bcap=8,
                              cfg=CFG, mode=mode, dtype=jnp.float64, ccap=ccap,
                              proportional=True)
    p, r = eng.init_state(list(queries))
    deg, egl, eog, eva, counts, snap = eng.device_graph_wl(src, dst)
    if sort_bucket_min is not None:
        old, jwl.SORT_BUCKET_MIN = jwl.SORT_BUCKET_MIN, sort_bucket_min
    try:
        p, r, rounds, pushes, epushes, wl_rounds = eng.push_wl(p, r, deg, snap)
    finally:
        if sort_bucket_min is not None:
            jwl.SORT_BUCKET_MIN = old
    return {"p": np.asarray(p), "r": np.asarray(r), "rounds": int(rounds),
            "pushes": float(pushes), "epushes": float(epushes), "wl_rounds": int(wl_rounds),
            "n": n, "src": src, "dst": dst, "n_local": eng.n_local, "ccarry": eng.ccarry}


def _single_device(src, dst, n, queries, mode):
    state = init_state(n, list(queries), mode=mode, dtype=jnp.float64)
    state, _ = push_to_convergence(state, WindowGraph.from_coo(src, dst, n), CFG)
    return np.asarray(state.p)[:n], np.asarray(state.r)[:n]


def _same_as_jax(got, want):
    """Equal round schedule and counts, the state at 1e-12."""
    n = want["n"]
    assert (int(got["rounds"]), int(got["wl_rounds"]), float(got["pushes"]),
            float(got["epushes"])) == (want["rounds"], want["wl_rounds"], want["pushes"],
                                       want["epushes"])
    np.testing.assert_allclose(got["p"][:n], want["p"][:n], atol=1e-12)
    np.testing.assert_allclose(got["r"][:n], want["r"][:n], atol=1e-12)
    assert np.abs(got["p"][n:]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_wlp_push_matches_jax(world, shape, mode):
    """From the one-hot state, the first round a rescan (the top tier over
    every local row): the reference's schedule, and the single-device
    engine's state at 1e-12."""
    want = _jax_push(shape, mode)
    got = world(shape)[f"push-{mode}"]
    _same_as_jax(got, want)
    assert int(got["rounds"]) < CFG.max_rounds
    assert int(got["rescan_rounds"]) >= 1 and int(got["dense_rounds"]) == 0
    p_ref, r_ref = _single_device(want["src"], want["dst"], want["n"], Q8, mode)
    np.testing.assert_allclose(got["p"][:want["n"]], p_ref, atol=1e-12)
    np.testing.assert_allclose(got["r"][:want["n"]], r_ref, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_wlp_sorted_receive_side(world, mode):
    """Every receive side through the sorted delivery (SORT_BUCKET_MIN=1 in
    both packages; reverse with the receiver's 1/d_out as its row scale)."""
    want = _jax_push((4, 1), mode, queries=(0, 7, 13, 25), sort_bucket_min=1)
    _same_as_jax(world((4, 1))[f"sorted-{mode}"], want)


@pytest.mark.parametrize("ccap", [64, 2])
def test_wlp_push_drain_rounds(world, ccap):
    """The skewed star at (4, 1): with a quota of 2 the hub's emission
    overflows into the compact carry and drains over dedicated all-to-all
    rounds (every rank of the group joins them), never a dense round; no
    mass is dropped. The reference's schedule, and its bound against the
    single-device engine (1e-12 where the quota covers a shard)."""
    want = _jax_push((4, 1), ccap=ccap, **STAR)
    got = world((4, 1))[f"drain-{ccap}"]
    _same_as_jax(got, want)
    assert int(got["dense_rounds"]) == 0
    if ccap == 2:
        assert int(got["drain_rounds"]) > 0, "the quota never overflowed"
    n = want["n"]
    p_ref, _ = _single_device(want["src"], want["dst"], n, STAR["queries"], FORWARD)
    atol = 1e-12 if ccap >= want["n_local"] else want["src"].size * CFG.eps
    np.testing.assert_allclose(got["p"][:n], p_ref, atol=atol)
    np.testing.assert_allclose(got["p"][:n].sum(0) + got["r"][:n].sum(0), 1.0, atol=1e-9)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_wlp_slides_match(world, shape, mode):
    """Six slides across rebuilds (fring=60); forward also runs the
    corrections' bucketed exchange: the reference's sharded wlp driver's
    per-slide rounds and state, and the single-device driver's state at
    1e-11 with the window's degrees."""
    src, dst, n = stream(2)
    queries = [0, 5, 11, 33]
    scfg = StreamConfig(window=300, slide=25)
    drv = ShardedStreamDriver(src, dst, n, queries, CFG, scfg, make_row_mesh(*shape), mode=mode,
                              dtype=jnp.float64, engine="wlp", ccap=64, fring=60)
    st = [drv.seed()] + list(drv.run(6))
    got = world(shape)[f"slide-{mode}"]
    np.testing.assert_array_equal(got["rounds"], [s["rounds"] for s in st])
    np.testing.assert_array_equal(got["wl_rounds"], [s["wl_rounds"] for s in st])
    np.testing.assert_allclose(got["p"][:n], drv.host_p()[:n], atol=1e-12)
    np.testing.assert_allclose(got["r"][:n], drv.host_r()[:n], atol=1e-12)
    sd = StreamDriver(src, dst, n, queries, CFG, scfg, mode=mode, dtype=jnp.float64)
    sd.seed()
    list(sd.run(6))
    np.testing.assert_allclose(got["p"][:n], np.asarray(sd.state.p)[:n], atol=1e-11)
    np.testing.assert_allclose(got["r"][:n], np.asarray(sd.state.r)[:n], atol=1e-11)
    lo = int(got["head"]) - scfg.window
    expect = np.bincount(src[lo:int(got["head"])], minlength=n).astype(np.int32)
    np.testing.assert_array_equal(got["deg"][:n], expect)


@pytest.mark.parametrize("proportional", [False, True])
def test_wlp_per_shard_memory_budget(world, proportional):
    """A graph whose whole [n_pad, S] state exceeds what a shard should
    hold: the proportional push returns no float tensor as large as
    n_pad * S on any shard (its largest is O(n_local * S + carry)), while
    the wl engine's carry outbox is n_pad * S. Each shard measures its own
    ops (rank 0's is read; 4x1, ecap 1600: at this seed one of 4 shards
    holds 1,540 edges). The push converges to the single-device state."""
    got = world((4, 1))[f"mem-{proportional}"]
    s = int(got["s"])
    full_state = int(got["n_pad"]) * s
    biggest = int(got["biggest"])
    budget = int(got["n_local"]) * s + int(got["ccarry"]) * s
    if proportional:
        assert biggest < full_state, (biggest, full_state)
        assert biggest <= 4 * budget, (biggest, budget)
    else:
        assert biggest >= full_state
    assert int(got["rounds"]) < CFG.max_rounds
    src, dst, n = graph("random", 1, 4000, 6000)
    p_ref, _ = _single_device(src, dst, n, range(8), FORWARD)
    np.testing.assert_allclose(got["p"][:n], p_ref, atol=1e-11)


def test_wlp_reverse_slide_memory_gap_pinned(world):
    """The reverse slide keeps the reference's documented gap: one
    [n_pad, 2S] stack of the old row sums' remote part and the batch's
    delta for its one reduce-scatter, and nothing larger."""
    got = world((4, 1))["gap"]
    assert int(got["biggest"]) == 2 * int(got["n_pad"]) * int(got["s"])
