"""Port of the wl2 engine (pprx_torch.engine.wl2) against the JAX engine on
the graph and tier ladders of tests/test_wl2.py, forward, f64.

The JAX side runs with segsum=False, the XLA path whose scatters do the
same arithmetic as the port's plain segment sum on the CPU. The JAX engines
agree with each other at 1e-12/1e-13 (tests/test_wl2.py), so p and r are
held at 1e-12, and the round schedule must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pprx.engine.wl2 as jwl2
import pprx_torch.engine.wl2 as twl2
from pprx.config import PprConfig
from pprx.engine.state import init_state as jax_init_state
from pprx.graph.dynamic import WindowGraph as JaxWindow
from pprx_torch.engine.segsum import segment_ids
from pprx_torch.engine.state import FORWARD, init_state
from pprx_torch.engine.wl2 import compact, make_tiers2, rld_expand
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


def _case(tiers):
    rng = np.random.default_rng(7)
    n, m = 40, 200
    src, dst = random_multigraph(rng, n, m)
    queries = [0, 13, 26]
    q = np.unique(np.asarray(queries, np.int32))
    cand0 = np.concatenate([q, np.full(8 - q.size, n, np.int32)])

    kg = jwl2.build_kill_graph(JaxWindow.from_coo(src, dst, n), FORWARD, fring=8)
    st = jax_init_state(n, queries, mode=FORWARD, dtype=jnp.float64)
    st, js = jwl2.push_to_convergence_wl2(
        st, kg, CFG, jnp.asarray(cand0), jnp.asarray(q.size, jnp.int32), True, tiers
    )

    tkg = twl2.build_kill_graph(
        WindowGraph.from_coo(src, dst, n, device="cpu"), FORWARD, fring=8
    )
    tst = init_state(n, queries, mode=FORWARD, dtype=torch.float64, device="cpu")
    tst, ts = twl2.push_to_convergence_wl2(
        tst, tkg, CFG, torch.from_numpy(cand0), q.size, True, tiers
    )

    np.testing.assert_allclose(tst.p.numpy(), np.asarray(st.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(st.r), rtol=0, atol=1e-12)
    assert ts.rounds == int(js.rounds)
    assert ts.wl_rounds == int(js.wl_rounds)
    assert ts.syncs == ts.rounds + 1  # one read-back per round + the first
    assert ts.wl_rounds > 0  # every ladder runs compact rounds too


@pytest.mark.parametrize("tiers", TIERS)
def test_wl2_convergence_matches_jax(tiers):
    _case(tiers)


@pytest.mark.parametrize("tiers", TIERS)
def test_wl2_sorted_delivery_matches_jax(monkeypatch, tiers):
    """Every compact round on the sorted segment-sum delivery, in both
    packages."""
    monkeypatch.setattr(jwl2, "SORT_DELIVER_MIN", 1)
    monkeypatch.setattr(twl2, "SORT_DELIVER_MIN", 1)
    _case(tiers)


def test_kill_graph_matches_jax():
    rng = np.random.default_rng(3)
    n, m = 30, 150
    src, dst = random_multigraph(rng, n, m)
    jkg = jwl2.build_kill_graph(JaxWindow.from_coo(src, dst, n, capacity=160), FORWARD, fring=8)
    tkg = twl2.build_kill_graph(
        WindowGraph.from_coo(src, dst, n, capacity=160, device="cpu"), FORWARD, fring=8
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
