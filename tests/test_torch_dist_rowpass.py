"""The sharded wl engine's dense round on the row passes (pprx_torch.dist.wl
``ShardedWlEngine._dense_round``: one ``scan_pass_`` and at most one
``frontier_rows`` a round; their plain versions here) against the JAX
package's ShardedWlEngine and against the round's eager form.

The worlds are gloo process groups of 1 and 2 processes
(tests/_torch_dist_worker.py), f64 unless stated. The push starts from a
state with work at every row's threshold (an eighth of the entries exactly
at it) on a graph with dangling rows, with a ladder so small (e_top 32) that
most rounds are dense; the stats-skip threshold is the reference's there
(``heavy_ew = 2 * e_top``), so both follow one schedule: equal rounds, wl
rounds and counters, p and r at 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import pprx.dist.wl as jwl
from pprx.config import PprConfig
from pprx.dist.mesh import make_row_mesh
from pprx.engine.state import FORWARD, REVERSE
from pprx_torch.config import PprConfig as TorchConfig
from pprx_torch.dist import wl as twl
from pprx_torch.dist.mesh import make_row_mesh as torch_row_mesh
from pprx_torch.engine import rowpass
from pprx_torch.engine.segsum import compact, segsum_gather_add_
from tests._torch_dist_worker import graph, threshold_state, worlds

torch.set_num_threads(1)

MODES = [FORWARD, REVERSE]
SHAPES = [(1, 1), (2, 1)]
E_TOP = 32
DENSE = dict(kind="dangling", seed=5, n=60, m=400, queries=(0, 7, 13, 25, 31, 44, 7, 2),
             e_top=E_TOP, fring=E_TOP, state_seed=11, heavy_ew=2 * E_TOP)
BF16 = dict(DENSE, dtype="f32", eps=1e-6)

CASES = {
    **{f"dense-{mode}": (SHAPES, "wl_push", dict(mode=mode, **DENSE)) for mode in MODES},
    "bf16": ([(2, 1)], "wl_push", dict(mode=FORWARD, bf16d=True, **BF16)),
    "bf16_witness": ([(2, 1)], "wl_push", dict(mode=FORWARD, **BF16)),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """shape -> {case: arrays}; both worlds start with the module."""
    cases = {sh: {name: (fn, kw) for name, (shapes, fn, kw) in CASES.items() if sh in shapes}
             for sh in SHAPES}
    return worlds(SHAPES, cases.__getitem__, tmp_path_factory, "rowpass")


def _jax_push(shape, mode, kind, seed, n, m, queries, e_top, fring, state_seed, heavy_ew,
              dtype="f64", eps=1e-8):
    """The reference's push_wl from the same threshold state."""
    del heavy_ew  # the reference's own threshold, which the port's runs take
    src, dst, n = graph(kind, seed, n, m)
    cfg = PprConfig(alpha=0.15, eps=eps, max_rounds=10_000)
    jdt = jnp.float64 if dtype == "f64" else jnp.float32
    eng = jwl.ShardedWlEngine(make_row_mesh(*shape), n, len(queries), ecap=src.size, bcap=8,
                              cfg=cfg, mode=mode, dtype=jdt, ccap=64, e_top=e_top, fring=fring)
    sh = NamedSharding(eng.mesh, eng.state_spec)
    p, r = (jax.device_put(jnp.asarray(a, jdt), sh) for a in
            threshold_state(n, eng.n_pad, src, len(queries), eps, mode == FORWARD, state_seed))
    deg, egl, eog, eva, counts, snap = eng.device_graph_wl(src, dst)
    p, r, rounds, pushes, epushes, wl_rounds = eng.push_wl(p, r, deg, snap)
    return {"p": np.asarray(p), "r": np.asarray(r), "rounds": int(rounds),
            "pushes": float(pushes), "epushes": float(epushes), "wl_rounds": int(wl_rounds),
            "n": n}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_dense_rounds_match_jax(world, shape, mode):
    """Most rounds dense, from a state with entries exactly at the
    threshold on a graph with dangling rows: the reference's rounds, wl
    rounds, pushes and edge pushes, and its p and r at 1e-12."""
    want = _jax_push(shape, mode, **DENSE)
    got = world(shape)[f"dense-{mode}"]
    n = want["n"]
    assert (int(got["rounds"]), int(got["wl_rounds"]), float(got["pushes"]),
            float(got["epushes"])) == (want["rounds"], want["wl_rounds"], want["pushes"],
                                       want["epushes"])
    assert int(got["dense_rounds"]) >= 3 and int(got["dense_rounds"]) > int(got["wl_rounds"])
    np.testing.assert_allclose(got["p"][:n], want["p"][:n], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["r"][:n], want["r"][:n], rtol=0, atol=1e-12)
    assert np.abs(got["p"][n:]).max(initial=0.0) == 0.0


def test_bf16_delivery_against_its_f32_witness(world):
    """bf16 delivery (2x1, f32, eps=1e-6) on the dense rounds' moved mass
    (written by the row pass in bf16) and the all-to-all's: the run ends
    within the f32 witness's accuracy: p within 1e-3 of the witness's (the
    bf16 rounding, 2^-9 relative, of mass pushed at most a few hundred
    times eps * deg), the mass lost within 1e-4 of it; and it differs from
    the witness, so the bf16 rows were delivered."""
    got, witness = world((2, 1))["bf16"], world((2, 1))["bf16_witness"]
    n = DENSE["n"]
    assert int(got["dense_rounds"]) >= 3 and int(got["rounds"]) < 5000
    assert not np.array_equal(got["p"], witness["p"])
    np.testing.assert_allclose(got["p"][:n], witness["p"][:n], rtol=0, atol=1e-3)
    mass = [st["p"][:n].sum(0) + st["r"][:n].sum(0) for st in (got, witness)]
    np.testing.assert_allclose(mass[0], mass[1], rtol=0, atol=1e-4)
    assert np.abs(got["p"][n:]).max(initial=0.0) == 0.0


def _engine(mode, bf16d=False, dtype=torch.float64):
    src, dst, n = graph(DENSE["kind"], DENSE["seed"], DENSE["n"], DENSE["m"])
    s = len(DENSE["queries"])
    eng = twl.ShardedWlEngine(torch_row_mesh(1, 1), n, s, ecap=src.size, bcap=8,
                              cfg=TorchConfig(alpha=0.15, eps=1e-8, max_rounds=10_000),
                              mode=mode, dtype=dtype, e_top=E_TOP, fring=E_TOP, bf16d=bf16d,
                              device="cpu")
    eng.heavy_ew = DENSE["heavy_ew"]
    deg, _, _, _, _, snap = eng.device_graph_wl(src, dst)
    p, r = (torch.from_numpy(a[:eng.n_local]).to(dtype) for a in threshold_state(
        n, eng.n_pad, src, s, 1e-8, mode == FORWARD, DENSE["state_seed"]))
    return eng, deg, snap, p, r


def _eager_dense_round(eng, p, r, deg, snap):
    """The round as the reference writes it (``pprx/dist/wl.py:789-800``,
    ``:934-947``) and the port ran it eagerly before the row passes: the
    activity mask, the mass, ``p + ...``, ``r - mass``, ``moving`` and its
    zero row by ``cat``, the deliveries, the counts, the rescan; K = 1."""
    alpha, dtype, s = eng.cfg.alpha, p.dtype, p.shape[1]
    act = eng._active(r, deg)
    mass = torch.where(act, r, 0.0)
    dang = (deg == 0)[:, None]
    inv_deg = 1.0 / deg.clamp(min=1).to(dtype)
    p = p + torch.where(dang, mass, alpha * mass)
    r = r - mass
    if eng.mode == FORWARD:
        moving = (1.0 - alpha) * mass * inv_deg[:, None]
    else:
        moving = torch.where(dang, (1.0 - alpha) / alpha * mass, (1.0 - alpha) * mass)
    moving_ext = torch.cat([moving, torch.zeros((1, s), dtype=dtype)])
    if eng.bf16d:
        moving_ext = moving_ext.to(torch.bfloat16)
    scale = None if eng.mode == FORWARD else inv_deg
    for view in ("d", "fd"):
        segsum_gather_add_(r, moving_ext, snap[f"{view}_gat"], snap[f"{view}_loff"],
                           row_scale=scale)
    srl, f_len = snap["srl"], snap["f_len"]
    n_act = act.sum(dim=1)
    edges = srl + f_len
    heavy = int(torch.where(n_act > 0, edges, 0).sum()) > eng.heavy_ew
    stats = [n_act.sum(), (n_act * edges).sum()]
    if heavy:
        return p, r, None, stats
    any2 = eng._active(r, deg).any(dim=1)
    cand2 = compact(any2, eng.wcarry, eng.n_local)
    return p, r, cand2, [any2.sum(), torch.where(any2, srl, 0).sum(),
                         torch.where(any2, f_len, 0).sum(), *stats]


@pytest.mark.parametrize("bf16d", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_dense_round_is_its_eager_form_bit_for_bit(mode, bf16d):
    """One dense round on the row passes (K = 1, f64; with bf16 delivery the
    moved mass rounded once from f64, as ``cat(...).to(bfloat16)`` did)
    against the eager round it replaced: p, r, the next list and every
    count equal bit for bit, the heavy branch (no rescan) and the light one
    both."""
    for heavy_ew in (2**40, 0):
        eng, deg, snap, p, r = _engine(mode, bf16d)
        eng.heavy_ew = heavy_ew
        # fresh-edge counts as a slide leaves them (the views stay empty):
        # the round's counts weigh a row by its window and fresh edges both
        snap["f_len"] = torch.from_numpy(np.random.default_rng(3).integers(
            0, 4, eng.n_local).astype(np.int32))
        want_p, want_r, want_cand, want_stats = _eager_dense_round(eng, p, r, deg, snap)
        got_p, got_r, got_cand, _, stats = eng._dense_round(p.clone(), r.clone(), deg, snap,
                                                            None)
        assert torch.equal(got_p, want_p) and torch.equal(got_r, want_r)
        if heavy_ew == 0:  # every frontier is heavy: the rescan is skipped
            assert got_cand is None and want_cand is None and stats[:3] == [twl._BIG] * 3
        else:
            assert torch.equal(got_cand, want_cand)
            assert [int(x) for x in stats[:3]] == [int(x) for x in want_stats[:3]]
        assert [int(x) for x in stats[5:]] == [int(x) for x in want_stats[-2:]]


@pytest.mark.parametrize("mode", MODES)
def test_dense_round_runs_each_row_pass_once(monkeypatch, mode):
    """Every dense round of a push calls ``scan_pass_`` once, with ``moving``
    a view of the delivery table (its zero row after it), and
    ``frontier_rows`` at most once; no other round calls either."""
    calls = {"scan_pass": 0, "frontier_rows": 0}

    def scan(p, r, deg, moving, *args, **kw):
        calls["scan_pass"] += 1
        assert moving.shape == p.shape and moving.is_contiguous()
        table = moving.untyped_storage()
        assert table.nbytes() == (p.shape[0] + 1) * p.shape[1] * moving.element_size()
        rowpass.scan_pass_(p, r, deg, moving, *args, **kw)

    def rows(*args, **kw):
        calls["frontier_rows"] += 1
        return rowpass.frontier_rows(*args, **kw)

    monkeypatch.setattr(twl, "scan_pass_", scan)
    monkeypatch.setattr(twl, "frontier_rows", rows)
    eng, deg, snap, p, r = _engine(mode)
    _, r, rounds, *_ = eng.push_wl(p, r, deg, snap)
    dense = eng.round_kinds["dense"]
    assert dense >= 3 and calls["scan_pass"] == dense
    assert 1 <= calls["frontier_rows"] <= dense
    assert rounds == dense + eng.round_kinds["compact"]
