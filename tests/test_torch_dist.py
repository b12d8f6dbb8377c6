"""The port's dense sharded engine (pprx_torch.dist.sharded), its driver
(pprx_torch.dist.stream, engine 'dense'), the mesh and the collective
wrappers, against the JAX package's on its virtual 8-device CPU mesh of the
same shape.

The port runs in real process groups: one process per shard, gloo over a
FileStore (tests/_torch_dist_worker.py), one world per mesh shape for the
whole module, f64. p and r are held at 1e-12 with equal rounds and counts
where no overflow reorders deliveries; with a carry (a2a, ccap=6) at the
accuracy bound m * eps, as tests/test_dist.py holds the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pprx.config import PprConfig, StreamConfig
from pprx.dist.mesh import make_row_mesh
from pprx.dist.sharded import ShardedEngine, partition_edges as jax_partition
from pprx.dist.stream import ShardedStreamDriver
from pprx.engine.state import FORWARD, REVERSE
from pprx_torch.dist.init import init_distributed
from pprx_torch.dist.mesh import make_row_mesh as torch_mesh
from pprx_torch.dist.sharded import partition_edges
from tests._torch_dist_worker import graph, stream, worlds

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.15, eps=1e-8, max_rounds=10_000)
SHAPES = [(1, 1), (2, 1), (4, 1), (2, 2)]
WORLDS = [s for s in SHAPES if s != (1, 1)]
MODES = [FORWARD, REVERSE]
# (exchange, ccap, shapes): ccap=6 forces the carry at (4, 1)
EXCHANGES = [("dense_rs", 1024, SHAPES), ("a2a", 1024, WORLDS), ("a2a", 6, [(4, 1)])]
PUSHES = [(shape, mode, ex, ccap) for ex, ccap, shapes in EXCHANGES for shape in shapes
          for mode in MODES]
SLIDES = [(shape, mode) for shape in SHAPES for mode in MODES]
# the carry case's graph and queries: tests/test_dist.py's (the first graph
# does not converge there in reverse within max_rounds, in either package),
# at eps=1e-6: about 700 rounds of six rows a shard pair, not 2,400-4,300
CARRY_INPUT = dict(seed=4, n=40, m=200, queries=(0, 9, 21, 33), eps=1e-6)


def _push_input(ccap):
    return CARRY_INPUT if ccap < 1024 else {}


def _cases(shape):
    cases = {f"push-{mode}-{ex}-{ccap}": ("dense_push", dict(mode=mode, exchange=ex, ccap=ccap,
                                                             **_push_input(ccap)))
             for s, mode, ex, ccap in PUSHES if s == shape}
    cases.update({f"slide-{mode}": ("slides", dict(engine="dense", mode=mode))
                  for s, mode in SLIDES if s == shape})
    if shape != (1, 1):
        cases.update(facts=("mesh_facts", {}), coll=("collectives", {}))
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """shape -> {case: arrays}; every shape's world starts with the module."""
    return worlds(SHAPES, _cases, tmp_path_factory, "dense")


def _jax_push(shape, mode, exchange, ccap):
    kw = dict(_push_input(ccap))
    queries = list(kw.pop("queries", (0, 7, 13, 25, 31, 44, 7, 2)))
    cfg = PprConfig(alpha=0.15, eps=kw.pop("eps", CFG.eps), max_rounds=10_000)
    src, dst, n = graph("random", **kw)
    eng = ShardedEngine(make_row_mesh(*shape), n, len(queries), ecap=src.size, bcap=8, cfg=cfg,
                        mode=mode, dtype=jnp.float64, exchange=exchange, ccap=ccap)
    p, r = eng.init_state(queries)
    deg, egl, eog, eva, counts = eng.device_graph(src, dst)
    p, r, rounds, pushes, epushes = eng.push(p, r, deg, egl, eog, eva)
    return np.asarray(p), np.asarray(r), int(rounds), float(pushes), float(epushes), counts, n


@pytest.mark.parametrize("shape,mode,exchange,ccap", PUSHES)
def test_push_matches_jax(world, shape, mode, exchange, ccap):
    p, r, rounds, pushes, epushes, counts, n = _jax_push(shape, mode, exchange, ccap)
    got = world(shape)[f"push-{mode}-{exchange}-{ccap}"]
    np.testing.assert_array_equal(got["counts"], counts)
    if ccap >= int(got["n_local"]):  # no overflow: the reference's schedule
        assert (int(got["rounds"]), float(got["pushes"]), float(got["epushes"])) == (
            rounds, pushes, epushes)
        tol = 1e-12
    else:  # the carry defers deliveries: the accuracy bound m * eps
        tol = 200 * CARRY_INPUT["eps"]
        assert int(got["rounds"]) < CFG.max_rounds
    np.testing.assert_allclose(got["p"][:n], p[:n], atol=tol)
    np.testing.assert_allclose(got["r"][:n], r[:n], atol=tol)
    assert np.abs(got["p"][n:]).max(initial=0.0) == 0.0  # padding rows stay zero
    if mode == FORWARD:  # no mass dropped, whatever the carry did
        np.testing.assert_allclose(got["p"][:n].sum(0) + got["r"][:n].sum(0), 1.0, atol=1e-9)


@pytest.mark.parametrize("shape,mode", SLIDES)
def test_slides_match_jax(world, shape, mode):
    """ShardedStreamDriver(engine='dense') over 6 slides: per-slide rounds,
    the final state and the degrees."""
    src, dst, n = stream(2)
    drv = ShardedStreamDriver(src, dst, n, [0, 5, 11, 33], CFG, StreamConfig(300, 25),
                              make_row_mesh(*shape), mode=mode, dtype=jnp.float64)
    rounds = [drv.seed()["rounds"]] + [s["rounds"] for s in drv.run(6)]
    got = world(shape)[f"slide-{mode}"]
    np.testing.assert_array_equal(got["rounds"], rounds)
    np.testing.assert_allclose(got["p"][:n], drv.host_p()[:n], atol=1e-12)
    np.testing.assert_allclose(got["r"][:n], drv.host_r()[:n], atol=1e-12)
    lo = int(got["head"]) - 300
    expect = np.bincount(src[lo:int(got["head"])], minlength=n)
    np.testing.assert_array_equal(got["deg"][:n], expect)
    np.testing.assert_array_equal(got["deg"], drv.host_deg())


@pytest.mark.parametrize("n_rows", [1, 2, 4, 8])
@pytest.mark.parametrize("by", ["src", "dst"])
def test_partition_edges_bit_for_bit(n_rows, by):
    src, dst, n = graph("random", seed=3)
    n_local = -(-(n + 1) // n_rows)
    got = partition_edges(src, dst, n_local, n_rows, src.size, by)
    want = jax_partition(src, dst, n_local, n_rows, src.size, by)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        partition_edges(src, dst, n_local, n_rows, src.size // n_rows - 1, by)


@pytest.mark.parametrize("shape", WORLDS)
def test_mesh_layout(world, shape):
    """rank = row * n_srcs + src, the row group is the ranks of one src by
    row, a second init is a no-op, and no worker loaded JAX."""
    facts = world(shape)["facts"]  # rank 0's view
    rows, srcs = shape
    assert (int(facts["rank"]), int(facts["row"]), int(facts["src"])) == (0, 0, 0)
    assert int(facts["size"]) == rows * srcs
    np.testing.assert_array_equal(facts["row_ranks"], np.arange(rows) * srcs)
    assert not bool(facts["init_again"]) and not bool(facts["jax_loaded"])


@pytest.mark.parametrize("shape", WORLDS)
def test_collectives_mean_what_jax_does(world, shape):
    """Each wrapper on every rank: reduce-scatter f64 sums the row group's
    blocks, all-to-all hands block j to row j (int32 ids and bf16 mass),
    and the stats reduction gives every rank the world's rows."""
    got = world(shape)["coll"]
    rows, srcs = shape
    for rank in range(rows * srcs):
        row, src = divmod(rank, srcs)
        group = [r * srcs + src for r in range(rows)]
        x = [np.arange(rows * 6, dtype=np.float64).reshape(rows * 3, 2) + 100 * g for g in group]
        np.testing.assert_array_equal(got["rs"][rank], sum(x)[row * 3:(row + 1) * 3])
        ids = [np.arange(rows * 2, dtype=np.int32).reshape(rows, 2) + 10 * g for g in group]
        np.testing.assert_array_equal(got["a2a"][rank], np.stack([i[row] for i in ids]))
        b16 = [torch.from_numpy((np.arange(rows * 2, dtype=np.float32).reshape(rows, 2) / 3
                                 + g)).to(torch.bfloat16).float().numpy() for g in group]
        np.testing.assert_array_equal(got["a2b"][rank], np.stack([b[row] for b in b16]))
        np.testing.assert_array_equal(got["stats"][rank],
                                      [[g, 7, 1] for g in range(rows * srcs)])


def test_single_process_needs_no_group():
    """A 1x1 mesh has no process group and init_distributed skips a
    single-process run; any other mesh needs a world of its size."""
    assert not init_distributed(None, None, None, device="cpu")
    mesh = torch_mesh(1, 1)
    assert (mesh.world, mesh.row_group, mesh.rank, mesh.row_ranks) == (None, None, 0, (0,))
    with pytest.raises(ValueError, match="needs 2 processes"):
        torch_mesh(2, 1)
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(None, 2, None, device="cpu")
