"""The port's sharded top-k (pprx_torch.dist.retrieve.make_sharded_topk)
against the JAX package's on its virtual 8-device CPU mesh of the same
shape: a local top-k per shard, one all-gather along the row group, a final
top-k, equal to the reference's scores and ids, tie order included (the
lowest global id wins), on every rank of a row group; padding rows never
come out. The port runs in real gloo process groups
(tests/_torch_dist_worker.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pprx.dist.mesh import make_row_mesh
from pprx.dist.retrieve import make_sharded_topk
from pprx_torch.retrieve.topk import topk_candidates
from tests._torch_dist_worker import topk_matrix, worlds

torch.set_num_threads(1)

SHAPES = [(1, 1), (2, 1), (2, 2), (4, 1)]
# name -> (n, s, k, seed, ties, poison)
CASES = {
    "ties": (500, 8, 10, 7, True, False),
    "padding": (37, 4, 12, 8, False, True),
    "few_rows": (5, 4, 12, 9, False, True),  # k above the rows there are
}


def _cases(shape):
    return {name: ("topk", dict(n=n, s=s, k=k, seed=seed, ties=ties, poison=poison))
            for name, (n, s, k, seed, ties, poison) in CASES.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worlds(SHAPES, _cases, tmp_path_factory, "topk")


def _jax_topk(shape, n, s, k, seed, ties, poison):
    rows, _ = shape
    mesh = make_row_mesh(*shape)
    n_local = -(-(n + 1) // rows)
    p = topk_matrix(n, s, n_local * rows, seed, ties, poison)
    pg = jax.device_put(jnp.asarray(p), NamedSharding(mesh, P("rows", "srcs")))
    sc, ids = make_sharded_topk(mesh, n, n_local, k)(pg)
    return np.asarray(sc), np.asarray(ids), p


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_topk_matches_jax(world, shape, case):
    n, s, k, *_ = CASES[case]
    sc, ids, p = _jax_topk(shape, *CASES[case])
    got = world(shape)[case]
    rows, srcs = shape
    s_loc = s // srcs
    for rank in range(rows * srcs):
        cols = slice(rank % srcs * s_loc, (rank % srcs + 1) * s_loc)
        np.testing.assert_array_equal(got["scores"][rank], sc[cols])
        np.testing.assert_array_equal(got["ids"][rank], ids[cols])
    real = got["scores"] > -np.inf
    assert got["ids"][real].max() < n and got["scores"].max() < 1.0  # no padding row
    if case == "ties":  # and the single-device head where scores are untied
        ref_sc, ref_ids = topk_candidates(torch.from_numpy(p[: n + 1]), k)
        np.testing.assert_array_equal(got["scores"][0], ref_sc.numpy()[:s_loc])
        untied = np.abs(ref_sc.numpy()[:s_loc] - 0.999) > 0
        np.testing.assert_array_equal(got["ids"][0][untied], ref_ids.numpy()[:s_loc][untied])
