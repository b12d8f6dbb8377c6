"""Top-k retrieval over the row-sharded reserve (port of
``pprx.dist.retrieve``).

Each rank takes a local top-k over its ``n_local`` rows; the k (score,
global id) winners of every shard ride one all-gather along the row group
(k * K rows instead of N), and a final top-k over them is exact: every
global winner is in its owner's local top-k. Queries stay split over
``srcs``; every rank of a row group gets its group's result.

How the port differs: ties go to the lowest global id, as the reference's
``lax.top_k`` gives them, through stable sorts (``torch.topk`` promises no
order among equal scores). Torch has no ``lax.approx_max_k``, so
``exact=False`` is exact too, as in ``pprx_torch.retrieve.topk``.
"""

from __future__ import annotations

import torch

from pprx_torch.dist.mesh import RowMesh, all_gather_rows


def make_sharded_topk(mesh: RowMesh, n: int, n_local: int, k: int, exact: bool = True):
    """Returns ``f(p_local) -> (scores [S_loc, k], ids [S_loc, k])`` for this
    shard's ``[n_local, S_loc]`` block of the reserve. Rows >= n (padding
    and the phantom row) never appear; ``exact`` is accepted for the
    reference's signature (both values are exact)."""
    del exact  # see module docstring
    k_loc = min(k, n_local)  # a shard's head is capped at its rows
    row0 = mesh.row * n_local

    def topk(p_local: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        # local head: score descending, lowest id first among equals
        sc, ids = torch.sort(p_local.T, dim=1, descending=True, stable=True)
        sc, gids = sc[:, :k_loc], ids[:, :k_loc] + row0
        sc = torch.where(gids < n, sc, -torch.inf)
        # one all-gather of (score, id) pairs, both exact in f64 (f32 or f64
        # scores, ids below 2**53): [K, 2, S_loc, k_loc] -> [S_loc, K * k_loc]
        # shard-major, so lower ids come first among equal scores, and the
        # stable sort keeps them so
        both = all_gather_rows(torch.stack([sc.double(), gids.double()]), mesh.row_group)
        sc_all = both[:, 0].permute(1, 0, 2).reshape(sc.shape[0], -1).to(sc.dtype)
        id_all = both[:, 1].permute(1, 0, 2).reshape(sc.shape[0], -1).long()
        if sc_all.shape[1] < k:  # a degenerate ask: k above the rows there are
            pad = k - sc_all.shape[1]
            sc_all = torch.nn.functional.pad(sc_all, (0, pad), value=-torch.inf)
            id_all = torch.nn.functional.pad(id_all, (0, pad))
        sc2, pos = torch.sort(sc_all, dim=1, descending=True, stable=True)
        return sc2[:, :k], torch.gather(id_all, 1, pos[:, :k])

    return topk
