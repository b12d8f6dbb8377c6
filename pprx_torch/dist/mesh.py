"""The ``rows x srcs`` process mesh (port of ``pprx.dist.mesh``).

The layout is the reference's: vertices are row-sharded over ``rows`` (each
shard owns a contiguous block of vertices, their edges, degrees and rows of
p/r; every push-round collective runs along this axis), and the batched
query axis is split over ``srcs`` (no traffic during a push). The
reference reshapes its device list to ``[n_rows, n_srcs]``; here one process
holds one shard, and process ``rank = row * n_srcs + src``.

A shard's collectives run on its **row group**: the ranks that share its
``src``, ordered by row, so that block ``k`` of a reduce-scatter or an
all-to-all belongs to row ``k``. Every rank creates every row group, in the
same order, as ``torch.distributed.new_group`` requires. A mesh with one row
has no row collectives, and a world of one process has no process group at
all: those collectives are absent, not run on a group of one.

The wrappers below take the group explicitly (``None``: the collective is
absent and the input is its own result) so that each can also be run on a
group of one, as the card's smoke run does with NCCL.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

# the newer names where this torch has them (the older ones warn there)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum_scatter(x, 'rows', tiled=True)``: ``x`` is ``[K * m, ...]``,
    summed over the group's ranks; the group's rank ``k`` gets block ``k``."""
    if group is None:
        return x
    k = group_size(group)
    out = x.new_empty((x.shape[0] // k, *x.shape[1:]))
    _reduce_scatter(out, x.contiguous(), group=group)
    return out


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(x, 'rows', split_axis=0, concat_axis=0, tiled=True)``
    with equal splits: ``x`` is ``[K, ...]``, block ``j`` goes to the group's
    rank ``j``, and block ``j`` of the result came from rank ``j`` (int32
    ids, f32/f64 mass, and bf16 mass, which NCCL and gloo both carry)."""
    if group is None:
        return x
    send = x.contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    return out


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``[K, *x.shape]``: every rank's ``x``, in the group's rank order."""
    if group is None:
        return x[None]
    k = group_size(group)
    out = x.new_empty((k * x.numel(),))
    _all_gather(out, x.contiguous().reshape(-1), group=group)
    return out.reshape(k, *x.shape)


def gather_stats(values, group, device: torch.device) -> np.ndarray:
    """The stats reduction: every rank's small vector of counts, int64 on the
    host as ``[ranks, len(values)]``, from one all-gather (one readback
    where ``group`` is ``None``). ``values`` mixes 0-dim device tensors and
    host integers; a vector of host integers alone is no readback at all in
    a world of one. Callers take maxima over a row group's rows and sums
    over all of them on the host."""
    if group is None and not any(isinstance(v, torch.Tensor) for v in values):
        return np.asarray([[int(v) for v in values]], np.int64)
    parts = [v.reshape(()).to(device=device, dtype=torch.int64) if isinstance(v, torch.Tensor)
             else torch.full((), int(v), dtype=torch.int64, device=device) for v in values]
    vec = torch.stack(parts)
    return all_gather_rows(vec, group).cpu().numpy()


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """This process's place in the ``rows x srcs`` mesh.

    world: the group of every shard, or ``None`` in a world of one.
    row_group: the ranks that share this rank's ``src``, by row, or ``None``
        when the mesh has one row.
    row_ranks: their global ranks (this rank's among them), by row.
    """

    n_rows: int
    n_srcs: int
    rank: int
    world: object | None
    row_group: object | None
    row_ranks: tuple[int, ...]

    @property
    def row(self) -> int:
        return self.rank // self.n_srcs

    @property
    def src(self) -> int:
        return self.rank % self.n_srcs

    @property
    def size(self) -> int:
        return self.n_rows * self.n_srcs


def make_row_mesh(n_rows: int, n_srcs: int = 1) -> RowMesh:
    """The ``('rows', 'srcs')`` mesh over this process group: the world must
    hold exactly ``n_rows * n_srcs`` processes (one per shard). A mesh of
    one shard needs no process group; any other needs
    ``pprx_torch.dist.init.init_distributed`` first."""
    need = n_rows * n_srcs
    if n_rows < 1 or n_srcs < 1:
        raise ValueError(f"mesh {n_rows}x{n_srcs}: both axes must be >= 1")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"mesh {n_rows}x{n_srcs} needs {need} processes, the world has {world}")
    if need == 1:
        return RowMesh(1, 1, 0, None, None, (0,))
    rank = dist.get_rank()
    row_group, row_ranks = None, ()
    for s in range(n_srcs):
        ranks = tuple(row * n_srcs + s for row in range(n_rows))
        group = dist.new_group(list(ranks)) if n_rows > 1 else None
        if rank % n_srcs == s:
            row_group, row_ranks = group, ranks
    return RowMesh(n_rows, n_srcs, rank, dist.group.WORLD, row_group, row_ranks)
