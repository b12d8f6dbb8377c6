"""Device-resident sliding-window graph (port of ``pprx.graph.dynamic``).

The live edge set of a sliding window is a contiguous slice of the stream,
so the store is a circular COO ring of fixed capacity: a slide overwrites
exactly the slots whose edges expire. Unfilled slots point at the phantom
vertex N. Storage is int32; callers cast at the point of use where an op
wants int64 indices.

The port adds the window's delivery-sorted view (``DeliveryView``), which
the dense engine's rounds deliver through with the segment sum: the
reference scatters over the ring as it lies (``pprx/engine/push.py:73, 83``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pprx_torch.device import resolve_device
from pprx_torch.engine.segsum import row_offsets
from pprx_torch.engine.state import FORWARD


@dataclasses.dataclass
class WindowGraph:
    """COO edge window. Fixed capacity; phantom-padded."""

    src: torch.Tensor  # int32[capacity]
    dst: torch.Tensor  # int32[capacity]
    deg: torch.Tensor  # int32[N+1] out-degrees (phantom row N pinned to 0)

    @property
    def n(self) -> int:
        return self.deg.shape[0] - 1

    @property
    def capacity(self) -> int:
        return self.src.shape[0]

    @classmethod
    def from_coo(
        cls, src, dst, n: int, capacity: int | None = None,
        device: torch.device | str | None = None,
    ) -> "WindowGraph":
        """The window on ``device`` (``None``: the card)."""
        device = resolve_device(device)
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        m = src.shape[0]
        if capacity is None:
            capacity = m
        if capacity < m:
            raise ValueError(f"capacity {capacity} < number of edges {m}")
        pad = np.full(capacity - m, n, dtype=np.int32)
        deg = np.bincount(src, minlength=n + 1).astype(np.int32)
        return cls(
            src=torch.from_numpy(np.concatenate([src, pad])).to(device),
            dst=torch.from_numpy(np.concatenate([dst, pad])).to(device),
            deg=torch.from_numpy(deg).to(device),
        )


@dataclasses.dataclass
class DeliveryView:
    """The window's edges in delivery order, as the segment sum (K1,
    ``segsum_gather_add_``) reads them: a stable sort of the ring by the
    endpoint that receives (forward ``dst``, reverse ``src``), so that
    each row's edges keep their ring order.

    gat: int32 [capacity], the other endpoint of each sorted edge, the row
        of the pushed table it reads (forward ``src``, reverse ``dst``).
    off: int32 [N+1], row ``w``'s edges ``[off[w], off[w+1])`` for the N
        real rows; the phantom-padded slots ``(N, N)`` sort past ``off[N]``
        and are never read, so row N receives nothing.
    """

    gat: torch.Tensor
    off: torch.Tensor


def delivery_view(graph: WindowGraph, mode: int) -> DeliveryView:
    """``graph``'s delivery-sorted view in ``mode`` (new tensors)."""
    sca, gat = (graph.dst, graph.src) if mode == FORWARD else (graph.src, graph.dst)
    sca_s, order = torch.sort(sca, stable=True)
    return DeliveryView(gat=gat[order], off=row_offsets(sca_s, graph.n))
