"""Device-resident sliding-window graph (port of ``pprx.graph.dynamic``).

The live edge set of a sliding window is a contiguous slice of the stream,
so the store is a circular COO ring of fixed capacity: a slide overwrites
exactly the slots whose edges expire. Unfilled slots point at the phantom
vertex N. Storage is int32; callers cast at the point of use where an op
wants int64 indices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pprx_torch.device import resolve_device


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
