"""State carried across from the JAX package (numpy arrays -> port tensors).

The array names are the ones ``pprx.io.checkpoint.save_checkpoint`` writes
for the fast driver: ``p, r, src, dst, deg`` and ``kg_<field>`` for every
KillGraph field. Two layout differences are bridged here:

- the reference pads its delivery-sorted views (``d_*``, ``fd_*``) to a
  multiple of its kernel's chunk size with phantom edges; the port keeps
  them at ring length, so the padding is stripped;
- the reference stores per-tile offsets for its TPU kernel
  (``d_toff``/``fd_toff``); the port recomputes per-row offsets
  (``d_off``/``fd_off``) from the sorted scatter endpoints and ignores them.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pprx_torch.device import resolve_device
from pprx_torch.engine.segsum import row_offsets
from pprx_torch.engine.state import PprState
from pprx_torch.engine.wl2 import KillGraph
from pprx_torch.graph.dynamic import WindowGraph

_KG_FIELDS = (
    "offsets", "nbr", "row_len", "snap_pos",
    "fr_gat", "fr_sca", "f_off", "f_nbr", "f_len",
    "d_gat", "d_pos", "fd_gat",
)


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def state_from_arrays(p, r, mode: int, device: torch.device | str | None = None) -> PprState:
    """PprState from [N+1, S] reserve/residual arrays (dtype kept), on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return PprState(p=_t(p, device), r=_t(r, device), mode=int(mode))


def kill_graph_from_arrays(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> KillGraph:
    """KillGraph from the reference's ``src, dst, deg`` and ``kg_*`` arrays,
    on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    window = WindowGraph(
        src=_t(arrays["src"], device, np.int32),
        dst=_t(arrays["dst"], device, np.int32),
        deg=_t(arrays["deg"], device, np.int32),
    )
    # the sorted scatter ids d_sca/fd_sca become per-row offsets
    names = (*_KG_FIELDS, "d_sca", "fd_sca")
    f = {k: _t(arrays[f"kg_{k}"], device, np.int32) for k in names}
    n = window.n
    cap = window.capacity
    fring = f["fr_gat"].shape[0]
    # strip the chunk padding (phantom edges at the sorted tail)
    for k, size in (("d_gat", cap), ("d_sca", cap), ("fd_gat", fring), ("fd_sca", fring)):
        if f[k].shape[0] < size or bool((f[k][size:] != n).any()):
            raise ValueError(f"kg_{k}: expected {size} edges plus phantom padding")
        f[k] = f[k][:size].clone()
    d_off = row_offsets(f.pop("d_sca"), n + 1)
    fd_off = row_offsets(f.pop("fd_sca"), n + 1)
    return KillGraph(window=window, d_off=d_off, fd_off=fd_off, **f)
