"""State carried between the JAX package and the port (numpy arrays <->
port tensors).

The array names are the ones ``pprx.io.checkpoint.save_checkpoint`` writes:
``p, r, src, dst, deg`` and, for the fast driver, ``kg_<field>`` for every
KillGraph field of the reference. Two layout differences are bridged here,
in both directions:

- the reference pads its delivery-sorted views (``d_*``, ``fd_*``) to a
  multiple of its kernel's chunk size with phantom edges; the port keeps
  them at ring length, so the padding is stripped on the way in and put
  back on the way out;
- the reference keeps the sorted scatter ids (``d_sca``/``fd_sca``) and
  per-tile offsets for its TPU kernel (``d_toff``/``fd_toff``); the port
  keeps per-row offsets (``d_off``/``fd_off``), computed from the ids on
  the way in, and rebuilds ids and tile offsets from them on the way out.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pprx_torch.device import resolve_device
from pprx_torch.engine.segsum import row_offsets, segment_ids
from pprx_torch.engine.state import PprState
from pprx_torch.engine.wl2 import KillGraph, refresh_fresh_csr
from pprx_torch.graph.dynamic import WindowGraph

_KG_FIELDS = (
    "offsets", "nbr", "row_len", "snap_pos",
    "fr_gat", "fr_sca", "f_off", "f_nbr", "f_len",
    "d_gat", "d_pos", "fd_gat",
)

# The reference's TPU kernel layout (``pprx/engine/segsum.py``): edge arrays
# padded to a multiple of EC_PAD, tile offsets for tiles of SEGSUM_TR rows.
# Own copies of the two constants and the two small formulas: importing the
# reference's module would load JAX.
EC_PAD = 2048
SEGSUM_TR = 256


def pad_len(w: int, ec: int = EC_PAD) -> int:
    """Edge-array length padded to the reference's chunk size."""
    return ((w + ec - 1) // ec) * ec


def tile_offsets(offsets: np.ndarray, n_rows: int, tr: int = SEGSUM_TR) -> np.ndarray:
    """int32 ``tile_off[i] = offsets[min(i*tr, n_rows)]`` from CSR offsets
    ``[n_rows+1]``: tile i of ``tr`` rows owns edges
    ``[tile_off[i], tile_off[i+1])``."""
    ntiles = (n_rows + tr - 1) // tr
    idx = np.minimum(np.arange(ntiles + 1) * tr, n_rows)
    return np.asarray(offsets)[idx].astype(np.int32)


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def state_from_arrays(p, r, mode: int, device: torch.device | str | None = None) -> PprState:
    """PprState from [N+1, S] reserve/residual arrays (dtype kept), on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    return PprState(p=_t(p, device), r=_t(r, device), mode=int(mode))


def window_from_arrays(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> WindowGraph:
    """WindowGraph from the ``src, dst, deg`` arrays, on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    return WindowGraph(
        src=_t(arrays["src"], device, np.int32),
        dst=_t(arrays["dst"], device, np.int32),
        deg=_t(arrays["deg"], device, np.int32),
    )


def kill_graph_from_arrays(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> KillGraph:
    """KillGraph from the reference's ``src, dst, deg`` and ``kg_*`` arrays,
    on ``device`` (``None``: the card). Without ``kg_fd_*`` (files older than
    the reference's delivery-sorted fresh view) the view is rebuilt with
    ``refresh_fresh_csr``."""
    device = resolve_device(device)
    window = window_from_arrays(arrays, device)
    # a file older than the reference's delivery-sorted fresh view has no
    # kg_fd_*: that view is derived state, rebuilt from the fresh ring
    has_fd = "kg_fd_gat" in arrays
    views = ("d", "fd") if has_fd else ("d",)
    f = {k: _t(arrays[f"kg_{k}"], device, np.int32) for k in _KG_FIELDS
         if has_fd or k != "fd_gat"}
    n = window.n
    sizes = {"d": window.capacity, "fd": f["fr_gat"].shape[0]}
    offs = {}
    for v in views:
        # strip the chunk padding (phantom edges at the sorted tail); the
        # sorted scatter ids become per-row offsets
        size, sca = sizes[v], _t(arrays[f"kg_{v}_sca"], device, np.int32)
        for k, a in ((f"{v}_gat", f[f"{v}_gat"]), (f"{v}_sca", sca)):
            if a.shape[0] < size or bool((a[size:] != n).any()):
                raise ValueError(f"kg_{k}: expected {size} edges plus phantom padding")
        f[f"{v}_gat"] = f[f"{v}_gat"][:size].clone()
        offs[f"{v}_off"] = row_offsets(sca[:size], n + 1)
    if has_fd:
        return KillGraph(window=window, **offs, **f)
    empty = torch.zeros(n + 2, dtype=torch.int32, device=device)
    return refresh_fresh_csr(KillGraph(window=window, fd_gat=f["fr_gat"].clone(), fd_off=empty,
                                       **offs, **f))


def _reference_view(gat: torch.Tensor, off: torch.Tensor, n: int):
    """One delivery-sorted view in the reference's layout: (gat, sca, toff)
    with ``gat`` and the scatter ids rebuilt from ``off`` phantom-padded to
    ``pad_len``, and tile offsets over the padded array (the padding lies
    in the phantom row's range)."""
    size = gat.shape[0]
    pad = np.full(pad_len(size) - size, n, np.int32)
    sca = segment_ids(off).cpu().numpy().astype(np.int32)  # all of them: off[-1] == size
    offs = off.cpu().numpy().astype(np.int64)
    offs[-1] = pad_len(size)
    return (
        np.concatenate([gat.cpu().numpy().astype(np.int32), pad]),
        np.concatenate([sca, pad]),
        tile_offsets(offs, n + 1),
    )


def kill_graph_to_arrays(kg: KillGraph) -> dict[str, np.ndarray]:
    """The reference's ``kg_*`` arrays of a port KillGraph (int32, on the
    host): the inverse of ``kill_graph_from_arrays``."""
    n = kg.n
    out = {
        f"kg_{k}": getattr(kg, k).cpu().numpy().astype(np.int32)
        for k in _KG_FIELDS if k not in ("d_gat", "fd_gat")
    }
    out["kg_d_gat"], out["kg_d_sca"], out["kg_d_toff"] = _reference_view(kg.d_gat, kg.d_off, n)
    out["kg_fd_gat"], out["kg_fd_sca"], out["kg_fd_toff"] = _reference_view(
        kg.fd_gat, kg.fd_off, n
    )
    return out
