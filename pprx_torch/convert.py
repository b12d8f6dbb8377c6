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

The sharded wl engine's per-shard snapshot crosses the same way
(``wl_snap_to_arrays``, ``wl_snap_from_arrays``): its local-first views are
``d_sca``, ``d_toffl`` and ``d_toff`` (and ``fd_*``) in the reference, the
local and remote per-row ranges ``d_loff`` and ``d_roff`` in the port.

The hybrid engine's graph (``hybrid_graph_from_arrays``,
``hybrid_graph_to_arrays``) has one layout in both packages: the window
(``src, dst, deg``), the CSR snapshot (``snap_offsets, snap_nbr,
snap_row_len``) and the signed overlay (``ov_src, ov_dst, ov_sign``), so a
mid-stream graph with a stale snapshot and a live overlay crosses as it
is. Checkpoints hold only the window: the snapshot is rebuilt on load.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pprx_torch.device import resolve_device
from pprx_torch.engine.frontier import CsrSnapshot, Overlay
from pprx_torch.engine.segsum import row_offsets, segment_ids
from pprx_torch.engine.sparse import HybridGraph
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
    """A tensor on ``device`` that owns its memory where the array is
    read-only (a view of another package's buffer): the port writes into
    its graphs in place."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


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


_HYBRID_PARTS = {"snap": (CsrSnapshot, ("offsets", "nbr", "row_len")),
                 "ov": (Overlay, ("src", "dst", "sign"))}


def hybrid_graph_from_arrays(
    arrays: Mapping[str, np.ndarray], device: torch.device | str | None = None
) -> HybridGraph:
    """HybridGraph from the window, ``snap_*`` and ``ov_*`` arrays, on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    parts = {part: cls(**{k: _t(arrays[f"{part}_{k}"], device, np.int32) for k in keys})
             for part, (cls, keys) in _HYBRID_PARTS.items()}
    return HybridGraph(window=window_from_arrays(arrays, device), **parts)


def hybrid_graph_to_arrays(graph: HybridGraph) -> dict[str, np.ndarray]:
    """The inverse of ``hybrid_graph_from_arrays`` (int32, on the host)."""
    out = {k: _np32(getattr(graph.window, k)) for k in ("src", "dst", "deg")}
    for part, (_, keys) in _HYBRID_PARTS.items():
        out.update({f"{part}_{k}": _np32(getattr(getattr(graph, part), k)) for k in keys})
    return out


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


# The sharded wl engine's snapshot keys in the reference's files (its
# WL_SNAP_KEYS), each array per shard.
REFERENCE_WL_SNAP_KEYS = (
    "soff", "snbr", "srl", "spos",
    "d_gat", "d_sca", "d_pos", "d_toff", "d_toffl",
    "fd_gat", "fd_sca", "fd_toff", "fd_toffl",
    "fr_gat", "fr_sca", "f_off", "f_nbr", "f_len", "fcnt",
)
_WL_SAME = ("soff", "snbr", "srl", "spos", "d_pos", "fr_gat", "fr_sca", "f_off", "f_nbr", "f_len")


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int32)


def _sharded_view_out(gat, loff, roff, n_local: int, n_pad: int, row0: int):
    """One local-first view of a shard in the reference's layout: (gat,
    sca, toff, toffl), ``gat`` and the scatter ids rebuilt from the ranges
    padded to ``pad_len`` (dead and padding edges: gather row n_local,
    scatter id n_pad), tile offsets over the local rows and the global
    ones (at K = 1 the remote segment is empty: its ranges all start past
    the local one)."""
    size = gat.shape[0]
    loff_h = loff.cpu().numpy().astype(np.int64)
    lloc = int(loff_h[-1])
    roff_h = (np.full(n_pad + 1, lloc, np.int64) if roff is None
              else roff.cpu().numpy().astype(np.int64))
    sca = np.full(pad_len(size), n_pad, np.int32)
    sca[:lloc] = row0 + np.repeat(np.arange(n_local), np.diff(loff_h))
    sca[lloc:int(roff_h[-1])] = np.repeat(np.arange(n_pad), np.diff(roff_h))
    gat_out = np.full(pad_len(size), n_local, np.int32)
    gat_out[:size] = _np32(gat)
    return gat_out, sca, tile_offsets(roff_h, n_pad), tile_offsets(loff_h, n_local)


def wl_snap_to_arrays(snap: Mapping, n_local: int, n_pad: int, row0: int) -> dict:
    """A shard's snapshot of the port's sharded wl engine as the reference's
    per-shard arrays (int32, on the host; ``fcnt`` a 1-element array)."""
    out = {k: _np32(snap[k]) for k in _WL_SAME}
    out["fcnt"] = np.asarray([snap["fcnt"]], np.int32)
    for v in ("d", "fd"):
        (out[f"{v}_gat"], out[f"{v}_sca"], out[f"{v}_toff"],
         out[f"{v}_toffl"]) = _sharded_view_out(snap[f"{v}_gat"], snap[f"{v}_loff"],
                                                snap[f"{v}_roff"], n_local, n_pad, row0)
    return out


def wl_snap_from_arrays(arrays: Mapping[str, np.ndarray], n_local: int, n_pad: int, row0: int,
                        n_rows: int, ring: int, device) -> dict:
    """The inverse of ``wl_snap_to_arrays`` for one shard: the port's
    snapshot on ``device`` from the reference's per-shard arrays. The view
    ranges come from the scatter ids (local segment first, then the remote
    one, dead last); ``ring`` is the fresh ring's length with its trash
    slot."""
    snap = {k: _t(arrays[k], device, np.int32) for k in _WL_SAME}
    snap["fcnt"] = int(np.asarray(arrays["fcnt"]).reshape(-1)[0])
    sizes = {"d": snap["spos"].shape[0], "fd": ring}
    for v in ("d", "fd"):
        size = sizes[v]
        gat, sca = np.asarray(arrays[f"{v}_gat"]), np.asarray(arrays[f"{v}_sca"]).astype(np.int64)
        if (gat.shape[0] < size or (gat[size:] != n_local).any()
                or (sca[size:] != n_pad).any()):
            raise ValueError(f"snap_{v}_gat: expected {size} edges plus phantom padding")
        sca = sca[:size]
        is_loc = (sca >= row0) & (sca < row0 + n_local)
        key = np.where(is_loc, sca - row0, np.where(sca < n_pad, sca + n_pad, 2 * n_pad))
        if (np.diff(key) < 0).any():
            raise ValueError(f"snap_{v}_sca: not in the local-first delivery order")
        snap[f"{v}_gat"] = _t(gat[:size], device, np.int32)
        snap[f"{v}_loff"] = _t(np.searchsorted(key, np.arange(n_local + 1)), device, np.int32)
        snap[f"{v}_roff"] = (None if n_rows == 1 else _t(
            np.searchsorted(key, n_pad + np.arange(n_pad + 1)), device, np.int32))
    return snap
