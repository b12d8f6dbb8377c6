"""Stream checkpoint/resume (port of ``pprx.io.checkpoint``, single device).

One ``.npz`` in the reference's layout: a ``meta`` JSON (n, head, step_idx,
mode, engine, cfg, scfg, and the driver's tuning where it has one),
``p, r, src, dst, deg``, and the driver's own arrays. Each driver says what
its file carries besides the state and the window (``engine``, ``tuning``,
``extra_arrays``; ``pprx_torch.graph.driver``) and takes it back
(``from_arrays``): the fast driver its capacities and every ``kg_*`` array
of the reference's KillGraph, the hybrid driver its capacities, from which
the loader rebuilds the snapshot with an empty overlay. Files load both
ways: a checkpoint of either package resumes in the other
(``pprx_torch.convert`` bridges the two layouts of the delivery-sorted
views).

Sharded checkpoints (``save_sharded_checkpoint``, ``load_sharded_checkpoint``)
are the reference's too: one ``.npz`` of the global arrays (``p, r, deg``,
the window buffers ``egl, eog, eva``, every shard's block in row order), the
host's slot bookkeeping, and for the wl engines (``wl``, ``wlp``) every
shard's snapshot as ``snap_<key>`` in the reference's layout
(``pprx_torch.convert.wl_snap_to_arrays``) with the fresh-ring counters. Rank
0 writes the file; each rank loads its own block. The wl engines' resolved
``segsum`` flag of the reference is written as null: the port has no such
choice, and the reference re-derives it for its own backend.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.convert import REFERENCE_WL_SNAP_KEYS, wl_snap_from_arrays, wl_snap_to_arrays
from pprx_torch.dist.mesh import RowMesh, all_gather_rows
from pprx_torch.dist.sharded import ShardedEngine
from pprx_torch.dist.stream import ShardedStreamDriver, assemble
from pprx_torch.dist.wl import ShardedWlEngine
from pprx_torch.engine.state import FORWARD
from pprx_torch.graph.driver import WindowDriver
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.hybrid_stream import HybridStreamDriver
from pprx_torch.graph.stream import StreamDriver

# the single-card drivers by their engine's name in a file
DRIVERS = {d.engine: d for d in (StreamDriver, FastStreamDriver, HybridStreamDriver)}


def save_checkpoint(path: str, drv: WindowDriver) -> None:
    """Write ``drv`` (a ``StreamDriver``, ``FastStreamDriver`` or
    ``HybridStreamDriver``) mid-stream to ``path``."""
    window = drv.window
    meta = {
        "n": drv.n,
        "head": drv.head,
        "step_idx": drv.step_idx,
        "mode": drv.mode,
        "engine": drv.engine,
        "cfg": dataclasses.asdict(drv.cfg),
        "scfg": dataclasses.asdict(drv.scfg),
    }
    tuning = drv.tuning()
    if tuning is not None:
        meta["tuning"] = tuning
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        p=drv.state.p.cpu().numpy(),
        r=drv.state.r.cpu().numpy(),
        src=window.src.cpu().numpy(),
        dst=window.dst.cpu().numpy(),
        deg=window.deg.cpu().numpy(),
        **drv.extra_arrays(),
    )


def load_checkpoint(
    path: str,
    stream_src: np.ndarray,
    stream_dst: np.ndarray,
    device: torch.device | str | None = None,
) -> WindowDriver:
    """Rebuild a driver mid-stream on ``device`` (``None``: the card) from a
    checkpoint of either package. The caller re-supplies the stream (it is
    input data, not state); everything else comes from the file."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("meta")).decode())
    engine = meta.get("engine", "dense")
    if engine not in DRIVERS:
        raise ValueError(f"checkpoint of unknown engine {engine!r}")
    return DRIVERS[engine].from_arrays(stream_src, stream_dst, arrays, meta, device)


def _row_blocks(arrays: dict[str, np.ndarray], mesh: RowMesh, device) -> dict[str, np.ndarray]:
    """Every row's copy of this shard's 1-D int arrays, concatenated in row
    order (the reference's global layout), from one all-gather over the
    world; the ``srcs`` copies of a row are the same, and ``src`` 0's is
    taken."""
    names = list(arrays)
    sizes = [arrays[k].size for k in names]
    flat = torch.from_numpy(np.concatenate([arrays[k].reshape(-1).astype(np.int64)
                                            for k in names])).to(device)
    every = all_gather_rows(flat, mesh.world).cpu().numpy()[::mesh.n_srcs]
    out, at = {}, 0
    for k, size in zip(names, sizes):
        out[k] = every[:, at:at + size].reshape(-1).astype(arrays[k].dtype)
        at += size
    return out


def save_sharded_checkpoint(path: str, drv: ShardedStreamDriver) -> None:
    """Write ``drv`` (a ``ShardedStreamDriver`` of any engine) mid-stream
    to ``path`` in the reference's layout. Every rank of the world calls it:
    the blocks are gathered over the world, rank 0 writes the file, and all
    meet at a barrier after it."""
    eng, mesh = drv.eng, drv.mesh
    wl = bool(drv._wl)
    meta = {
        "kind": "sharded",
        "engine": ("wlp" if eng.proportional else "wl") if wl else "dense",
        "n": drv.n,
        "head": drv.head,
        "step_idx": drv.step_idx,
        "mode": drv.mode,
        "cfg": dataclasses.asdict(drv.cfg),
        "scfg": dataclasses.asdict(drv.scfg),
        "ecap": eng.ecap,
        "bcap": eng.bcap,
        "s_total": eng.s_total,
        "exchange": eng.exchange,
        "ccap_requested": eng.user_ccap if wl else eng.ccap,
    }
    ints = {"deg": drv.deg, "egl": drv.egl, "eog": drv.eog, "eva": drv.eva}
    blocks = {k: v.cpu().numpy().astype(np.int32) for k, v in ints.items()}
    if wl:
        meta["wl_tuning"] = {
            "fring": eng.fring,
            "e_top": eng.e_top,
            "n_tiers": eng.n_tiers,
            "bf16d": eng.bf16d,
            "segsum": None,
            "tiers": [list(t) for t in eng.tiers],
            "ccaps": [int(c) for c in eng.ccaps],
            "since_rb": drv._since_rb,
        }
        snap = wl_snap_to_arrays(drv.snap, eng.n_local, eng.n_pad, eng.row0)
        blocks.update({f"snap_{k}": snap[k] for k in REFERENCE_WL_SNAP_KEYS})
    blocks = _row_blocks(blocks, mesh, drv.device)
    p, r = assemble(drv.p, mesh), assemble(drv.r, mesh)
    if mesh.rank == 0:
        extra = {}
        if wl:
            extra["fcnt_host"] = np.asarray(drv._fcnt_host, np.int64)
        free_lens = np.asarray(drv._free_top, np.int64)
        free_flat = np.concatenate(
            [np.asarray(st[:t], np.int64) for st, t in zip(drv._free_stack, drv._free_top)])
        np.savez_compressed(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            p=p, r=r, **blocks,
            pos_owner=drv.pos_owner, pos_slot=drv.pos_slot,
            free_lens=free_lens, free_flat=free_flat, **extra,
        )
    if mesh.world is not None:
        torch.distributed.barrier(group=mesh.world)


def load_sharded_checkpoint(
    path: str,
    stream_src: np.ndarray,
    stream_dst: np.ndarray,
    mesh: RowMesh,
    device: torch.device | str | None = None,
) -> ShardedStreamDriver:
    """This rank's ``ShardedStreamDriver`` mid-stream on ``device``
    (``None``: the card) from a sharded checkpoint of either package. The
    mesh must have the shape the file was written under (the rows' blocks
    are a function of it); a wl engine must rebuild the tiers and quotas the
    file names."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("meta")).decode())
    if meta.get("kind") != "sharded":
        raise ValueError(f"{path}: not a sharded checkpoint")
    engine = meta.get("engine", "dense")
    wl = engine in ("wl", "wlp")
    cfg, scfg = PprConfig(**meta["cfg"]), StreamConfig(**meta["scfg"])
    dtype = torch.from_numpy(arrays["p"][:0]).dtype
    common = dict(ecap=meta["ecap"], bcap=meta["bcap"], cfg=cfg, mode=meta["mode"],
                  dtype=dtype, device=device)
    if wl:
        tune = meta["wl_tuning"]
        eng = ShardedWlEngine(mesh, meta["n"], meta["s_total"], ccap=meta.get("ccap_requested"),
                              fring=tune["fring"], e_top=tune["e_top"], n_tiers=tune["n_tiers"],
                              proportional=engine == "wlp", bf16d=bool(tune.get("bf16d", False)),
                              **common)
        got = [list(t) for t in eng.tiers]
        if got != tune["tiers"]:
            raise ValueError(
                f"wl checkpoint tier mismatch: saved {tune['tiers']}, reconstructed {got} — "
                "mesh/capacity params differ from the run that wrote the checkpoint")
        if "ccaps" in tune and list(eng.ccaps) != tune["ccaps"]:
            raise ValueError(f"wl checkpoint quota mismatch: saved {tune['ccaps']}, "
                             f"reconstructed {list(eng.ccaps)}")
    else:
        eng = ShardedEngine(mesh, meta["n"], meta["s_total"],
                            exchange=meta.get("exchange", "dense_rs"),
                            ccap=meta.get("ccap_requested", 1024), **common)
    stride, k_rows = eng.slot_stride, eng.n_rows
    if arrays["p"].shape != (eng.n_pad, eng.s_total) or arrays["egl"].size != k_rows * stride:
        raise ValueError(f"{path}: written under another mesh than {k_rows}x{eng.n_srcs}")
    dev, row, nl = eng.device, mesh.row, eng.n_local

    def block(a):
        return torch.from_numpy(np.ascontiguousarray(np.split(a, k_rows)[row])).to(dev)

    cols = slice(eng.col0, eng.col0 + eng.s_loc)

    def state_block(a):
        return torch.from_numpy(np.ascontiguousarray(a[row * nl:(row + 1) * nl, cols])).to(dev)

    drv = ShardedStreamDriver.__new__(ShardedStreamDriver)
    drv.stream_src = np.asarray(stream_src, dtype=np.int32)
    drv.stream_dst = np.asarray(stream_dst, dtype=np.int32)
    drv.n, drv.cfg, drv.scfg, drv.mode = meta["n"], cfg, scfg, meta["mode"]
    drv.mesh, drv.eng, drv.device, drv._wl = mesh, eng, dev, wl
    drv.p, drv.r = state_block(arrays["p"]), state_block(arrays["r"])
    drv.deg, drv.egl, drv.eog, drv.eva = (block(arrays[k].astype(np.int32))
                                          for k in ("deg", "egl", "eog", "eva"))
    if wl:
        missing = [k for k in REFERENCE_WL_SNAP_KEYS if f"snap_{k}" not in arrays]
        if missing:
            raise ValueError("sharded wl checkpoint uses an older snapshot layout "
                             f"(missing fields {missing})")
        mine = {k: np.split(arrays[f"snap_{k}"], k_rows)[row] for k in REFERENCE_WL_SNAP_KEYS}
        drv.snap = wl_snap_from_arrays(mine, nl, eng.n_pad, eng.row0, k_rows, eng.fring + 1, dev)
        drv._fcnt_host = np.asarray(arrays["fcnt_host"], np.int64)
        drv._since_rb = meta["wl_tuning"]["since_rb"]
    drv._gather_key = (drv.stream_src if drv.mode == FORWARD else drv.stream_dst) // nl
    drv.pos_owner = np.asarray(arrays["pos_owner"])
    drv.pos_slot = np.asarray(arrays["pos_slot"])
    lens = np.asarray(arrays["free_lens"], np.int64)
    flat = np.asarray(arrays["free_flat"], np.int32)
    drv._free_stack = [np.empty(eng.ecap, np.int32) for _ in range(k_rows)]
    drv._free_top = lens.copy()
    for k, off in enumerate(np.concatenate([[0], np.cumsum(lens)[:-1]])):
        drv._free_stack[k][:lens[k]] = flat[off:off + lens[k]]
    drv.head, drv.step_idx = meta["head"], meta["step_idx"]
    # the forward wl slide's ring follows from the host's bookkeeping
    drv.ring = drv._device_ring() if wl and drv.mode == FORWARD else None
    drv._pack = None
    return drv
