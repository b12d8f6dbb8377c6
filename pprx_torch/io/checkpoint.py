"""Stream checkpoint/resume (port of ``pprx.io.checkpoint``, single device).

One ``.npz`` in the reference's layout: a ``meta`` JSON (n, head, step_idx,
mode, engine, cfg, scfg, and for the fast driver its tuning), ``p, r, src,
dst, deg``, and for the fast driver every ``kg_*`` array of the reference's
KillGraph (the kill-in-place snapshot and the fresh ring are part of the
exact round schedule). Files load both ways: a checkpoint of either package
resumes in the other (``pprx_torch.convert`` bridges the two layouts of the
delivery-sorted views).

``meta["tuning"]["segsum"]`` is written true: the port always delivers
through its segment sum, and the reference resumes on its kernel.
Checkpoints of the reference's hybrid driver are refused: that engine is
not ported.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from pprx_torch.convert import kill_graph_to_arrays
from pprx_torch.engine.wl2 import KillGraph
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.stream import StreamDriver


def save_checkpoint(path: str, drv: StreamDriver | FastStreamDriver) -> None:
    """Write ``drv`` (a ``StreamDriver`` or a ``FastStreamDriver``)
    mid-stream to ``path``."""
    is_fast = isinstance(drv.graph, KillGraph)
    window = drv.graph.window if is_fast else drv.graph
    meta = {
        "n": drv.n,
        "head": drv.head,
        "step_idx": drv.step_idx,
        "mode": drv.mode,
        "engine": "fast" if is_fast else "dense",
        "cfg": dataclasses.asdict(drv.cfg),
        "scfg": dataclasses.asdict(drv.scfg),
    }
    extra = {}
    if is_fast:
        meta["tuning"] = {
            "tiers": [list(t) for t in drv.tiers],
            "rebuild_every": drv.rebuild_every,
            "e_top": drv.e_top,
            "fring": drv.fring,
            "cap0": drv.cap0,
            "fcnt": drv.fcnt,
            "queries": [int(q) for q in drv._queries],
            "segsum": True,
            "bf16d": drv.bf16d,
        }
        extra = kill_graph_to_arrays(drv.graph)
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        p=drv.state.p.cpu().numpy(),
        r=drv.state.r.cpu().numpy(),
        src=window.src.cpu().numpy(),
        dst=window.dst.cpu().numpy(),
        deg=window.deg.cpu().numpy(),
        **extra,
    )


def load_checkpoint(
    path: str,
    stream_src: np.ndarray,
    stream_dst: np.ndarray,
    device: torch.device | str | None = None,
) -> StreamDriver | FastStreamDriver:
    """Rebuild a driver mid-stream on ``device`` (``None``: the card) from a
    checkpoint of either package. The caller re-supplies the stream (it is
    input data, not state); everything else comes from the file."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("meta")).decode())
    engine = meta.get("engine", "dense")
    if engine == "fast":
        return FastStreamDriver.from_arrays(stream_src, stream_dst, arrays, meta, device)
    if engine == "dense":
        return StreamDriver.from_arrays(stream_src, stream_dst, arrays, meta, device)
    raise ValueError(
        f"checkpoint of engine {engine!r}: not ported (the port has the dense and "
        "the fast driver; the hybrid engine was superseded by the fast one)"
    )
