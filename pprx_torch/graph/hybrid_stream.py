"""Sliding-window driver on the hybrid (snapshot + overlay) engine (port of
``pprx.graph.hybrid_stream``).

Each slide corrects the state for its b expiries and b insertions, appends
the 2b changes to the signed overlay, rewrites the ring slots, and pushes
to convergence with frontier-sparse rounds (``pprx_torch.engine.sparse``):
the worklist loop, seeded with the 4b endpoints the corrections touched,
or with ``worklist=False`` the single-tier adaptive loop. The CSR snapshot
is re-sorted from the window, and the overlay cleared, whenever the next
slide's 2b entries would not fit the overlay (every ``rebuild_every``
slides). The new batch and its slots go to the device in one int32
transfer.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.convert import state_from_arrays, window_from_arrays
from pprx_torch.device import resolve_device
from pprx_torch.engine.sparse import (
    HybridGraph,
    _dedup_compact,
    make_tiers,
    push_to_convergence_hybrid,
    push_to_convergence_worklist,
    rebuild_snapshot,
)
from pprx_torch.engine.state import FORWARD, PprState, PushStats, init_state
from pprx_torch.engine.update import apply_edge_batch
from pprx_torch.graph.dynamic import WindowGraph

# The driver's capacities, which a checkpoint carries: a resumed driver runs
# the writer's, not ones derived again.
TUNING = ("fcap", "ecap", "scan_ecap", "wcap", "ovacap", "tiers", "rebuild_every", "worklist")


def hybrid_slide_step(
    state: PprState,
    graph: HybridGraph,
    new_src: torch.Tensor,
    new_dst: torch.Tensor,
    slots: torch.Tensor,
    ov_count: int,
    cfg: PprConfig,
    fcap: int,
    ecap: int,
    scan_ecap: int = 0,
    tiers: tuple[tuple[int, int, int], ...] = (),
    worklist: bool = True,
) -> tuple[PprState, HybridGraph, PushStats]:
    """One window slide. ``ov_count`` is the overlay's fill; the 2b new
    entries must fit behind it (the reference's ``dynamic_update_slice``
    would clamp the start and overwrite live entries; the driver rebuilds
    before that). Rewrites the ring and the overlay in place: callers must
    not keep the pre-slide graph. ``scan_ecap`` (0: ``ecap``) sizes only
    the worklist loop's scan rounds."""
    b = new_src.shape[0]
    ov = graph.ov
    if ov_count + 2 * b > ov.src.shape[0]:
        raise ValueError(f"overlay overflow: ov_count {ov_count} + 2b {2 * b} > "
                         f"capacity {ov.src.shape[0]}")
    scan_ecap = scan_ecap if scan_ecap > 0 else ecap
    w = graph.window
    old_src = w.src[slots]
    old_dst = w.dst[slots]
    # corrections read the old ring (reverse-mode row sums) and old degrees
    state, w = apply_edge_batch(state, w, new_src, new_dst, old_src, old_dst, cfg)
    # overlay: expirations (-1) then insertions (+1) at [ov_count, ov_count + 2b)
    at = slice(ov_count, ov_count + 2 * b)
    ov.src[at] = torch.cat([old_src, new_src])
    ov.dst[at] = torch.cat([old_dst, new_dst])
    ov.sign[ov_count:ov_count + b] = -1
    ov.sign[ov_count + b:at.stop] = 1
    w.src[slots] = new_src
    w.dst[slots] = new_dst
    graph = HybridGraph(window=w, snap=graph.snap, ov=ov)
    if not worklist:
        state, stats = push_to_convergence_hybrid(state, graph, cfg, fcap, ecap)
        return state, graph, stats
    # the corrections inject mass only at the 4b batch endpoints: they are
    # the whole initial candidate set
    wcap = tiers[-1][0]
    cand0, c0n = _dedup_compact(torch.cat([old_src, old_dst, new_src, new_dst]), wcap, graph.n)
    # the list holds at most 4b ids, so it fits without a read where 4b <= wcap
    cand0_ok = True if 4 * b <= wcap else c0n <= wcap
    state, stats = push_to_convergence_worklist(
        state, graph, cfg, cand0, cand0_ok, tiers, fcap, scan_ecap)
    return state, graph, stats


class HybridStreamDriver:
    """Sliding-window stream driver on the hybrid engine. The capacities
    are the reference's (``pprx.graph.hybrid_stream.HybridStreamDriver``):
    ``fcap`` n+1 rows; ``ecap`` 8 slides' worth of edge lanes, at least
    65,536 and at most the window; ``scan_ecap`` 4 ecap, at most half the
    window (but not below ecap); candidate rows ``wcap`` and live overlay
    entries ``ovacap`` 4 slides' worth (at least 32,768 and 8,192), on a
    ladder of ``n_tiers`` tiers (``make_tiers``); an overlay of
    ``2 * slide * rebuild_every`` entries."""

    def __init__(
        self,
        stream_src: np.ndarray,
        stream_dst: np.ndarray,
        n: int,
        queries,
        cfg: PprConfig,
        scfg: StreamConfig,
        mode: int = FORWARD,
        dtype: torch.dtype = torch.float32,
        rebuild_every: int = 4,
        fcap: int | None = None,
        ecap: int | None = None,
        worklist: bool = True,
        n_tiers: int = 3,
        device: torch.device | str | None = None,
    ):
        if stream_src.shape[0] < scfg.window:
            raise ValueError("stream shorter than one window")
        self.device = resolve_device(device)
        self.stream_src = np.asarray(stream_src, dtype=np.int32)
        self.stream_dst = np.asarray(stream_dst, dtype=np.int32)
        self.n = n
        self.cfg = cfg
        self.scfg = scfg
        self.mode = mode
        w, b = scfg.window, scfg.slide
        window = WindowGraph.from_coo(
            self.stream_src[:w], self.stream_dst[:w], n, capacity=w, device=self.device
        )
        self.graph = HybridGraph.build(window, mode, 2 * b * rebuild_every)
        self.state = init_state(n, queries, mode=mode, dtype=dtype, device=self.device)
        self.fcap = fcap if fcap is not None else n + 1
        self.ecap = ecap if ecap is not None else min(max(8 * b, 65_536), w)
        self.scan_ecap = min(4 * self.ecap, max(w // 2, self.ecap))
        self.worklist = worklist
        self.wcap = max(4 * b, 32_768)
        self.ovacap = max(4 * b, 8192)
        self.tiers = make_tiers(self.wcap, self.ecap, self.ovacap, n_tiers=n_tiers)
        self.rebuild_every = rebuild_every
        self.ov_count = 0
        self.head = w
        self.step_idx = 0

    @classmethod
    def from_arrays(
        cls,
        stream_src: np.ndarray,
        stream_dst: np.ndarray,
        arrays: Mapping[str, np.ndarray],
        meta: Mapping,
        device: torch.device | str | None = None,
    ) -> "HybridStreamDriver":
        """A driver mid-stream from the arrays (``p, r, src, dst, deg``) and
        metadata (``n, head, step_idx, mode, cfg, scfg, tuning``) that
        ``pprx.io.checkpoint.save_checkpoint`` writes for the reference's
        hybrid driver. The tuning is the writer's; the snapshot is rebuilt
        from the window and the overlay starts empty."""
        if meta.get("engine") != "hybrid":
            raise ValueError(f"not a hybrid-driver state: engine={meta.get('engine')!r}")
        tune = meta["tuning"]
        drv = cls.__new__(cls)
        drv.device = resolve_device(device)
        drv.stream_src = np.asarray(stream_src, dtype=np.int32)
        drv.stream_dst = np.asarray(stream_dst, dtype=np.int32)
        drv.n = int(meta["n"])
        drv.cfg = PprConfig(**meta["cfg"])
        drv.scfg = StreamConfig(**meta["scfg"])
        drv.mode = int(meta["mode"])
        drv.state = state_from_arrays(arrays["p"], arrays["r"], drv.mode, drv.device)
        drv.rebuild_every = int(tune["rebuild_every"])
        drv.graph = HybridGraph.build(window_from_arrays(arrays, drv.device), drv.mode,
                                      2 * drv.scfg.slide * drv.rebuild_every)
        drv.ov_count = 0
        for key in ("fcap", "ecap", "scan_ecap", "wcap", "ovacap"):
            setattr(drv, key, int(tune[key]))
        drv.tiers = tuple(tuple(int(x) for x in t) for t in tune["tiers"])
        drv.worklist = bool(tune["worklist"])
        drv.head = int(meta["head"])
        drv.step_idx = int(meta["step_idx"])
        return drv

    def seed(self) -> PushStats:
        """Static push on the initial window (the worklist loop starts with
        a scan)."""
        if self.worklist:
            cand0 = torch.full((self.wcap,), self.n, dtype=torch.int32, device=self.device)
            self.state, stats = push_to_convergence_worklist(
                self.state, self.graph, self.cfg, cand0, False, self.tiers,
                self.fcap, self.scan_ecap)
        else:
            self.state, stats = push_to_convergence_hybrid(
                self.state, self.graph, self.cfg, self.fcap, self.ecap)
        return stats

    @property
    def steps_available(self) -> int:
        return (self.stream_src.shape[0] - self.head) // self.scfg.slide

    def run(self, n_steps: int | None = None) -> Iterator[PushStats]:
        """Slide the window ``n_steps`` times (default: until the stream
        ends)."""
        b = self.scfg.slide
        w = self.scfg.window
        total = self.steps_available if n_steps is None else n_steps
        for _ in range(total):
            if self.head + b > self.stream_src.shape[0]:
                return
            if self.ov_count + 2 * b > self.graph.ov.src.shape[0]:
                self.graph = rebuild_snapshot(self.graph, self.mode)
                self.ov_count = 0
            pack = np.concatenate([
                self.stream_src[self.head : self.head + b],
                self.stream_dst[self.head : self.head + b],
                (np.arange(self.head, self.head + b) % w).astype(np.int32),
            ])
            pack = torch.from_numpy(pack).to(self.device)
            self.state, self.graph, stats = hybrid_slide_step(
                self.state, self.graph, pack[:b], pack[b : 2 * b], pack[2 * b :],
                self.ov_count, self.cfg, self.fcap, self.ecap, self.scan_ecap,
                self.tiers, self.worklist,
            )
            self.ov_count += 2 * b
            self.head += b
            self.step_idx += 1
            yield stats
