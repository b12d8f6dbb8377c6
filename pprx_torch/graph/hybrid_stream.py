"""Sliding-window driver on the hybrid (snapshot + overlay) engine (port of
``pprx.graph.hybrid_stream``).

Each slide corrects the state for its b expiries and b insertions, appends
the 2b changes to the signed overlay, rewrites the ring slots, and pushes
to convergence with frontier-sparse rounds (``pprx_torch.engine.sparse``):
the worklist loop, seeded with the 4b endpoints the corrections touched,
or with ``worklist=False`` the single-tier adaptive loop. The CSR snapshot
is re-sorted from the window, and the overlay cleared, whenever the next
slide's 2b entries would not fit the overlay (every ``rebuild_every``
slides). The new batch, its slots and the overlay's fill go to the device
in one int32 transfer.

The driver's state, window, snapshot, overlay and the window's
delivery-sorted view (the dense scan's) are its buffers for its whole
life, and it keeps one ``RoundGraphs``: the slide (the corrections, the
overlay append at the fill the pack carries, the ring writes, the view's
rebuild and the first list with its validity, which stays on the device)
is the loop's prologue, so that on CUDA a slide is one launch of its loop's
graph and one read of the loop's statistics, as the reference's slide is
one jitted program. The rebuild writes into the held snapshot and clears
the overlay in place (``RoundGraphs.run``: on CUDA a replay of its graph, a
second launch). The seed and ``from_arrays`` take the same loops. The slide
loop is the shell's (``pprx_torch.graph.driver``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.convert import window_from_arrays
from pprx_torch.engine import loop
from pprx_torch.engine.graphs import RoundGraphs, copy_into_
from pprx_torch.engine.sparse import (
    HybridGraph,
    _dedup_compact,
    converge,
    count_frontier,
    graph_key,
    list_counts,
    make_tiers,
    push_to_convergence_hybrid,
    push_to_convergence_worklist,
    rebuild_snapshot_,
    round_graphs_for,
    scan_tiers,
)
from pprx_torch.engine.state import FORWARD, PprState, PushStats
from pprx_torch.engine.update import apply_edge_batch_, window_row_sums
from pprx_torch.graph.dynamic import DeliveryView, delivery_view
from pprx_torch.graph.driver import WindowDriver

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
    """One window slide, in place: ``slide_`` on a pack of the batch, its
    ring ``slots`` and the overlay's fill ``ov_count``, with round buffers
    and a delivery-sorted view of its own (a driver keeps its own for its
    life). Returns the same state and graph, and the loop's statistics."""
    fill = torch.full((1,), ov_count, dtype=torch.int32, device=slots.device)
    pack = torch.cat([new_src, new_dst, slots, fill]).to(torch.int32)
    g, view = round_graphs_for(state, graph, None, tiers[-1][0] if worklist else 1, None)
    stats = slide_(state, graph, view, pack, ov_count, cfg, fcap, ecap, scan_ecap, tiers,
                   worklist, g)
    return state, graph, stats


def slide_(
    state: PprState,
    graph: HybridGraph,
    view: DeliveryView,
    pack: torch.Tensor,
    ov_count: int,
    cfg: PprConfig,
    fcap: int,
    ecap: int,
    scan_ecap: int,
    tiers: tuple[tuple[int, int, int], ...],
    worklist: bool,
    graphs: RoundGraphs,
) -> PushStats:
    """One window slide in place. ``pack`` is int32 ``[3b + 1]`` on the
    device: the batch's new_src and new_dst, their ring slots, and the
    overlay's fill ``ov_count``, which the host passes too, to refuse an
    overflow. ``scan_ecap`` (0: ``ecap``) sizes only the worklist loop's
    scan rounds. ``graphs`` is bound to ``state``, ``graph``, ``view`` and
    ``pack``: on CUDA the slide up to its first round is one captured
    prologue that reads ``pack`` where it lies, and the loop's graph runs
    it first."""
    b = (pack.shape[0] - 1) // 3
    if ov_count + 2 * b > graph.ov.src.shape[0]:
        # the reference's dynamic_update_slice would clamp the start and
        # overwrite live entries; the driver rebuilds before that
        raise ValueError(f"overlay overflow: ov_count {ov_count} + 2b {2 * b} > "
                         f"capacity {graph.ov.src.shape[0]}")
    g = graphs
    g.hold("the hybrid state, graph and view", state, graph, view)
    g.hold("a slide's pack", pack)
    wcap = tiers[-1][0] if worklist else 0
    front = g.buffer("front", graph.n, torch.bool)
    prologue = ((*graph_key(state, cfg), "slide", b, wcap),
                lambda: _slide_prologue(state, graph, view, pack, cfg, g, front, wcap))
    if worklist:
        scans = scan_tiers(tiers, fcap, scan_ecap if scan_ecap > 0 else ecap)
        return converge(state, graph, view, cfg, g, tuple(tiers), scans, True, prologue)
    return converge(state, graph, view, cfg, g, (), ((fcap, ecap),), False, prologue)


def _slide_prologue(state: PprState, graph: HybridGraph, view: DeliveryView, pack: torch.Tensor,
                    cfg: PprConfig, g: RoundGraphs, front: torch.Tensor, wcap: int) -> None:
    """A slide up to its first round: the corrections, the overlay append,
    the ring writes, the view's rebuild, and the first list with its counts
    and validity (``wcap`` > 0), or the state's first count (its rows into
    ``front``). Shapes depend on ``b`` alone; the overlay's fill is read
    from ``pack`` on the device."""
    n = graph.n
    b = (pack.shape[0] - 1) // 3
    forward = state.mode == FORWARD
    new_src, new_dst, slots = pack[:b], pack[b:2 * b], pack[2 * b:3 * b]
    w, ov = graph.window, graph.ov
    old_src, old_dst = w.src[slots], w.dst[slots]
    # corrections read the old degrees, and in reverse mode the old window's
    # row sums (K1 over the old view: sorted by src, gathering dst)
    rowsum = None if forward else window_row_sums(state.p, [(view.gat, view.off)])
    apply_edge_batch_(state, w, new_src, new_dst, old_src, old_dst, cfg, rowsum=rowsum)
    del rowsum
    # overlay: expiries (-1) then insertions (+1) at [ov_count, ov_count + 2b)
    at = (pack[3 * b] + torch.arange(2 * b, device=pack.device)).long()
    ov.src.index_copy_(0, at, torch.cat([old_src, new_src]))
    ov.dst.index_copy_(0, at, torch.cat([old_dst, new_dst]))
    sign = torch.ones(2 * b, dtype=ov.sign.dtype, device=pack.device)
    sign[:b].fill_(-1)
    ov.sign.index_copy_(0, at, sign)
    w.src[slots] = new_src
    w.dst[slots] = new_dst
    copy_into_(view, delivery_view(w, state.mode))
    if wcap:
        # the corrections inject mass only at the 4b batch endpoints: they
        # are the whole first list; its validity stays on the device
        cand0, c0n = _dedup_compact(torch.cat([old_src, old_dst, new_src, new_dst]), wcap, n)
        g.emit(cand0)
        g.counts[loop.C0V:loop.C0V + 1].copy_((c0n <= wcap).reshape(1))
        list_counts(graph, state.mode, g, wcap)
    else:
        g.counts[:3].zero_()
        count_frontier(state, graph, cfg, g, front)


class HybridStreamDriver(WindowDriver):
    """Sliding-window stream driver on the hybrid engine. The capacities
    are the reference's (``pprx.graph.hybrid_stream.HybridStreamDriver``):
    ``fcap`` n+1 rows; ``ecap`` 8 slides' worth of edge lanes, at least
    65,536 and at most the window; ``scan_ecap`` 4 ecap, at most half the
    window (but not below ecap); candidate rows ``wcap`` and live overlay
    entries ``ovacap`` 4 slides' worth (at least 32,768 and 8,192), on a
    ladder of ``n_tiers`` tiers (``make_tiers``); an overlay of
    ``2 * slide * rebuild_every`` entries."""

    engine = "hybrid"

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
        super().__init__(stream_src, stream_dst, n, queries, cfg, scfg, mode, dtype, device)
        w, b = scfg.window, scfg.slide
        self.graph = HybridGraph.build(self.first_window(), mode, 2 * b * rebuild_every)
        self.fcap = fcap if fcap is not None else n + 1
        self.ecap = ecap if ecap is not None else min(max(8 * b, 65_536), w)
        self.scan_ecap = min(4 * self.ecap, max(w // 2, self.ecap))
        self.worklist = worklist
        self.wcap = max(4 * b, 32_768)
        self.ovacap = max(4 * b, 8192)
        self.tiers = make_tiers(self.wcap, self.ecap, self.ovacap, n_tiers=n_tiers)
        self.rebuild_every = rebuild_every
        self.ov_count = 0
        self._hold()

    def _hold(self) -> None:
        """The delivery-sorted view, the round buffers and the slide's
        pack, for the driver's life."""
        self.view = delivery_view(self.graph.window, self.mode)
        self.round_graphs = RoundGraphs(self.n, self.wcap if self.worklist else 1, self.device,
                                        n_counts=loop.N_COUNTS)
        self._hold_pack(3 * self.scfg.slide + 1)

    def _resume(self, arrays: Mapping[str, np.ndarray], tune: Mapping) -> None:
        """The writer's tuning (the JAX package's hybrid driver's too); the
        snapshot is rebuilt from the window and the overlay starts empty."""
        self.rebuild_every = int(tune["rebuild_every"])
        self.graph = HybridGraph.build(window_from_arrays(arrays, self.device), self.mode,
                                       2 * self.scfg.slide * self.rebuild_every)
        self.ov_count = 0
        for key in ("fcap", "ecap", "scan_ecap", "wcap", "ovacap"):
            setattr(self, key, int(tune[key]))
        self.tiers = tuple(tuple(int(x) for x in t) for t in tune["tiers"])
        self.worklist = bool(tune["worklist"])
        self._hold()

    def tuning(self) -> dict:
        return {k: getattr(self, k) for k in TUNING}

    def seed(self) -> PushStats:
        """Static push on the initial window (the worklist loop starts with
        a scan)."""
        g, view = self.round_graphs, self.view
        if self.worklist:
            cand0 = torch.full((self.wcap,), self.n, dtype=torch.int32, device=self.device)
            return push_to_convergence_worklist(
                self.state, self.graph, self.cfg, cand0, False, self.tiers, self.fcap,
                self.scan_ecap, graphs=g, view=view)[1]
        return push_to_convergence_hybrid(self.state, self.graph, self.cfg, self.fcap, self.ecap,
                                          graphs=g, view=view)[1]

    def _rebuild_due(self) -> bool:
        return self.ov_count + 2 * self.scfg.slide > self.graph.ov.src.shape[0]

    def _rebuild(self) -> None:
        self.round_graphs.run(("rebuild", self.mode),
                              lambda: rebuild_snapshot_(self.graph, self.mode))
        self.ov_count = 0

    def _pack_batch(self) -> np.ndarray:
        """``[new_src, new_dst, slots, overlay fill]``."""
        return np.concatenate([*self._batch(), self._slots(), [self.ov_count]]).astype(np.int32)

    def _slide(self) -> PushStats:
        return slide_(self.state, self.graph, self.view, self._pack, self.ov_count, self.cfg,
                      self.fcap, self.ecap, self.scan_ecap, self.tiers, self.worklist,
                      self.round_graphs)

    def _advance(self) -> None:
        self.ov_count += 2 * self.scfg.slide
