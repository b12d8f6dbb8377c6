"""Sliding-window driver on the wl2 engine (port of ``pprx.graph.fast_stream``).

Per slide: expiries are killed in place in the CSR snapshot, fresh edges
join a mini-CSR re-sorted each slide, and the convergence loop runs compact
rounds with exact tier selection (``pprx_torch.engine.wl2``). The new batch
goes to the device in one int32 transfer; the expiring batch, the endpoint
sorts and the candidate seeds are derived on the device. On CUDA a slide is
one launch of its loop's graph, the prologue inside, and one read of the
loop's statistics; a slide that rebuilds the kill graph first replays the
rebuild's graph, a second launch.

The slide loop and its spans are the shell's (``pprx_torch.graph.driver``);
this driver's slide has all of them, ``slide.mirror`` its host copy of the
ring. The prologue stamps the card's clock at its passes and counts the
rows its corrections work on (``corr.rows``, one count a slide's loop).

The driver's state and kill graph are its buffers for its whole life: the
slide step, the rebuild and ``from_arrays`` write into their tensors, never
rebind them, because on CUDA the convergence rounds are captured graphs
(``pprx_torch.engine.graphs``) that read fixed addresses. A caller that
puts a saved state back copies into them (``copy_into_``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from pprx_torch import trace
from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.convert import kill_graph_from_arrays, kill_graph_to_arrays
from pprx_torch.engine.graphs import RoundGraphs
from pprx_torch.engine.segsum import compact
from pprx_torch.engine.state import FORWARD, PprState, PushStats
from pprx_torch.engine.update import apply_edge_batch_, source_rows, window_row_sums
from pprx_torch.engine.wl2 import (
    KillGraph,
    first_count,
    build_kill_graph,
    converge_wl2,
    graph_key,
    make_tiers2,
    push_to_convergence_wl2,
    rebuild_kill_graph_,
    refresh_fresh_csr,
    round_graphs_for,
)
from pprx_torch.graph.driver import WindowDriver

# the recorder's counter of a slide: the distinct source rows its
# corrections work on
CORR_ROWS = "corr.rows"


def wl2_slide_step(
    state: PprState,
    kg: KillGraph,
    pack: torch.Tensor,
    fcnt: int,
    cfg: PprConfig,
    tiers: tuple[tuple[int, int, int], ...],
    bf16d: bool = False,
    graphs: RoundGraphs | None = None,
) -> tuple[PprState, KillGraph, PushStats]:
    """One window slide. ``pack`` is int32 ``[2b + 2]`` on the device: the
    batch's new_src and new_dst in stream order, then its first ring slot
    (its stream position modulo the window's capacity) and the fresh-ring
    fill ``fcnt``, which the host passes too, to refuse an overflow.

    Updates the tensors of ``state`` and ``kg`` in place (the state, the
    degrees, the ring, the kill marks, the fresh ring and its views) and
    returns the same objects; ``graphs`` as for ``push_to_convergence_wl2``,
    bound to ``pack`` too. On CUDA the prologue (everything before the first
    round) is one captured graph that reads ``pack`` where it lies (a driver
    uploads each batch into the same tensor), and the loop's graph runs it
    first: a slide is one graph launch and one read of the loop's
    statistics.
    """
    b = (pack.shape[0] - 2) // 2
    fring = kg.fr_gat.shape[0]
    if fcnt + b > fring:
        # the reference's dynamic_update_slice would clamp the start and
        # overwrite live fresh edges; the driver rebuilds before that
        raise ValueError(f"fresh ring overflow: fcnt {fcnt} + b {b} > fring {fring}")
    tiers = tuple(tiers)
    g = round_graphs_for(state, kg, tiers, pack.device, graphs)
    g.bind(state, kg, pack)
    prologue = ((*graph_key(state, cfg, bf16d), "slide", b),
                lambda: _slide_prologue(state, kg, pack, cfg, g))
    return state, kg, converge_wl2(state, kg, cfg, True, tiers, g, bf16d, prologue=prologue)


def _slide_prologue(state: PprState, kg: KillGraph, pack: torch.Tensor, cfg: PprConfig,
                    g: RoundGraphs) -> None:
    """A slide up to its first round: the corrections, the kills, the ring
    writes, the fresh re-sort, and the first candidate list with its exact
    counts in ``g``. Shapes depend on ``b`` alone; the ring slot and the
    fresh-ring fill are read from ``pack`` on the device. Stamps mark its
    three passes: the sorts and corrections, the kills and ring writes with
    the fresh re-sort, the first count; in reverse mode ``rev.rowsum`` and
    ``rev.corrections`` split the first at the row-sum sweep's two ends. The
    count of the batch's distinct source rows goes to the recorder's
    ``corr.rows`` (``RoundGraphs.count_``)."""
    n = kg.n
    dev = pack.device
    trace.stamp("prologue.sort_corrections", dev)
    b = (pack.shape[0] - 2) // 2
    new_src0, new_dst0 = pack[:b], pack[b:2 * b]
    lane = torch.arange(b, dtype=torch.int32, device=dev)
    slots0 = (pack[2 * b] + lane) % kg.window.capacity
    old_src0 = kg.window.src[slots0]
    old_dst0 = kg.window.dst[slots0]
    # sort both batches by the row their corrections add to, so that K1
    # takes them as they lie (``keys_sorted``)
    forward = state.mode == FORWARD
    _, pn = torch.sort(new_dst0 if forward else new_src0, stable=True)
    _, po = torch.sort(old_dst0 if forward else old_src0, stable=True)
    new_src, new_dst = new_src0[pn], new_dst0[pn]
    old_src, old_dst = old_src0[po], old_dst0[po]
    slots = slots0[pn]
    # initial candidates: every endpoint the slide touches, unique ascending
    # (index_fill_, not ``x[idx] = scalar``: that copies the scalar from the
    # host, which a capture refuses; so does ``x[i] = scalar`` on a 1-D x)
    mark = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    for ends in (old_src0, old_dst0, new_src0, new_dst0):
        mark.index_fill_(0, ends.long(), True)
    c0n = mark[:n].sum()
    cand0 = compact(mark[:n], min(4 * b, n + 1), n)
    # corrections read the old degrees (and in reverse mode the old window's
    # row sums), so they run before any mutation. In reverse mode both views
    # are sorted by src, gathering dst, and before the kills and ring writes
    # the live snapshot slots and the fresh ring together are the old window
    rowsum = None
    if not forward:
        trace.stamp("rev.rowsum", dev)
        rowsum = window_row_sums(state.p, [(kg.d_gat, kg.d_off[:n + 1]),
                                           (kg.fd_gat, kg.fd_off[:n + 1])])
        trace.stamp("rev.corrections", dev)
    # the rows the corrections' row work runs on: the batch's sources, and
    # how many (the recorder's ``corr.rows``, read with the loop's carry)
    rows, n_rows = source_rows(old_src0, new_src0, n + 1)
    g.count_(CORR_ROWS, n_rows)
    apply_edge_batch_(state, kg.window, new_src, new_dst, old_src, old_dst, cfg, rowsum=rowsum,
                      keys_sorted=True, rows=rows)
    del rowsum
    trace.stamp("prologue.kill_ring", dev)
    # kill the expiring edges in both snapshot views (their slots are
    # snapshot-era: the driver keeps rebuild_every * slide <= window)
    kg.nbr.index_fill_(0, kg.snap_pos[slots].long(), n)
    kg.d_gat.index_fill_(0, kg.d_pos[slots].long(), n)
    # recycle the ring slots with the fresh batch
    kg.window.src[slots] = new_src
    kg.window.dst[slots] = new_dst
    # append the fresh edges to the ring + incremental per-row counts
    new_gat, new_sca = (new_src, new_dst) if forward else (new_dst, new_src)
    ring = pack[2 * b + 1] + lane
    kg.fr_gat[ring] = new_gat
    kg.fr_sca[ring] = new_sca
    kg.f_len.index_add_(0, new_gat, torch.ones_like(new_gat))
    kg.f_len[n:].fill_(0)
    refresh_fresh_csr(kg)
    trace.stamp("prologue.first_count", dev)
    g.seed(cand0, c0n)
    first_count(kg, g)


class FastStreamDriver(WindowDriver):
    """Sliding-window stream driver on the wl2 compact-frontier engine."""

    engine = "fast"

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
        rebuild_every: int = 8,
        e_top: int | None = None,
        n_tiers: int = 5,
        bf16d: bool = False,
        device: torch.device | str | None = None,
    ):
        super().__init__(stream_src, stream_dst, n, queries, cfg, scfg, mode, dtype, device)
        if rebuild_every * scfg.slide > scfg.window:
            raise ValueError(
                "rebuild_every * slide must be <= window (fresh edges must "
                f"not expire between rebuilds): {rebuild_every} * {scfg.slide}"
                f" > {scfg.window}"
            )
        w, b = scfg.window, scfg.slide
        self.fring = b * rebuild_every
        self.graph = build_kill_graph(self.first_window(), mode, self.fring)
        # edge-lane tier top: the reference's TPU-tuned rule, kept for parity
        # (big post-slide frontiers fall to the delivery-sorted scan)
        if e_top is not None:
            self.e_top = e_top
        elif len(queries) % 128:
            self.e_top = min(max(2 * b, 40_960), 262_144, w // 2)
        else:
            self.e_top = min(max(8 * b, 65_536), 262_144, w // 2)
        self.tiers = make_tiers2(n, w, self.fring, self.e_top, n_tiers=n_tiers)
        self.rebuild_every = rebuild_every
        self.fcnt = 0
        # host mirror of the ring (the window's edges, for exact-PPR checks)
        self.hsrc = self.stream_src[:w].copy()
        self.hdst = self.stream_dst[:w].copy()
        self.cap0 = 4 * b
        self._queries = list(queries)
        # bf16 scan-round delivery; residual removal stays exact
        self.bf16d = bool(bf16d)
        self._hold()

    def _hold(self) -> None:
        """The round buffers and the slide's pack, for the driver's life."""
        self.round_graphs = RoundGraphs(self.n, self.tiers[-1][0], self.device)
        self._hold_pack(2 * self.scfg.slide + 2)

    def _resume(self, arrays: Mapping[str, np.ndarray], tune: Mapping) -> None:
        """The kill graph from the ``kg_*`` arrays and the writer's tuning
        (the JAX package's fast-driver layout too)."""
        self.graph = kill_graph_from_arrays(arrays, self.device)
        self.rebuild_every = int(tune["rebuild_every"])
        self.e_top = int(tune["e_top"])
        self.fring = int(tune["fring"])
        self.cap0 = int(tune["cap0"])
        self.fcnt = int(tune["fcnt"])
        self.tiers = tuple(tuple(int(x) for x in t) for t in tune["tiers"])
        self._queries = [int(q) for q in tune["queries"]]
        self.bf16d = bool(tune.get("bf16d", False))
        self.hsrc = np.asarray(arrays["src"], dtype=np.int32).copy()
        self.hdst = np.asarray(arrays["dst"], dtype=np.int32).copy()
        self._hold()

    def tuning(self) -> dict:
        """The capacities, the fresh ring's fill and the queries; ``segsum``
        true: the port always delivers through its segment sum, and the
        reference resumes on its kernel."""
        return {
            "tiers": [list(t) for t in self.tiers],
            "rebuild_every": self.rebuild_every,
            "e_top": self.e_top,
            "fring": self.fring,
            "cap0": self.cap0,
            "fcnt": self.fcnt,
            "queries": [int(q) for q in self._queries],
            "segsum": True,
            "bf16d": self.bf16d,
        }

    def extra_arrays(self) -> dict[str, np.ndarray]:
        """Every ``kg_*`` array of the reference's KillGraph: the kill-in-place
        snapshot and the fresh ring are part of the exact round schedule."""
        return kill_graph_to_arrays(self.graph)

    @classmethod
    def from_checkpoint(
        cls, path: str, stream_src: np.ndarray, stream_dst: np.ndarray,
        device: torch.device | str | None = None,
    ) -> "FastStreamDriver":
        """A driver from a fast-driver checkpoint ``.npz`` of either package
        (``pprx_torch.io.checkpoint.load_checkpoint``)."""
        from pprx_torch.io.checkpoint import load_checkpoint  # imports this module

        drv = load_checkpoint(path, stream_src, stream_dst, device)
        if not isinstance(drv, cls):
            raise ValueError(f"{path}: not a fast-driver checkpoint")
        return drv

    def seed(self) -> PushStats:
        q = np.unique(np.asarray(self._queries, np.int32))
        cand0 = np.full(max(q.size, 8), self.n, np.int32)
        cand0[: q.size] = q
        _, stats = push_to_convergence_wl2(
            self.state, self.graph, self.cfg,
            torch.from_numpy(cand0).to(self.device), q.size, True, self.tiers,
            bf16d=self.bf16d, graphs=self.round_graphs,
        )
        return stats

    def refine(self, eps: float, rounds: int | None = None) -> PushStats:
        """Push the current state to a tighter threshold (retrieval-time
        refinement). The push invariant is preserved, so the stream can go
        on from the refined state. ``rounds`` bounds the refinement; an
        interrupted refinement is safe at any point."""
        cfg_r = dataclasses.replace(
            self.cfg, eps=eps,
            max_rounds=self.cfg.max_rounds if rounds is None else rounds,
        )
        # c0ok=False: the first round is a scan, which reseeds the
        # candidate list exactly for the tighter threshold
        cand0 = torch.full((8,), self.n, dtype=torch.int32, device=self.device)
        _, stats = push_to_convergence_wl2(
            self.state, self.graph, cfg_r, cand0, 0, False, self.tiers,
            bf16d=self.bf16d, graphs=self.round_graphs,
        )
        return stats

    def _rebuild_due(self) -> bool:
        return self.fcnt + self.scfg.slide > self.fring

    def _rebuild(self) -> None:
        self.round_graphs.run(("rebuild", self.mode, self.fring),
                              lambda: rebuild_kill_graph_(self.graph, self.mode, self.fring))
        self.fcnt = 0

    def _pack_batch(self) -> np.ndarray:
        """``[new_src, new_dst, first ring slot, fresh-ring fill]``."""
        return np.concatenate([*self._batch(), [self.head % self.scfg.window, self.fcnt]]
                              ).astype(np.int32)

    def _slide(self) -> PushStats:
        return wl2_slide_step(self.state, self.graph, self._pack, self.fcnt, self.cfg,
                              self.tiers, bf16d=self.bf16d, graphs=self.round_graphs)[2]

    def _mirror(self) -> None:
        slots = self._slots()
        self.hsrc[slots], self.hdst[slots] = self._batch()

    def _advance(self) -> None:
        self.fcnt += self.scfg.slide
