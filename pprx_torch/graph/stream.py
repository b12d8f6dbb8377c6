"""Sliding-window stream driver on the dense engine (port of
``pprx.graph.stream``).

The host loop slides the window one batch per step: the b new edges
overwrite the ring slots of the b expiring ones, the state is corrected
(``apply_edge_batch_``) and pushed back to convergence over the whole COO
window (``push_to_convergence``). ``slide=1`` is the per-edge mode: every
edge event is absorbed before the next is read.

The driver's state, ring, degrees and delivery-sorted view are fixed
buffers for its life, updated in place, and it keeps one ``RoundGraphs``:
on CUDA each loop (the seed's, each slide's) is one launch of the loop
graph it captured at its first loop, and one read.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.convert import state_from_arrays, window_from_arrays
from pprx_torch.device import resolve_device
from pprx_torch.engine.graphs import RoundGraphs, copy_into_
from pprx_torch.engine.push import push_to_convergence
from pprx_torch.engine.segsum import segsum_gather_add_
from pprx_torch.engine.state import FORWARD, PprState, PushStats, init_state
from pprx_torch.engine.update import apply_edge_batch_
from pprx_torch.graph.dynamic import DeliveryView, WindowGraph, delivery_view


def slide_step_(
    state: PprState,
    graph: WindowGraph,
    view: DeliveryView,
    new_src: torch.Tensor,
    new_dst: torch.Tensor,
    slots: torch.Tensor,
    cfg: PprConfig,
    graphs: RoundGraphs | None = None,
) -> PushStats:
    """One window slide, in place: delete the expiring edges at ``slots``,
    insert the new ones there, correct the state and the degrees, rebuild
    the delivery-sorted ``view`` into its tensors, push to convergence
    (through ``graphs``, as ``push_to_convergence``)."""
    old_src = graph.src[slots]
    old_dst = graph.dst[slots]
    # corrections read the old degrees, and in reverse mode the old
    # window's row sums: K1 over the view, which is still the old window's
    # (sorted by src, gathering dst)
    rowsum = None
    if state.mode != FORWARD:
        rowsum = torch.zeros_like(state.p)
        segsum_gather_add_(rowsum[:graph.n], state.p, view.gat, view.off)
    apply_edge_batch_(state, graph, new_src, new_dst, old_src, old_dst, cfg, rowsum=rowsum)
    del rowsum
    graph.src[slots] = new_src
    graph.dst[slots] = new_dst
    copy_into_(view, delivery_view(graph, state.mode))
    return push_to_convergence(state, graph, cfg, graphs, view)[1]


class StreamDriver:
    """Host loop over the slide steps. Holds the full stream in host
    memory; the device holds the live window and the PPR state. ``queries``
    selects the batched query vertices (sources in forward mode, targets in
    reverse mode)."""

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
        w = scfg.window
        self.graph = WindowGraph.from_coo(
            self.stream_src[:w], self.stream_dst[:w], n, capacity=w, device=self.device
        )
        self.state = init_state(n, queries, mode=mode, dtype=dtype, device=self.device)
        self.head = w  # next stream position to insert
        self.step_idx = 0
        self._hold()

    def _hold(self) -> None:
        """The delivery-sorted view and the round buffers, for the
        driver's life."""
        self.view = delivery_view(self.graph, self.mode)
        self.round_graphs = RoundGraphs(self.n, 1, self.device)

    @classmethod
    def from_arrays(
        cls,
        stream_src: np.ndarray,
        stream_dst: np.ndarray,
        arrays: Mapping[str, np.ndarray],
        meta: Mapping,
        device: torch.device | str | None = None,
    ) -> "StreamDriver":
        """A driver mid-stream from checkpoint arrays (``p, r, src, dst,
        deg``) and metadata (``n, head, step_idx, mode, cfg, scfg``)."""
        if meta.get("engine", "dense") != "dense":
            raise ValueError(f"not a dense-driver state: engine={meta.get('engine')!r}")
        drv = cls.__new__(cls)
        drv.device = resolve_device(device)
        drv.stream_src = np.asarray(stream_src, dtype=np.int32)
        drv.stream_dst = np.asarray(stream_dst, dtype=np.int32)
        drv.n = int(meta["n"])
        drv.cfg = PprConfig(**meta["cfg"])
        drv.scfg = StreamConfig(**meta["scfg"])
        drv.mode = int(meta["mode"])
        drv.state = state_from_arrays(arrays["p"], arrays["r"], drv.mode, drv.device)
        drv.graph = window_from_arrays(arrays, drv.device)
        drv.head = int(meta["head"])
        drv.step_idx = int(meta["step_idx"])
        drv._hold()
        return drv

    def seed(self) -> PushStats:
        """Static push on the initial window."""
        return push_to_convergence(self.state, self.graph, self.cfg, self.round_graphs,
                                   self.view)[1]

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
            # one int32 transfer per slide: [new_src, new_dst, slots]
            pack = np.concatenate([
                self.stream_src[self.head : self.head + b],
                self.stream_dst[self.head : self.head + b],
                (np.arange(self.head, self.head + b) % w).astype(np.int32),
            ])
            pack = torch.from_numpy(pack).to(self.device)
            stats = slide_step_(self.state, self.graph, self.view, pack[:b], pack[b : 2 * b],
                                pack[2 * b :], self.cfg, self.round_graphs)
            self.head += b
            self.step_idx += 1
            yield stats
