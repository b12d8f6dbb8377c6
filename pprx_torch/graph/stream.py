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
graph it captured at its first loop, and one read. The slide loop is the
shell's (``pprx_torch.graph.driver``); the batch goes to the device in one
int32 transfer, ``[new_src, new_dst, slots]``, into its held pack.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.convert import window_from_arrays
from pprx_torch.engine.graphs import RoundGraphs, copy_into_
from pprx_torch.engine.push import push_to_convergence
from pprx_torch.engine.state import FORWARD, PushStats
from pprx_torch.engine.update import apply_edge_batch_, window_row_sums
from pprx_torch.graph.dynamic import WindowGraph, delivery_view
from pprx_torch.graph.driver import WindowDriver


class StreamDriver(WindowDriver):
    """Host loop over the slide steps. Holds the full stream in host
    memory; the device holds the live window and the PPR state. ``queries``
    selects the batched query vertices (sources in forward mode, targets in
    reverse mode)."""

    engine = "dense"

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
        super().__init__(stream_src, stream_dst, n, queries, cfg, scfg, mode, dtype, device)
        self.graph = self.first_window()
        self._hold()

    def _hold(self) -> None:
        """The delivery-sorted view, the round buffers and the slide's
        pack, for the driver's life."""
        self.view = delivery_view(self.graph, self.mode)
        self.round_graphs = RoundGraphs(self.n, 1, self.device)
        self._hold_pack(3 * self.scfg.slide)

    def _resume(self, arrays: Mapping[str, np.ndarray], tune: Mapping | None) -> None:
        self.graph = window_from_arrays(arrays, self.device)
        self._hold()

    @property
    def window(self) -> WindowGraph:
        return self.graph

    def seed(self) -> PushStats:
        """Static push on the initial window."""
        return push_to_convergence(self.state, self.graph, self.cfg, self.round_graphs,
                                   self.view)[1]

    def _pack_batch(self) -> np.ndarray:
        """``[new_src, new_dst, slots]``."""
        return np.concatenate([*self._batch(), self._slots()]).astype(np.int32)

    def _slide(self) -> PushStats:
        """One window slide, in place: delete the expiring edges at the
        pack's slots, insert the new ones there, correct the state and the
        degrees, rebuild the delivery-sorted view into its tensors, push to
        convergence (one loop of ``round_graphs``)."""
        b, state, graph, view, pack = self.scfg.slide, self.state, self.graph, self.view, self._pack
        new_src, new_dst, slots = pack[:b], pack[b:2 * b], pack[2 * b:]
        old_src, old_dst = graph.src[slots], graph.dst[slots]
        # corrections read the old degrees, and in reverse mode the old
        # window's row sums: K1 over the view, which is still the old window's
        # (sorted by src, gathering dst)
        rowsum = None if state.mode == FORWARD else window_row_sums(state.p, [(view.gat, view.off)])
        apply_edge_batch_(state, graph, new_src, new_dst, old_src, old_dst, self.cfg,
                          rowsum=rowsum)
        del rowsum
        graph.src[slots] = new_src
        graph.dst[slots] = new_dst
        copy_into_(view, delivery_view(graph, state.mode))
        return push_to_convergence(state, graph, self.cfg, self.round_graphs, view)[1]
