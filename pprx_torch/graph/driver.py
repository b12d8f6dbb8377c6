"""The sliding-window shell under the single-card stream drivers: the
dense (``graph/stream.py``), the wl2 (``graph/fast_stream.py``) and the
hybrid (``graph/hybrid_stream.py``) driver.

The shell holds the whole stream on the host (int32), the PPR state on the
device, the cursor (``head``, the next stream position to insert, and
``step_idx``) and one int32 pack for the driver's life, into which each
slide's batch is uploaded (a captured prologue reads it where it lies). It
runs the slide loop and the half of ``from_arrays`` every driver shares.

Each slide is a span of the flight recorder (``pprx_torch.trace``), its id
the slide's ``step_idx``, with the host's steps as its children:
``slide.rebuild`` (where one is due), ``slide.pack``, ``slide.upload``,
``slide.issue`` (which ``RoundGraphs`` ends at the loop's launch, opening
``loop.wait``) and, where the driver keeps a host copy of the ring,
``slide.mirror``.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

from pprx_torch import trace
from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.convert import state_from_arrays
from pprx_torch.device import resolve_device
from pprx_torch.engine.state import PushStats, init_state
from pprx_torch.graph.dynamic import WindowGraph

# the flight recorder's spans of a slide
SLIDE, REBUILD, PACK, UPLOAD, ISSUE, MIRROR = (trace.tag(f"slide{x}") for x in (
    "", ".rebuild", ".pack", ".upload", ".issue", ".mirror"))


class WindowDriver:
    """A stream driver's shell. ``queries`` selects the batched query
    vertices (sources in forward mode, targets in reverse mode).

    A driver adds its engine: ``engine``, its name in a checkpoint; its
    graph and held buffers (``_resume`` for ``from_arrays``); the batch in
    its pack's layout (``_pack_batch``, an int32 array); ``_rebuild`` where
    ``_rebuild_due``; the slide of the batch in ``_pack`` (``_slide``, the
    loop's statistics); ``_mirror`` where it keeps a host copy of the ring;
    its counters (``_advance``); and what its checkpoint carries besides
    the state and the window (``tuning``, ``extra_arrays``), which
    ``pprx_torch.io.checkpoint`` writes as given."""

    engine: str
    _mirror = None

    def __init__(self, stream_src: np.ndarray, stream_dst: np.ndarray, n: int, queries,
                 cfg: PprConfig, scfg: StreamConfig, mode: int, dtype: torch.dtype,
                 device: torch.device | str | None):
        if stream_src.shape[0] < scfg.window:
            raise ValueError("stream shorter than one window")
        self._open(stream_src, stream_dst, n, cfg, scfg, mode, device)
        self.state = init_state(n, queries, mode=mode, dtype=dtype, device=self.device)
        self.head = scfg.window
        self.step_idx = 0

    def _open(self, stream_src, stream_dst, n: int, cfg: PprConfig, scfg: StreamConfig,
              mode: int, device) -> None:
        self.device = resolve_device(device)
        self.stream_src = np.asarray(stream_src, dtype=np.int32)
        self.stream_dst = np.asarray(stream_dst, dtype=np.int32)
        self.n, self.cfg, self.scfg, self.mode = n, cfg, scfg, mode

    @classmethod
    def from_arrays(cls, stream_src: np.ndarray, stream_dst: np.ndarray,
                    arrays: Mapping[str, np.ndarray], meta: Mapping,
                    device: torch.device | str | None = None) -> "WindowDriver":
        """A driver mid-stream from a checkpoint's arrays (``p, r, src, dst,
        deg`` and the driver's own) and metadata (``n, head, step_idx, mode,
        engine, cfg, scfg`` and the driver's ``tuning``), as either
        package's ``save_checkpoint`` writes them."""
        if meta.get("engine", "dense") != cls.engine:
            raise ValueError(f"not a {cls.engine}-driver state: engine={meta.get('engine')!r}")
        drv = cls.__new__(cls)
        drv._open(stream_src, stream_dst, int(meta["n"]), PprConfig(**meta["cfg"]),
                  StreamConfig(**meta["scfg"]), int(meta["mode"]), device)
        drv.state = state_from_arrays(arrays["p"], arrays["r"], drv.mode, drv.device)
        drv.head = int(meta["head"])
        drv.step_idx = int(meta["step_idx"])
        drv._resume(arrays, meta.get("tuning"))
        return drv

    def first_window(self) -> WindowGraph:
        """The stream's first ``window`` edges as the COO ring."""
        w = self.scfg.window
        return WindowGraph.from_coo(self.stream_src[:w], self.stream_dst[:w], self.n,
                                    capacity=w, device=self.device)

    def _hold_pack(self, length: int) -> None:
        self._pack = torch.zeros(length, dtype=torch.int32, device=self.device)

    @property
    def window(self) -> WindowGraph:
        """The live window's COO ring, which a checkpoint saves."""
        return self.graph.window

    def tuning(self) -> dict | None:
        return None

    def extra_arrays(self) -> dict[str, np.ndarray]:
        return {}

    @property
    def steps_available(self) -> int:
        return (self.stream_src.shape[0] - self.head) // self.scfg.slide

    def _batch(self) -> tuple[np.ndarray, np.ndarray]:
        """The next slide's new edges: the stream at ``[head, head + b)``."""
        at = slice(self.head, self.head + self.scfg.slide)
        return self.stream_src[at], self.stream_dst[at]

    def _slots(self) -> np.ndarray:
        """Their ring slots: the stream positions modulo the window."""
        return np.arange(self.head, self.head + self.scfg.slide) % self.scfg.window

    def _rebuild_due(self) -> bool:
        return False

    def _advance(self) -> None:
        pass

    def run(self, n_steps: int | None = None) -> Iterator[PushStats]:
        """Slide the window ``n_steps`` times (default: until the stream
        ends)."""
        b = self.scfg.slide
        total = self.steps_available if n_steps is None else n_steps
        rec = trace.RECORDER
        for _ in range(total):
            if self.head + b > self.stream_src.shape[0]:
                return
            with rec.span(SLIDE, self.step_idx):
                if self._rebuild_due():
                    with rec.span(REBUILD):
                        self._rebuild()
                with rec.span(PACK):
                    pack = self._pack_batch()
                # the batch's one upload, into the tensor the slide reads
                with rec.span(UPLOAD):
                    self._pack.copy_(torch.from_numpy(pack))
                with rec.span(ISSUE):  # ends at the loop's launch (``loop.wait``)
                    stats = self._slide()
                if self._mirror is not None:
                    with rec.span(MIRROR):
                        self._mirror()
            self._advance()
            self.head += b
            self.step_idx += 1
            yield stats
