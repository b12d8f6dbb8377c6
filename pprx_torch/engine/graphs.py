"""Captured CUDA graphs of the wl2 slides and convergence rounds: the port's
counterpart of the reference's compiled slide, seed and refine programs
(``pprx/graph/fast_stream.py``'s jitted ``wl2_slide_step`` and
``_seed_wl2_jit``, ``_refine_wl2_jit``).

The reference runs a whole convergence loop as one device program: a
``lax.while_loop`` whose branches are ``lax.cond``. Torch has no device-side
branch, so the port keeps the loop on the host with one packed readback a
round, which picks the next branch (``pprx_torch.engine.wl2``). What a
graph removes is the rest: each round's ~70 eager launches and the Python
around them, and a slide prologue's ~160, become one ``CUDAGraph.replay()``.

A graph reads and writes fixed addresses, so:

- the state's ``p`` and ``r`` and every tensor of the kill graph (its window
  too) are the driver's buffers for its whole life: the slide step, the
  rebuild and a restore copy into them (``copy_into_``), and ``bind``
  refuses a state, graph or slide's pack whose tensors are not the ones
  captured;
- what one round hands the next, or the host, lives here, outside the
  graphs' memory pool: the candidate list ``cand`` (int32, ``width``
  entries: ``n + 1`` or the widest tier; a tier reads its first ``w_i``
  entries, a round writes its list and ``n`` past it), the counters
  ``counts`` (int64 ``[5]``: cn, fed, fre, n_active, edge_work) and
  ``c0n``, the seed list's length. The host reads ``counts`` through a
  pinned buffer and an event.

A graph is captured at the first use of its key (the caller's: mode, bf16
delivery, eps, alpha and the step's shape). The steps are the rounds
(``pprx_torch.engine.wl2``), a slide's prologue and the kill graph's
rebuild (``pprx_torch.graph.fast_stream``). That step first runs eagerly
on a side stream: its own work, which also loads every kernel the capture
records (the segment-sum library loads its module lazily). Then the same
function is captured into a graph that shares the cache's one memory pool:
the graphs replay one after another, and nothing crosses between them
through the pool. A failed capture raises; nothing falls back to eager
launches on CUDA. A kernel's wrapper counts a launch when it runs, so a
capture's counts are taken back out of every kernel module's ``LAUNCHES``
(``KERNEL_COUNTS``) and added again on every replay.

On CPU tensors ``run`` calls the step's function: the same functions on
the same buffers, eagerly. That is the plain path the tests take, chosen by the
device the caller passed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Hashable

import torch

from pprx_torch.engine import rowpass, segsum

N_COUNTS = 5  # cn, fed, fre, n_active, edge_work

# every kernel module's launch counts, which a replay adds to
KERNEL_COUNTS = (segsum.LAUNCHES, rowpass.LAUNCHES)


def tensor_ptrs(obj) -> tuple[int, ...]:
    """``data_ptr()`` of every tensor of a dataclass of tensors (nested
    dataclasses too), in field order."""
    ptrs = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            ptrs.append(v.data_ptr())
        elif dataclasses.is_dataclass(v):
            ptrs.extend(tensor_ptrs(v))
    return tuple(ptrs)


def copy_into_(dst, src) -> None:
    """Copy every tensor of the dataclass ``src`` into the same field of
    ``dst`` (nested dataclasses too), in place; a field that is one tensor
    in both is left alone. Shapes must be equal: ``copy_`` would broadcast."""
    for f in dataclasses.fields(dst):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if isinstance(a, torch.Tensor):
            if a.shape != b.shape:
                raise ValueError(f"{f.name}: cannot copy {tuple(b.shape)} into {tuple(a.shape)}")
            if a is not b:
                a.copy_(b)
        elif dataclasses.is_dataclass(a):
            copy_into_(a, b)


class RoundGraphs:
    """One driver's round buffers, and on CUDA its captured round graphs.

    ``captures``, ``capture_s``, ``replays`` and ``eager`` (rounds run
    eagerly on CUDA: each capture's warm-up) count since construction.
    """

    def __init__(self, n: int, width: int, device: torch.device | str):
        self.device = torch.device(device)
        self.n = n
        self.cand = torch.full((max(width, n + 1),), n, dtype=torch.int32, device=self.device)
        self.counts = torch.zeros(N_COUNTS, dtype=torch.int64, device=self.device)
        self.c0n = torch.zeros((), dtype=torch.int64, device=self.device)
        self.graphs: dict[Hashable, tuple[torch.cuda.CUDAGraph, list[dict]]] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.eager = 0
        self._bound: tuple[int, ...] | None = None
        self._pack: int | None = None
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.side = torch.cuda.Stream(self.device)
            self.host = torch.empty(N_COUNTS, dtype=torch.int64, pin_memory=True)
            self.ready = torch.cuda.Event()

    def bind(self, state, kg, pack: torch.Tensor | None = None) -> None:
        """Tie the cache to the tensors of ``state`` and ``kg`` at its first
        call, and to a slide's ``pack`` at the first call that passes one;
        later calls must hand over the same tensors."""
        ptrs = tensor_ptrs(state) + tensor_ptrs(kg)
        if self._bound is None:
            self._bound = ptrs
        elif ptrs != self._bound:
            raise RuntimeError(
                "the state or the kill graph was rebound after its rounds were captured: "
                "copy into the driver's tensors (copy_into_) instead")
        if pack is None:
            return
        if self._pack is None:
            self._pack = pack.data_ptr()
        elif pack.data_ptr() != self._pack:
            raise RuntimeError(
                "a slide's pack was rebound after its prologue was captured: "
                "upload each batch into the same tensor instead")

    def seed(self, cand0: torch.Tensor, c0n: torch.Tensor | int) -> None:
        """The first candidate list: ``cand0`` (phantom-padded), then ``n``;
        ``c0n`` of its entries count."""
        m = min(cand0.shape[0], self.cand.shape[0])
        self.cand[:m].copy_(cand0[:m])
        self.cand[m:].fill_(self.n)
        if isinstance(c0n, torch.Tensor):
            self.c0n.copy_(c0n)
        else:
            self.c0n.fill_(int(c0n))

    def emit(self, cand2: torch.Tensor) -> None:
        """A round's next candidate list into ``cand``, ``n`` past it."""
        w = cand2.shape[0]
        self.cand[:w].copy_(cand2)
        if w < self.cand.shape[0]:
            self.cand[w:].fill_(self.n)

    def put(self, at: int, *counts: torch.Tensor) -> None:
        """Device scalars into ``counts[at:]``."""
        self.counts[at:at + len(counts)].copy_(torch.stack(counts))

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """One round: ``fn()`` on the CPU; on CUDA the replay of its graph,
        captured at the key's first use (after ``fn`` ran eagerly once)."""
        if self.device.type != "cuda":
            fn()
            return
        # a capture records the current device's stream, whatever device
        # the tensors are on: make it the driver's
        with torch.cuda.device(self.device):
            self._run(key, fn)

    def _run(self, key: Hashable, fn: Callable[[], None]) -> None:
        hit = self.graphs.get(key)
        if hit is not None:
            graph, launched = hit
            graph.replay()
            for counts, added in zip(KERNEL_COUNTS, launched):
                for k, c in added.items():
                    counts[k] += c
            self.replays += 1
            return
        main = torch.cuda.current_stream(self.device)
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            fn()
        main.wait_stream(self.side)
        self.eager += 1
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = [dict(counts) for counts in KERNEL_COUNTS]
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                fn()
        finally:
            launched = [{k: counts[k] - was[k] for k in was}
                        for counts, was in zip(KERNEL_COUNTS, before)]
            for counts, was in zip(KERNEL_COUNTS, before):
                counts.update(was)
        self.graphs[key] = (graph, launched)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def read(self) -> list[int]:
        """``counts`` on the host: the round's one sync."""
        if self.device.type != "cuda":
            return self.counts.tolist()
        self.host.copy_(self.counts, non_blocking=True)
        self.ready.record(torch.cuda.current_stream(self.device))
        self.ready.synchronize()
        return self.host.tolist()

    def summary(self) -> dict:
        return {"graphs": len(self.graphs), "captures": self.captures,
                "capture_s": self.capture_s, "replays": self.replays, "eager_rounds": self.eager}
