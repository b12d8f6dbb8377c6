"""Captured CUDA graphs of the wl2 slides and convergence loops, of the
sharded engines' in a world of one shard (the wl loop, the
memory-proportional ``wlp`` loop and the dense loop), of the dense
engine's loop and of the hybrid engine's slides and two loops: the port's
counterpart of the reference's compiled slide, seed and refine programs
(``pprx/graph/fast_stream.py``'s jitted ``wl2_slide_step`` and
``_seed_wl2_jit``, ``_refine_wl2_jit``; ``pprx/dist/wl.py``'s jitted
``push_wl`` and ``slide_wl``; ``pprx/dist/sharded.py``'s ``push`` and
``slide``; ``pprx/engine/push.py``'s ``push_to_convergence``;
``pprx/graph/hybrid_stream.py``'s jitted ``hybrid_slide_step`` and
``_seed_worklist_jit``).

The reference runs a whole convergence loop as one device program: a
``lax.while_loop`` whose branches are ``lax.switch`` and ``lax.cond``. On
the card so does the port (``RoundGraphs.loop``): each branch (a compact
tier, the scan round, its stats) and the loop's prologue (a slide's, or a
seed's first count) is captured once with torch, and the loop is one CUDA
graph built around them (``pprx_torch/csrc/loop.cu``): ``[prologue] ->
prime -> WHILE { turn -> SWITCH { tier_0 | .. | tier_k-1 | scan ->
after_scan -> IF { stats } } }`` (the dense engine's: ``WHILE { turn ->
SWITCH { round } }``; the proportional loop's: ``WHILE { turn -> SWITCH {
tier_0 | .. | tier_k-1 | drain | rescan } }``; the hybrid engine's:
``WHILE { turn -> SWITCH { tier_0 | .. | tier_k-1 | scan_0 | .. |
scan_ks-1 | dense | count } }``, its loop without a worklist the same with
no tier), where the three steps are K4's one-warp kernels on
the loop's carry (``pprx_torch.engine.loop``), which set the conditions: a
turn tallies the round before and picks the next one's branch, or none. A
loop is one graph launch and one read of the carry (its statistics) by the
host. On the CPU the same branches run eagerly
under a host loop of K4's plain steps, with a read of the counts a round.

A graph reads and writes fixed addresses, so:

- the state's ``p`` and ``r`` and every tensor of the kill graph (its window
  too), or the sharded engine's blocks, snapshot and ring, or the dense
  engine's window and its delivery-sorted view, or the hybrid engine's
  window, snapshot, overlay and view, are the driver's buffers
  for its whole life: the slide step, the rebuild and a
  restore copy into them (``copy_into_``), and ``bind`` and ``hold``
  refuse a state, graph or slide's pack whose tensors are not the ones
  captured;
- what one round hands the next, or the host, lives here, outside the
  graphs' memory pool: the candidate list ``cand`` (int32, ``width``
  entries: ``n + 1`` or the widest tier; a tier reads its first ``w_i``
  entries, a round writes its list and ``n`` past it), the counters
  ``counts`` (int64 ``[5]``: cn, fed, fre, n_active, edge_work; the
  sharded loop's ``[6]`` add ``ewr``), ``c0n``,
  the seed list's length, the loop's ``carry``, and what an engine keeps
  between its rounds besides (``buffer``: the hybrid engine's frontier
  rows). The host reads the
  carry (or, in the host loop, ``counts``) through a pinned buffer and an
  event.

Every branch of a loop is captured before its loop graph is built, and an
unused branch must not run on the live state: each is warmed up by a
throwaway capture in relaxed mode, which runs nothing but loads every
kernel it records, then captured for keeps (``keep_graph=True``) into the
cache's one memory pool; the branches run one after another, and nothing
crosses between them through the pool. A loop graph holds clones of its
branches' topology, not their memory, so the cache keeps every captured
graph as long as itself. A step that the host schedules apart (the kill
graph's rebuild) is ``run``: run eagerly once on a side stream, captured,
then replayed. A failed capture, build or launch raises; nothing falls
back to eager launches or to the host loop on CUDA. A kernel's wrapper
counts a launch when it runs, so a capture's counts are taken back out of
every kernel module's ``LAUNCHES`` (``KERNEL_COUNTS``) and added again for
each replay, and for each of a loop's branch executions, which the carry
counts.

On CPU tensors ``run`` calls the step's function: the same functions on
the same buffers, eagerly. That is the plain path the tests take, chosen by the
device the caller passed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Hashable

import torch

from pprx_torch import _ext
from pprx_torch.engine import loop, rowpass, segsum

N_COUNTS = 5  # cn, fed, fre, n_active, edge_work (the sharded loop adds ewr)

# every kernel module's launch counts, which a replay adds to
KERNEL_COUNTS = (segsum.LAUNCHES, segsum.SITE_LAUNCHES, rowpass.LAUNCHES, loop.LAUNCHES)

# Where every loop's round log goes while it is a list (``None``: nowhere,
# and a loop on the card reads its carry's head alone): one dict a loop,
# with its ``table``, ``max_rounds``, ``rounds`` and logged ``rows`` (the
# first ``loop.LOG_CAP`` rounds; ``loop.replay_log`` replays them).
LOG_SINK: list | None = None

Step = tuple[Hashable, Callable[[], None]]  # a graph's key and its function


def tensor_ptrs(obj) -> tuple[int, ...]:
    """``data_ptr()`` of every tensor of ``obj``: a tensor, or a dataclass,
    dict, tuple or list of them (nested too), in field, key or item order;
    anything else holds none."""
    if isinstance(obj, torch.Tensor):
        return (obj.data_ptr(),)
    if dataclasses.is_dataclass(obj):
        items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (tuple, list)):
        items = obj
    else:
        return ()
    return tuple(ptr for v in items for ptr in tensor_ptrs(v))


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
    """One driver's round buffers, and on CUDA its captured graphs.

    ``captures`` and ``capture_s`` count captures since construction (each
    branch and prologue of a loop once, and each ``run`` step), ``replays``
    the ``run`` steps' replays and ``eager`` their warm-ups (runs on
    CUDA), ``loop_launches`` the loop graphs' launches,
    ``branch_execs`` the branches those ran and ``reads`` the host's reads
    of a loop's counts or carry (one a loop on CUDA).
    """

    def __init__(self, n: int, width: int, device: torch.device | str,
                 n_counts: int = N_COUNTS):
        self.device = torch.device(device)
        self.n = n
        self.cand = torch.full((max(width, n + 1),), n, dtype=torch.int32, device=self.device)
        self.counts = torch.zeros(n_counts, dtype=torch.int64, device=self.device)
        self.c0n = torch.zeros((), dtype=torch.int64, device=self.device)
        self.graphs: dict[Hashable, tuple[torch.cuda.CUDAGraph, list[dict]]] = {}
        self.kept: dict[Hashable, tuple[torch.cuda.CUDAGraph, list[dict]]] = {}
        self.loops: dict[Hashable, tuple[loop.LoopGraph, list]] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.eager = 0
        self.loop_launches = 0
        self.branch_execs = 0
        self.reads = 0
        # measurement: a slide's prologue replayed apart, before its loop
        self.split_prologue = False
        self._held: dict[str, tuple[int, ...]] = {}
        self._buffers: dict[str, torch.Tensor] = {}
        self._inputs: tuple[int, int] | None = None
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.side = torch.cuda.Stream(self.device)
            self.host = torch.empty(n_counts, dtype=torch.int64, pin_memory=True)
            # the loop's carry on the card (the host loop keeps its own)
            self.carry = loop.new_carry(self.device)
            self.carry_host = torch.empty(loop.SIZE, dtype=torch.int64, pin_memory=True)
            self.inputs_host = torch.empty(2, dtype=torch.int64, pin_memory=True)
            self.ready = torch.cuda.Event()

    def bind(self, state, kg, pack: torch.Tensor | None = None) -> None:
        """Tie the cache to the tensors of ``state`` and ``kg`` at its first
        call, and to a slide's ``pack`` at the first call that passes one;
        later calls must hand over the same tensors."""
        self.hold("the state or the kill graph", state, kg)
        if pack is not None:
            self.hold("a slide's pack", pack)

    def hold(self, what: str, *objs) -> None:
        """Tie the cache to the tensors of ``objs`` (``tensor_ptrs``) under
        the name ``what`` at its first call; later calls under that name
        must hand over the same tensors: a captured graph reads them where
        they lie."""
        ptrs = tensor_ptrs(objs)
        if self._held.setdefault(what, ptrs) != ptrs:
            raise RuntimeError(
                f"{what} was rebound after its rounds were captured: copy into the "
                "tensors bound first (copy_into_), or upload into the same tensor, instead")

    def buffer(self, name: str, size: int, dtype: torch.dtype) -> torch.Tensor:
        """A 1-D tensor of ``size`` kept under ``name`` for the cache's life,
        allocated at its first use (outside any capture: call it before the
        loop), zero-filled."""
        buf = self._buffers.get(name)
        if buf is None:
            buf = self._buffers[name] = torch.zeros(size, dtype=dtype, device=self.device)
        if buf.shape != (size,) or buf.dtype != dtype:
            raise ValueError(f"buffer {name!r} is {buf.dtype} {tuple(buf.shape)}, "
                             f"not {dtype} ({size},)")
        return buf

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
        """``counts`` on the host: the host loop's read a round."""
        if self.device.type != "cuda":
            return self.counts.tolist()
        self.host.copy_(self.counts, non_blocking=True)
        self.ready.record(torch.cuda.current_stream(self.device))
        self.ready.synchronize()
        return self.host.tolist()

    def capture(self, key: Hashable, fn: Callable[[], None]):
        """``fn`` captured for a loop graph, at the key's first use: warmed
        up by a throwaway capture in relaxed mode (it runs nothing, so a
        branch the loop may never take leaves the state alone), then
        captured for keeps. Returns (graph, launches by kernel module)."""
        hit = self.kept.get(key)
        if hit is not None:
            return hit
        t0 = time.perf_counter()
        before = [dict(counts) for counts in KERNEL_COUNTS]
        try:
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=self.side,
                                  capture_error_mode="relaxed"):
                fn()
            for counts, was in zip(KERNEL_COUNTS, before):
                counts.update(was)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=self.pool):
                fn()
            launched = [{k: counts[k] - was[k] for k in was}
                        for counts, was in zip(KERNEL_COUNTS, before)]
        finally:
            for counts, was in zip(KERNEL_COUNTS, before):
                counts.update(was)
        self.kept[key] = (graph, launched)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return self.kept[key]

    def loop(self, prologue: Step | None, branches: list[Step], table: loop.Table,
             c0ok: bool, max_rounds: int) -> tuple[list[int], int]:
        """One convergence loop: ``prologue``, then rounds of ``branches``
        (the tiers', the scan's and its stats', as ``table`` numbers them;
        under the dense rule the round's alone; under the proportional rule
        the tiers', the drain's and the rescan's; under the hybrid rule the
        tiers', the scan tiers', the dense scan's and the count's)
        as K4's steps pick them, from the counts the prologue (or the
        caller) left in ``counts``. On CUDA one launch of the loop's graph
        (built at its first use) and one read of the carry; on the CPU
        ``host_loop``. Returns (the carry's values: its head, and the round
        log where ``LOG_SINK`` takes it; the host's reads)."""
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                values, reads = self._device_loop(prologue, branches, table, c0ok, max_rounds)
        else:
            values, reads = self.host_loop(prologue, branches, table, c0ok, max_rounds)
        self.reads += reads
        if LOG_SINK is not None:
            LOG_SINK.append({"table": table, "max_rounds": int(max_rounds),
                             "rounds": values[loop.ROUNDS], "rows": loop.log_rows(values)})
        return values, reads

    def host_loop(self, prologue: Step | None, branches: list[Step], table: loop.Table,
                  c0ok: bool, max_rounds: int) -> tuple[list[int], int]:
        """The loop on the host, as ``loop``: the loop graph's sequence,
        each branch by ``run`` and K4's plain steps on a carry on the CPU,
        with a read of ``counts`` after the prologue and after each round
        and each stats run."""
        carry = loop.new_carry("cpu")
        if prologue is not None:
            self.run(*prologue)
        loop.set_inputs(carry, c0ok, max_rounds)
        counts = self.read()
        reads = 1
        if loop.prime(carry, counts, table):
            # the WHILE's body: a turn, then the SWITCH over its branch
            while (b := loop.turn(carry, counts, table)) != table.stop:
                self.run(*branches[b])
                counts = self.read()
                reads += 1
                if b == table.scan and table.has_stats and loop.after_scan(
                        carry, counts, table):
                    self.run(*branches[-1])
                    counts = self.read()
                    reads += 1
        n = loop.HEAD if LOG_SINK is None else loop.SIZE
        return carry[:n].tolist(), reads

    def _device_loop(self, prologue, branches, table, c0ok, max_rounds):
        key = (None if prologue is None else prologue[0], tuple(k for k, _ in branches), table)
        hit = self.loops.get(key)
        if hit is None:
            for name in ("segsum", "rowpass", "loop"):
                _ext.load(name)
            parts = [self.capture(*step) for step in [prologue] * (prologue is not None)
                     + branches]
            raw = [graph.raw_cuda_graph() for graph, _ in parts]
            head = raw.pop(0) if prologue is not None else None
            graph = loop.LoopGraph(head, raw, self.carry, self.counts, table)
            hit = self.loops[key] = (graph, parts)
        graph, parts = hit
        stream = torch.cuda.current_stream(self.device)
        inputs = (int(max_rounds), int(bool(c0ok)))
        if inputs != self._inputs:
            # the host's buffer is not written again before a read has
            # waited on this copy
            self.inputs_host.copy_(torch.tensor(inputs))
            self.carry[loop.MAX_ROUNDS:loop.C0OK + 1].copy_(self.inputs_host, non_blocking=True)
            self._inputs = inputs
        graph.launch(stream.cuda_stream)
        self.loop_launches += 1
        n = loop.HEAD if LOG_SINK is None else loop.SIZE
        self.carry_host[:n].copy_(self.carry[:n], non_blocking=True)
        self.ready.record(stream)
        self.ready.synchronize()
        values = self.carry_host[:n].tolist()
        # what the loop launched: its prologue once, each branch as often
        # as it ran, and K4's steps: a turn a round (and a count, which is
        # not a round) and one to end the loop (none where prime stopped
        # it), after_scan in the scan's arm where the rule has stats
        execs = values[loop.EXECS:loop.EXECS + len(branches)]
        for (_, launched), times in zip(parts, [1] * (prologue is not None) + execs):
            for counts, added in zip(KERNEL_COUNTS, launched):
                for k, c in added.items():
                    counts[k] += c * times
        turns = values[loop.ROUNDS] + (execs[table.count_arm] if table.hybrid else 0)
        loop.LAUNCHES["prime"] += 1
        loop.LAUNCHES["turn"] += turns + 1 if turns else 0
        loop.LAUNCHES["after_scan"] += execs[table.scan] if table.has_stats else 0
        self.branch_execs += sum(execs)
        return values, 1

    def summary(self) -> dict:
        return {"graphs": len(self.graphs) + len(self.kept), "loops": len(self.loops),
                "captures": self.captures, "capture_s": self.capture_s,
                "replays": self.replays, "eager_rounds": self.eager,
                "loop_launches": self.loop_launches, "branch_execs": self.branch_execs,
                "reads": self.reads,
                "graph_launches": self.replays + self.loop_launches}
