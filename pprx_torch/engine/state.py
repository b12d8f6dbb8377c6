"""PPR reserve/residual state (port of ``pprx.engine.state``).

Layout is vertex-major, source-minor: ``[N+1, S]`` with S the batched query
axis, so every per-edge mass transfer moves one contiguous S-vector. Row N
is the phantom vertex: padding edges point at it, and it stays zero.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from pprx_torch.device import resolve_device

FORWARD = 0
REVERSE = 1


@dataclasses.dataclass
class PprState:
    """Reserve/residual pair for S batched queries over N vertices.

    p, r: ``[N+1, S]``; row N is the phantom row (always zero).
    mode: FORWARD (queries are sources) or REVERSE (queries are targets).
    """

    p: torch.Tensor
    r: torch.Tensor
    mode: int = FORWARD

    @property
    def n(self) -> int:
        return self.p.shape[0] - 1

    @property
    def n_queries(self) -> int:
        return self.p.shape[1]


def settled_distance(a: PprState, b: PprState, alpha: float) -> float:
    """``max |(p_a + alpha r_a) - (p_b + alpha r_b)|`` of two forward states
    (``b`` is brought to ``a``'s device and dtype).

    Two runs of the same pushes on different devices, or twice on a card,
    differ in the last bits of their sums, and a residual that lies at its
    push threshold is then pushed in one run and not in the other. That
    push moves ``alpha * r``, up to ``alpha * eps * deg`` (1e-5 from 67
    edges on at eps = 1e-6, alpha = 0.15), from ``r`` to ``p``: ``max |dp|``
    reads it as a difference although both states are as close to exact
    PPR. ``p + alpha * r`` is what a vertex holds whether or not it has
    pushed: a push leaves it as it was at the pushed vertex and adds
    ``alpha (1 - alpha) r / deg <= alpha (1 - alpha) eps`` at each receiver
    (``(1 - alpha) r`` at a vertex without out-edges, whose whole residual
    settles). So it compares what two runs hold, not which pushes they
    made."""
    bp, br = (t.to(device=a.p.device, dtype=a.p.dtype) for t in (b.p, b.r))
    return float(((a.p - bp) + alpha * (a.r - br)).abs().max())


@dataclasses.dataclass
class PushStats:
    """Host-side counters of one convergence loop.

    The fields of ``pprx.engine.state.PushStats``: rounds; pushes (active
    (vertex, query) pairs processed); edge_pushes (edge traversals weighted
    by active queries); wl_rounds (rounds served by the compact worklist
    path); scans_cand/scans_fed/scans_liv (why rounds fell back to a scan:
    candidate-list overflow, snapshot-edge bound, fresh-edge bound).

    The port adds ``syncs``: the number of device-to-host reads the loop
    waited on (on CUDA the wl2 loop runs on the card and reads once, its
    statistics at its end; the CPU's host loop reads the counts after its
    first step and after each round; the other engines' host loops a read a
    round or more); and ``stats_reads``: the scan rounds of the wl2 loop
    that ran their next-frontier stats (the light scans that another round
    follows), counted alike on the card and the CPU (the host loop reads
    the counts a second time after each); and ``arms``: the hybrid loops'
    executions by kind of arm (``wl`` the worklist tiers, ``sparse`` and
    ``dense`` the scans, ``count`` the frontier's counts, which are not
    rounds; ``sparse_by_tier`` the sparse scans by scan tier), from the
    loop's carry.
    """

    rounds: int = 0
    pushes: int = 0
    edge_pushes: int = 0
    wl_rounds: int = 0
    scans_cand: int = 0
    scans_fed: int = 0
    scans_liv: int = 0
    syncs: int = 0
    stats_reads: int = 0
    arms: dict = dataclasses.field(default_factory=dict)

    @property
    def scan_rounds(self) -> int:
        return self.rounds - self.wl_rounds


def init_state(
    n: int,
    queries: Sequence[int],
    mode: int = FORWARD,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> PprState:
    """r = one-hot at each query, p = 0. ``queries`` indexes the S axis.
    ``device=None`` is the card."""
    device = resolve_device(device)
    q = torch.as_tensor(list(queries), dtype=torch.int64, device=device)
    s = q.shape[0]
    p = torch.zeros((n + 1, s), dtype=dtype, device=device)
    r = torch.zeros((n + 1, s), dtype=dtype, device=device)
    r[q, torch.arange(s, device=device)] = 1.0
    return PprState(p=p, r=r, mode=mode)
