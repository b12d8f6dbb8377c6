"""Dense push engine (port of ``pprx.engine.push``): one round over the whole
COO window, and the push-to-convergence loop.

A round processes every active (vertex, query) pair: the residual's mass
is taken onto the reserve and what leaves along the edges is delivered.
Signed residuals (deletions) are handled by |r| thresholds throughout; the
push rules and the closed-form handling of dangling vertices are the
reference's (``pprx/ref/push.py``).

How the port differs:

- ``push_to_convergence`` runs its rounds as ``dense_round_``, in place:
  the round's elementwise work is one pass over the state (K2,
  ``rowpass.scan_pass_``) and its delivery one segment sum over the
  window's delivery-sorted view (K1, ``segsum_gather_add_``), which sums a
  row's edges in their order, deterministically, where the reference
  scatters over the ring (``pprx/engine/push.py:73, 83``; XLA's scatter is
  deterministic on the TPU). No ``[N+1, S]`` temporary is built beyond the
  delivered rows (``moving``). A reverse round scales a row's sum by its
  1/d_out once, where the reference scales every edge: the f32 bits move,
  not the f64 parity.
- The loop is the reference's ``lax.while_loop`` (``pprx/engine/push.py:
  94-119``) under K4's dense rule (``pprx_torch.engine.loop``): on CUDA one
  launch of a conditional CUDA graph, ``first count -> prime -> WHILE {
  turn -> SWITCH { dense round } }`` (``RoundGraphs.loop``), and one read of
  its carry (``PushStats.syncs`` 1); on the CPU a host loop of K4's plain
  steps over the same functions, with a read of the counts a round.
- The flight recorder (``pprx_torch.trace``) stamps a dense round before
  K2 (``k2``), before each K1 launch (``k1``; the wl2 scan round's
  ``k1.window`` and ``k1.fresh``) and after the last (``k1.end``).
- ``push_round`` is the reference's round on the ring as it lies (gather,
  then ``index_add_`` in edge blocks, on atomics on CUDA), a plain witness
  that the tests hold to the reference; no engine calls it (the hybrid
  engine's dense fallback is ``dense_round_`` too).
"""

from __future__ import annotations

import torch

from pprx_torch import trace
from pprx_torch.config import PprConfig
from pprx_torch.engine import loop
from pprx_torch.engine.graphs import RoundGraphs
from pprx_torch.engine.rowpass import active_mask, frontier_rows, scan_pass_
from pprx_torch.engine.segsum import segsum_gather_add_
from pprx_torch.engine.state import FORWARD, PprState, PushStats
from pprx_torch.engine.update import edge_blocks
from pprx_torch.graph.dynamic import DeliveryView, WindowGraph, delivery_view


def _active_mask(state: PprState, graph: WindowGraph, cfg: PprConfig) -> torch.Tensor:
    """[N+1, S] bool — which (vertex, query) pairs exceed the push threshold.

    Forward: |r[v]| > eps * max(d_out(v), 1); reverse: |r[v]| > eps.
    The phantom row N never activates because its residual is always zero.
    """
    return active_mask(state.r, graph.deg, cfg.eps, state.mode == FORWARD)


def push_round(
    state: PprState, graph: WindowGraph, cfg: PprConfig
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """One dense push round over every active (vertex, query) pair, on the
    ring as it lies, in edge blocks (``index_add_`` a block; the loop's
    round is ``dense_round_``). Returns (new_state, n_active_pairs,
    n_edge_pushes), the counts as int64 device scalars.
    """
    dtype = state.r.dtype
    alpha = cfg.alpha
    act = _active_mask(state, graph, cfg)
    mass = torch.where(act, state.r, 0.0)  # [N+1, S]
    deg = graph.deg
    dangling = (deg == 0)[:, None]
    inv_deg = 1.0 / deg.clamp(min=1).to(dtype)

    # reserve absorbs alpha*mass (all of it at dangling vertices: closed form)
    p_new = state.p + torch.where(dangling, mass, alpha * mass)
    r_new = state.r - mass
    row_bytes = mass.shape[1] * mass.element_size()

    if state.mode == FORWARD:
        # edge (u,w): r[w] += (1-alpha) * mass[u] / d_out(u); dangling rows
        # have no edges
        scale = (1.0 - alpha) * mass * inv_deg[:, None]
        for lo, hi in edge_blocks(graph.capacity, row_bytes):
            r_new.index_add_(0, graph.dst[lo:hi], scale[graph.src[lo:hi]])
        edge_pushes = (act * deg[:, None]).sum()
    else:
        # reverse: edge (u,w): r[u] += outmass[w] / d_out(u); outmass leaves
        # w scaled (1-alpha), a dangling w by the closed-form factor beta
        beta = (1.0 - alpha) / alpha
        outmass = torch.where(dangling, beta * mass, (1.0 - alpha) * mass)
        for lo, hi in edge_blocks(graph.capacity, row_bytes):
            src = graph.src[lo:hi]
            r_new.index_add_(0, src, outmass[graph.dst[lo:hi]] * inv_deg[src, None])
        # edge pushes in reverse = in-degree work: the per-row count of
        # active queries gathered at each edge's dst, not the [W, S] mask
        edge_pushes = act.sum(dim=1)[graph.dst].sum()

    # keep the phantom row identically zero
    p_new[-1] = 0.0
    r_new[-1] = 0.0
    return PprState(p=p_new, r=r_new, mode=state.mode), act.sum(), edge_pushes


def dense_round_(
    state: PprState, deg: torch.Tensor, views: list[tuple[torch.Tensor, torch.Tensor]],
    cfg: PprConfig, counts: torch.Tensor, moving_dtype: torch.dtype | None = None,
    k1_stamps: tuple[str, ...] = ("k1",),
) -> None:
    """One dense round in place on ``state.p`` and ``state.r``: K2 takes
    every active pair's mass off ``r`` onto ``p`` and writes the rows that
    leave (``moving``, in ``moving_dtype``, by default the state's), then K1
    delivers them over each of ``views``, ``(gat, off)`` pairs of a
    delivery-sorted view with ``off`` over rows ``[0, N]`` (the dense
    engine's window, ``delivery_view(graph, state.mode)``; the wl2 scan
    round's window and fresh views): forward ``r[w] += sum of moving[u]``
    over the edges ``(u, w)``, reverse ``r[u] += (sum of moving[w]) /
    max(d_out(u), 1)``, the scale exact in the state's dtype.

    counts: int64 [2], overwritten with the round's active pairs and edge
    pushes (forward each active pair's out-degree, reverse each edge's
    active pairs at its ``dst``: ``pprx/engine/push.py:76, 84-85``).
    ``k1_stamps``: the stamp before each view's K1 launch, one a view.
    """
    n = deg.shape[0] - 1
    forward = state.mode == FORWARD
    r = state.r
    counts.zero_()
    moving = torch.empty_like(r, dtype=moving_dtype or r.dtype)
    row_act = None if forward else torch.empty(n + 1, dtype=torch.int32, device=r.device)
    trace.stamp("k2", r.device)
    scan_pass_(state.p, r, deg, moving, counts, row_act, eps=cfg.eps, alpha=cfg.alpha,
               forward=forward)
    scale = None
    if not forward:
        scale = 1.0 / deg[:n].clamp(min=1).to(r.dtype)
        # a view's gat is each edge's dst; phantom, killed and unfilled
        # slots name row N, whose count is 0
        counts[1:].copy_(torch.stack([row_act[gat].sum() for gat, _ in views]).sum())
    # rows [0, N) only: the phantom row's edges are never read
    for (gat, off), name in zip(views, k1_stamps, strict=True):
        trace.stamp(name, r.device)
        segsum_gather_add_(r[:n], moving, gat, off, row_scale=scale)
    trace.stamp("k1.end", r.device)
    # keep the phantom row identically zero
    state.p[-1] = 0.0
    r[-1] = 0.0


def first_count(state: PprState, deg: torch.Tensor, cfg: PprConfig,
                counts: torch.Tensor) -> None:
    """What ``prime`` reads in ``counts[3]``: the rows that hold an active
    pair (K3, ``frontier_rows``, one read of ``r``), which is 0 exactly
    where the reference's first count of active pairs (``n0``) is."""
    _, rows, _, _ = frontier_rows(state.r, deg, deg, deg, eps=cfg.eps,
                                  forward=state.mode == FORWARD)
    counts[3:4].copy_(rows)


def push_to_convergence(
    state: PprState, graph: WindowGraph, cfg: PprConfig,
    graphs: RoundGraphs | None = None, view: DeliveryView | None = None,
) -> tuple[PprState, PushStats]:
    """Push rounds (``dense_round_``) until one finds no active (vertex,
    query) pair or ``cfg.max_rounds`` is hit, as the reference's loop; from
    a converged state none. Updates ``state.p`` and ``state.r`` in place and
    returns the state.

    ``graphs``: the caller's round buffers and, on CUDA, its captured loop,
    bound to ``state``, ``graph`` and ``view`` (a driver keeps one for its
    life and rebuilds the view into the same tensors); ``None`` makes a new
    one, which on CUDA captures the loop's first count and round. ``view``:
    the window's delivery-sorted view in the state's mode; ``None`` builds
    it. On CUDA the state is f32 (K1's and K2's type), and the loop is one
    graph launch and one read (``PushStats.syncs``); on the CPU a host
    loop with a read a round and one before the first.
    """
    view = delivery_view(graph, state.mode) if view is None else view
    g = RoundGraphs(graph.n, 1, state.r.device) if graphs is None else graphs
    g.hold("the dense state, window and view", state, graph, view)
    key = ("dense", state.mode, cfg.eps, cfg.alpha)
    first = ((*key, "first"), lambda: first_count(state, graph.deg, cfg, g.counts))
    rnd = ((*key, "round"),
           lambda: dense_round_(state, graph.deg, [(view.gat, view.off)], cfg, g.counts[3:5]))
    values, reads = g.loop(first, [rnd], loop.DENSE_TABLE, True, cfg.max_rounds)
    return state, PushStats(rounds=values[loop.ROUNDS], pushes=values[loop.PUSHES],
                            edge_pushes=values[loop.EDGE_PUSHES], syncs=reads)
