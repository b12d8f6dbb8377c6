"""Dense push engine (port of ``pprx.engine.push``): one round over the whole
COO window, and the push-to-convergence loop.

A round processes every active (vertex, query) pair as gather + scatter-add
over the COO ring. Signed residuals (deletions) are handled by |r|
thresholds throughout; the push rules and the closed-form handling of
dangling vertices are the reference's (``pprx/ref/push.py``).

How the port differs:

- The reference's ``[W, S]`` gathers (``scale[graph.src]``,
  ``outmass[graph.dst]``) were fused away by XLA. Here the ring is processed
  in edge blocks (``index_add_`` per block), so the largest temporary is one
  block of gathered rows. The ring is rewritten every slide, so it is not
  sorted per round.
- The loop runs on the host with one packed readback per round, counted in
  ``PushStats.syncs``, as the wl2 port's does.
- ``index_add_`` runs on atomics on CUDA: f32 sums there may differ from run
  to run in the last bits.
"""

from __future__ import annotations

import torch

from pprx_torch.config import PprConfig
from pprx_torch.engine.rowpass import active_mask
from pprx_torch.engine.state import FORWARD, PprState, PushStats
from pprx_torch.engine.update import edge_blocks
from pprx_torch.graph.dynamic import WindowGraph


def _active_mask(state: PprState, graph: WindowGraph, cfg: PprConfig) -> torch.Tensor:
    """[N+1, S] bool — which (vertex, query) pairs exceed the push threshold.

    Forward: |r[v]| > eps * max(d_out(v), 1); reverse: |r[v]| > eps.
    The phantom row N never activates because its residual is always zero.
    """
    return active_mask(state.r, graph.deg, cfg.eps, state.mode == FORWARD)


def push_round(
    state: PprState, graph: WindowGraph, cfg: PprConfig
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """One dense push round over every active (vertex, query) pair.

    Returns (new_state, n_active_pairs, n_edge_pushes), the counts as int64
    device scalars.
    """
    return push_round_given_act(state, _active_mask(state, graph, cfg), graph, cfg)


def push_round_given_act(
    state: PprState, act: torch.Tensor, graph: WindowGraph, cfg: PprConfig
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """Dense round with the activity mask supplied by the caller."""
    dtype = state.r.dtype
    alpha = cfg.alpha
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


def push_to_convergence(
    state: PprState, graph: WindowGraph, cfg: PprConfig
) -> tuple[PprState, PushStats]:
    """Iterate push rounds until no (vertex, query) pair is active or
    ``cfg.max_rounds`` is hit. One host sync per round (the round's counts),
    plus one for the first activity count."""
    stats = PushStats()
    na = int(_active_mask(state, graph, cfg).sum())
    stats.syncs += 1
    while na > 0 and stats.rounds < cfg.max_rounds:
        state, na_t, ew_t = push_round(state, graph, cfg)
        na, ew = torch.stack([na_t, ew_t]).tolist()
        stats.syncs += 1
        stats.rounds += 1
        stats.pushes += na
        stats.edge_pushes += ew
    return state, stats
