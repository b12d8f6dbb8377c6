"""Frontier-sparse push rounds over a CSR snapshot and a signed overlay, with
the dense fallback and the worklist loop (port of ``pprx.engine.sparse``).

What the engine does is the reference's:

1. A scan round takes the activity mask over all rows, compacts the active
   rows, expands their snapshot rows edge-balanced
   (``pprx_torch.engine.frontier``), sweeps the signed overlay, and
   scatters the contributions into ``r``. It runs at the smallest capacity
   tier that holds the exact frontier, or as a dense round over the whole
   COO window when none does or when the frontier's edges and the
   overlay's capacity together reach half the window.
2. A worklist round touches only a candidate list (a superset of the
   active rows, kept across rounds: each round's scatter targets), with no
   pass over all rows of ``r``, and emits upper bounds of the next
   round's needs so that the loop can pick the next tier from 1-D work.
3. ``push_to_convergence_worklist`` runs a worklist round at the smallest
   tier that fits the bounds while the list is valid, and a scan round
   that reseeds the list from a fresh activity scan otherwise.

How the port differs:

- The loops run on the host. Each round reads back one packed set of
  counts (the next list's count and bounds, the round's pushes and edge
  pushes), and the next branch and tier are chosen from it; every read is
  counted in ``PushStats.syncs``.
- A scan round needs the exact frontier's row count and snapshot edges
  before it runs, to pick its tier. A scan round's reseed computes those
  counts and the activity mask on the state the next round starts from,
  so they are carried: a scan round that follows a scan round (or the
  prime of a loop that starts with a scan) costs no extra read. A scan
  round that follows a worklist round, whose bounds are not exact, reads
  them first: one extra sync for each such round.
- ``jnp.nonzero(size=, fill_value=)`` is ``compact`` (no sync); the dense
  fallback is the port's ``push_round_given_act`` (COO in edge blocks).
- A worklist round updates ``state.p`` and ``state.r`` in place, after
  every read of the pre-round ``r``; the loops therefore consume the state
  they are given. ``sparse_round`` returns new tensors.
- Counts are int64 (the reference sums float32 counters); ``edge_work``
  weighs each row's active queries by its snapshot row length, as the
  reference does, from the per-row counts rather than an ``[N+1, S]``
  product.
"""

from __future__ import annotations

import dataclasses

import torch

from pprx_torch.config import PprConfig
from pprx_torch.engine.frontier import CsrSnapshot, Overlay, build_snapshot, compact_frontier, expand
from pprx_torch.engine.push import _active_mask, push_round_given_act
from pprx_torch.engine.state import FORWARD, PprState, PushStats
from pprx_torch.engine.wl2 import _fit, compact
from pprx_torch.graph.dynamic import WindowGraph


@dataclasses.dataclass
class HybridGraph:
    """COO window + CSR snapshot + signed overlay."""

    window: WindowGraph
    snap: CsrSnapshot
    ov: Overlay

    @property
    def n(self) -> int:
        return self.window.n

    @classmethod
    def build(cls, window: WindowGraph, mode: int, overlay_cap: int) -> "HybridGraph":
        return cls(window=window, snap=_snapshot(window, mode),
                   ov=Overlay.empty(overlay_cap, window.n, window.src.device))


def _snapshot(window: WindowGraph, mode: int) -> CsrSnapshot:
    key, other = (window.src, window.dst) if mode == FORWARD else (window.dst, window.src)
    return build_snapshot(key, other, window.n)


def rebuild_snapshot(graph: HybridGraph, mode: int) -> HybridGraph:
    """Re-sort the live window into a fresh snapshot; clear the overlay."""
    return dataclasses.replace(graph, snap=_snapshot(graph.window, mode),
                               ov=Overlay.empty(graph.ov.src.shape[0], graph.n,
                                                graph.window.src.device))


def sparse_round(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """One frontier-sparse push round; the caller guarantees that the
    frontier fits ``fcap`` rows and ``ecap`` snapshot edges
    (``adaptive_round`` checks)."""
    return sparse_round_given_act(state, _active_mask(state, graph.window, cfg), graph, cfg,
                                  fcap, ecap)


def sparse_round_given_act(
    state: PprState, act: torch.Tensor, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """Sparse round with the activity mask supplied. Returns (new_state,
    n_active, edge_work), the counts as int64 device scalars."""
    dtype = state.r.dtype
    alpha = cfg.alpha
    beta = (1.0 - alpha) / alpha
    forward = state.mode == FORWARD
    deg = graph.window.deg
    n_act = act.sum(dim=1)
    fidx = compact_frontier(n_act > 0, fcap, graph.n)
    dangling = deg == 0
    inv_deg = 1.0 / deg.clamp(min=1).to(dtype)

    # frontier-restricted reserve absorption and residual removal
    mass_f = torch.where(act[fidx], state.r[fidx], 0.0)
    dang_f = dangling[fidx][:, None]
    p = state.p.index_add(0, fidx, torch.where(dang_f, mass_f, alpha * mass_f))
    r = state.r.index_add(0, fidx, mass_f, alpha=-1)
    if forward:
        moving_f = (1.0 - alpha) * mass_f * inv_deg[fidx][:, None]
    else:
        moving_f = torch.where(dang_f, beta * mass_f, (1.0 - alpha) * mass_f)

    # snapshot expansion
    t, nbr, valid, _ = expand(fidx, graph.snap, ecap)
    delta = torch.zeros_like(r).index_add_(0, nbr, moving_f[t] * valid.to(dtype)[:, None])

    # signed overlay sweep, gathered at the mode's gather endpoint
    ov = graph.ov
    gat, sca = (ov.src, ov.dst) if forward else (ov.dst, ov.src)
    mass_ov = torch.where(act[gat], state.r[gat], 0.0)
    if forward:
        mov_ov = (1.0 - alpha) * mass_ov * inv_deg[gat][:, None]
    else:
        mov_ov = torch.where(dangling[gat][:, None], beta * mass_ov, (1.0 - alpha) * mass_ov)
    delta.index_add_(0, sca, mov_ov * ov.sign.to(dtype)[:, None])

    r = r + delta if forward else r + delta * inv_deg[:, None]
    p[-1] = 0.0
    r[-1] = 0.0
    edge_work = (n_act * graph.snap.row_len).sum()
    return PprState(p=p, r=r, mode=state.mode), n_act.sum(), edge_work


def _front_counts(act: torch.Tensor, graph: HybridGraph) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows of the any-query frontier, their snapshot edges), int64
    device scalars."""
    n = graph.n
    any_ = act[:n].any(dim=1)
    return any_.sum(), torch.where(any_, graph.snap.row_len[:n], 0).sum()


def frontier_edge_count(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(active pairs, snapshot edges in the any-query frontier's rows)."""
    act = _active_mask(state, graph.window, cfg)
    return act.sum(), _front_counts(act, graph)[1]


def _tiered_round(
    state: PprState, act: torch.Tensor, graph: HybridGraph, cfg: PprConfig,
    tiers: tuple[tuple[int, int], ...], n_front: int, fedges: int,
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """The scan round at the smallest tier that fits the exact frontier
    (``n_front`` rows, ``fedges`` snapshot edges, read on the host), or the
    dense round when none fits or the sparse round is not worth it."""
    # worth it: frontier edge work plus the overlay's capacity (not its live
    # count, as in the reference) at most half the dense edge work
    worth = (fedges + graph.ov.src.shape[0]) * 2 <= graph.window.capacity
    i = sum(not (n_front <= f_i and fedges <= e_i) for f_i, e_i in tiers)
    if worth and i < len(tiers):
        return sparse_round_given_act(state, act, graph, cfg, *tiers[i])
    return push_round_given_act(state, act, graph.window, cfg)


def adaptive_round_tiered(
    state: PprState, graph: HybridGraph, cfg: PprConfig, tiers: tuple[tuple[int, int], ...],
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """Full-scan round at the smallest capacity tier that fits the exact
    frontier, dense otherwise. ``tiers``: ((fcap_i, ecap_i), ...) smallest
    first. Reads the frontier's counts back once."""
    act = _active_mask(state, graph.window, cfg)
    n_front, fedges = torch.stack(_front_counts(act, graph)).tolist()
    return _tiered_round(state, act, graph, cfg, tuple(tiers), n_front, fedges)


def adaptive_round(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """Single-tier adaptive round (sparse when the frontier fits and is
    worth it, dense otherwise)."""
    return adaptive_round_tiered(state, graph, cfg, ((fcap, ecap),))


def _dedup_compact(ids: torch.Tensor, cap: int, phantom: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted dedup of a padded id list: (unique ids padded with
    ``phantom`` to ``cap``, their count as a device scalar). Phantom entries
    sort last and are not counted. A count above ``cap`` means the list was
    cut and must not be used."""
    s, _ = torch.sort(ids)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    keep = first & (s != phantom)
    count = keep.sum()
    pos = compact(keep, cap, ids.shape[0] - 1)
    inside = torch.arange(cap, device=ids.device) < count.clamp(max=cap)
    return torch.where(inside, s[pos], phantom).to(torch.int32), count


def worklist_round(
    state: PprState,
    graph: HybridGraph,
    cfg: PprConfig,
    cand: torch.Tensor,
    fcap: int,
    ecap: int,
    ovacap: int = 0,
) -> tuple[PprState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """One push round touching only the candidate rows: no pass over all
    rows of ``r``.

    ``cand``: int32[wcap] deduplicated candidate rows (live entries first,
    phantom-padded), a superset of every active row. The caller guarantees
    that the active rows fit ``fcap``, their snapshot edges ``ecap``, and
    the live overlay entries under them ``ovacap`` (0: the overlay's
    capacity).

    Updates ``state.p`` and ``state.r`` in place and returns (state,
    next_cand, next_count, n_active, edge_work, bounds): the next list is
    the round's scatter targets (valid iff next_count <= wcap), and
    ``bounds`` holds upper bounds of the next round's needs, ``fed_ub``
    (snapshot edges under all next candidates) and ``live_ub`` (live
    overlay entries under them). Counts are int64 device scalars.
    """
    dtype = state.r.dtype
    alpha = cfg.alpha
    beta = (1.0 - alpha) / alpha
    forward = state.mode == FORWARD
    n = graph.n
    dev = cand.device
    deg = graph.window.deg
    row_len = graph.snap.row_len
    wcap = cand.shape[0]

    r_c = state.r[cand]  # [wcap, S], a copy: read before r is updated below
    deg_c = deg[cand]
    if forward:
        act_c = r_c.abs() > (cfg.eps * deg_c.clamp(min=1).to(dtype))[:, None]
    else:
        act_c = r_c.abs() > cfg.eps
    n_act_c = act_c.sum(dim=1)
    any_c = n_act_c > 0

    # compact the active subset (cand is deduplicated: fidx rows are unique)
    fpos = compact(any_c, fcap, wcap - 1)
    in_range = torch.arange(fcap, device=dev) < any_c.sum()
    fidx = torch.where(in_range, cand[fpos], n)
    mass_f = torch.where(in_range[:, None] & act_c[fpos], r_c[fpos], 0.0)
    dangling = deg == 0
    inv_deg = 1.0 / deg.clamp(min=1).to(dtype)
    dang_f = dangling[fidx][:, None]
    if forward:
        moving_f = (1.0 - alpha) * mass_f * inv_deg[fidx][:, None]
    else:
        moving_f = torch.where(dang_f, beta * mass_f, (1.0 - alpha) * mass_f)
    t, nbr, valid, _ = expand(fidx, graph.snap, ecap)
    contrib = moving_f[t] * valid.to(dtype)[:, None]

    # overlay sweep restricted to live entries: those whose gather endpoint
    # is in this round's frontier (1-D mark and compaction over the ring)
    ov = graph.ov
    gat_full, sca_full = (ov.src, ov.dst) if forward else (ov.dst, ov.src)
    ov_on = ov.sign != 0
    ova = ovacap if ovacap > 0 else gat_full.shape[0]
    fmark = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    fmark[fidx] = True
    fmark[n] = False
    live = fmark[gat_full] & ov_on
    opos = compact(live, ova, 0)
    ovalid = torch.arange(ova, device=dev) < live.sum()
    gat = torch.where(ovalid, gat_full[opos], n)
    sca = torch.where(ovalid, sca_full[opos], n)
    sign_c = torch.where(ovalid, ov.sign[opos], 0)
    r_gat = state.r[gat]
    if forward:
        act_ov = r_gat.abs() > (cfg.eps * deg[gat].clamp(min=1).to(dtype))[:, None]
        mass_ov = torch.where(act_ov, r_gat, 0.0)
        mov_ov = (1.0 - alpha) * mass_ov * inv_deg[gat][:, None]
    else:
        mass_ov = torch.where(r_gat.abs() > cfg.eps, r_gat, 0.0)
        mov_ov = torch.where(dangling[gat][:, None], beta * mass_ov, (1.0 - alpha) * mass_ov)
    mov_ov = mov_ov * sign_c.to(dtype)[:, None]
    if not forward:
        # the receiver's 1/d_out, per lane
        contrib = contrib * inv_deg[nbr][:, None]
        mov_ov = mov_ov * inv_deg[sca][:, None]

    # every read of the pre-round r is done: update in place
    p = state.p.index_add_(0, fidx, torch.where(dang_f, mass_f, alpha * mass_f))
    r = state.r.index_add_(0, fidx, mass_f, alpha=-1)
    r.index_add_(0, nbr, contrib)
    r.index_add_(0, sca, mov_ov)
    p[-1] = 0.0
    r[-1] = 0.0

    # next candidates: the scatter targets, deduplicated by a 1-D mark
    marks = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    marks[nbr] = True
    marks[sca] = True
    marks[n] = False  # the phantom is never a candidate
    bounds = {
        "fed_ub": torch.where(marks[:n], row_len[:n], 0).sum(),
        "live_ub": (marks[gat_full] & ov_on).sum(),
    }
    edge_work = (n_act_c * row_len[cand]).sum()
    return (PprState(p=p, r=r, mode=state.mode), compact(marks, wcap, n), marks.sum(),
            n_act_c.sum(), edge_work, bounds)


def make_tiers(
    wcap: int,
    ecap: int,
    ovacap: int,
    n_tiers: int = 3,
    div: int = 4,
    min_wcap: int = 2048,
    min_ecap: int = 4096,
    min_ovacap: int = 1024,
) -> tuple[tuple[int, int, int], ...]:
    """Geometric (wcap, ecap, ovacap) ladder for worklist rounds, smallest
    first. The ``min_*`` values are cutoffs, not clamps: a smaller tier is
    added only while every divided cap stays at or above its cutoff. The
    reference's ladder (copied: importing it loads JAX)."""
    tiers = [(wcap, ecap, ovacap)]
    for _ in range(n_tiers - 1):
        w2, e2, o2 = tiers[0]
        nxt = (w2 // div, e2 // div, o2 // div)
        if nxt[0] < min_wcap or nxt[1] < min_ecap or nxt[2] < min_ovacap:
            break
        tiers.insert(0, nxt)
    return tuple(tiers)


def push_to_convergence_worklist(
    state: PprState,
    graph: HybridGraph,
    cfg: PprConfig,
    cand0: torch.Tensor,
    cand0_ok: bool | torch.Tensor,
    tiers: tuple[tuple[int, int, int], ...],
    scan_fcap: int,
    scan_ecap: int,
) -> tuple[PprState, PushStats]:
    """Convergence loop whose steady rounds cost O(frontier), not O(N).

    Each round: while the candidate list is valid and its bounds fit the
    largest tier, a worklist round at the smallest tier that fits them;
    otherwise a scan round (``tiers[:-1]``' (wcap, ecap) below its own
    ``(scan_fcap, scan_ecap)``, dense when none fits) that reseeds the list
    from a fresh activity scan. ``tiers`` is smallest first, and its
    largest wcap is ``cand0``'s length. ``cand0`` seeds the list; with
    ``cand0_ok`` False (a bool, or a device bool read back with the list's
    first counts) the loop starts with a scan. A valid list with no
    candidate means no active row: the loop runs no round.

    Consumes ``state`` (worklist rounds update it in place).
    """
    n = graph.n
    tiers = tuple(tiers)
    wcap, ecap, ovacap = tiers[-1]
    if cand0.shape[0] != wcap:
        raise ValueError(f"cand0 capacity {cand0.shape[0]} != largest tier wcap {wcap}")
    dev = cand0.device
    row_len = graph.snap.row_len
    ov = graph.ov
    gat_full = ov.src if state.mode == FORWARD else ov.dst
    ov_on = ov.sign != 0
    scan_tiers = tuple((w, e) for (w, e, _) in tiers[:-1]) + ((scan_fcap, scan_ecap),)
    stats = PushStats()

    def read(*vals) -> list[int]:
        stats.syncs += 1
        return torch.stack([v.long() for v in vals]).tolist()

    def live_bound(mark: torch.Tensor) -> torch.Tensor:
        return (mark[gat_full] & ov_on).sum()

    # the list's bounds from cand0 (1-D work)
    live0 = cand0 != n
    cmark0 = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    cmark0[cand0] = True
    cmark0[n] = False
    cn, fed, liv, ok = read(live0.sum(), torch.where(live0, row_len[cand0], 0).sum(),
                            live_bound(cmark0), torch.as_tensor(cand0_ok, device=dev))
    ok = bool(ok)
    act = front = None
    if ok:
        # the list holds every active row: no candidate, no round
        na = int(cn > 0)
    else:
        # the prime is a full activity count, read with the first scan
        # round's frontier counts
        act = _active_mask(state, graph.window, cfg)
        na, *front = read(act.sum(), *_front_counts(act, graph))
    cand = cand0

    while na > 0 and stats.rounds < cfg.max_rounds:
        use_wl = ok and cn <= wcap and fed <= ecap and liv <= ovacap
        if use_wl:
            i = sum(not (cn <= w_i and fed <= e_i and liv <= o_i) for w_i, e_i, o_i in tiers[:-1])
            w_i, e_i, o_i = tiers[i]
            state, cand2, n2, na_t, ew_t, b = worklist_round(
                state, graph, cfg, cand[:w_i], w_i, e_i, o_i)
            n2, fed2, liv2, na, ew = read(n2, b["fed_ub"], b["live_ub"], na_t, ew_t)
            # a tier round can mark more rows than its own w_i, and its list
            # was then cut at w_i: judge the overflow against the tier used
            if n2 > w_i:
                n2 = wcap + 1
            cand2 = _fit(cand2, wcap, n)
            act = front = None  # the bounds are not the exact frontier
        else:
            if act is None:
                act = _active_mask(state, graph.window, cfg)
                front = read(*_front_counts(act, graph))
            state, na_t, ew_t = _tiered_round(state, act, graph, cfg, scan_tiers, *front)
            # reseed from a fresh scan; its mask and counts are the next
            # scan round's
            act = _active_mask(state, graph.window, cfg)
            any2 = act[:n].any(dim=1)
            cand2 = compact(any2, wcap, n)
            amark = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            amark[:n] = any2
            n2, fed2, liv2, na, ew = read(any2.sum(), torch.where(any2, row_len[:n], 0).sum(),
                                          live_bound(amark), na_t, ew_t)
            front = [n2, fed2]
        stats.rounds += 1
        stats.pushes += na
        stats.edge_pushes += ew
        stats.wl_rounds += int(use_wl)
        if not use_wl:
            stats.scans_cand += int(not ok or cn > wcap)
            stats.scans_fed += int(fed > ecap)
            stats.scans_liv += int(liv > ovacap)
        # a list overflow does not corrupt the state (the round was exact):
        # it forces a scan and reseed next
        cand, cn, fed, liv, ok = cand2, n2, fed2, liv2, n2 <= wcap
    return state, stats


def push_to_convergence_hybrid(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int
) -> tuple[PprState, PushStats]:
    """Convergence loop of single-tier scan rounds (sparse or dense each
    round). Each round's activity mask and frontier counts are computed
    after the round before it and read back with its counts: one sync a
    round, and one before the first."""
    tiers = ((fcap, ecap),)
    stats = PushStats()
    act = _active_mask(state, graph.window, cfg)
    na, *front = torch.stack([act.sum(), *_front_counts(act, graph)]).tolist()
    stats.syncs += 1
    while na > 0 and stats.rounds < cfg.max_rounds:
        state, na_t, ew_t = _tiered_round(state, act, graph, cfg, tiers, *front)
        act = _active_mask(state, graph.window, cfg)
        na, ew, *front = torch.stack([na_t, ew_t, *_front_counts(act, graph)]).tolist()
        stats.syncs += 1
        stats.rounds += 1
        stats.pushes += na
        stats.edge_pushes += ew
    return state, stats
