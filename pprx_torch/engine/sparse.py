"""Frontier-sparse push rounds over a CSR snapshot and a signed overlay, with
the dense fallback and the worklist loop (port of ``pprx.engine.sparse``).

What the engine does is the reference's:

1. A scan round takes the activity mask over all rows, compacts the active
   rows, expands their snapshot rows edge-balanced
   (``pprx_torch.engine.frontier``), sweeps the signed overlay, and
   scatters the contributions into ``r``. It runs at the smallest capacity
   tier that holds the exact frontier, or as a dense round over the whole
   window when none does or when the frontier's edges and the overlay's
   capacity together reach half the window.
2. A worklist round touches only a candidate list (a superset of the
   active rows, kept across rounds: each round's scatter targets), with no
   pass over all rows of ``r``, and emits upper bounds of the next
   round's needs so that the loop can pick the next tier from 1-D work.
3. ``push_to_convergence_worklist`` runs a worklist round at the smallest
   tier that fits the bounds while the list is valid, and a scan round
   that reseeds the list from a fresh activity scan otherwise;
   ``push_to_convergence_hybrid`` runs scan rounds alone.

How the port differs:

- Both loops are the reference's ``lax.while_loop`` under K4's hybrid rule
  (``pprx_torch.engine.loop``): on CUDA each is one launch of a
  conditional CUDA graph (``RoundGraphs.loop``) and one read of its carry
  (``PushStats.syncs`` 1); on the CPU a host loop of K4's plain steps over
  the same arms, with a read of the counts after the prologue and after
  each arm. The arms are the worklist tiers, the sparse scan tiers, the
  dense scan and a count of the frontier (K3), which pushes nothing and is
  not a round: a scan's arm is chosen from the exact frontier, which a
  scan's reseed (or a prologue's count) leaves and a worklist round's
  bounds are not, so a scan after a worklist round counts first.
- The frontier's rows are K3's (``rowpass.frontier_rows``, one read of
  ``r``), kept between arms in a buffer (``RoundGraphs.buffer``). A sparse
  scan takes its pair mask on those rows (``r[fidx]``), not as an
  ``[N+1, S]`` mask; the reseed is K3, ``compact`` and the 1-D live bound
  over the overlay.
- The dense fallback is the dense engine's round (``push.dense_round_``:
  K2, then K1 over the window's delivery-sorted view), not a scatter over
  the ring; it counts what the reference's dense round counts.
- A worklist round or a sparse scan delivers its snapshot lanes and its
  overlay lanes in one sorted call (``wl2.sorted_deliver_``: a stable sort
  of the keys, then K1's gather entry over ``[moving_f; mov_ov]``), where
  the reference scatters the ``[ecap, S]`` contributions and the overlay's
  rows; invalid lanes key the phantom row and are dropped, and in reverse
  mode the receiver's 1/d_out is K1's per-row scale, one factor on each
  row's sum. Unlike the fast driver's compact rounds, every arm delivers
  so, however small: on an H100 the hybrid driver ran faster end to end
  with every arm sorted than with the arms under 2M lanes times S
  scattering, on a small stream (S=16) as on the headline's (PERF.md),
  though one such arm's first delivery, timed alone, is faster by scatter
  (the smallest worklist tier at S=16 or S=64).
- Every arm updates ``state.p`` and ``state.r`` in place, after every read
  of the pre-round ``r``: the loops and rounds consume the state they are
  given. Lists and counts go between arms through ``RoundGraphs``' fixed
  buffers, so that each arm is one captured graph on CUDA.
- ``jnp.nonzero(size=, fill_value=)`` is ``compact`` (no sync).
- Counts are int64 (the reference sums float32 counters); ``edge_work``
  weighs each row's active queries by its snapshot row length, as the
  reference does, from the per-row counts rather than an ``[N+1, S]``
  product.
"""

from __future__ import annotations

import dataclasses

import torch

from pprx_torch.config import PprConfig
from pprx_torch.engine import loop
from pprx_torch.engine.frontier import (
    CsrSnapshot,
    Overlay,
    build_snapshot,
    compact_frontier,
    expand,
)
from pprx_torch.engine.graphs import RoundGraphs, Step, copy_into_
from pprx_torch.engine.push import dense_round_
from pprx_torch.engine.rowpass import active_mask, frontier_rows
from pprx_torch.engine.state import FORWARD, PprState, PushStats
from pprx_torch.engine.wl2 import compact, sorted_deliver_
from pprx_torch.graph.dynamic import DeliveryView, WindowGraph, delivery_view


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
    """Re-sort the live window into a fresh snapshot; clear the overlay
    (new tensors)."""
    return dataclasses.replace(graph, snap=_snapshot(graph.window, mode),
                               ov=Overlay.empty(graph.ov.src.shape[0], graph.n,
                                                graph.window.src.device))


def rebuild_snapshot_(graph: HybridGraph, mode: int) -> None:
    """``rebuild_snapshot`` into ``graph``'s own tensors (a captured round
    keeps reading them)."""
    copy_into_(graph.snap, _snapshot(graph.window, mode))
    graph.ov.src.fill_(graph.n)
    graph.ov.dst.fill_(graph.n)
    graph.ov.sign.zero_()


def _frontier(state: PprState, graph: HybridGraph, cfg: PprConfig):
    """K3 over rows ``[0, N)``: (rows holding an active pair, bool [N];
    their count and their snapshot edges, int64 device scalars)."""
    n = graph.n
    row_len = graph.snap.row_len[:n]
    any2, cn2, fed2, _ = frontier_rows(state.r[:n], graph.window.deg[:n], row_len, row_len,
                                       eps=cfg.eps, forward=state.mode == FORWARD)
    return any2, cn2, fed2


def _sparse_scan_(state: PprState, graph: HybridGraph, cfg: PprConfig, front: torch.Tensor,
                  fcap: int, ecap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One sparse scan round in place, over the rows ``front`` (bool [N]:
    the rows of this state that hold an active pair) at capacities
    ``fcap`` rows and ``ecap`` snapshot edges, which the caller checked.
    Returns (n_active, edge_work), int64 device scalars."""
    dtype = state.r.dtype
    alpha = cfg.alpha
    beta = (1.0 - alpha) / alpha
    forward = state.mode == FORWARD
    p, r = state.p, state.r
    deg = graph.window.deg
    inv_deg = 1.0 / deg.clamp(min=1).to(dtype)
    fidx = compact_frontier(front, fcap, graph.n)

    # the pair mask on the frontier rows (a copy of them: r changes below)
    r_f = r[fidx]
    act_f = active_mask(r_f, deg[fidx], cfg.eps, forward)
    n_act = act_f.sum(dim=1)
    mass_f = torch.where(act_f, r_f, 0.0)
    dang_f = (deg[fidx] == 0)[:, None]
    if forward:
        moving_f = (1.0 - alpha) * mass_f * inv_deg[fidx][:, None]
    else:
        moving_f = torch.where(dang_f, beta * mass_f, (1.0 - alpha) * mass_f)

    # snapshot expansion
    t, nbr, valid, _ = expand(fidx, graph.snap, ecap)

    # the signed overlay, gathered at the mode's gather endpoint
    ov = graph.ov
    gat, sca = (ov.src, ov.dst) if forward else (ov.dst, ov.src)
    r_g = r[gat]
    mass_ov = torch.where(active_mask(r_g, deg[gat], cfg.eps, forward), r_g, 0.0)
    if forward:
        mov_ov = (1.0 - alpha) * mass_ov * inv_deg[gat][:, None]
    else:
        mov_ov = torch.where((deg[gat] == 0)[:, None], beta * mass_ov, (1.0 - alpha) * mass_ov)
    mov_ov = mov_ov * ov.sign.to(dtype)[:, None]

    # every read of the pre-round r is done: update in place
    p.index_add_(0, fidx, torch.where(dang_f, mass_f, alpha * mass_f))
    r.index_add_(0, fidx, mass_f, alpha=-1)
    _deliver_(r, moving_f, t, nbr, valid, mov_ov, sca, None if forward else inv_deg,
              "sparse_scan")
    p[-1] = 0.0
    r[-1] = 0.0
    return n_act.sum(), (n_act * graph.snap.row_len[fidx]).sum()


def _deliver_(r: torch.Tensor, moving_f: torch.Tensor, t: torch.Tensor, nbr: torch.Tensor,
              valid: torch.Tensor, mov_ov: torch.Tensor, sca: torch.Tensor,
              inv_deg: torch.Tensor | None, site: str) -> None:
    """A round's delivery into ``r`` in place: ``moving_f[t[j]]`` at
    ``nbr[j]`` for each valid snapshot lane and ``mov_ov[k]`` at ``sca[k]``
    for each overlay lane, in reverse mode (``inv_deg`` given) times the
    receiver's 1/d_out: one sorted call over ``[moving_f; mov_ov]`` with the
    scale per row, the invalid lanes keyed the phantom row N, which it
    drops, and its launch counted under ``site``."""
    n = r.shape[0] - 1
    keys, table, rows = delivery_lanes(n, moving_f, t, nbr, valid, mov_ov, sca)
    sorted_deliver_(r[:n], keys, table, rows,
                    row_scale=None if inv_deg is None else inv_deg[:n], site=site)


def delivery_lanes(n: int, moving_f: torch.Tensor, t: torch.Tensor, nbr: torch.Tensor,
                   valid: torch.Tensor, mov_ov: torch.Tensor, sca: torch.Tensor) -> tuple:
    """``_deliver_``'s lanes before the sort: (keys, the table ``[moving_f;
    mov_ov]``, each lane's table row), a snapshot lane keyed ``nbr`` (the
    phantom row ``n`` where it is invalid), an overlay lane ``sca``."""
    fcap, ova = moving_f.shape[0], mov_ov.shape[0]
    keys = torch.cat([torch.where(valid, nbr, n), sca])
    rows = torch.cat([t, torch.arange(fcap, fcap + ova, dtype=t.dtype, device=t.device)])
    return keys, torch.cat([moving_f, mov_ov]), rows


def _dense_scan_(state: PprState, graph: HybridGraph, view: DeliveryView, cfg: PprConfig,
                 counts: torch.Tensor) -> None:
    """The dense fallback in place: the dense engine's round over the
    window's delivery-sorted ``view``; ``counts`` (int64 [2]) gets its
    active pairs and edge pushes."""
    dense_round_(state, graph.window.deg, [(view.gat, view.off)], cfg, counts)


def sparse_round(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """One frontier-sparse push round in place; the caller guarantees that
    the frontier fits ``fcap`` rows and ``ecap`` snapshot edges
    (``adaptive_round`` checks). Returns (state, n_active, edge_work)."""
    front, _, _ = _frontier(state, graph, cfg)
    return (state, *_sparse_scan_(state, graph, cfg, front, fcap, ecap))


def frontier_edge_count(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(active pairs, snapshot edges in the any-query frontier's rows)."""
    act = active_mask(state.r, graph.window.deg, cfg.eps, state.mode == FORWARD)
    any_ = act[:graph.n].any(dim=1)
    return act.sum(), torch.where(any_, graph.snap.row_len[:graph.n], 0).sum()


def _scan_arm(tiers: tuple[tuple[int, int], ...], n_front: int, fedges: int,
              graph: HybridGraph) -> int | None:
    """The scan tier that holds the exact frontier (``n_front`` rows,
    ``fedges`` snapshot edges), where the sparse round is worth it (the
    frontier's edges plus the overlay's capacity, not its live count as in
    the reference, at most half the window); ``None``: the dense round. The
    host's form of K4's choice (``loop.Table.scans``)."""
    worth = (fedges + graph.ov.src.shape[0]) * 2 <= graph.window.capacity
    i = sum(not (n_front <= f_i and fedges <= e_i) for f_i, e_i in tiers)
    return i if worth and i < len(tiers) else None


def adaptive_round_tiered(
    state: PprState, graph: HybridGraph, cfg: PprConfig, tiers: tuple[tuple[int, int], ...],
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """Full-scan round in place at the smallest capacity tier that fits the
    exact frontier, dense otherwise. ``tiers``: ((fcap_i, ecap_i), ...)
    smallest first. Reads the frontier's counts back once."""
    front, n_front, fedges = _frontier(state, graph, cfg)
    i = _scan_arm(tuple(tiers), *torch.stack([n_front, fedges]).tolist(), graph)
    if i is not None:
        return (state, *_sparse_scan_(state, graph, cfg, front, *tiers[i]))
    counts = torch.zeros(2, dtype=torch.int64, device=state.r.device)
    _dense_scan_(state, graph, delivery_view(graph.window, state.mode), cfg, counts)
    return state, counts[0], counts[1]


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


def _mark(ids: torch.Tensor, n: int) -> torch.Tensor:
    """bool [N+1]: the rows ``ids`` names, the phantom row N never."""
    mark = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    mark.index_fill_(0, ids.long(), True)
    mark[n:].fill_(False)
    return mark


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
    act_c = active_mask(r_c, deg[cand], cfg.eps, forward)
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

    # overlay sweep restricted to live entries: those whose gather endpoint
    # is in this round's frontier (1-D mark and compaction over the ring)
    ov = graph.ov
    gat_full, sca_full = (ov.src, ov.dst) if forward else (ov.dst, ov.src)
    ov_on = ov.sign != 0
    ova = ovacap if ovacap > 0 else gat_full.shape[0]
    live = _mark(fidx, n)[gat_full] & ov_on
    opos = compact(live, ova, 0)
    ovalid = torch.arange(ova, device=dev) < live.sum()
    gat = torch.where(ovalid, gat_full[opos], n)
    sca = torch.where(ovalid, sca_full[opos], n)
    sign_c = torch.where(ovalid, ov.sign[opos], 0)
    r_gat = state.r[gat]
    mass_ov = torch.where(active_mask(r_gat, deg[gat], cfg.eps, forward), r_gat, 0.0)
    if forward:
        mov_ov = (1.0 - alpha) * mass_ov * inv_deg[gat][:, None]
    else:
        mov_ov = torch.where(dangling[gat][:, None], beta * mass_ov, (1.0 - alpha) * mass_ov)
    mov_ov = mov_ov * sign_c.to(dtype)[:, None]

    # every read of the pre-round r is done: update in place
    p = state.p.index_add_(0, fidx, torch.where(dang_f, mass_f, alpha * mass_f))
    r = state.r.index_add_(0, fidx, mass_f, alpha=-1)
    _deliver_(r, moving_f, t, nbr, valid, mov_ov, sca, None if forward else inv_deg,
              "worklist")
    p[-1] = 0.0
    r[-1] = 0.0

    # next candidates: the scatter targets, deduplicated by a 1-D mark
    marks = _mark(torch.cat([nbr, sca]), n)
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


def scan_tiers(tiers: tuple[tuple[int, int, int], ...], scan_fcap: int,
               scan_ecap: int) -> tuple[tuple[int, int], ...]:
    """The worklist loop's scan tiers: the worklist ladder's (wcap, ecap)
    below its own ``(scan_fcap, scan_ecap)``."""
    return tuple((w, e) for (w, e, _) in tiers[:-1]) + ((scan_fcap, scan_ecap),)


# ---- the loops' arms: each reads the list and the frontier rows from the
# RoundGraphs buffers and writes its list and counts back there, so that on
# CUDA each is one captured graph (the counts: cn, fed, fre, n_active,
# edge_work, and the first list's validity, loop.C0V)

def list_counts(graph: HybridGraph, mode: int, g: RoundGraphs, wcap: int) -> None:
    """The list ``g.cand[:wcap]``'s counts: its live entries, their
    snapshot edges and the live overlay entries under them."""
    n = graph.n
    cand = g.cand[:wcap]
    live = cand != n
    gat_full = graph.ov.src if mode == FORWARD else graph.ov.dst
    g.put(0, live.sum(), torch.where(live, graph.snap.row_len[cand], 0).sum(),
          (_mark(cand, n)[gat_full] & (graph.ov.sign != 0)).sum())


def count_frontier(state: PprState, graph: HybridGraph, cfg: PprConfig, g: RoundGraphs,
           front: torch.Tensor) -> None:
    """The count arm (and a prologue's first count): the frontier's rows
    into ``front``, their count and snapshot edges into ``counts[3:5]``."""
    any2, cn2, fed2 = _frontier(state, graph, cfg)
    front.copy_(any2)
    g.put(3, cn2, fed2)


def _reseed(state: PprState, graph: HybridGraph, cfg: PprConfig, g: RoundGraphs,
            front: torch.Tensor, wcap: int) -> None:
    """After a scan: the frontier's rows into ``front`` and its exact
    counts into ``counts[:3]``; with a worklist (``wcap`` > 0), the list of
    its rows and the live overlay entries under them."""
    n = graph.n
    any2, cn2, fed2 = _frontier(state, graph, cfg)
    front.copy_(any2)
    liv2 = torch.zeros((), dtype=torch.int64, device=any2.device)
    if wcap:
        g.emit(compact(any2, wcap, n))
        amark = torch.zeros(n + 1, dtype=torch.bool, device=any2.device)
        amark[:n].copy_(any2)
        ov = graph.ov
        liv2 = (amark[ov.src if state.mode == FORWARD else ov.dst] & (ov.sign != 0)).sum()
    g.put(0, cn2, fed2, liv2)


def _tier_step(state, graph, cfg, g: RoundGraphs, tier: tuple[int, int, int]) -> None:
    w_i, e_i, o_i = tier
    _, cand2, n2, na, ew, b = worklist_round(state, graph, cfg, g.cand[:w_i], w_i, e_i, o_i)
    g.emit(cand2)
    g.put(0, n2, b["fed_ub"], b["live_ub"], na, ew)


def _sparse_step(state, graph, cfg, g: RoundGraphs, front, tier: tuple[int, int],
                 wcap: int) -> None:
    na, ew = _sparse_scan_(state, graph, cfg, front, *tier)
    g.put(3, na, ew)
    _reseed(state, graph, cfg, g, front, wcap)


def _dense_step(state, graph, view, cfg, g: RoundGraphs, front, wcap: int) -> None:
    _dense_scan_(state, graph, view, cfg, g.counts[3:5])
    _reseed(state, graph, cfg, g, front, wcap)


def graph_key(state: PprState, cfg: PprConfig) -> tuple:
    """What a captured arm bakes in besides its shapes."""
    return ("hybrid", state.mode, cfg.eps, cfg.alpha)


def _arms(state, graph, view, cfg, g: RoundGraphs, tiers, scans) -> list[Step]:
    """The loop's arms as ``loop.hybrid_table`` numbers them: the worklist
    tiers, the sparse scans, the dense scan, the count."""
    key = graph_key(state, cfg)
    front = g.buffer("front", graph.n, torch.bool)
    wcap = tiers[-1][0] if tiers else 0

    def tier(t):
        return (*key, "tier", t), lambda: _tier_step(state, graph, cfg, g, t)

    def scan(t):
        return (*key, "scan", t, wcap), lambda: _sparse_step(state, graph, cfg, g, front, t, wcap)

    return [tier(t) for t in tiers] + [scan(t) for t in scans] + [
        ((*key, "dense", wcap), lambda: _dense_step(state, graph, view, cfg, g, front, wcap)),
        ((*key, "count"), lambda: count_frontier(state, graph, cfg, g, front)),
    ]


def round_graphs_for(state: PprState, graph: HybridGraph, view: DeliveryView | None,
                     width: int, graphs: RoundGraphs | None) -> tuple[RoundGraphs, DeliveryView]:
    """``graphs`` (a new cache where it is ``None``) bound to ``state``,
    ``graph`` and ``view`` (built where it is ``None``), with a candidate
    buffer of at least ``width``."""
    view = delivery_view(graph.window, state.mode) if view is None else view
    g = RoundGraphs(graph.n, width, state.r.device, n_counts=loop.N_COUNTS) if graphs is None \
        else graphs
    if g.cand.shape[0] < width or g.counts.shape[0] < loop.N_COUNTS:
        raise ValueError(f"round buffers of {g.cand.shape[0]} candidates and "
                         f"{g.counts.shape[0]} counts hold no hybrid loop of width {width}")
    g.hold("the hybrid state, graph and view", state, graph, view)
    return g, view


def arm_kinds(table: loop.Table, values: list[int]) -> dict:
    """A hybrid loop's executions by kind of arm, from its carry's head:
    ``wl`` the worklist tiers, ``sparse`` the sparse scans (by tier in
    ``sparse_by_tier``), ``dense`` the dense scans, ``count`` the counts
    of the frontier (not rounds)."""
    execs = values[loop.EXECS:loop.EXECS + table.n_branches]
    k, ks = len(table.tiers), len(table.scans)
    return {"wl": sum(execs[:k]), "sparse": sum(execs[k:k + ks]),
            "dense": execs[table.dense_arm], "count": execs[table.count_arm],
            "sparse_by_tier": execs[k:k + ks]}


def converge(state: PprState, graph: HybridGraph, view: DeliveryView, cfg: PprConfig,
             g: RoundGraphs, tiers: tuple[tuple[int, int, int], ...],
             scans: tuple[tuple[int, int], ...], c0ok: bool, prologue: Step | None) -> PushStats:
    """The convergence loop under K4's hybrid rule, from what ``prologue``
    (a graph key and its step) leaves in ``g``: the first list in ``cand``
    with its counts and validity (``counts[:3]``, ``counts[loop.C0V]``)
    where ``c0ok``, else the state's first count (``count_frontier``).
    ``tiers``: the worklist ladder, none for ``push_to_convergence_hybrid``'s
    loop.

    On CUDA one launch of the loop's graph and one read; on the CPU a host
    loop of the same arms, a read after the prologue and after each arm."""
    table = loop.hybrid_table(tiers, scans, graph.ov.src.shape[0], graph.window.capacity)
    values, reads = g.loop(prologue, _arms(state, graph, view, cfg, g, tiers, scans), table,
                           c0ok, cfg.max_rounds)
    return PushStats(
        rounds=values[loop.ROUNDS], pushes=values[loop.PUSHES],
        edge_pushes=values[loop.EDGE_PUSHES], wl_rounds=values[loop.WL_ROUNDS],
        scans_cand=values[loop.SCANS_CAND], scans_fed=values[loop.SCANS_FED],
        scans_liv=values[loop.SCANS_LIV], syncs=reads, arms=arm_kinds(table, values))


def push_to_convergence_worklist(
    state: PprState,
    graph: HybridGraph,
    cfg: PprConfig,
    cand0: torch.Tensor,
    cand0_ok: bool | torch.Tensor,
    tiers: tuple[tuple[int, int, int], ...],
    scan_fcap: int,
    scan_ecap: int,
    graphs: RoundGraphs | None = None,
    view: DeliveryView | None = None,
) -> tuple[PprState, PushStats]:
    """Convergence loop whose steady rounds cost O(frontier), not O(N).

    Each round: while the candidate list is valid and its bounds fit the
    largest tier, a worklist round at the smallest tier that fits them;
    otherwise a scan round (``scan_tiers``: the ladder's (wcap, ecap) below
    its own ``(scan_fcap, scan_ecap)``, dense when none fits) that reseeds
    the list from a fresh activity scan. ``tiers`` is smallest first, and
    its largest wcap is ``cand0``'s length. ``cand0`` seeds the list; with
    ``cand0_ok`` False the loop starts with a scan, from the state's first
    count; ``cand0_ok`` may be a device bool, which the loop reads on the
    device. A valid list with no candidate means no active row: the loop
    runs no round.

    Consumes ``state`` (every round updates it in place). ``graphs`` and
    ``view``: the caller's round buffers (on CUDA its captured arms and
    loops) and the window's delivery-sorted view, bound to ``state`` and
    ``graph`` (a driver keeps both for its life); ``None`` makes new ones.
    """
    tiers = tuple(tiers)
    wcap = tiers[-1][0]
    if cand0.shape[0] != wcap:
        raise ValueError(f"cand0 capacity {cand0.shape[0]} != largest tier wcap {wcap}")
    g, view = round_graphs_for(state, graph, view, wcap, graphs)
    g.seed(cand0, 0)
    listed = not (cand0_ok is False)
    if isinstance(cand0_ok, torch.Tensor):
        g.counts[loop.C0V:loop.C0V + 1].copy_(cand0_ok.reshape(1))
    else:
        g.counts[loop.C0V:loop.C0V + 1].fill_(int(bool(cand0_ok)))
    front = g.buffer("front", graph.n, torch.bool)

    def first():
        list_counts(graph, state.mode, g, wcap)
        if not listed:
            count_frontier(state, graph, cfg, g, front)

    prologue = ((*graph_key(state, cfg), "first", wcap, listed), first)
    stats = converge(state, graph, view, cfg, g, tiers, scan_tiers(tiers, scan_fcap, scan_ecap),
                     listed, prologue)
    return state, stats


def push_to_convergence_hybrid(
    state: PprState, graph: HybridGraph, cfg: PprConfig, fcap: int, ecap: int,
    graphs: RoundGraphs | None = None, view: DeliveryView | None = None,
) -> tuple[PprState, PushStats]:
    """Convergence loop of single-tier scan rounds (sparse or dense each
    round) from the state's first count; ``graphs`` and ``view`` as for
    ``push_to_convergence_worklist``. Consumes ``state``."""
    g, view = round_graphs_for(state, graph, view, 1, graphs)
    front = g.buffer("front", graph.n, torch.bool)

    def first():
        g.counts[:3].zero_()
        count_frontier(state, graph, cfg, g, front)

    prologue = ((*graph_key(state, cfg), "first"), first)
    return state, converge(state, graph, view, cfg, g, (), ((fcap, ecap),), False, prologue)
