"""Compact-frontier push engine v2 (port of ``pprx.engine.wl2``).

What the engine does is the reference's (see ``pprx/engine/wl2.py``):

1. Candidate lists stay compact. Each round's next-frontier candidates are
   its delivery targets, deduplicated by a winner scatter: the lane that
   reads back its own id owns the row.
2. Window expiries are killed in place in the CSR snapshot (neighbor set to
   the phantom vertex N). Fresh edges since the snapshot live in a mini-CSR
   re-sorted each slide.
3. Rounds run at the smallest capacity tier whose exact frontier counts
   fit, or as one dense delivery-sorted round over the whole window.

How the port differs:

- On CUDA the whole loop runs on the card, as the reference's
  ``lax.while_loop`` does: one conditional CUDA graph whose branches are
  the captured rounds, steered by the control kernel K4 on a small carry
  (``pprx_torch.engine.graphs``, ``pprx_torch.engine.loop``), launched
  once and read once (``PushStats.syncs`` is 1). On the CPU a host loop
  runs K4's plain steps and reads the round's device scalars (cn, fed,
  fre, na, ew) from one small buffer each round. Rounds update the state
  in place and hand the next candidate list over in a static buffer, so
  that a graph's addresses stay fixed.
- ``jnp.nonzero(size=, fill_value=)`` becomes ``compact``: a fixed-size
  cumsum-scatter compaction with no sync and a static shape.
- Multi-operand ``lax.sort`` becomes ``torch.sort(stable=True)`` plus
  gathers; the slot -> position maps are inverse permutations, built with
  one scatter of ``arange`` instead of a second sort.
- Every sorted delivery goes through ``segsum_gather_add_`` (the Hopper
  kernel on CUDA tensors, its plain version on CPU tensors), which reads
  ``moving[gat[j]]`` itself: the ``[W, S]`` array ``moving[gat]`` that the
  reference hands to its kernel is never built. The TPU kernel's lane
  padding, EC padding and tile offsets are gone; per-row offsets
  (``d_off``, ``fd_off``) take their place.
- A scan round's elementwise work (the activity test, the mass moved onto
  ``p``, the ``moving`` rows, its counts) is one pass over the state, and
  so is a rescan's activity test (``pprx_torch.engine.rowpass``: Hopper
  kernels on CUDA tensors, where XLA fused the same ops on the TPU).
- A scan round's next-frontier stats are a branch of their own
  (``_frontier_stats``), run after the scan's counts are known and only for
  a light scan that another round follows, as the reference's ``lax.cond``
  skips them for a heavy one (``PushStats.stats_reads`` counts the runs;
  the host loop reads the counts again after each). The round schedule is
  the reference's.
- Reverse scan rounds hand the receiver's 1/d_out to the segment sum as its
  per-row scale (the delivery row is the receiver), where the reference
  either folds it into every edge or factors it out of a window-sized
  delta array. Their count of edge pushes gathers the per-row count of
  active queries, not the ``[W, S]`` mask.
"""

from __future__ import annotations

import dataclasses

import torch

from pprx_torch.config import PprConfig
from pprx_torch.engine import loop
from pprx_torch.engine.graphs import RoundGraphs, copy_into_
from pprx_torch.engine.loop import Table
from pprx_torch.engine.push import dense_round_
from pprx_torch.engine.rowpass import frontier_rows
from pprx_torch.engine.segsum import row_offsets, segsum_gather_add_
from pprx_torch.engine.state import FORWARD, PprState, PushStats
from pprx_torch.graph.dynamic import WindowGraph

# Scan rounds skip the next-frontier stats while the current frontier's edge
# mass exceeds STATS_GUARD * the ladder top (the successor is another scan);
# tuned on the TPU, kept for parity.
STATS_GUARD = 2

# Compact rounds with at least this many delivery lanes sort them and
# deliver through the segment sum instead of an unsorted scatter (TPU A/B;
# kept for parity, to be re-swept on the H100).
SORT_DELIVER_MIN = 131_072

_BIG = loop.BIG  # the reference's "skip" sentinel (int32 max // 2)


@dataclasses.dataclass
class KillGraph:
    """COO window + kill-in-place CSR snapshot + fresh mini-CSR.

    offsets/nbr/row_len: CSR snapshot sorted by the mode's gather endpoint
        (src forward, dst reverse); ``nbr`` holds the scatter endpoint,
        killed slots hold N.
    snap_pos: int32[capacity] ring slot -> snapshot position.
    fr_gat/fr_sca: raw fresh-edge ring (insertion order; phantom-padded).
    f_off/f_nbr/f_len: fresh mini-CSR re-sorted from the ring each slide.
    d_gat/d_pos/d_off: the snapshot sorted by the scatter endpoint
        (delivery order) for scan rounds; killed slots have d_gat == N,
        whose moving row is zero. ``d_off`` holds per-row edge ranges,
        which stand for the reference's sorted scatter ids ``d_sca``.
    fd_gat/fd_off: the fresh ring in delivery order.
    """

    window: WindowGraph
    offsets: torch.Tensor
    nbr: torch.Tensor
    row_len: torch.Tensor
    snap_pos: torch.Tensor
    fr_gat: torch.Tensor
    fr_sca: torch.Tensor
    f_off: torch.Tensor
    f_nbr: torch.Tensor
    f_len: torch.Tensor
    d_gat: torch.Tensor
    d_pos: torch.Tensor
    d_off: torch.Tensor
    fd_gat: torch.Tensor
    fd_off: torch.Tensor

    @property
    def n(self) -> int:
        return self.window.n


def _inverse_perm(order: torch.Tensor) -> torch.Tensor:
    """int32 inverse of a permutation: inv[order[i]] = i."""
    inv = torch.empty_like(order, dtype=torch.int32)
    inv[order] = torch.arange(order.shape[0], dtype=torch.int32, device=order.device)
    return inv


def compact(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """int32 [size]: positions of the True entries of a 1-D ``mask`` in
    order, cut to ``size`` and padded with ``fill``. The counterpart of
    ``jnp.nonzero(mask, size=size, fill_value=fill)`` with no host sync:
    a cumsum gives each kept entry its slot, and entries past ``size`` go
    to a dump slot that is dropped."""
    m = mask.shape[0]
    slot = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (slot < size), slot, size)
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=mask.device)
    out.scatter_(0, slot, torch.arange(m, dtype=torch.int32, device=mask.device))
    return out[:size]


def build_kill_graph(window: WindowGraph, mode: int, fring: int) -> KillGraph:
    """Snapshot build: stable-sort the window by gather endpoint, plus a
    second view sorted by scatter endpoint for scan rounds."""
    n = window.n
    dev = window.src.device
    key, other = (window.src, window.dst) if mode == FORWARD else (window.dst, window.src)
    key_s, order = torch.sort(key, stable=True)
    nbr = other[order]
    snap_pos = _inverse_perm(order)
    offsets = row_offsets(key_s, n + 1)
    d_sca, order_d = torch.sort(other, stable=True)
    d_gat = key[order_d]
    d_pos = _inverse_perm(order_d)
    # the empty fresh view: every ring entry is phantom, owned by row n
    fd_off = torch.zeros(n + 2, dtype=torch.int32, device=dev)
    fd_off[n + 1:].fill_(fring)
    full_n = torch.full((fring,), n, dtype=torch.int32, device=dev)
    return KillGraph(
        window=window,
        offsets=offsets,
        nbr=nbr,
        row_len=offsets[1:] - offsets[:-1],
        snap_pos=snap_pos,
        fr_gat=full_n.clone(),
        fr_sca=full_n.clone(),
        f_off=torch.zeros(n + 2, dtype=torch.int32, device=dev),
        f_nbr=full_n.clone(),
        f_len=torch.zeros(n + 1, dtype=torch.int32, device=dev),
        d_gat=d_gat,
        d_pos=d_pos,
        d_off=row_offsets(d_sca, n + 1),
        fd_gat=full_n,
        fd_off=fd_off,
    )


def rebuild_kill_graph_(kg: KillGraph, mode: int, fring: int) -> KillGraph:
    """``build_kill_graph`` of ``kg``'s window, written into ``kg``'s own
    tensors (a captured round keeps reading them); returns ``kg``."""
    copy_into_(kg, build_kill_graph(kg.window, mode, fring))
    return kg


def refresh_fresh_csr(kg: KillGraph) -> KillGraph:
    """Re-sort the fresh ring into the mini-CSR and the delivery-sorted
    fresh view (once per slide, after the ring append), in place; returns
    ``kg``. ``f_len`` is kept incrementally by the slide step; phantom
    padding sorts to the tail."""
    n = kg.n
    _, order = torch.sort(kg.fr_gat, stable=True)
    fd_sca, order_d = torch.sort(kg.fr_sca, stable=True)
    kg.f_nbr.copy_(kg.fr_sca[order])
    kg.f_off[:1].fill_(0)
    kg.f_off[1:].copy_(torch.cumsum(kg.f_len, 0, dtype=torch.int32))
    kg.fd_gat.copy_(kg.fr_gat[order_d])
    kg.fd_off.copy_(row_offsets(fd_sca, n + 1))
    return kg


def dense_round_sorted(
    state: PprState, kg: KillGraph, cfg: PprConfig, bf16d: bool = False
) -> tuple[PprState, torch.Tensor, torch.Tensor]:
    """One push round over every active (vertex, query) pair, delivered in
    scatter-endpoint order through the segment sum (window view, then
    fresh view): the dense engine's round (``push.dense_round_``) over the
    kill graph's two views. Updates ``state.p`` and ``state.r`` in place and
    returns (state, n_active, edge_pushes) with int64 device scalars.

    ``bf16d`` delivers the increments in bf16 (f32 accumulation); the
    residual removal, and in reverse mode the per-row scale, stay exact in
    the state's dtype."""
    n = kg.n
    counts = torch.zeros(2, dtype=torch.int64, device=state.r.device)
    dense_round_(state, kg.window.deg,
                 [(kg.d_gat, kg.d_off[: n + 1]), (kg.fd_gat, kg.fd_off[: n + 1])], cfg, counts,
                 torch.bfloat16 if bf16d else None)
    return state, counts[0], counts[1]


def rld_expand(
    starts: torch.Tensor, lens: torch.Tensor, ecap: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-balanced run-length decode: enumerate sum(lens) edge lanes (up
    to ``ecap``), mapping lane j -> (owning row t, array position pos,
    valid). Lane j belongs to the row t with cum[t-1] <= j < cum[t]."""
    w = starts.shape[0]
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    j = torch.arange(ecap, dtype=torch.int32, device=starts.device)
    t = torch.searchsorted(cum, j, right=True, out_int32=True).clamp_(max=w - 1)
    valid = j < cum[-1]
    pos = starts[t] + (j - (cum - lens)[t])
    pos = torch.where(valid, pos, 0)
    return t, pos, valid


def make_tiers2(
    n: int,
    cap_snap: int,
    fring: int,
    e_top: int,
    n_tiers: int = 8,
    div: int = 4,
    min_w: int = 1024,
    min_e: int = 2048,
    min_g: int = 512,
) -> tuple[tuple[int, int, int], ...]:
    """Geometric (w, e, g) capacity ladder, smallest first: w sizes the
    candidate rows, e the snapshot-expansion lanes, g the fresh-expansion
    lanes. ``min_*`` are cutoffs, not clamps. Same ladder as
    ``pprx.engine.wl2.make_tiers2`` (copied: importing it loads jax)."""
    e_top = min(e_top, cap_snap)
    g_top = max(min(fring, max(e_top // 4, 1)), 1)
    w_top = min(max(e_top // 2, min_w), n + 1)
    tiers = [(w_top, e_top, g_top)]
    for _ in range(n_tiers - 1):
        w2, e2, g2 = tiers[0]
        nxt = (
            min(max(w2 // div, 1), n + 1),
            max(e2 // div, 1),
            max(g2 // div, 1),
        )
        if nxt[0] < min_w or nxt[1] < min_e or nxt[2] < min_g:
            break
        tiers.insert(0, nxt)
    return tuple(tiers)


def _frontier_stats(state: PprState, kg: KillGraph, cfg: PprConfig, emit_w: int):
    """Next frontier by a full activity rescan (rowpass K3, one read of
    ``r``): (cand2, cn2, fed2, fre2)."""
    n = kg.n
    any2, cn2, fed2, fre2 = frontier_rows(
        state.r[:n], kg.window.deg[:n], kg.row_len[:n], kg.f_len[:n], eps=cfg.eps,
        forward=state.mode == FORWARD)
    return compact(any2, emit_w, n), cn2, fed2, fre2


def sorted_deliver_(
    rin: torch.Tensor, keys: torch.Tensor, table: torch.Tensor,
    rows: torch.Tensor | None = None, row_scale: torch.Tensor | None = None,
    site: str = "other",
) -> torch.Tensor:
    """``rin[keys[j]] += table[rows[j]]`` (``table[j]`` without ``rows``)
    for every lane whose key lies in ``[0, R)``, R = ``rin``'s rows, in
    place: one stable sort of the keys, then the segment sum's gather
    entry over the sorted lanes (no ``[L, S]`` array of sorted rows is
    built), each row's sum times ``row_scale[row]`` where one is given.
    Lanes keyed R or above are dropped. ``site`` names the call site its
    launch is counted under (``segsum.SITES``). Returns the sorted keys."""
    keys_s, order = torch.sort(keys, stable=True)
    gat = order if rows is None else rows[order]
    segsum_gather_add_(rin, table, gat, row_offsets(keys_s, rin.shape[0]), row_scale=row_scale,
                       site=site)
    return keys_s


def _compact_round(
    state: PprState,
    kg: KillGraph,
    cfg: PprConfig,
    cand: torch.Tensor,
    e_cap: int,
    g_cap: int,
    emit_w: int,
    rescan_emit: bool,
):
    """One push round over the compact candidate list ``cand`` (unique live
    rows first, phantom-padded). The caller guarantees that cand holds every
    active row and that their snapshot/fresh edge totals fit e_cap/g_cap.

    Updates ``state.p`` and ``state.r`` in place and returns (state,
    cand2[emit_w], cn2, fed2, fre2, n_active, edge_work), the counts as
    int64 device scalars. The next list is valid iff cn2 <= emit_w.
    """
    dtype = state.r.dtype
    alpha = cfg.alpha
    n = kg.n
    deg = kg.window.deg

    r_c = state.r[cand]  # [w, S], a copy: read before r is updated below
    deg_c = deg[cand]
    if state.mode == FORWARD:
        th = cfg.eps * deg_c.clamp(min=1).to(dtype)
        act_c = r_c.abs() > th[:, None]
    else:
        act_c = r_c.abs() > cfg.eps
    any_c = act_c.any(dim=1)
    n_active = act_c.sum()

    mass = torch.where(act_c, r_c, 0.0)
    dang_c = (deg_c == 0)[:, None]
    state.p.index_add_(0, cand, torch.where(dang_c, mass, alpha * mass))
    if state.mode == FORWARD:
        inv_deg_c = 1.0 / deg_c.clamp(min=1).to(dtype)
        moving = (1.0 - alpha) * mass * inv_deg_c[:, None]
    else:
        beta = (1.0 - alpha) / alpha
        moving = torch.where(dang_c, beta * mass, (1.0 - alpha) * mass)

    live_row = any_c & (cand != n)
    # snapshot expansion (killed slots have nbr == n and are masked below)
    len_s = torch.where(live_row, kg.row_len[cand], 0)
    t1, pos1, val1 = rld_expand(kg.offsets[cand], len_s, e_cap)
    nbr1 = torch.where(val1, kg.nbr[pos1], n)
    c1 = moving[t1] * (val1 & (nbr1 != n)).to(dtype)[:, None]
    # fresh expansion
    len_f = torch.where(live_row, kg.f_len[cand], 0)
    t2, pos2, val2 = rld_expand(kg.f_off[cand], len_f, g_cap)
    nbr2 = torch.where(val2, kg.f_nbr[pos2], n)
    c2 = moving[t2] * (val2 & (nbr2 != n)).to(dtype)[:, None]
    if state.mode != FORWARD:
        # the receiver's 1/d_out per lane: the sorted delivery below carries
        # -mass at cand unscaled in the same vals, so it takes no row scale
        inv_deg = 1.0 / deg.clamp(min=1).to(dtype)
        c1 = c1 * inv_deg[nbr1][:, None]
        c2 = c2 * inv_deg[nbr2][:, None]

    # one delivery: residual removal at cand + delivery at both target lists
    tgt_d = torch.cat([nbr1, nbr2])
    keys = torch.cat([cand, tgt_d])
    vals = torch.cat([-mass, c1, c2])
    if keys.shape[0] >= SORT_DELIVER_MIN:
        # in place into state.r (nothing reads the pre-round r after this),
        # rows [0, n) only: masked lanes and padding all key the phantom row
        sorted_deliver_(state.r[:n], keys, vals)
    else:
        state.r.index_add_(0, keys, vals)

    edge_work = (act_c * (kg.row_len[cand] + kg.f_len[cand])[:, None]).sum()

    if rescan_emit:
        # big rounds: a full activity rescan is cheaper than winner-dedup
        # over O(e_cap) targets, and tightens the counts to the true frontier
        cand2, cn2, fed2, fre2 = _frontier_stats(state, kg, cfg, emit_w)
    else:
        # winner-dedup: the lane that reads back its own id owns the row.
        # amax makes the last lane the winner, as the reference's sequential
        # scatter does on the CPU, and keeps the order fixed on CUDA.
        lane = torch.arange(tgt_d.shape[0], dtype=torch.int32, device=tgt_d.device)
        scratch = torch.zeros(n + 1, dtype=torch.int32, device=tgt_d.device)
        scratch.scatter_reduce_(0, tgt_d.long(), lane, reduce="amax")
        win = (scratch[tgt_d] == lane) & (tgt_d != n)
        cn2 = win.sum()
        cpos = compact(win, emit_w, 0)
        in_r = torch.arange(emit_w, device=cand.device) < cn2
        cand2 = torch.where(in_r, tgt_d[cpos], n)
        fed2 = torch.where(win, kg.row_len[tgt_d], 0).sum()
        fre2 = torch.where(win, kg.f_len[tgt_d], 0).sum()
    return state, cand2, cn2, fed2, fre2, n_active, edge_work


def _fit(cand: torch.Tensor, w: int, n: int) -> torch.Tensor:
    """The first ``w`` candidates, phantom-padded when the list is shorter."""
    if cand.shape[0] >= w:
        return cand[:w]
    pad = torch.full((w - cand.shape[0],), n, dtype=cand.dtype, device=cand.device)
    return torch.cat([cand, pad])


# ---- the rounds as the loop runs them: each reads the candidate list from
# the RoundGraphs buffer and writes its list and counts back there, so that
# on CUDA each is one captured graph

def first_count(kg: KillGraph, g: RoundGraphs) -> None:
    """The seed list's exact counts (cn, fed, fre): its first ``c0n``
    entries that are not phantom."""
    n = kg.n
    cand = g.cand
    live = (cand != n) & (torch.arange(cand.shape[0], device=cand.device) < g.c0n)
    g.put(0, live.sum(), torch.where(live, kg.row_len[cand], 0).sum(),
          torch.where(live, kg.f_len[cand], 0).sum())


def _compact_step(state, kg, cfg, g: RoundGraphs, tier, emit_w: int, rescan: bool) -> None:
    w_i, e_i, g_i = tier
    _, cand2, cn2, fed2, fre2, na, ew = _compact_round(
        state, kg, cfg, g.cand[:w_i], e_i, g_i, emit_w, rescan)
    g.emit(cand2)
    g.put(0, cn2, fed2, fre2, na, ew)


def _scan_step(state, kg, cfg, g: RoundGraphs, bf16d: bool) -> None:
    _, na, ew = dense_round_sorted(state, kg, cfg, bf16d=bf16d)
    g.put(3, na, ew)


def _stats_step(state, kg, cfg, g: RoundGraphs) -> None:
    cand2, cn2, fed2, fre2 = _frontier_stats(state, kg, cfg, kg.n + 1)
    g.emit(cand2)
    g.put(0, cn2, fed2, fre2)


def round_graphs_for(state: PprState, kg: KillGraph, tiers, device,
                     graphs: RoundGraphs | None) -> RoundGraphs:
    """``graphs`` (a new cache where it is ``None``) bound to ``state`` and
    ``kg``, with a candidate buffer as wide as the ladder's top tier."""
    g = RoundGraphs(kg.n, tiers[-1][0], device) if graphs is None else graphs
    if g.cand.shape[0] < tiers[-1][0]:
        raise ValueError(f"a candidate buffer of {g.cand.shape[0]} is narrower than "
                         f"tier {tiers[-1][0]}")
    g.bind(state, kg)
    return g


def graph_key(state: PprState, cfg: PprConfig, bf16d: bool) -> tuple:
    """What a captured program bakes in besides its shapes."""
    return (state.mode, bool(bf16d), cfg.eps, cfg.alpha)


def push_to_convergence_wl2(
    state: PprState,
    kg: KillGraph,
    cfg: PprConfig,
    cand0: torch.Tensor,
    c0n: torch.Tensor | int,
    c0ok: bool,
    tiers: tuple[tuple[int, int, int], ...],
    bf16d: bool = False,
    graphs: RoundGraphs | None = None,
) -> tuple[PprState, PushStats]:
    """Push to convergence; each round runs at the smallest capacity tier
    whose exact frontier counts fit, or as one dense delivery-sorted round
    when nothing fits. ``cand0`` seeds the candidate list (its first ``c0n``
    entries); pass ``c0ok=False`` to start with a scan. Rounds update the
    state's tensors in place and return it.

    ``graphs``: the caller's round buffers and, on CUDA, its captured
    rounds and loops, bound to ``state`` and ``kg`` (a driver keeps one for
    its life); ``None`` makes a new one, which on CUDA captures every branch
    of the loop.
    """
    tiers = tuple(tiers)
    g = round_graphs_for(state, kg, tiers, cand0.device, graphs)
    g.seed(cand0, c0n)
    first = ((*graph_key(state, cfg, bf16d), "first"), lambda: first_count(kg, g))
    return state, converge_wl2(state, kg, cfg, c0ok, tiers, g, bf16d, prologue=first)


def loop_table(tiers: tuple[tuple[int, int, int], ...], n: int) -> Table:
    """The loop's table of a tier ladder: each tier's emitted list width
    (its next tier's; ``n + 1`` where the tier reseeds by a rescan) and the
    stats-skip threshold."""
    _, e_top, g_top = tiers[-1]
    emit = tuple(_emit(tiers, i, n)[1] for i in range(len(tiers)))
    return Table(tiers=tuple(tiers), emit=emit, heavy_ew=STATS_GUARD * (e_top + g_top))


def _emit(tiers, i: int, n: int) -> tuple[bool, int]:
    """Tier ``i``'s (rescan, emitted list width): big tiers reseed by
    rescan (cheaper than slot-dedup there) and emit a list of ``n + 1``."""
    w_i, e_i, g_i = tiers[i]
    rescan = (e_i + g_i) > max(n // 2, 4096)
    return rescan, n + 1 if rescan else tiers[min(i + 1, len(tiers) - 1)][0]


def converge_wl2(
    state: PprState,
    kg: KillGraph,
    cfg: PprConfig,
    c0ok: bool,
    tiers: tuple[tuple[int, int, int], ...],
    g: RoundGraphs,
    bf16d: bool = False,
    prologue: tuple | None = None,
) -> PushStats:
    """The convergence loop of ``push_to_convergence_wl2`` from a candidate
    list and its exact counts in ``g`` (``cand``, ``counts[:3]``), which
    ``prologue`` (a graph key and its step: a slide's, or a seed's first
    count) writes where it is given, as the loop's first step.

    The round schedule is the reference's (``pprx_torch.engine.loop``'s
    steps):
    on CUDA the whole loop is one launch of a conditional graph and one
    read (``RoundGraphs.loop``), on the CPU a host loop of the same
    branches with a read of the counts a round (and a second after a light
    scan's stats), each counted in ``PushStats.syncs``."""
    n = kg.n
    tiers = tuple(tiers)
    key = graph_key(state, cfg, bf16d)

    def tier(i: int):
        rescan, emit_w = _emit(tiers, i, n)
        return ((*key, "compact", tiers[i], emit_w, rescan),
                lambda: _compact_step(state, kg, cfg, g, tiers[i], emit_w, rescan))

    branches = [tier(i) for i in range(len(tiers))] + [
        ((*key, "scan"), lambda: _scan_step(state, kg, cfg, g, bf16d)),
        ((*key, "stats"), lambda: _stats_step(state, kg, cfg, g)),
    ]
    values, reads = g.loop(prologue, branches, loop_table(tiers, n), c0ok, cfg.max_rounds)
    return PushStats(
        rounds=values[loop.ROUNDS], pushes=values[loop.PUSHES],
        edge_pushes=values[loop.EDGE_PUSHES], wl_rounds=values[loop.WL_ROUNDS],
        scans_cand=values[loop.SCANS_CAND], scans_fed=values[loop.SCANS_FED],
        scans_liv=values[loop.SCANS_LIV], syncs=reads, stats_reads=values[loop.STATS_READS])
