"""Row-sharded dense push engine (port of ``pprx.dist.sharded``).

What the engine does is the reference's: vertices are row-sharded over the
mesh's ``rows`` (each shard owns a block of ``n_local`` vertices, their p/r
rows, out-degrees and every window edge whose gather endpoint it owns:
src in forward mode, dst in reverse), queries are split over ``srcs``. A
push round gathers and scales over the owned edges into a ``[n_pad, S]``
delta and delivers it with one reduce-scatter along the row group
(``exchange="dense_rs"``), or ships only the delta's nonzero rows in
per-destination buckets of ``ccap`` over one all-to-all, carrying the rest
to the next round (``exchange="a2a"``). Corrections and the reverse row
sums ride the same machinery. Each shard's edge buffer has ``ecap`` slots
and a trash slot at ``ecap`` that padding targets.

How the port differs:

- One process per shard holds its block (``p``, ``r`` ``[n_local, S_loc]``,
  ``deg`` ``[n_local]``, the edge buffers ``[ecap+1]``); the reference's
  ``shard_map`` over global arrays becomes SPMD code on the local block, and
  its collectives the wrappers of ``pprx_torch.dist.mesh``. At ``K = 1`` the
  row collectives are absent.
- In a world of one shard under ``dense_rs`` (what
  ``ShardedStreamDriver`` builds at a 1x1 mesh) the ``lax.while_loop`` is
  the dense engine's loop (``pprx_torch.engine.push``): rounds of
  ``dense_round_`` (K2, then K1's gather entry) over ``slot_view``, the
  window's live slots in delivery order, under K4's dense rule
  (``loop.DENSE_TABLE``; nothing is pending there), its first count K3.
  On the card a push, and a slide's corrections, window write and view
  rebuild, are one launch of a conditional CUDA graph and one read of its
  carry (``RoundGraphs.loop``); on the CPU the same functions run under
  ``RoundGraphs.host_loop``. No ``[W, S]`` temporary is built: a reverse
  slide's row sums go through K1 over the view too. The blocks ``p``,
  ``r``, ``deg``, the window and the slide's batch rows are then the
  tensors the loop holds, updated in place; the view is rebuilt into its
  tensors after every window write.
- Elsewhere (more than one shard, or ``exchange="a2a"``) a round holds
  collectives or a capped carry, and the ``lax.while_loop`` is a host loop
  with one stats reduction a round (``gather_stats`` over the world: the
  active count, the edge pushes and whether a carry is pending), whose
  world sums every rank reads alike.
- The window buffers are updated in place: callers hand the returned
  tensors on and keep no others.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pprx_torch.config import PprConfig
from pprx_torch.device import resolve_device
from pprx_torch.dist.mesh import RowMesh, all_to_all_rows, gather_stats, reduce_scatter_rows
from pprx_torch.engine import loop
from pprx_torch.engine.graphs import RoundGraphs, copy_into_
from pprx_torch.engine.push import dense_round_, first_count
from pprx_torch.engine.segsum import row_offsets, segsum_gather_add_, sorted_deliver_
from pprx_torch.engine.state import FORWARD, PprState
from pprx_torch.graph.dynamic import DeliveryView


class EdgePartition(NamedTuple):
    """Host-built edge arrays, concatenated per shard (shard-major, stride
    ecap+1 with the trash slot last).

    gather_local: LOCAL vertex index of the gather endpoint (src in forward
        mode, dst in reverse mode) within its owner shard.
    other_global: GLOBAL index of the scatter endpoint.
    valid: int32 1/0.
    counts: [n_rows] live-edge count per shard (host bookkeeping).
    """

    gather_local: np.ndarray
    other_global: np.ndarray
    valid: np.ndarray
    counts: np.ndarray


def partition_edges(
    src: np.ndarray, dst: np.ndarray, n_local: int, n_rows: int, ecap: int, by: str
) -> EdgePartition:
    """Group edges by the owner shard of their gather endpoint. Within each
    shard, edges occupy slots [0, count); padding (and the trash slot)
    carry valid=0. The reference's NumPy, as it is."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    key = src if by == "src" else dst
    other = dst if by == "src" else src
    owner = key // n_local
    stride = ecap + 1
    gl = np.zeros(n_rows * stride, np.int32)
    og = np.zeros(n_rows * stride, np.int32)
    va = np.zeros(n_rows * stride, np.int32)
    counts = np.zeros(n_rows, np.int64)
    for k in range(n_rows):
        sel = owner == k
        cnt = int(sel.sum())
        if cnt > ecap:
            raise ValueError(f"shard {k} owns {cnt} edges > per-shard capacity {ecap}")
        base = k * stride
        gl[base : base + cnt] = key[sel] - k * n_local
        og[base : base + cnt] = other[sel]
        va[base : base + cnt] = 1
        counts[k] = cnt
    return EdgePartition(gl, og, va, counts)


def forward_corrections_pairs(p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v,
                              alpha: float, n_pad: int):
    """Block-local forward corrections (the invariant-exact rules of
    ``pprx_torch.engine.update``): the delete phase at the old degrees, then
    the insert phase at the post-delete degrees. Returns (p, r, ids, vals,
    deg2): the cross-shard delivery as per-edge (global id, mass) pairs,
    invalid batch rows with id ``n_pad`` and zero mass."""
    dtype = p.dtype
    beta = (1.0 - alpha) / alpha
    nloc = deg.shape[0]
    d0f = deg.clamp(min=1).to(dtype)
    del_vf = del_v.to(dtype)[:, None]
    ins_vf = ins_v.to(dtype)[:, None]

    # delete phase (old p, old degrees)
    k_del = torch.zeros(nloc, dtype=deg.dtype, device=deg.device).index_add_(0, del_u, del_v)
    per_edge_del = beta * p[del_u] / d0f[del_u, None] * del_vf
    d1 = deg - k_del
    touched = k_del > 0
    full = touched & (d1 == 0)
    k_f = k_del.to(dtype)
    scale_p = torch.where(touched, d1.clamp(min=1).to(dtype) / d0f, 1.0)
    num = torch.where(full, k_f - alpha, k_f)
    r = r + torch.where(touched, num / (alpha * d0f), 0.0)[:, None] * p
    p = p * scale_p[:, None]

    # insert phase (post-delete p and degrees)
    d1f = d1.clamp(min=1).to(dtype)
    k_ins = torch.zeros(nloc, dtype=deg.dtype, device=deg.device).index_add_(0, ins_u, ins_v)
    per_edge_ins = beta * p[ins_u] / d1f[ins_u, None] * ins_vf
    touched = k_ins > 0
    from_dang = touched & (d1 == 0)
    k_f = k_ins.to(dtype)
    scale_p = torch.where(touched, torch.where(from_dang, k_f, (d1 + k_ins).to(dtype) / d1f), 1.0)
    num = torch.where(from_dang, k_f - alpha, k_f)
    denom = torch.where(from_dang, alpha, alpha * d1f)
    r = r - torch.where(touched, num / denom, 0.0)[:, None] * p
    p = p * scale_p[:, None]
    ids = torch.cat([torch.where(del_v > 0, del_w, n_pad), torch.where(ins_v > 0, ins_w, n_pad)])
    vals = torch.cat([-per_edge_del, per_edge_ins])
    return p, r, ids.to(torch.int32), vals, d1 + k_ins


def forward_corrections(p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v,
                        alpha: float, n_pad: int):
    """``forward_corrections_pairs`` with the cross-shard delivery summed
    into the ``[n_pad, S]`` ``acc`` the caller reduce-scatters. Returns
    (p, r, acc, deg2)."""
    p, r, ids, vals, deg2 = forward_corrections_pairs(
        p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v, alpha, n_pad)
    acc = torch.zeros((n_pad, p.shape[1]), dtype=p.dtype, device=p.device)
    acc.index_add_(0, ids.clamp(0, n_pad - 1), vals)
    return p, r, acc, deg2


def reverse_apply(p, r, deg, del_u, del_v, ins_u, ins_v, s_old, s_new, alpha: float):
    """Tail of the reverse corrections: given this shard's old and new
    out-row sums of p, ``r += beta * ((P'p) - (Pp))`` and the degree update.
    Returns (r, d_new)."""
    dtype = p.dtype
    beta = (1.0 - alpha) / alpha
    nloc = deg.shape[0]
    zeros = torch.zeros(nloc, dtype=deg.dtype, device=deg.device)
    d_new = deg - zeros.index_add(0, del_u, del_v) + zeros.index_add(0, ins_u, ins_v)
    pp_old = torch.where((deg == 0)[:, None], p, s_old / deg.clamp(min=1).to(dtype)[:, None])
    pp_new = torch.where((d_new == 0)[:, None], p, s_new / d_new.clamp(min=1).to(dtype)[:, None])
    return r + beta * (pp_new - pp_old), d_new


def check_slot_values(values, what: str) -> None:
    """Window slots are dead (0) or live (1): the delivery through the slot
    view (K1) takes no per-edge weight, so any other value is refused, not
    reweighted. ``values``: a NumPy array or a tensor (read here)."""
    v = torch.as_tensor(values)
    if bool(((v != 0) & (v != 1)).any()):
        raise ValueError(f"{what}: a slot's value must be 0 or 1, found "
                         f"{sorted(set(v.unique().tolist()) - {0, 1})[:4]}")


def slot_view(egl, eog, eva, n: int) -> DeliveryView:
    """The window's live slots (``eva > 0``) in delivery order, in a world
    of one shard: a stable sort by the row each delivers to, ``eog`` (the
    destination in forward mode, the source in reverse), so that a row's
    edges keep their slot order. ``gat`` is each sorted slot's ``egl`` (the
    row of the pushed table it reads), ``off`` runs over rows ``[0, n]``.
    Dead, cleared and trash slots sort past ``off[n]`` and gather row
    ``n``, the zero phantom row: they deliver nothing, and a reverse
    round's count of active pairs over ``gat`` finds none there."""
    live = eva > 0
    key_s, order = torch.sort(torch.where(live, eog, n), stable=True)
    return DeliveryView(gat=torch.where(live, egl, n)[order].to(torch.int32),
                        off=row_offsets(key_s, n))


def write_window_(egl, eog, eva, clear_slots, write_slots, gat, sca, val) -> None:
    """The slide's window-buffer mutation, in place: expiring slots go
    invalid, then the new edges take their slots (padding targets the trash
    slot, which never stays live). No op takes a value from the host, so a
    CUDA graph captures it."""
    eva.index_fill_(0, clear_slots.long(), 0)
    egl[write_slots] = gat
    eog[write_slots] = sca
    eva[write_slots] = val
    eva[-1:].fill_(0)


def reverse_corrections(p, r, deg, egl, eog, eva, del_u, del_v, ins_u, ins_v,
                        clear_slots, write_slots, write_dl, write_sg, write_v,
                        alpha: float, n_pad: int, row_group):
    """Block-local reverse corrections and the window mutation: the row sums
    of p before and after the slide come from ONE stacked reduce-scatter of
    ``[n_pad, 2S]`` along the row group. Returns (p, r, d_new); ``egl``,
    ``eog``, ``eva`` are updated in place."""
    dtype = p.dtype
    s = p.shape[1]
    acc = torch.zeros((n_pad, 2 * s), dtype=dtype, device=p.device)
    acc[:, :s].index_add_(0, eog, p[egl] * eva.to(dtype)[:, None])
    old_v = eva[clear_slots].to(dtype)[:, None]
    acc[:, s:].index_add_(0, eog[clear_slots], -p[egl[clear_slots]] * old_v)
    acc[:, s:].index_add_(0, write_sg, p[write_dl] * write_v.to(dtype)[:, None])
    red = reduce_scatter_rows(acc, row_group)
    s_old = red[:, :s]
    s_new = s_old + red[:, s:]
    write_window_(egl, eog, eva, clear_slots, write_slots, write_dl, write_sg, write_v)
    r, d_new = reverse_apply(p, r, deg, del_u, del_v, ins_u, ins_v, s_old, s_new, alpha)
    return p, r, d_new


def compact_rows(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """int64 ``[K, size]``: per row of a 2-D ``mask``, the positions of its
    True entries in order, cut to ``size`` and padded with ``fill`` (a
    vectorised ``jnp.nonzero(m, size=, fill_value=)`` per row, no sync)."""
    k, m = mask.shape
    slot = torch.cumsum(mask, 1) - 1
    slot = torch.where(mask & (slot < size), slot, size)
    out = torch.full((k, size + 1), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(1, slot, torch.arange(m, device=mask.device).expand(k, m))
    return out[:, :size]


class ShardedEngine:
    """The dense sharded engine for one (mesh, shapes, cfg, mode): every
    method takes and returns this shard's blocks. ``init_state`` and
    ``device_graph`` build them; ``slide`` takes batches the host driver
    (``pprx_torch.dist.stream.ShardedStreamDriver``) packed per shard to
    ``bcap`` with trash-slot targets. ``device=None`` is the card."""

    def __init__(
        self,
        mesh: RowMesh,
        n: int,
        s_total: int,
        ecap: int,
        bcap: int,
        cfg: PprConfig,
        mode: int = FORWARD,
        dtype: torch.dtype = torch.float32,
        exchange: str = "dense_rs",
        ccap: int = 1024,
        device: torch.device | str | None = None,
    ):
        """exchange: 'dense_rs' (reduce-scatter of the dense delta, exact,
        O(n_pad * S) traffic a round) or 'a2a' (bucketed all-to-all of the
        nonzero rows; rows beyond the per-pair capacity ``ccap`` stay in a
        local carry and ship next round)."""
        if s_total % mesh.n_srcs != 0:
            raise ValueError(f"s_total {s_total} not divisible by srcs axis {mesh.n_srcs}")
        if exchange not in ("dense_rs", "a2a"):
            raise ValueError(f"unknown exchange mode {exchange!r}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.n = n
        self.n_rows = mesh.n_rows
        self.n_srcs = mesh.n_srcs
        self.s_total = s_total
        self.s_loc = s_total // mesh.n_srcs
        self.n_local = math.ceil((n + 1) / self.n_rows)
        self.n_pad = self.n_local * self.n_rows
        self.ecap = ecap
        self.slot_stride = ecap + 1  # + trash slot
        self.trash_slot = ecap
        self.bcap = bcap
        self.cfg = cfg
        self.mode = mode
        self.dtype = dtype
        self.exchange = exchange
        self.ccap = min(ccap, self.n_local)
        self.row0 = mesh.row * self.n_local  # first global row of this shard
        self.col0 = mesh.src * self.s_loc  # first global query column
        # the device loop's buffers and, on the card, its captured graphs,
        # and the window's slot view: made at the first push or slide
        self.round_graphs: RoundGraphs | None = None
        self._view: DeliveryView | None = None

    @property
    def on_graphs(self) -> bool:
        """Whether the loop runs as ``RoundGraphs.loop`` (one conditional
        graph on the card, its host loop on the CPU): in a world of one
        shard under ``dense_rs``. Elsewhere a round holds collectives or a
        capped carry, and the loop is a host loop with a stats reduction a
        round (``_host_push``)."""
        return self.mesh.size == 1 and self.exchange == "dense_rs"

    # -- the reductions every rank reads alike --------------------------
    def _world(self, values) -> np.ndarray:
        return gather_stats(values, self.mesh.world, self.device)

    def _active(self, r: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
        if self.mode == FORWARD:
            return r.abs() > (self.cfg.eps * deg.clamp(min=1).to(r.dtype))[:, None]
        return r.abs() > self.cfg.eps

    # ------------------------------------------------------------------
    def init_state(self, queries) -> tuple[torch.Tensor, torch.Tensor]:
        """This shard's ``[n_local, S_loc]`` p/r blocks, r one-hot at the
        query vertices it owns in the query columns it holds."""
        q = np.asarray(list(queries), np.int64)
        p = torch.zeros((self.n_local, self.s_loc), dtype=self.dtype, device=self.device)
        r = torch.zeros_like(p)
        cols = np.arange(self.col0, self.col0 + self.s_loc)
        mine = (q[cols] >= self.row0) & (q[cols] < self.row0 + self.n_local)
        rows = torch.from_numpy(q[cols][mine] - self.row0).to(self.device)
        r[rows, torch.from_numpy(np.flatnonzero(mine)).to(self.device)] = 1.0
        return p, r

    def device_graph(self, src, dst):
        """Partition the window's edges and the degrees; this shard's part.
        Returns (deg, gather_local, other_global, valid, host_counts), the
        counts of every shard."""
        by = "src" if self.mode == FORWARD else "dst"
        part = partition_edges(src, dst, self.n_local, self.n_rows, self.ecap, by)
        check_slot_values(part.valid, "the window")
        deg = np.bincount(np.asarray(src, np.int64), minlength=self.n_pad)[: self.n_pad]
        lo, stride = self.mesh.row, self.slot_stride

        def mine(a):
            return torch.from_numpy(np.ascontiguousarray(
                a[lo * stride:(lo + 1) * stride], np.int32)).to(self.device)

        deg_loc = deg[self.row0:self.row0 + self.n_local].astype(np.int32)
        return (torch.from_numpy(deg_loc).to(self.device), mine(part.gather_local),
                mine(part.other_global), mine(part.valid), part.counts)

    # ------------------------------------------------------------------
    def _exchange_a2a(self, acc: torch.Tensor, carry: torch.Tensor):
        """Ship only the nonzero (local row, mass[S]) rows per shard pair,
        ``ccap`` of them at most; the rest wait in the carry."""
        k, nl, s, ccap = self.n_rows, self.n_local, acc.shape[1], self.ccap
        blocks = (acc + carry).reshape(k, nl, s)
        rownz = blocks.abs().sum(dim=2) > 0
        ids = compact_rows(rownz, ccap, 0)
        valid = torch.arange(ccap, device=acc.device)[None, :] < rownz.sum(dim=1)[:, None]
        masses = torch.gather(blocks, 1, ids[:, :, None].expand(k, ccap, s))
        masses = masses * valid[:, :, None].to(acc.dtype)
        sent = torch.zeros((k, nl), dtype=acc.dtype, device=acc.device)
        sent.scatter_reduce_(1, ids, valid.to(acc.dtype), reduce="amax")
        carry2 = (blocks * (1.0 - sent[:, :, None])).reshape(self.n_pad, s)
        group = self.mesh.row_group
        recv_ids = all_to_all_rows(ids, group)
        recv_mass = all_to_all_rows(masses, group)
        delta = torch.zeros((nl, s), dtype=acc.dtype, device=acc.device)
        delta.index_add_(0, recv_ids.reshape(-1), recv_mass.reshape(-1, s))
        return delta, carry2

    def push(self, p, r, deg, egl, eog, eva):
        """Push to convergence on this block: (p, r, rounds, pushes,
        edge_pushes), the counts summed over the world. In a world of one
        shard under ``dense_rs`` (``on_graphs``) ``p`` and ``r`` are
        updated in place and come back."""
        if self.on_graphs:
            self._dense_graphs(p, r, deg, egl, eog, eva)
            return self._dense_loop(p, r, deg, "first", lambda: None)
        return self._host_push(p, r, deg, egl, eog, eva)

    # -- the device loop (a world of one shard under dense_rs) -----------
    def _key(self, *parts) -> tuple:
        """A captured graph's key: what it bakes in besides its shapes."""
        return ("sharded_dense", self.mode, self.cfg.eps, self.cfg.alpha, *parts)

    def _dense_graphs(self, p, r, deg, egl, eog, eva) -> RoundGraphs:
        """The loop's buffers, made at the first push or slide: its round
        graphs and the window's slot view (one read there: the window's
        values are 0 or 1). The blocks and the window are held from then on:
        a captured graph reads them where they lie."""
        if self.round_graphs is None:
            check_slot_values(eva, "the window")
            self.round_graphs = RoundGraphs(self.n_local - 1, 1, self.device)
            self._view = slot_view(egl, eog, eva, self.n_local - 1)
        self.round_graphs.hold("the engine's blocks and window", p, r, deg, egl, eog, eva)
        return self.round_graphs

    def _dense_loop(self, p, r, deg, key: str, before):
        """The dense loop as ``RoundGraphs.loop`` under ``loop.DENSE_TABLE``:
        ``before()`` (a slide's corrections, window write and view rebuild)
        and the first count as its prologue, then rounds of
        ``dense_round_`` over the slot view. ``n_local`` is ``n + 1`` here:
        the last row is the phantom row, which the round keeps zero."""
        g, cfg, view = self.round_graphs, self.cfg, self._view
        state = PprState(p=p, r=r, mode=self.mode)

        def first():
            before()
            first_count(state, deg, cfg, g.counts)

        rnd = (self._key("round"),
               lambda: dense_round_(state, deg, [(view.gat, view.off)], cfg, g.counts[3:5]))
        values, _ = g.loop((self._key(key), first), [rnd], loop.DENSE_TABLE, True, cfg.max_rounds)
        return p, r, values[loop.ROUNDS], values[loop.PUSHES], values[loop.EDGE_PUSHES]

    def _rebuild_view(self, egl, eog, eva) -> None:
        copy_into_(self._view, slot_view(egl, eog, eva, self.n_local - 1))

    def _dense_forward_prologue(self, p, r, deg, egl, eog, eva, del_u, del_w, del_v, ins_u,
                                ins_w, ins_v, clear_slots, write_slots) -> None:
        """A forward slide up to its loop, in place: the corrections, whose
        cross-row pairs run straight into ``r`` (no wire) through K1 in a
        stable sort's order (deterministic, where ``index_add_`` runs on
        atomics; invalid pairs, id ``n_pad``, add nothing), the window
        write and the view's rebuild."""
        p2, r2, ids, vals, deg2 = forward_corrections_pairs(
            p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v, self.cfg.alpha, self.n_pad)
        sorted_deliver_(r2[:self.n_local - 1], ids, vals, site="corrections")
        p.copy_(p2)
        r.copy_(r2)
        deg.copy_(deg2)
        write_window_(egl, eog, eva, clear_slots, write_slots, ins_u, ins_w, ins_v)
        self._rebuild_view(egl, eog, eva)

    def _dense_reverse_prologue(self, p, r, deg, egl, eog, eva, del_u, del_v, ins_u, ins_v,
                                clear_slots, write_slots, write_dl, write_sg, write_v) -> None:
        """A reverse slide up to its loop, in place: the live window's row
        sums of ``p`` through the slot view (K1) and the batch's delta
        beside them (K1 in a stable sort's order: deterministic), the
        window write, the corrections and the view's rebuild."""
        dtype, n = p.dtype, self.n_local - 1
        view = self._view
        s_old = torch.zeros_like(p)
        segsum_gather_add_(s_old[:n], p, view.gat, view.off)
        s_new = s_old.clone()
        old_v = eva[clear_slots].to(dtype)[:, None]
        delta = torch.cat([-p[egl[clear_slots]] * old_v, p[write_dl] * write_v.to(dtype)[:, None]])
        sorted_deliver_(s_new[:n], torch.cat([eog[clear_slots], write_sg]), delta,
                        site="corrections")
        write_window_(egl, eog, eva, clear_slots, write_slots, write_dl, write_sg, write_v)
        r2, d_new = reverse_apply(p, r, deg, del_u, del_v, ins_u, ins_v, s_old, s_new,
                                  self.cfg.alpha)
        r.copy_(r2)
        deg.copy_(d_new)
        self._rebuild_view(egl, eog, eva)

    def _host_push(self, p, r, deg, egl, eog, eva):
        """The host loop: a stats reduction over the world a round."""
        cfg, dtype = self.cfg, self.dtype
        alpha = cfg.alpha
        inv_deg = (1.0 / deg.clamp(min=1).to(dtype))[:, None]
        dangling = (deg == 0)[:, None]
        live = (eva > 0)[:, None]
        evaf = eva.to(dtype)[:, None]
        carry = None
        if self.exchange == "a2a":
            carry = torch.zeros((self.n_pad, p.shape[1]), dtype=dtype, device=p.device)
        work = int(self._world([self._active(r, deg).sum()]).sum())
        rounds = pushes = epushes = 0
        while work > 0 and rounds < cfg.max_rounds:
            act = self._active(r, deg)
            mass = torch.where(act, r, 0.0)
            p = p + torch.where(dangling, mass, alpha * mass)
            r = r - mass
            if self.mode == FORWARD:
                moving = (1.0 - alpha) * mass * inv_deg
            else:
                beta = (1.0 - alpha) / alpha
                moving = torch.where(dangling, beta * mass, (1.0 - alpha) * mass)
            acc = torch.zeros((self.n_pad, p.shape[1]), dtype=dtype, device=p.device)
            acc.index_add_(0, eog, moving[egl] * evaf)
            if carry is not None:
                delta, carry = self._exchange_a2a(acc, carry)
                pend = (carry != 0).any()
            else:
                delta, pend = reduce_scatter_rows(acc, self.mesh.row_group), 0
            r = r + (delta if self.mode == FORWARD else delta * inv_deg)
            ep = (act[egl] & live).sum()
            na, ep, pend_any = self._world([act.sum(), ep, pend]).sum(axis=0)
            work = int(na) + int(pend_any > 0)  # a pending carry forces another round
            rounds += 1
            pushes += int(na)
            epushes += int(ep)
        return p, r, rounds, pushes, epushes

    def slide(self, p, r, deg, egl, eog, eva, *batches):
        """One window slide; returns (p, r, rounds, pushes, edge_pushes,
        deg2, egl, eog, eva), the window buffers updated in place.

        Forward batches (by src owner; entry i of the insert batch goes to
        local slot ``write_slots[i]``, the trash slot for padding):
        ``del_u, del_w, del_v, ins_u, ins_w, ins_v, clear_slots,
        write_slots``. Reverse: ``del_u, del_v, ins_u, ins_v`` by src owner
        (degree updates), ``clear_slots, write_slots, write_dl, write_sg,
        write_v`` by dst owner (new edges: dst local, src global).

        In a world of one shard under ``dense_rs`` the corrections, the
        window write, the view's rebuild and the loop are one loop graph
        launch and one read on the card; ``p``, ``r`` and ``deg`` are
        updated in place and come back, and the batch rows must be the
        tensors of the first slide (views of the driver's one upload)."""
        alpha, n_pad = self.cfg.alpha, self.n_pad
        if self.on_graphs:
            g = self._dense_graphs(p, r, deg, egl, eog, eva)
            g.hold("a slide's batch rows", batches)
            val = batches[5] if self.mode == FORWARD else batches[8]
            if val.device.type == "cpu":  # on the card the driver writes ones
                check_slot_values(val, "a slide's new edges")
            prologue = (self._dense_forward_prologue if self.mode == FORWARD
                        else self._dense_reverse_prologue)
            p, r, rounds, pushes, epushes = self._dense_loop(
                p, r, deg, "slide", lambda: prologue(p, r, deg, egl, eog, eva, *batches))
            return p, r, rounds, pushes, epushes, deg, egl, eog, eva
        if self.mode == FORWARD:
            del_u, del_w, del_v, ins_u, ins_w, ins_v, clear_slots, write_slots = batches
            p, r, acc, deg2 = forward_corrections(
                p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v, alpha, n_pad)
            r = r + reduce_scatter_rows(acc, self.mesh.row_group)
            write_window_(egl, eog, eva, clear_slots, write_slots, ins_u, ins_w, ins_v)
        else:
            (del_u, del_v, ins_u, ins_v, clear_slots, write_slots,
             write_dl, write_sg, write_v) = batches
            p, r, deg2 = reverse_corrections(
                p, r, deg, egl, eog, eva, del_u, del_v, ins_u, ins_v, clear_slots,
                write_slots, write_dl, write_sg, write_v, alpha, n_pad, self.mesh.row_group)
        p, r, rounds, pushes, epushes = self.push(p, r, deg2, egl, eog, eva)
        return p, r, rounds, pushes, epushes, deg2, egl, eog, eva
