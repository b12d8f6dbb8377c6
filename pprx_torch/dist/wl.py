"""Sharded compact-frontier push engine (port of ``pprx.dist.wl``).

What the engine does is the reference's: the wl2 compact-frontier machinery
runs per shard. Each shard keeps a kill-in-place CSR snapshot of its window
edges (gather endpoint local, scatter endpoint global; expired slots point
at the phantom ``n_pad``) and a fresh mini-CSR re-sorted each slide. A round
pushes only the shard's candidate rows (unique and ascending), expands them
with the edge-balanced run-length decode, deduplicates the targets and
ships per-destination buckets of (local id, mass) over one all-to-all along
the row group, with per-tier quotas; what overflows waits in a carry, and a
pending carry forces a dense round (the whole window in delivery order,
then the carry, one reduce-scatter and a rescan). Tier and dense choices
are the same on every rank of a row group: they come from the group's
maxima of the frontier counts (the uniform-branch rule); groups of
different ``srcs`` decide alone. At ``K = 1`` every collective is absent:
compact rounds deliver their deduplicated emission straight into ``r``, and
the carry is a dummy.

How the port differs:

- In a world of one shard (a 1x1 mesh) the convergence loop is the
  reference's ``lax.while_loop``: each round is a branch (a tier's compact
  round, the dense round's scan, its stats; for ``proportional`` a tier's
  compact round, the drain, the rescan) chosen by K4's steps under the
  sharded rule, or the proportional one (``pprx_torch.engine.loop``), and
  on the card a slide's prologue and its loop are one launch of a
  conditional CUDA graph with one read of the carry (``RoundGraphs.loop``);
  on the CPU the same branches run under ``RoundGraphs.host_loop``. The
  engine's blocks, snapshot, ring and pack, and the proportional loop's
  carry, are then fixed buffers that every slide and rebuild writes in
  place.
- Elsewhere, one process per shard, a host loop with one stats reduction a
  round (``mesh.gather_stats`` over the world: the next decision's counts,
  the pending carry, the active pairs and edge pushes); every rank reads
  the same world sums and its row group's maxima from it.
- The delivery views keep per-row edge ranges instead of the TPU kernel's
  tile offsets: ``*_loff`` over the shard's rows for the local segment,
  ``*_roff`` over the global rows for the remote one (K > 1; it starts past
  the local segment). Both segments go through ``segsum_gather_add_``: the
  kernel reads exact edge ranges, so the remote accumulator has none of
  the TPU kernel's boundary-chunk double count and rides it too.
- The K = 1 compact round is the single-device port's sorted delivery
  (``pprx_torch.engine.wl2.sorted_deliver_``), and ``sorted_bucket_rows``'
  group sum (the reference's sorted ``.at[sidx].add``) is the segment sum's
  gather entry over the sorted lanes.
- A dense round's elementwise work (the activity test, ``p`` and ``r`` in
  place, the moved mass written into the delivery table, the row counts)
  is one pass over the state, and so is its rescan
  (``pprx_torch.engine.rowpass``: Hopper kernels on CUDA tensors, where XLA
  fused the same ops on the TPU).
- The dense round's stats-skip is a branch: the rescan runs only for a
  light round (read back first by the host loop at K > 1). Its threshold is
  ``STATS_GUARD * (e_top + g_top)``, the single-device form, where the
  reference leaves out the fresh cap.
- The forward slide's slot ring keeps its arrays on the device and its
  three counters on the host, which knows each slide's counts already. The
  slide's one transfer (its *pack*) is this shard's fresh edges, then the
  slide's scalars (``slide_tail``): the counts, the ring's counters and
  the fresh ring's fill, which the device reads from there and the host
  keeps its own copies of. The reverse slide's pack is its six batch rows
  (the reference's ``PACK_R`` words), then its counts and the fill.
- The reverse slide's row-sum sweep runs through ``segsum_gather_add_``
  over the same local-first views as the dense rounds (the reference keeps
  it on a sorted scatter; its anomaly (ii)). The view ranges are exact, so
  the local and the remote segments each add every live edge once.

``proportional=True`` is the reference's memory-proportional loop (``wlp``):
no ``[n_pad, S]`` array on the push path. Every round emits through
``sorted_bucket_rows``; what overflows a quota waits in a compact sorted
carry of ``ccarry`` (id, mass) pairs that drain rounds ship; a frontier the
ladder cannot hold runs the all-covering top tier seeded with every local
row (a rescan). Each branch is chosen from the row group's maxima, as in
the wl loop, and a drain round's all-to-all is joined by every rank of the
group, its own carry empty or not. The forward slide's corrections ride
one bucketed all-to-all too, their overflow seeding the loop's carry; the
reverse slide keeps its one ``[n_pad, 2S]`` reduce-scatter (the
reference's documented gap).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pprx_torch.config import PprConfig
from pprx_torch.dist.mesh import RowMesh, all_to_all_rows, gather_stats, reduce_scatter_rows
from pprx_torch.engine import loop
from pprx_torch.engine.graphs import RoundGraphs
from pprx_torch.dist.sharded import (
    ShardedEngine,
    forward_corrections,
    forward_corrections_pairs,
    reverse_apply,
    write_window_,
)
from pprx_torch.engine.rowpass import frontier_rows, scan_pass_
from pprx_torch.engine.segsum import row_offsets, segsum_gather_add_
from pprx_torch.engine.state import FORWARD
from pprx_torch.engine.wl2 import (
    _BIG,
    STATS_GUARD,
    _inverse_perm,
    compact,
    rld_expand,
    sorted_deliver_,
)


def make_wl_tiers(
    n_local: int,
    ecap: int,
    fring: int,
    e_top: int,
    w_top: int,
    n_tiers: int = 4,
    div: int = 4,
    min_w: int = 512,
    min_e: int = 1024,
    min_g: int = 256,
) -> tuple[tuple[int, int, int], ...]:
    """Per-shard geometric (w, e, g) capacity ladder, smallest first: w the
    candidate rows, e the snapshot-expansion lanes, g the fresh ones;
    ``min_*`` are cutoffs, not clamps. The reference's ladder."""
    e_top = max(min(e_top, ecap), 1)
    g_top = max(min(fring, max(e_top // 4, 1)), 1)
    w_top = min(max(w_top, min_w), n_local + 1)
    tiers = [(w_top, e_top, g_top)]
    for _ in range(n_tiers - 1):
        w2, e2, g2 = tiers[0]
        nxt = (
            min(max(w2 // div, 1), n_local + 1),
            max(e2 // div, 1),
            max(g2 // div, 1),
        )
        if nxt[0] < min_w or nxt[1] < min_e or nxt[2] < min_g:
            break
        tiers.insert(0, nxt)
    return tuple(tiers)


# K > 1 compact rounds dedup and bucket by sort from this many emission
# lanes on (tuned on the TPU, kept for parity)
SORT_BUCKET_MIN = 65_536

# The per-shard snapshot's keys. The reference's d_sca/d_toff/d_toffl (and
# fd_*) are the per-row ranges d_loff/d_roff here; fcnt is a host integer
# (the device reads it from each slide's pack).
WL_SNAP_KEYS = (
    "soff", "snbr", "srl", "spos",
    "d_gat", "d_pos", "d_loff", "d_roff",
    "fd_gat", "fd_loff", "fd_roff",
    "fr_gat", "fr_sca", "f_off", "f_nbr", "f_len", "fcnt",
)

# The forward slide's slot ring: a FIFO of occupied slots in insertion order
# (each shard's expiring edges are its oldest entries) and a LIFO stack of
# free slots; the reference's keys. oring and fstack live on the device, the
# three counters on the host (the device reads them from each slide's pack).
WL_RING_KEYS = ("oring", "hd", "tl", "fstack", "ftop")


def sorted_bucket(ids, vals, k: int, n_local: int, n_pad: int, ccap: int, ccarry: int):
    """Dedup by sort and owner-bucket (global id, mass) pairs: ``ids`` [L]
    (invalid = n_pad), ``vals`` [L, S]. See ``sorted_bucket_rows``."""
    rows = torch.arange(ids.shape[0], device=ids.device)
    return sorted_bucket_rows(ids, rows, vals, k, n_local, n_pad, ccap, ccarry)


def sorted_bucket_rows(ids, rows, moving, k: int, n_local: int, n_pad: int, ccap: int,
                       ccarry: int):
    """``sorted_bucket`` where lane j's mass is ``moving[rows[j]]``: one
    stable sort groups duplicate ids, the segment sum's gather entry adds
    each group's mass (no ``[L, S]`` array of sorted rows is built), the
    owners are contiguous in the sorted order, and the ``[K,
    ccap]`` send buffers are gathers from it. Returns (send_ids [K*ccap]
    local ids, pad n_local; send_mass [K*ccap, S]; carry_ids [ccarry]
    sorted global ids, pad n_pad; carry_mass [ccarry, S]; pend), the
    entries past each owner's quota in the carry. The carry must hold the
    unique ids past quota: ``ccarry >= min(L, n_pad)`` guarantees it."""
    length = ids.shape[0]
    if ccarry < min(length, n_pad):
        raise ValueError(f"sorted_bucket_rows carry contract violated: ccarry={ccarry} < "
                         f"min(L={length}, n_pad={n_pad})")
    ids_s, order = torch.sort(ids, stable=True)
    rows_s = rows[order]
    seg_start = torch.ones_like(ids_s, dtype=torch.bool)
    seg_start[1:] = ids_s[1:] != ids_s[:-1]
    sidx = torch.cumsum(seg_start, 0) - 1
    # one group = one id, so duplicate writes carry the same value; groups
    # past the last real one keep n_pad
    gids = torch.full((length,), n_pad, dtype=torch.int32, device=ids.device)
    gids.scatter_(0, sidx, ids_s.to(torch.int32))
    # group g sums the lanes [off[g], off[g+1]); groups past the last real
    # one get empty ranges and stay zero
    gmass = torch.zeros((length, moving.shape[1]), dtype=moving.dtype, device=moving.device)
    segsum_gather_add_(gmass, moving, rows_s, row_offsets(sidx, length), site="group_sum")
    return _bucket_tail(gids, gmass, k, n_local, n_pad, ccap, ccarry)


def _bucket_tail(gids, gmass, k: int, n_local: int, n_pad: int, ccap: int, ccarry: int):
    dev = gids.device
    bounds = torch.arange(k + 1, dtype=gids.dtype, device=dev) * n_local
    starts = torch.searchsorted(gids, bounds)
    counts = starts[1:] - starts[:-1]  # unique ids per owner
    # send buffers by gather: slot (k, j) <- sorted position starts[k] + j
    j_ix = torch.arange(ccap, device=dev)[None, :].expand(k, ccap)
    valid = j_ix < counts.clamp(max=ccap)[:, None]
    g_idx = torch.where(valid, starts[:k, None] + j_ix, 0).reshape(-1)
    valid = valid.reshape(-1)
    k_of = torch.arange(k, device=dev)[:, None].expand(k, ccap).reshape(-1)
    send_ids = torch.where(valid, gids[g_idx] - k_of * n_local, n_local).to(torch.int32)
    send_mass = gmass[g_idx] * valid[:, None].to(gmass.dtype)
    # overflow -> compact carry, also by gather
    oc = (counts - ccap).clamp(min=0)
    base = torch.cat([torch.zeros(1, dtype=oc.dtype, device=dev), torch.cumsum(oc, 0)])
    pend = base[k]
    ci = torch.arange(ccarry, device=dev)
    own = (torch.searchsorted(base, ci, right=True) - 1).clamp(0, k - 1)
    ok = ci < pend
    c_idx = torch.where(ok, starts[own] + ccap + (ci - base[own]), 0)
    carry_ids = torch.where(ok, gids[c_idx], n_pad).to(torch.int32)
    carry_mass = gmass[c_idx] * ok[:, None].to(gmass.dtype)
    return send_ids, send_mass, carry_ids, carry_mass, pend


class ShardedWlEngine(ShardedEngine):
    """Row-sharded engine whose push loop runs compact-frontier rounds with
    a bucketed all-to-all, in both modes (reverse applies the receiver's
    1/d_out as the dense engine does). The window and its slides come from
    the parent (``init_state``, ``device_graph``); the snapshot, the push
    and the forward slide are here."""

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
        ccap: int | None = None,
        fring: int | None = None,
        e_top: int | None = None,
        n_tiers: int = 4,
        proportional: bool = False,
        bf16d: bool = False,
        device: torch.device | str | None = None,
    ):
        """``ccap`` caps every tier's all-to-all quota (None: the quotas
        alone); ``fring`` the fresh ring (default 2 * bcap); ``e_top`` the
        ladder's top (default min(65,536, ecap)). ``bf16d``: dense-round
        deliveries and the all-to-all's mass travel in bf16 (f32 sums);
        residual removal, thresholds and the carry stay exact.
        ``proportional``: the memory-proportional loop (module docstring)."""
        super().__init__(mesh, n, s_total, ecap, bcap, cfg, mode=mode, dtype=dtype,
                         exchange="dense_rs", ccap=2048 if ccap is None else ccap, device=device)
        if 2 * self.n_pad >= 2**31:
            raise ValueError(f"n_pad {self.n_pad}: delivery keys need 2 * n_pad < 2**31")
        self.bf16d = bool(bf16d)
        self.proportional = bool(proportional)
        # what a checkpoint keeps: the caller's quota cap, not the quotas
        self.user_ccap = ccap
        self.n_tiers = n_tiers
        self.fring = max(bcap, fring if fring is not None else 2 * bcap)
        self.e_top = e_top if e_top is not None else min(65_536, ecap)
        self.tiers = make_wl_tiers(self.n_local, ecap, self.fring, self.e_top,
                                   w_top=max(self.e_top // 2, 512), n_tiers=n_tiers)
        if self.proportional:
            # an all-covering top tier (any frontier fits: srl sums <= ecap,
            # f_len sums <= fring) takes the dense round's place; the carry
            # holds one round's deduplicated emission, which n_pad bounds too
            top = (self.n_local + 1, ecap, self.fring)
            self.tiers = tuple(t for t in self.tiers
                               if t[0] < top[0] or t[1] < top[1] or t[2] < top[2]) + (top,)
            self.ccarry = min(max(e + g for (_, e, g) in self.tiers), self.n_pad)
        # per-tier all-to-all quotas: the deduped emission of tier i fits
        # under balanced ownership; an explicit ccap caps them (K = 1 has no
        # wire, so there it sizes nothing)
        quotas = []
        for (_, e_i, g_i) in self.tiers:
            q = max(1024, -(-(e_i + g_i) // self.n_rows))
            if ccap is not None:
                q = min(q, ccap)
            quotas.append(min(q, self.n_local))
        self.ccaps = tuple(quotas)
        self.wl_ccap = self.ccaps[-1]  # the top tier's: corrections and drains
        # candidates are unique local rows: n_local + 1 bounds every list
        self.wcarry = self.n_local + 1
        _, e_top_, g_top_ = self.tiers[-1]
        self.heavy_ew = STATS_GUARD * (e_top_ + g_top_)
        # rounds of each kind over the engine's life (read, not reset, here)
        self.round_kinds = dict.fromkeys(("compact", "dense", "drain", "rescan"), 0)
        # what every dense round writes, once per engine: the moved mass
        # with the zero row dead edges gather (the last, never written),
        # the row pass's counts and each row's active pairs; and the
        # reverse row-sum sweep's copy of p with its zero row
        dev, s, nl = self.device, self.s_loc, self.n_local
        if not self.proportional:
            self._moving_ext = torch.zeros(
                (nl + 1, s), dtype=torch.bfloat16 if self.bf16d else dtype, device=dev)
            self._scan_counts = torch.zeros(2, dtype=torch.int64, device=dev)
            self._row_act = torch.empty(nl, dtype=torch.int32, device=dev)
        self._p_ext = (None if mode == FORWARD
                       else torch.zeros((nl + 1, s), dtype=dtype, device=dev))
        # the device loop's buffers and, on the card, its captured graphs;
        # the proportional loop's carry (its pending count is the counts'
        # N_PEND) and the rescan's list, every local row
        self.round_graphs = (RoundGraphs(nl, self.wcarry, dev, n_counts=loop.N_COUNTS)
                             if self.on_graphs else None)
        if self.on_graphs and self.proportional:
            self._cids = torch.full((self.ccarry,), self.n_pad, dtype=torch.int32, device=dev)
            self._cmass = torch.zeros((self.ccarry, s), dtype=dtype, device=dev)
            self._every_row = torch.arange(nl + 1, dtype=torch.int32, device=dev)

    @property
    def on_graphs(self) -> bool:
        """Whether the loop runs as ``RoundGraphs.loop`` (one conditional
        graph on the card, its host loop on the CPU): in a world of one
        shard, for the wl loop and the proportional one. Elsewhere it is
        the host loop with a stats reduction a round (``_wl_loop``,
        ``_prop_loop``), whose work is the world's."""
        return self.mesh.size == 1

    # ------------------------------------------------------------------
    # the snapshot and its delivery views
    # ------------------------------------------------------------------
    def _delivery_view(self, dst, gat, live, need_pos: bool = True):
        """One edge set in delivery order, local destinations first (by
        dst), then remote ones (by dst), dead last. Returns (gat_s, pos,
        loff, roff): the sorted gather rows (dead: the zero row n_local), the
        slot -> position map (or None), per-row ranges of the local segment
        over this shard's rows, and of the remote one over the global rows
        (empty for local rows; None at K = 1, where there is none)."""
        n_local, n_pad, base = self.n_local, self.n_pad, self.row0
        is_loc = (dst >= base) & (dst < base + n_local)
        key = torch.where(live, torch.where(is_loc, dst - base, dst + n_pad), 2 * n_pad)
        key_s, order = torch.sort(key, stable=True)
        gat_s = torch.where(live, gat, n_local)[order].to(torch.int32)
        pos = _inverse_perm(order) if need_pos else None
        bounds = torch.arange(n_local + 1, dtype=key_s.dtype, device=key_s.device)
        loff = torch.searchsorted(key_s, bounds, out_int32=True)
        roff = None
        if self.n_rows > 1:
            bounds = n_pad + torch.arange(n_pad + 1, dtype=key_s.dtype, device=key_s.device)
            roff = torch.searchsorted(key_s, bounds, out_int32=True)
        return gat_s, pos, loff, roff

    def rebuild(self, egl, eog, eva) -> dict:
        """Re-sort this shard's window slots into a fresh snapshot and an
        empty fresh ring (the driver calls it before the ring would overflow
        or a fresh edge could expire)."""
        n_local, n_pad, dev = self.n_local, self.n_pad, egl.device
        live = eva > 0
        _, order = torch.sort(torch.where(live, egl, n_local), stable=True)
        counts = torch.zeros(n_local, dtype=torch.int32, device=dev).index_add_(0, egl, eva)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        dst = torch.where(live, eog, n_pad)
        d_gat, d_pos, d_loff, d_roff = self._delivery_view(dst, egl, live)
        ring = self.fring + 1  # + the trash slot padding writes land in
        return {
            "soff": torch.cat([zero, torch.cumsum(counts, 0, dtype=torch.int32)]),
            "snbr": dst[order],
            "srl": counts,
            "spos": _inverse_perm(order),
            "d_gat": d_gat, "d_pos": d_pos, "d_loff": d_loff, "d_roff": d_roff,
            "fd_gat": torch.full((ring,), n_local, dtype=torch.int32, device=dev),
            "fd_loff": torch.zeros(n_local + 1, dtype=torch.int32, device=dev),
            "fd_roff": None if d_roff is None else torch.zeros_like(d_roff),
            "fr_gat": torch.full((ring,), n_local, dtype=torch.int32, device=dev),
            "fr_sca": torch.full((ring,), n_pad, dtype=torch.int32, device=dev),
            "f_off": torch.zeros(n_local + 1, dtype=torch.int32, device=dev),
            "f_nbr": torch.full((ring,), n_pad, dtype=torch.int32, device=dev),
            "f_len": torch.zeros(n_local, dtype=torch.int32, device=dev),
            "fcnt": 0,
        }

    def rebuild_(self, snap: dict, egl, eog, eva) -> None:
        """``rebuild`` into the tensors of ``snap``, in place: the driver's
        rebuild before a slide. In a world of one shard on the card it is a
        captured graph, replayed from its second call (``RoundGraphs.run``)."""
        def fn():
            for key, v in self.rebuild(egl, eog, eva).items():
                if isinstance(v, torch.Tensor):
                    if snap[key].shape != v.shape:
                        raise ValueError(f"snapshot {key}: cannot copy {tuple(v.shape)} into "
                                         f"{tuple(snap[key].shape)}")
                    snap[key].copy_(v)

        if self.on_graphs:
            self._hold(snap=snap, window=(egl, eog, eva))
            self.round_graphs.run(self._key("rebuild"), fn)
        else:
            fn()
        snap["fcnt"] = 0

    def device_graph_wl(self, src, dst):
        """``device_graph`` plus the snapshot: (deg, egl, eog, eva, counts,
        snap)."""
        deg, egl, eog, eva, counts = self.device_graph(src, dst)
        return deg, egl, eog, eva, counts, self.rebuild(egl, eog, eva)

    def _claim_fresh(self, snap: dict, cnt: int) -> None:
        """The host's fresh-ring fill advanced by a slide's ``cnt`` fresh
        edges; an overflow raises (the driver rebuilds before one)."""
        fcnt = snap["fcnt"]
        if fcnt + cnt > self.fring:
            raise ValueError(f"fresh ring overflow: fcnt {fcnt} + {cnt} > fring {self.fring}")
        snap["fcnt"] = fcnt + cnt

    def _mutate(self, snap: dict, clear_slots, gat, sca, val, fcnt) -> None:
        """Kill the expiring edges in the snapshot (both views; their slots
        are snapshot-era, which the driver's rebuild rule keeps true),
        append the fresh batch to the ring from its fill ``fcnt`` (a device
        scalar; a valid prefix of edges, padding lands in the trash slot)
        and re-sort the fresh mini-CSR and its delivery view. In place,
        into the snapshot's tensors."""
        n_local, n_pad, fring = self.n_local, self.n_pad, self.fring
        snap["snbr"].index_fill_(0, snap["spos"][clear_slots].long(), n_pad)
        # the delivery view: point the gather at the zero row (ranges stay)
        snap["d_gat"].index_fill_(0, snap["d_pos"][clear_slots].long(), n_local)
        iota = torch.arange(gat.shape[0], device=gat.device)
        on = val > 0
        pos = torch.where(on, fcnt + iota, fring)
        fr_gat, fr_sca = snap["fr_gat"], snap["fr_sca"]
        fr_gat[pos] = torch.where(on, gat, n_local)
        fr_gat[fring:].fill_(n_local)
        fr_sca[pos] = torch.where(on, sca, n_pad)
        fr_sca[fring:].fill_(n_pad)
        snap["f_len"].index_add_(0, gat.clamp(0, n_local - 1), val)
        _, order = torch.sort(fr_gat, stable=True)
        zero = torch.zeros(1, dtype=torch.int32, device=gat.device)
        fd_gat, _, fd_loff, fd_roff = self._delivery_view(fr_sca, fr_gat, fr_sca < n_pad,
                                                          need_pos=False)
        snap["f_nbr"].copy_(fr_sca[order])
        snap["f_off"].copy_(torch.cat([zero, torch.cumsum(snap["f_len"], 0, dtype=torch.int32)]))
        snap["fd_gat"].copy_(fd_gat)
        snap["fd_loff"].copy_(fd_loff)
        if fd_roff is not None:
            snap["fd_roff"].copy_(fd_roff)

    # ------------------------------------------------------------------
    # the push loop (block-local)
    # ------------------------------------------------------------------
    def _moving(self, mass, dang, inv_deg):
        alpha = self.cfg.alpha
        if self.mode == FORWARD:
            return (1.0 - alpha) * mass * inv_deg
        return torch.where(dang, (1.0 - alpha) / alpha * mass, (1.0 - alpha) * mass)

    def _expand(self, i: int, p, r, deg, snap, candw):
        """Push the candidate rows ``candw`` (unique, ascending, padded with
        n_local) in place in ``p`` and ``r``, and expand them at tier ``i``:
        (ids, rows, moving, na, ew) with ``ids`` [L] the global targets
        (invalid = n_pad) and lane j's mass ``moving[rows[j]]``."""
        _, e_i, g_i = self.tiers[i]
        n_local, n_pad = self.n_local, self.n_pad
        alpha, dtype = self.cfg.alpha, p.dtype
        srl, f_len = snap["srl"], snap["f_len"]
        live = candw < n_local
        cc = candw.clamp(0, n_local - 1)
        r_c = torch.where(live[:, None], r[cc], 0.0)
        deg_c = deg[cc]
        act = self._active(r_c, deg_c) & live[:, None]
        mass = torch.where(act, r_c, 0.0)
        dang_c = (deg_c == 0)[:, None]
        # candidate rows are unique (ascending): plain adds, no collisions
        p.index_add_(0, cc, torch.where(dang_c, mass, alpha * mass))
        r.index_add_(0, cc, -mass)
        moving = self._moving(mass, dang_c, (1.0 / deg_c.clamp(min=1).to(dtype))[:, None])
        anyact = act.any(dim=1)
        n_act = act.sum(dim=1)
        na = n_act.sum()
        ew = (n_act * (srl[cc] + f_len[cc])).sum()
        # snapshot + fresh expansion (targets are global ids)
        t1, pos1, val1 = rld_expand(snap["soff"][cc], torch.where(anyact, srl[cc], 0), e_i)
        g1 = torch.where(val1, snap["snbr"][pos1.clamp(0, self.slot_stride - 1)], n_pad)
        t2, pos2, val2 = rld_expand(snap["f_off"][cc], torch.where(anyact, f_len[cc], 0), g_i)
        g2 = torch.where(val2, snap["f_nbr"][pos2.clamp(0, self.fring)], n_pad)
        return torch.cat([g1, g2]), torch.cat([t1, t2]), moving, na, ew

    def _inv_deg(self, deg, dtype):
        """The receiver's 1/d_out of a reverse delivery (None forward)."""
        return None if self.mode == FORWARD else 1.0 / deg.clamp(min=1).to(dtype)

    def _compact_round(self, i: int, p, r, deg, snap, cand, carry, pend: int):
        """One push round at tier ``i`` over the candidate rows, in place in
        ``p`` and ``r``. Returns (cand2, carry, stats) with stats the
        round's [cn2, fed2, fre2, ok2, pend2, na, ew]."""
        n_local, n_pad, k = self.n_local, self.n_pad, self.n_rows
        dtype, s = p.dtype, p.shape[1]
        ids, rows, moving, na, ew = self._expand(i, p, r, deg, snap, cand[:self.tiers[i][0]])
        inv_deg = self._inv_deg(deg, dtype)
        if k == 1:
            # no wire: one stable sort dedups the emission, which runs
            # straight into r; its ascending unique ids are the next list
            # (n_pad == n_local, so the id pad is the candidate pad)
            keys_s = sorted_deliver_(r, ids, moving, rows, row_scale=inv_deg)
            return self._next_candidates(keys_s, snap, carry, pend, na, ew)
        length = ids.shape[0]
        ccap = self.ccaps[i]
        if length >= SORT_BUCKET_MIN:
            send_ids, send_mass, cids, cmass, pend2 = sorted_bucket_rows(
                ids, rows, moving, k, n_local, n_pad, ccap, min(length, n_pad))
            carry.index_add_(0, cids.clamp(0, n_pad - 1),
                             cmass * (cids < n_pad).to(dtype)[:, None])
            pend = pend + pend2
        else:
            vals = moving[rows] * (ids < n_pad).to(dtype)[:, None]
            lane = torch.arange(length, device=ids.device)
            ids64 = ids.long()
            # winner-dedup over global ids: the last lane wins, as the
            # reference's sequential scatter does on the CPU
            scratch = torch.zeros(n_pad + 1, dtype=torch.int64, device=ids.device)
            scratch.scatter_reduce_(0, ids64, lane, reduce="amax")
            win = (scratch[ids64] == lane) & (ids < n_pad)
            ucnt = win.sum()
            cpos = compact(win, length, 0)
            inr = lane < ucnt
            uids = torch.where(inr, ids64[cpos], n_pad)
            cidx = torch.zeros(n_pad + 1, dtype=torch.int64, device=ids.device)
            cidx[uids] = lane
            cbuf = torch.zeros((length, s), dtype=dtype, device=ids.device)
            cbuf.index_add_(0, cidx[ids64], vals)
            owner = torch.where(inr, uids // n_local, k)
            rank = torch.zeros_like(owner)
            for kk in range(k):
                mk = owner == kk
                rank = torch.where(mk, torch.cumsum(mk, 0) - 1, rank)
            sendable = (owner < k) & (rank < ccap)
            flat = torch.where(sendable, owner * ccap + rank, k * ccap)
            send_ids = torch.full((k * ccap + 1,), n_local, dtype=torch.int32, device=ids.device)
            send_ids[flat] = torch.where(sendable, uids - owner * n_local, n_local).to(torch.int32)
            send_ids = send_ids[: k * ccap]
            send_mass = torch.zeros((k * ccap + 1, s), dtype=dtype, device=ids.device)
            send_mass[flat] = cbuf * sendable.to(dtype)[:, None]
            send_mass = send_mass[: k * ccap]
            # leftovers wait in the carry (flushed by dense rounds)
            left = (owner < k) & (rank >= ccap)
            carry.index_add_(0, uids.clamp(0, n_pad - 1), cbuf * left.to(dtype)[:, None])
            pend = pend + left.sum()
        # THE exchange: one all-to-all of (local id, mass) buckets
        if self.bf16d:
            send_mass = send_mass.to(torch.bfloat16)
        group = self.mesh.row_group
        recv_ids = all_to_all_rows(send_ids.reshape(k, ccap), group).reshape(-1)
        recv_mass = all_to_all_rows(send_mass.reshape(k, ccap, s), group).reshape(-1, s)
        # received blocks are sorted per sender only: one sort makes the
        # delivery sorted and gives the next list, ascending
        rid_s, order_r = torch.sort(recv_ids, stable=True)
        rm_s = recv_mass[order_r].to(dtype) * (rid_s < n_local).to(dtype)[:, None]
        rcs = rid_s.clamp(0, n_local - 1)
        r.index_add_(0, rcs, rm_s if inv_deg is None else rm_s * inv_deg[rcs, None])
        return self._next_candidates(rid_s, snap, carry, pend, na, ew)

    def _next_candidates(self, keys_s, snap, carry, pend, na, ew):
        """The next list from ascending delivered ids (padding >= n_local):
        the first lane of each run of a live id, and its counts."""
        n_local, wcarry = self.n_local, self.wcarry
        win = torch.ones_like(keys_s, dtype=torch.bool)
        win[1:] = keys_s[1:] != keys_s[:-1]
        win &= keys_s < n_local
        cn2 = win.sum()
        m = min(keys_s.shape[0], wcarry)
        cpos = compact(win, m, 0)
        cand2 = torch.full((wcarry,), n_local, dtype=torch.int32, device=keys_s.device)
        cand2[:m] = torch.where(torch.arange(m, device=keys_s.device) < cn2, keys_s[cpos],
                                n_local)
        kc = keys_s.clamp(0, n_local - 1)
        fed2 = torch.where(win, snap["srl"][kc], 0).sum()
        fre2 = torch.where(win, snap["f_len"][kc], 0).sum()
        return cand2, carry, [cn2, fed2, fre2, cn2 <= wcarry, pend, na, ew]

    def _scan(self, p, r, deg, snap):
        """A dense round's pass over every active pair, in place in ``p``
        and ``r``, delivered local-first through the segment sum (window
        view, then fresh view) from the engine's delivery table, whose
        remote segments stay there for the caller at K > 1. Returns the
        round's counts as device scalars: (na, ew, ewr), ``ewr`` the
        stats-skip's (the window and fresh edges of every row with an
        active pair)."""
        n_local = self.n_local
        moving_ext, counts, row_act = self._moving_ext, self._scan_counts, self._row_act
        counts.zero_()
        # the round's elementwise work in one pass (rowpass K2): p and r in
        # place, the moved mass written straight into the delivery table
        scan_pass_(p, r, deg, moving_ext[:n_local], counts, row_act, eps=self.cfg.eps,
                   alpha=self.cfg.alpha, forward=self.mode == FORWARD)
        scale = self._inv_deg(deg, p.dtype)
        for view in ("d", "fd"):
            segsum_gather_add_(r, moving_ext, snap[f"{view}_gat"], snap[f"{view}_loff"],
                               row_scale=scale)
        n_act = row_act.long()
        edges = snap["srl"] + snap["f_len"]
        return counts[0], (n_act * edges).sum(), torch.where(n_act > 0, edges, 0).sum()

    def _rescan(self, r, deg, snap):
        """The dense round's stats: the next frontier, one read of ``r``
        (rowpass K3). Returns (cand2 [wcarry], cn2, fed2, fre2)."""
        any2, cn2, fed2, fre2 = frontier_rows(r, deg, snap["srl"], snap["f_len"],
                                              eps=self.cfg.eps, forward=self.mode == FORWARD)
        return compact(any2, self.wcarry, self.n_local), cn2, fed2, fre2

    def _dense_round(self, p, r, deg, snap, carry):
        """One round over every active pair (``_scan``); at K > 1 the
        remote segments and the carry go into ``acc`` and one
        reduce-scatter. Then the rescan, unless the row group's heaviest
        frontier is above the stats-skip threshold (read back first: a
        skipped rescan is not run). ``p`` and ``r`` are updated in place
        (at K > 1 ``r`` is replaced). Returns (p, r, cand2, carry,
        stats)."""
        mesh = self.mesh
        na, ew, ewr = self._scan(p, r, deg, snap)
        if self.n_rows > 1:
            # the carry outbox joins the remote mass; the owners apply
            # 1/d_out after the reduce-scatter in reverse mode
            for view in ("d", "fd"):
                segsum_gather_add_(carry, self._moving_ext, snap[f"{view}_gat"],
                                   snap[f"{view}_roff"])
            delta = reduce_scatter_rows(carry, mesh.row_group)
            scale = self._inv_deg(deg, p.dtype)
            r = r + (delta if scale is None else delta * scale[:, None])
            carry.zero_()
        got = gather_stats([ewr, na, ew], mesh.row_group, self.device)
        na, ew = (int(v) for v in got[mesh.row if mesh.row_group is not None else 0, 1:])
        if int(got[:, 0].max()) > self.heavy_ew:
            # the successor is another dense round: no rescan
            return p, r, None, carry, [_BIG, _BIG, _BIG, 0, 0, na, ew]
        cand2, cn2, fed2, fre2 = self._rescan(r, deg, snap)
        return p, r, cand2, carry, [cn2, fed2, fre2, 1, 0, na, ew]

    # ------------------------------------------------------------------
    # the device loop (a world of one shard): the rounds as loop branches
    # that read and write the RoundGraphs buffers, and the loop's table
    # ------------------------------------------------------------------
    def _key(self, *parts) -> tuple:
        """A captured graph's key: what it bakes in besides its shapes."""
        return (self.mode, self.bf16d, self.cfg.eps, self.cfg.alpha, *parts)

    def _hold(self, blocks=None, snap=None, window=None, ring=None, pack=None) -> None:
        """Each named group of tensors must be the one the graphs hold."""
        g = self.round_graphs
        for what, objs in (("the engine's p, r and deg", blocks), ("the snapshot", snap),
                           ("the window", window), ("the ring", ring), ("a slide's pack", pack)):
            if objs is not None:
                g.hold(what, objs)

    def loop_table(self) -> loop.Table:
        """The loop's table: the ladder, each tier's list (``wcarry``: a
        compact round's list is always valid at K = 1), the stats-skip
        threshold and the sharded rule; for ``proportional`` the
        proportional rule, which reads no stats-skip threshold."""
        if self.proportional:
            return loop.Table(tiers=self.tiers, emit=(self.wcarry,) * len(self.tiers),
                              heavy_ew=0, rule=loop.PROPORTIONAL)
        return loop.Table(tiers=self.tiers, emit=(self.wcarry,) * len(self.tiers),
                          heavy_ew=self.heavy_ew, rule=loop.SHARDED)

    def _first_count(self, snap) -> None:
        """The counts of the list in ``cand``: its live rows, their window
        and fresh edges."""
        g, n_local = self.round_graphs, self.n_local
        live = g.cand < n_local
        c = g.cand.clamp(0, n_local - 1)
        g.put(0, live.sum(), torch.where(live, snap["srl"][c], 0).sum(),
              torch.where(live, snap["f_len"][c], 0).sum())

    def _tier_step(self, i: int, p, r, deg, snap) -> None:
        """A compact round at tier ``i`` from the list in ``cand``."""
        g = self.round_graphs
        cand2, _, (cn2, fed2, fre2, _, _, na, ew) = self._compact_round(
            i, p, r, deg, snap, g.cand, None, 0)
        g.emit(cand2)
        g.put(0, cn2, fed2, fre2, na, ew)

    def _scan_step(self, p, r, deg, snap) -> None:
        self.round_graphs.put(3, *self._scan(p, r, deg, snap))

    def _stats_step(self, r, deg, snap) -> None:
        g = self.round_graphs
        cand2, cn2, fed2, fre2 = self._rescan(r, deg, snap)
        g.emit(cand2)
        g.put(0, cn2, fed2, fre2)

    def _graph_loop(self, p, r, deg, snap, c0ok: bool, prologue):
        """The convergence loop as ``RoundGraphs.loop``: ``prologue`` (a
        graph key and its step), then the rounds K4 picks from the list and
        counts it leaves, each a branch on the engine's buffers. Returns
        ``_wl_loop``'s six values; the round kinds are counted from the
        carry's branch executions."""
        k = len(self.tiers)
        branches = [(self._key("tier", i), functools.partial(self._tier_step, i, p, r, deg, snap))
                    for i in range(k)]
        branches += [(self._key("scan"), lambda: self._scan_step(p, r, deg, snap)),
                     (self._key("stats"), lambda: self._stats_step(r, deg, snap))]
        values, _ = self.round_graphs.loop(prologue, branches, self.loop_table(), c0ok,
                                           self.cfg.max_rounds)
        execs = values[loop.EXECS:loop.EXECS + k + 1]
        self.round_kinds["compact"] += sum(execs[:k])
        self.round_kinds["dense"] += execs[k]
        return (p, r, values[loop.ROUNDS], values[loop.PUSHES], values[loop.EDGE_PUSHES],
                values[loop.WL_ROUNDS])

    # -- the proportional loop's branches, on the loop's carry buffers
    def _carry_into(self, carry) -> None:
        """A round's (cids, cmass, pend) into the loop's carry: the
        buffers, and ``pend`` into the counts' ``N_PEND``."""
        cids, cmass, pend = carry
        self._cids.copy_(cids)
        self._cmass.copy_(cmass)
        self.round_graphs.put(loop.N_PEND, pend)

    def _prop_first(self, snap) -> None:
        """A push's prologue: an empty carry and the list's counts."""
        self._cids.fill_(self.n_pad)
        self._cmass.zero_()
        self.round_graphs.counts[loop.N_PEND:].zero_()
        self._first_count(snap)

    def _prop_tier_step(self, i: int, p, r, deg, snap, candw=None) -> None:
        """A compact round at tier ``i`` over ``candw``: the list in
        ``cand`` (None), or every row (the rescan)."""
        g = self.round_graphs
        if candw is None:
            candw = g.cand[:self.tiers[i][0]]
        cand2, carry, (cn2, fed2, fre2, _, _, _, na, ew) = self._prop_compact(
            i, p, r, deg, snap, candw)
        g.emit(cand2)
        g.put(0, cn2, fed2, fre2, na, ew)
        self._carry_into(carry)

    def _drain_step(self, r, deg, snap) -> None:
        """A drain round: the carry shipped, the list kept and widened;
        nothing pushed."""
        g = self.round_graphs
        # (the list's validity a drain keeps is the carry's: K4 keeps it)
        cand2, carry, (cn2, fed2, fre2, _, _, _, _, _) = self._drain_round(
            r, deg, snap, g.cand, (self._cids, self._cmass, None), 0)
        g.emit(cand2)
        g.put(0, cn2, fed2, fre2)
        g.counts[3:5].zero_()
        self._carry_into(carry)

    def _prop_graph_loop(self, p, r, deg, snap, c0ok: bool, prologue):
        """``_graph_loop`` for ``proportional``: the branches are each
        tier's compact round on the list in ``cand``, the drain and the
        rescan (the top tier over every local row), under the proportional
        rule. Returns ``_prop_loop``'s six values; the round kinds are
        counted from the carry's branch executions."""
        k, g = len(self.tiers), self.round_graphs
        branches = [(self._key("prop_tier", i),
                     functools.partial(self._prop_tier_step, i, p, r, deg, snap))
                    for i in range(k)]
        branches += [(self._key("drain"), lambda: self._drain_step(r, deg, snap)),
                     (self._key("rescan"), lambda: self._prop_tier_step(
                         k - 1, p, r, deg, snap, self._every_row))]
        values, _ = g.loop(prologue, branches, self.loop_table(), c0ok, self.cfg.max_rounds)
        execs = values[loop.EXECS:loop.EXECS + k + 2]
        self.round_kinds["compact"] += sum(execs[:k])
        self.round_kinds["drain"] += execs[k]
        self.round_kinds["rescan"] += execs[k + 1]
        return (p, r, values[loop.ROUNDS], values[loop.PUSHES], values[loop.EDGE_PUSHES],
                values[loop.WL_ROUNDS])

    def _wl_loop(self, p, r, deg, snap, cand0, ok0: int):
        """Push to convergence on the host: (p, r, rounds, pushes, edge_pushes,
        wl_rounds), the counts summed over the world and ``wl_rounds`` this
        row group's. ``cand0`` [wcarry]: unique ascending local rows,
        padded with n_local, covering every active row when ``ok0`` (else
        the first round is a dense rescan). Compact rounds update ``p`` and
        ``r`` in place: callers keep only what is returned."""
        n_local, mesh = self.n_local, self.mesh
        w_t, e_t, g_t = self.tiers[-1]
        live0 = cand0 < n_local
        c0 = cand0.clamp(0, n_local - 1)
        counts0 = [live0.sum(), torch.where(live0, snap["srl"][c0], 0).sum(),
                   torch.where(live0, snap["f_len"][c0], 0).sum(), int(ok0), 0, 0, 0]
        got = self._world(counts0)
        carry = None
        if self.n_rows > 1:  # at K = 1 the carry is never fed
            carry = torch.zeros((self.n_pad, p.shape[1]), dtype=p.dtype, device=p.device)
        rows = list(mesh.row_ranks)
        cand = cand0
        rounds = wl = pushes = epushes = 0
        work = 1  # the first round always runs
        while work > 0 and rounds < self.cfg.max_rounds:
            # the uniform decision: this row group's maxima (min of ok)
            grp = got[rows]
            cn, fed, fre, pend_g = (int(grp[:, c].max()) for c in (0, 1, 2, 4))
            use_wl = (int(grp[:, 3].min()) > 0 and cn <= w_t and fed <= e_t and fre <= g_t
                      and pend_g == 0)
            if use_wl:
                tier = sum(not (cn <= w_i and fed <= e_i and fre <= g_i)
                           for (w_i, e_i, g_i) in self.tiers[:-1])
                cand, carry, stats = self._compact_round(
                    tier, p, r, deg, snap, cand, carry, int(got[mesh.rank, 4]))
                wl += 1
                self.round_kinds["compact"] += 1
            else:
                p, r, cand, carry, stats = self._dense_round(p, r, deg, snap, carry)
                self.round_kinds["dense"] += 1
            got = self._world(stats)
            total = got.sum(axis=0)
            work = int(total[5]) + int((got[:, 4] > 0).sum())
            rounds += 1
            pushes += int(total[5])
            epushes += int(total[6])
        return p, r, rounds, pushes, epushes, wl

    # ------------------------------------------------------------------
    # the memory-proportional loop (proportional=True)
    # ------------------------------------------------------------------
    def _deliver(self, r, send_ids, send_mass, inv_deg):
        """The proportional rounds' exchange: one all-to-all of this shard's
        ``[K * q]`` (local id, mass) buckets, the received mass into ``r``
        (sorted through the segment sum from ``SORT_BUCKET_MIN`` lanes on,
        else by ``index_add_``; padding ids n_local add nothing). Returns
        the received ids."""
        k, n_local, s = self.n_rows, self.n_local, send_mass.shape[1]
        q = send_ids.shape[0] // k
        if self.bf16d:
            send_mass = send_mass.to(torch.bfloat16)
        group = self.mesh.row_group
        recv_ids = all_to_all_rows(send_ids.reshape(k, q), group).reshape(-1)
        recv_mass = all_to_all_rows(send_mass.reshape(k, q, s), group).reshape(-1, s)
        recv_mass = recv_mass.to(r.dtype)
        if recv_ids.shape[0] >= SORT_BUCKET_MIN:
            sorted_deliver_(r, recv_ids, recv_mass, row_scale=inv_deg)
        else:
            rc = recv_ids.clamp(0, n_local - 1)
            r.index_add_(0, rc, recv_mass if inv_deg is None else recv_mass * inv_deg[rc, None])
        return recv_ids

    def _next_marked(self, snap, recv_ids, cand=None):
        """The next list from an O(n_local) mark array: the rows ``recv_ids``
        delivered to, with ``cand``'s live rows kept (drain rounds). Returns
        (cand2, cn2, fed2, fre2)."""
        n_local = self.n_local
        # (index_fill_, not ``x[idx] = True``: that copies the value from
        # the host, which a capture refuses)
        mark = torch.zeros(n_local + 1, dtype=torch.bool, device=recv_ids.device)
        if cand is not None:
            mark.index_fill_(0, cand.clamp(0, n_local).long(), True)
        mark.index_fill_(0, recv_ids.clamp(0, n_local).long(), True)
        any2 = mark[:n_local]
        return (compact(any2, self.wcarry, n_local), any2.sum(),
                torch.where(any2, snap["srl"], 0).sum(), torch.where(any2, snap["f_len"], 0).sum())

    def _prop_compact(self, i: int, p, r, deg, snap, candw):
        """A proportional push round at tier ``i`` over ``candw``: every
        emission through ``sorted_bucket_rows`` and one all-to-all, the
        overflow into a fresh carry. Returns (cand2, (cids, cmass, pend),
        stats) with stats [cn2, fed2, fre2, ok2, pend2, work, na, ew]."""
        ids, rows, moving, na, ew = self._expand(i, p, r, deg, snap, candw)
        send_ids, send_mass, cids, cmass, pend = sorted_bucket_rows(
            ids, rows, moving, self.n_rows, self.n_local, self.n_pad, self.ccaps[i], self.ccarry)
        recv_ids = self._deliver(r, send_ids, send_mass, self._inv_deg(deg, p.dtype))
        cand2, cn2, fed2, fre2 = self._next_marked(snap, recv_ids)
        return cand2, (cids, cmass, pend), [cn2, fed2, fre2, 1, pend, na, na, ew]

    def _drain_round(self, r, deg, snap, cand, carry, ok: int):
        """Ship the carry (re-bucketed at the top tier's quota) over one
        all-to-all; what still overflows stays. Nothing is pushed."""
        cids, cmass, _ = carry
        send_ids, send_mass, cids2, cmass2, pend2 = sorted_bucket(
            cids, cmass, self.n_rows, self.n_local, self.n_pad, self.wl_ccap, self.ccarry)
        recv_ids = self._deliver(r, send_ids, send_mass, self._inv_deg(deg, r.dtype))
        cand2, cn2, fed2, fre2 = self._next_marked(snap, recv_ids, cand)
        return cand2, (cids2, cmass2, pend2), [cn2, fed2, fre2, ok, pend2, cn2 > 0, 0, 0]

    def _prop_loop(self, p, r, deg, snap, cand0, ok0: int, carry0=None):
        """``_wl_loop`` for ``proportional=True``: each round a compact
        round at the smallest tier that holds the row group's frontier, a
        drain round while any rank of the group has a pending carry, or a
        rescan (the top tier over every local row) when a list is not
        known to cover the frontier. ``carry0``: (cids, cmass, pend) left by
        the corrections. ``p`` and ``r`` are updated in place."""
        n_local, mesh, n_t = self.n_local, self.mesh, len(self.tiers)
        dev, s = p.device, p.shape[1]
        if carry0 is None:
            carry0 = (torch.full((self.ccarry,), self.n_pad, dtype=torch.int32, device=dev),
                      torch.zeros((self.ccarry, s), dtype=p.dtype, device=dev), 0)
        carry, cand = carry0, cand0
        live0 = cand0 < n_local
        c0 = cand0.clamp(0, n_local - 1)
        got = self._world([live0.sum(), torch.where(live0, snap["srl"][c0], 0).sum(),
                           torch.where(live0, snap["f_len"][c0], 0).sum(), int(ok0), carry[2],
                           0, 0, 0])
        rows = list(mesh.row_ranks)
        every_row = torch.arange(n_local + 1, dtype=torch.int32, device=dev)
        rounds = pushes = epushes = 0
        work = 1  # the first round always runs
        while work > 0 and rounds < self.cfg.max_rounds:
            # the uniform decision: this row group's maxima (min of ok)
            grp = got[rows]
            cn, fed, fre, pend_g = (int(grp[:, c].max()) for c in (0, 1, 2, 4))
            if pend_g > 0:
                kind = "drain"
                cand, carry, stats = self._drain_round(r, deg, snap, cand, carry,
                                                       int(got[mesh.rank, 3]))
            elif int(grp[:, 3].min()) > 0:
                kind = "compact"
                tier = sum(not (cn <= w_i and fed <= e_i and fre <= g_i)
                           for (w_i, e_i, g_i) in self.tiers[:-1])
                cand, carry, stats = self._prop_compact(tier, p, r, deg, snap,
                                                        cand[:self.tiers[tier][0]])
            else:
                kind = "rescan"
                cand, carry, stats = self._prop_compact(n_t - 1, p, r, deg, snap, every_row)
            self.round_kinds[kind] += 1
            got = self._world(stats)
            total = got.sum(axis=0)
            work = int(total[5]) + int((got[:, 4] > 0).sum())
            rounds += 1
            pushes += int(total[6])
            epushes += int(total[7])
        return p, r, rounds, pushes, epushes, rounds

    def _loop(self, p, r, deg, snap, cand0, ok0: int, carry0=None):
        if self.proportional:
            return self._prop_loop(p, r, deg, snap, cand0, ok0, carry0)
        return self._wl_loop(p, r, deg, snap, cand0, ok0)

    # ------------------------------------------------------------------
    def push_wl(self, p, r, deg, snap, cand0=None, ok0: int = 0):
        """Push to convergence with the compact-frontier loop (or the
        proportional one). With no ``cand0`` the first round is a dense
        round or a rescan (exact). In a world of one shard ``p``, ``r``,
        ``deg`` and ``snap`` become the tensors the engine's graphs hold."""
        if cand0 is None:
            cand0 = torch.full((self.wcarry,), self.n_local, dtype=torch.int32,
                               device=self.device)
            ok0 = 0
        if not self.on_graphs:
            return self._loop(p, r, deg, snap, cand0, ok0)
        self._hold(blocks=(p, r, deg), snap=snap)
        self.round_graphs.emit(cand0)
        if self.proportional:
            return self._prop_graph_loop(p, r, deg, snap, bool(ok0),
                                         (self._key("first"), lambda: self._prop_first(snap)))
        return self._graph_loop(p, r, deg, snap, bool(ok0),
                                (self._key("first"), lambda: self._first_count(snap)))

    def slide_tail(self, counts, ring, snap) -> np.ndarray:
        """The scalars a slide's pack carries after its batch rows (int32):
        forward this shard's (fresh, expiring) counts and the ring's ``hd``,
        ``tl`` and ``ftop``; reverse its (expiring, fresh, written) counts;
        then the fresh ring's fill. The host keeps its own copies, which
        ``slide_wl`` advances."""
        ints = [int(c) for c in counts]
        if self.mode == FORWARD:
            ints += [ring["hd"], ring["tl"], ring["ftop"]]
        return np.asarray(ints + [snap["fcnt"]], np.int32)

    def slide_wl(self, p, r, deg, egl, eog, eva, snap, pack, ring, counts):
        """One window slide on the compact-frontier loop (or the
        proportional one). Forward: ``pack`` is this shard's fresh edges on
        the device (``ins_u`` local, then ``ins_w`` global, ``bcap`` each, a
        valid prefix) and ``slide_tail``'s scalars, ``counts`` the host's
        (fresh, expiring) counts for this shard; the expiring edges and the
        slot schedule come from ``ring``. Reverse: ``pack`` is the six batch
        rows ``_slide_reverse`` reads and its tail, and ``counts`` its
        three, ``ring`` None. The corrections' touched rows seed the
        candidate list. Returns (p, r, rounds, pushes, edge_pushes,
        wl_rounds, deg2, egl, eog, eva, snap, ring), the buffers, the
        snapshot and the ring updated in place (in a world of one shard
        ``p``, ``r`` and ``deg`` too: the same tensors come back)."""
        if self.mode != FORWARD:
            return (*self._slide_reverse(p, r, deg, egl, eog, eva, snap, pack, counts), None)
        cnt_w, cnt_c = (int(c) for c in counts)
        self._claim_fresh(snap, cnt_w)
        rcap = self.ecap + 1  # FIFO ring modulus (live slots <= ecap)
        ring2 = {**ring, "hd": (ring["hd"] + cnt_c) % rcap, "tl": (ring["tl"] + cnt_w) % rcap,
                 "ftop": ring["ftop"] + cnt_c - cnt_w}
        if self.on_graphs:
            self._hold(blocks=(p, r, deg), snap=snap, window=(egl, eog, eva),
                       ring=(ring["oring"], ring["fstack"]), pack=pack)
            prologue = (self._key("slide"), lambda: self._forward_prologue(
                p, r, deg, egl, eog, eva, snap, pack, ring))
            return (*self._loop_on_graphs(p, r, deg, snap, prologue), deg, egl, eog, eva,
                    snap, ring2)
        p, r, deg2, cand0, carry0 = self._forward_corrections(p, r, deg, egl, eog, eva, snap,
                                                              pack, ring)
        p, r, rounds, pushes, epushes, wl = self._loop(p, r, deg2, snap, cand0, 1, carry0)
        return p, r, rounds, pushes, epushes, wl, deg2, egl, eog, eva, snap, ring2

    def _forward_corrections(self, p, r, deg, egl, eog, eva, snap, pack, ring):
        """The forward slide up to its loop, from the scalars of ``pack``:
        the ring's schedule, the corrections, the window's and the
        snapshot's mutation. Returns (p, r, deg2, cand0, carry0), ``carry0``
        the proportional loop's seed (else None)."""
        b, ecap, n_local, n_pad = self.bcap, self.ecap, self.n_local, self.n_pad
        alpha, dev = self.cfg.alpha, pack.device
        ins_u, ins_w = pack[:b], pack[b:2 * b]
        cnt_w, cnt_c, hd, tl, ft, fcnt = pack[2 * b:2 * b + 6].long().unbind(0)
        iota = torch.arange(b, device=dev)
        ins_v = (iota < cnt_w).to(torch.int32)
        rcap = ecap + 1
        oring, fstack = ring["oring"], ring["fstack"]
        # expiring slots: this shard's cnt_c oldest ring entries
        clear_slots = torch.where(iota < cnt_c, oring[(hd + iota) % rcap], ecap)
        # push the freed slots (index ecap is the stack's dump), then pop
        # the fresh batch's top first (entry i <-> ins_* i)
        fstack[torch.where(iota < cnt_c, ft + iota, ecap)] = clear_slots
        ft = ft + cnt_c
        write_slots = torch.where(iota < cnt_w, fstack[(ft - 1 - iota).clamp(0, ecap)], ecap)
        # the claimed slots join the ring's tail (index rcap is its dump)
        oring[torch.where(iota < cnt_w, (tl + iota) % rcap, rcap)] = write_slots
        del_u, del_w, del_v = egl[clear_slots], eog[clear_slots], eva[clear_slots]
        # (index_fill_, not ``x[idx] = True``: that copies the value from
        # the host, which a capture refuses)
        mark = torch.zeros(n_local + 1, dtype=torch.bool, device=dev)
        mark.index_fill_(0, torch.where(del_v > 0, del_u, n_local).long(), True)
        mark.index_fill_(0, torch.where(ins_v > 0, ins_u, n_local).long(), True)
        carry0 = None
        if self.proportional:
            # the correction pairs ride one bucketed all-to-all (exact mass);
            # what overflows seeds the loop's carry
            p, r, ids, vals, deg2 = forward_corrections_pairs(
                p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v, alpha, n_pad)
            k, q, group = self.n_rows, self.wl_ccap, self.mesh.row_group
            send_ids, send_mass, cids, cmass, pend = sorted_bucket(
                ids, vals, k, n_local, n_pad, q, self.ccarry)
            recv_ids = all_to_all_rows(send_ids.reshape(k, q), group).reshape(-1)
            recv_mass = all_to_all_rows(send_mass.reshape(k, q, -1), group)
            r.index_add_(0, recv_ids.clamp(0, n_local - 1), recv_mass.reshape(k * q, -1))
            mark.index_fill_(0, recv_ids.clamp(0, n_local).long(), True)
            carry0 = (cids, cmass, pend)
        elif self.n_rows == 1:
            # no wire: the correction pairs run straight into r
            p, r, ids, vals, deg2 = forward_corrections_pairs(
                p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v, alpha, n_pad)
            valid = ids < n_pad
            r.index_add_(0, ids.clamp(0, n_local - 1), vals * valid.to(p.dtype)[:, None])
            mark.index_fill_(0, torch.where(valid, ids, n_local).long(), True)
        else:
            p, r, acc, deg2 = forward_corrections(
                p, r, deg, del_u, del_w, del_v, ins_u, ins_w, ins_v, alpha, n_pad)
            delta = reduce_scatter_rows(acc, self.mesh.row_group)
            r = r + delta
            mark[:n_local] |= (delta != 0).any(dim=1)
        cand0 = compact(mark[:n_local], self.wcarry, n_local)
        write_window_(egl, eog, eva, clear_slots, write_slots, ins_u, ins_w, ins_v)
        self._mutate(snap, clear_slots, ins_u, ins_w, ins_v, fcnt)
        return p, r, deg2, cand0, carry0

    def _loop_on_graphs(self, p, r, deg, snap, prologue):
        """A slide's loop in a world of one shard, from a valid list."""
        if self.proportional:
            return self._prop_graph_loop(p, r, deg, snap, True, prologue)
        return self._graph_loop(p, r, deg, snap, True, prologue)

    def _forward_prologue(self, p, r, deg, egl, eog, eva, snap, pack, ring) -> None:
        """A forward slide up to its loop on the engine's buffers: the
        corrections into ``p``, ``r`` and ``deg``, the first list and its
        counts into the loop's buffers (for ``proportional`` the carry the
        corrections left too). A world of one shard."""
        p2, r2, deg2, cand0, carry0 = self._forward_corrections(p, r, deg, egl, eog, eva, snap,
                                                                pack, ring)
        p.copy_(p2)
        r.copy_(r2)
        deg.copy_(deg2)
        self.round_graphs.emit(cand0)
        self._first_count(snap)
        if carry0 is not None:
            self._carry_into(carry0)

    def rowsum_sweep(self, p, snap):
        """The reverse slide's row sums of ``p`` over the live window edges
        (the snapshot's view after kills plus the fresh view), local-first
        through the segment sum: (s_loc [n_local, S], the sums of this
        shard's rows over the edges it holds; acc [n_pad, S], the rest by
        global row, None at K = 1). ``p`` is copied into the engine's table
        with its zero row."""
        s = p.shape[1]
        p_ext = self._p_ext
        p_ext[:-1].copy_(p)
        s_loc = torch.zeros_like(p)
        for view in ("d", "fd"):
            segsum_gather_add_(s_loc, p_ext, snap[f"{view}_gat"], snap[f"{view}_loff"])
        if self.n_rows == 1:
            return s_loc, None
        acc = torch.zeros((self.n_pad, s), dtype=p.dtype, device=p.device)
        for view in ("d", "fd"):
            segsum_gather_add_(acc, p_ext, snap[f"{view}_gat"], snap[f"{view}_roff"])
        return s_loc, acc

    def _slide_reverse(self, p, r, deg, egl, eog, eva, snap, pack, counts):
        """The reverse slide: ``pack`` holds ``del_u``, ``ins_u`` (by source
        owner), ``clear_slots``, ``write_slots``, ``write_dl``, ``write_sg``
        (by destination owner), ``bcap`` each, then ``slide_tail``'s
        scalars; ``counts`` the host's (expiring, fresh, written) counts for
        this shard."""
        self._claim_fresh(snap, int(counts[2]))
        if self.on_graphs:
            self._hold(blocks=(p, r, deg), snap=snap, window=(egl, eog, eva), pack=pack)
            prologue = (self._key("slide"), lambda: self._reverse_prologue(
                p, r, deg, egl, eog, eva, snap, pack))
            return (*self._loop_on_graphs(p, r, deg, snap, prologue), deg, egl, eog, eva,
                    snap)
        r, d_new, cand0 = self._reverse_corrections(p, r, deg, egl, eog, eva, snap, pack)
        p, r, rounds, pushes, epushes, wl = self._loop(p, r, d_new, snap, cand0, 1)
        return p, r, rounds, pushes, epushes, wl, d_new, egl, eog, eva, snap

    def _reverse_corrections(self, p, r, deg, egl, eog, eva, snap, pack):
        """The reverse slide up to its loop, from the scalars of ``pack``:
        the old row sums from the sweep, the batch's delta beside them in
        one ``[n_pad, 2S]`` reduce-scatter along the row group, the
        corrections, the window's and the snapshot's mutation. Returns (r2,
        d_new, cand0)."""
        b, n_local, dtype = self.bcap, self.n_local, p.dtype
        del_u, ins_u, clear_slots, write_slots, write_dl, write_sg = pack[:6 * b].reshape(
            6, b).unbind(0)
        cnt_o, cnt_n, cnt_w, fcnt = pack[6 * b:6 * b + 4].long().unbind(0)
        iota = torch.arange(b, device=pack.device)
        del_v, ins_v, write_v = ((iota < c).to(torch.int32) for c in (cnt_o, cnt_n, cnt_w))
        s_loc, acc_old = self.rowsum_sweep(p, snap)
        # the batch's delta by global row: expiring edges out, fresh ones in
        acc_d = torch.zeros((self.n_pad, p.shape[1]), dtype=dtype, device=p.device)
        old_v = eva[clear_slots].to(dtype)[:, None]
        acc_d.index_add_(0, eog[clear_slots], -p[egl[clear_slots]] * old_v)
        acc_d.index_add_(0, write_sg, p[write_dl] * write_v.to(dtype)[:, None])
        if acc_old is None:
            s_old = s_loc
            s_new = s_old + acc_d
        else:
            s = p.shape[1]
            red = reduce_scatter_rows(torch.cat([acc_old, acc_d], dim=1), self.mesh.row_group)
            s_old = s_loc + red[:, :s]
            s_new = s_old + red[:, s:]
        write_window_(egl, eog, eva, clear_slots, write_slots, write_dl, write_sg, write_v)
        r, d_new = reverse_apply(p, r, deg, del_u, del_v, ins_u, ins_v, s_old, s_new,
                                 self.cfg.alpha)
        # a row whose correction is not zero has a changed row sum or degree
        mark = torch.zeros(n_local + 1, dtype=torch.bool, device=p.device)
        mark.index_fill_(0, torch.where(del_v > 0, del_u, n_local).long(), True)
        mark.index_fill_(0, torch.where(ins_v > 0, ins_u, n_local).long(), True)
        mark[:n_local] |= (s_new != s_old).any(dim=1) | (d_new != deg)
        cand0 = compact(mark[:n_local], self.wcarry, n_local)
        self._mutate(snap, clear_slots, write_dl, write_sg, write_v, fcnt)
        return r, d_new, cand0

    def _reverse_prologue(self, p, r, deg, egl, eog, eva, snap, pack) -> None:
        """A reverse slide up to its loop on the engine's buffers: the
        corrections into ``r`` and ``deg``, the first list and its counts
        into the loop's buffers. A world of one shard."""
        r2, d_new, cand0 = self._reverse_corrections(p, r, deg, egl, eog, eva, snap, pack)
        r.copy_(r2)
        deg.copy_(d_new)
        self.round_graphs.emit(cand0)
        if self.proportional:  # an empty carry
            self._prop_first(snap)
        else:
            self._first_count(snap)

    def make_ring(self, oring, hd, tl, fstack, ftop) -> dict:
        """This shard's slot ring from the host's ``[K, ...]`` arrays: oring
        [K, ecap+2] (slot ids, oldest first from hd; dump at ecap+1), hd, tl,
        ftop [K], fstack [K, ecap+1] (free slots, LIFO; dump at ecap)."""
        row = self.mesh.row

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[row], np.int32)).to(self.device)

        return {"oring": put(oring), "fstack": put(fstack), "hd": int(hd[row]),
                "tl": int(tl[row]), "ftop": int(ftop[row])}

    def cand0_rows(self, rows_per_shard: np.ndarray) -> torch.Tensor:
        """This shard's row of the host's per-shard local candidate lists
        (``[K, wcarry]``, each unique ascending, padded with n_local: the
        compact rounds' sorted-candidate contract)."""
        return torch.from_numpy(np.ascontiguousarray(
            rows_per_shard[self.mesh.row], np.int32)).to(self.device)
