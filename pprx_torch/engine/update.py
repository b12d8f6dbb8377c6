"""Batched invariant-exact edge corrections (port of ``pprx.engine.update``).

Forward mode, beta = (1-alpha)/alpha, per source vertex u with old degree
d, k edges deleted then (with p', d' the post-delete values) k' inserted:

  delete batch:  per edge (u,w):  r[w] -= beta * p[u]/d
                 D = d-k >= 1:    p[u] *= D/d;   r[u] += k*p[u]/(alpha*d)
                 D == 0:          p[u] *= 1/d;   r[u] += (k-alpha)*p[u]/(alpha*d)
  insert batch:  per edge (u,w):  r[w] += beta * p'[u]/max(d',1)
                 d' >= 1:         p'[u] *= (d'+k')/d'; r[u] -= k'*p'[u]/(alpha*d')
                 d' == 0, k'>=1:  p'[u] *= k';         r[u] -= (k'-alpha)*p'[u]/alpha

Reverse mode (p unchanged; needs the row means of p over each out-row):

  r[u] += beta * ((P'p)(u) - (Pp)(u))
  (Pp)(u) = mean of p over u's out-row, or p(u) if u is dangling.

``(P'p) - (Pp)`` is non-zero only at rows whose out-edges changed, so the
new row sums are the old ones plus two batch-sized sums. The old row sums
are one sweep of the whole window: the caller passes them in (``rowsum``;
every driver gets them from ``window_row_sums``, the segment-sum kernel
over its delivery-sorted views), or they are summed here from the COO ring
in edge blocks (``out_row_sums``, the tests' witness), so that no
``[W, S]`` array is built.

Every per-edge sum (forward into ``r``, reverse into the new row sums) is
the segment sum K1 over the batch's lanes sorted by the row they add to:
deletions, then insertions, each one call (``segsum_add_`` of the
materialised forward payloads and of the negated reverse deletion rows,
``segsum_gather_add_`` of the reverse insertion rows read from ``p``),
counted under K1's ``corrections`` site. A caller whose batches arrive
sorted by that row says so (``keys_sorted``) and the lanes go to K1 as
they lie; otherwise one stable sort each (``segsum.sorted_deliver_``). On
the card every run of the same inputs gives the same bits; on the CPU the
plain version adds each row's lanes in their batch order, as the
reference's scatter does. Batches are phantom-padded (u = w = N); phantom
entries are exact no-ops because p[N] = 0.

Every row-wise factor is the identity outside the batch's source rows
(forward ``c_r = 0``, ``c_p = 1``; reverse ``(P'p - Pp)(u) = 0``), so the
row work runs on those rows alone (``source_rows``: a list of static
length, at most the batches' lanes, padded with the phantom row): one pass
over the listed rows (``rowpass.corr_forward_``, ``corr_reverse_``: a
kernel on the card; on the CPU the same torch operations on the rows
gathered, then written back), the same operations in the same order, so
the bits of a pass over all ``N + 1`` rows, at a fraction of its bytes.
Reverse mode's new row sums are built in a ``[T, S]`` block, T the list's
length, each lane keyed by its row's place in the list (the list ascends,
so sorted lanes stay sorted).
"""

from __future__ import annotations

import torch

from pprx_torch.config import PprConfig
from pprx_torch.engine.rowpass import corr_forward_, corr_reverse_
from pprx_torch.engine.segsum import (compact, row_offsets, segsum_add_, segsum_gather_add_,
                                      sorted_deliver_)
from pprx_torch.engine.state import FORWARD, PprState
from pprx_torch.graph.dynamic import WindowGraph

# Most bytes of gathered rows a COO sweep holds at once (its edge block).
EDGE_BLOCK_BYTES = 1 << 28


def _counts(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int32 histogram of ``idx`` over ``n_rows`` bins. (``torch.bincount``
    on CUDA reads the max back to the host; this does not.)"""
    out = torch.zeros(n_rows, dtype=torch.int32, device=idx.device)
    return out.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def edge_blocks(n_edges: int, row_bytes: int):
    """``(lo, hi)`` ranges that cut ``n_edges`` edges into blocks whose
    gathered rows (``row_bytes`` each) stay within ``EDGE_BLOCK_BYTES``."""
    block = max(1, EDGE_BLOCK_BYTES // max(row_bytes, 1))
    for lo in range(0, n_edges, block):
        yield lo, min(lo + block, n_edges)


def window_row_sums(p: torch.Tensor,
                    views: list[tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Reverse mode's ``rowsum[u] = sum of p[w] over the window's edges
    (u, w)`` from a driver's delivery views: ``(gat, off)`` pairs sorted by
    ``src`` and gathering ``dst``, ``off`` over rows ``[0, N]``, which
    together hold the old window (a slot killed or not yet filled names row
    N, which is zero in ``p``), as ``push.dense_round_`` takes them. One
    launch of the segment sum's gather entry into zeros per view, in the
    order given: no ``[W, S]`` array and no atomics."""
    rowsum = torch.zeros_like(p)
    for gat, off in views:
        segsum_gather_add_(rowsum[:p.shape[0] - 1], p, gat, off)
    return rowsum


def out_row_sums(p: torch.Tensor, graph: WindowGraph) -> torch.Tensor:
    """``rowsum[u] = sum of p[w] over the window's edges (u, w)``, from the
    COO ring in edge blocks (``index_add_`` per block)."""
    rowsum = torch.zeros_like(p)
    for lo, hi in edge_blocks(graph.capacity, p.shape[1] * p.element_size()):
        rowsum.index_add_(0, graph.src[lo:hi], p[graph.dst[lo:hi]])
    return rowsum


def source_rows(del_src: torch.Tensor, ins_src: torch.Tensor,
                n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows whose own values a batch's corrections change: the unique
    source rows of both batches, ascending, int64 ``[min(L, n_rows)]`` (L
    the batches' lanes together), padded with the phantom row ``n_rows -
    1``; and how many are real rows, a device scalar (nothing is read back,
    so a capture takes it)."""
    n = n_rows - 1
    mark = torch.zeros(n_rows, dtype=torch.bool, device=del_src.device)
    for src in (del_src, ins_src):
        mark.index_fill_(0, src.long(), True)
    size = min(del_src.shape[0] + ins_src.shape[0], n_rows)
    return compact(mark[:n], size, n).long(), mark[:n].sum()


def _add_lanes_(rin: torch.Tensor, keys: torch.Tensor, table: torch.Tensor,
                rows: torch.Tensor | None, keys_sorted: bool) -> None:
    """``rin[keys[j]] += table[rows[j]]`` (``table[j]`` without ``rows``)
    through K1 at the ``corrections`` site: over the lanes as they lie
    where ``keys`` ascend, else after one stable sort."""
    if not keys_sorted:
        sorted_deliver_(rin, keys, table, rows, site="corrections")
        return
    off = row_offsets(keys, rin.shape[0])
    if rows is None:
        segsum_add_(rin, table, off, site="corrections")
    else:
        segsum_gather_add_(rin, table, rows, off, site="corrections")


def apply_edge_batch(
    state: PprState,
    graph: WindowGraph,
    ins_src: torch.Tensor,
    ins_dst: torch.Tensor,
    del_src: torch.Tensor,
    del_dst: torch.Tensor,
    cfg: PprConfig,
    rowsum: torch.Tensor | None = None,
    keys_sorted: bool = False,
) -> tuple[PprState, WindowGraph]:
    """Apply one batch of edge deletions then insertions.

    Returns a new state and a new window (new ``p``, ``r`` and ``deg``, the
    same ring); the inputs are not modified. ``apply_edge_batch_`` on
    copies: see there."""
    out = PprState(p=state.p.clone(), r=state.r.clone(), mode=state.mode)
    new_graph = WindowGraph(src=graph.src, dst=graph.dst, deg=graph.deg.clone())
    return apply_edge_batch_(out, new_graph, ins_src, ins_dst, del_src, del_dst, cfg, rowsum,
                             keys_sorted)


def apply_edge_batch_(
    state: PprState,
    graph: WindowGraph,
    ins_src: torch.Tensor,
    ins_dst: torch.Tensor,
    del_src: torch.Tensor,
    del_dst: torch.Tensor,
    cfg: PprConfig,
    rowsum: torch.Tensor | None = None,
    keys_sorted: bool = False,
    rows: torch.Tensor | None = None,
) -> tuple[PprState, WindowGraph]:
    """Apply one batch of edge deletions then insertions in place:
    ``state.r``, in forward mode ``state.p``, and ``graph.deg`` are
    updated; returns ``(state, graph)``. The COO ring itself is rewritten
    by the stream driver: reverse-mode corrections read the old ring, so
    call this before overwriting expiring slots. Deletion batches must be
    valid: every (u,w) currently in the graph, with multiplicity.

    Forward, both per-edge scatters go into ``r`` first (the insert
    payload is ``beta * p[u] * s1[u] / d1[u]``, ``s1`` the delete phase's
    row scale: the post-delete ``p'[u]``), then one row pass
    ``r += c_r * p; p *= c_p`` with ``c_r = r_add - r_sub * s1`` and
    ``c_p = s1 * s2`` per row: the two phases' row updates in one, on the
    source rows alone.

    ``rowsum`` (reverse mode only): the ``[N+1, S]`` sums of ``p`` over each
    vertex's out-row in the old window, where the caller has them;
    ``None`` sums them here (``out_row_sums``). It is read, not written;
    the new row sums take a ``[T, S]`` block, T the source rows' list.

    ``rows``: the batch's ``source_rows`` list, where the caller has made
    it (the fast driver counts its rows); ``None`` makes it here.

    ``keys_sorted``: each batch is already in ascending order of the row
    its lanes add to (forward ``dst``, reverse ``src``), as the fast driver
    sorts them, so K1 takes the lanes as they lie. Nothing checks it: a
    captured prologue may not read the device.
    """
    dtype = state.r.dtype
    n_rows = state.p.shape[0]
    alpha = cfg.alpha
    beta = (1.0 - alpha) / alpha
    d0 = graph.deg
    k_del = _counts(del_src, n_rows)
    k_ins = _counts(ins_src, n_rows)
    p, r = state.p, state.r
    deg_new = d0 - k_del + k_ins
    deg_new[-1:].fill_(0)  # phantom row degree pinned (a slice: capturable)
    if rows is None:
        rows = source_rows(del_src, ins_src, n_rows)[0]

    if state.mode != FORWARD:
        if rowsum is None:
            rowsum = out_row_sums(p, graph)
        # pp_new - pp_old on the source rows (0 elsewhere), built in one
        # [T, S] block: pp is the mean of p over the out-row, or p itself on
        # a dangling row (whose old row sum is 0). The old sums' rows, then
        # the deletions' rows negated and the insertions' read from p, each
        # lane at its row's place in the list: each row's lanes in the order
        # of the form ``rowsum - x1 - x2 + y1``
        diff = rowsum[rows]
        _add_lanes_(diff, torch.searchsorted(rows, del_src.long()), p[del_dst].neg_(), None,
                    keys_sorted)
        _add_lanes_(diff, torch.searchsorted(rows, ins_src.long()), p, ins_dst, keys_sorted)
        # then the means, pp_new - pp_old and r += beta * it: one pass over
        # the listed rows (``rowpass.corr_reverse_``)
        corr_reverse_(r, p, rowsum, diff, rows, deg_new, d0, beta)
        r[-1] = 0.0
        graph.deg.copy_(deg_new)
        return state, graph

    # ---- delete phase (old p, old degrees) ----
    d0f = d0.clamp(min=1).to(dtype)
    _add_lanes_(r, del_dst, (beta * p[del_src] / d0f[del_src, None]).neg_(), None, keys_sorted)
    D = d0 - k_del
    touched = k_del > 0
    full = touched & (D == 0)
    s1 = torch.where(touched, D.clamp(min=1).to(dtype) / d0f, 1.0)
    kd = k_del.to(dtype)
    num = torch.where(full, kd - alpha, kd)
    r_add = torch.where(touched, num / (alpha * d0f), 0.0)

    # ---- insert phase (post-delete p = p * s1, post-delete degrees) ----
    d1 = D
    d1f = d1.clamp(min=1).to(dtype)
    _add_lanes_(r, ins_dst, beta * (p[ins_src] * s1[ins_src, None]) / d1f[ins_src, None], None,
                keys_sorted)
    touched = k_ins > 0
    from_dangling = touched & (d1 == 0)
    ki = k_ins.to(dtype)
    s2 = torch.where(
        touched, torch.where(from_dangling, ki, (d1 + k_ins).to(dtype) / d1f), 1.0
    )
    num = torch.where(from_dangling, ki - alpha, ki)
    denom = torch.where(from_dangling, alpha, alpha * d1f)
    r_sub = torch.where(touched, num / denom, 0.0)

    # ---- both phases' row updates in one pass over the source rows ----
    corr_forward_(r, p, rows, r_add - r_sub * s1, s1 * s2)
    p[-1] = 0.0
    r[-1] = 0.0
    graph.deg.copy_(deg_new)
    return state, graph
