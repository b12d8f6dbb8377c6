"""Delivery-sorted segment sum (port of ``pprx.engine.segsum``).

The hot op of every window-scale push round is

    r[w, :] += sum over delivery-sorted edges j with seg[j] == w of contrib[j, :]

The edges are already grouped by destination row, so row w's contributions
are the contiguous range ``[row_off[w], row_off[w+1])``. Two entries:

- ``segsum_add_(rin, contribs, row_off)`` sums rows of a materialised
  ``[W, S]`` array;
- ``segsum_gather_add_(rin, table, gat, row_off)`` sums ``table[gat[j]]``,
  what the reference's callers write as ``segsum_add(r, moving[gat], ...)``,
  without the ``[W, S]`` array.

Both take an optional ``row_scale`` (one factor per output row on the row's
sum): reverse push multiplies every edge's contribution by the inverse
out-degree of its destination row, which is one factor per row.

On CUDA tensors both launch the hand-written Hopper kernels of
``pprx_torch/csrc/segsum.cu`` (built at first use by ``pprx_torch._ext``):
an edge-balanced pass and a small pass over the rows that span chunks,
deterministic, no atomics. A state that fills a warp's lanes runs the wide
kernels (lanes over columns); a narrower one (S=8, S=16: configs 3 and 2)
the narrow ones, where several edges share a warp step. ``layout_for``
chooses, from S and the length of the edge array alone. On CPU tensors
they run the plain versions, ``segsum_add_plain`` and
``segsum_gather_add_plain``.

The TPU kernel's tile offsets, EC padding, lane padding of narrow states
to 128, ``[W_pad/128, 128]`` seg-id reshape and limb-split precision modes
existed for Mosaic and are not ported: the port keeps per-row offsets
(``row_offsets``) and accumulates in f32.

The module also holds ``compact``, the engines' fixed-size
``jnp.nonzero``, so that no engine imports another for a list primitive.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from pprx_torch import _ext

# Calls that launched the kernels since the last reset, by (entry, whether
# the call had a ``row_scale``): a run shows that its main path went through
# a kernel by setting these to 0 before and reading them after.
ENTRIES = ("segsum_add", "segsum_gather_add")
LAUNCHES = {(entry, scaled): 0 for entry in ENTRIES for scaled in (False, True)}

# The same calls by call site (a wrapper's ``site``): the hybrid engine's
# worklist rounds and sparse scans, ``wlp``'s group sum, a slide's edge
# corrections (every driver's, and the 1x1 sharded engines'), and every
# other call.
SITES = ("worklist", "sparse_scan", "group_sum", "corrections", "other")
SITE_LAUNCHES = {site: 0 for site in SITES}


def reset_launches() -> None:
    for counts in (LAUNCHES, SITE_LAUNCHES):
        for key in counts:
            counts[key] = 0


def launches(entry: str | None = None, scaled: bool | None = None,
             since: dict | None = None) -> int:
    """Launches counted since the last reset, or since ``since`` (an earlier
    ``dict(LAUNCHES)``): of one entry or of both, with a ``row_scale``,
    without, or either."""
    return sum(
        count - (since[key] if since else 0)
        for key, count in LAUNCHES.items()
        if entry in (None, key[0]) and scaled in (None, key[1])
    )


def row_offsets(sorted_ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int32 [n_rows+1] CSR offsets of an ascending non-negative id array:
    row w owns positions [off[w], off[w+1]); ids >= n_rows lie past
    off[n_rows]."""
    bounds = torch.arange(n_rows + 1, dtype=sorted_ids.dtype, device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, bounds, out_int32=True)


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


def segment_ids(row_off: torch.Tensor) -> torch.Tensor:
    """The row of each edge in ``[row_off[0], row_off[-1])``: the inverse
    of ``row_offsets`` over that range."""
    rows = torch.arange(row_off.shape[0] - 1, dtype=row_off.dtype, device=row_off.device)
    return torch.repeat_interleave(rows, row_off.diff())


def _add_rows_plain(rin, ids, rows, row_scale) -> torch.Tensor:
    """``rin[ids[j]] += rows[j]``, or with a scale the rows' sums times
    ``row_scale`` (summed unscaled first, as the kernel does)."""
    if row_scale is None:
        return rin.index_add_(0, ids, rows)
    sums = torch.zeros_like(rin).index_add_(0, ids, rows)
    return rin.add_(sums * row_scale.to(rin.dtype)[:, None])


def segsum_add_plain(
    rin: torch.Tensor,
    contribs: torch.Tensor,
    row_off: torch.Tensor,
    row_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version, from the same row ranges the kernel reads:
    ``rin[w] += [row_scale[w] *] sum of contribs[j]`` for j in
    ``[row_off[w], row_off[w+1])``, in place, in ``rin``'s dtype."""
    lo, hi = int(row_off[0]), int(row_off[-1])
    rows = contribs[lo:hi].to(rin.dtype)
    return _add_rows_plain(rin, segment_ids(row_off), rows, row_scale)


def segsum_gather_add_plain(
    rin: torch.Tensor,
    table: torch.Tensor,
    gat: torch.Tensor,
    row_off: torch.Tensor,
    row_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of the gather entry: ``rin[w] += [row_scale[w] *]
    sum of table[gat[j]]`` for j in ``[row_off[w], row_off[w+1])``, in
    place, in ``rin``'s dtype."""
    lo, hi = int(row_off[0]), int(row_off[-1])
    rows = table[gat[lo:hi]].to(rin.dtype)
    return _add_rows_plain(rin, segment_ids(row_off), rows, row_scale)


_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _entries() -> dict:
    """The C entry points of the built ``segsum`` library, by (source dtype,
    index dtype or None for the unfused entry)."""
    lib = _ext.load("segsum")
    fns = {
        (torch.float32, None): lib.pprx_segsum_add_f32,
        (torch.bfloat16, None): lib.pprx_segsum_add_bf16,
        (torch.float32, torch.int32): lib.pprx_segsum_gather_add_f32_i32,
        (torch.float32, torch.int64): lib.pprx_segsum_gather_add_f32_i64,
        (torch.bfloat16, torch.int32): lib.pprx_segsum_gather_add_bf16_i32,
        (torch.bfloat16, torch.int64): lib.pprx_segsum_gather_add_bf16_i64,
    }
    for (_, idx), fn in fns.items():
        # rin, source, [gat,] row_off, row_scale, scratch, n_rows, s, n_edges,
        # chunk, vec, lanes, stream
        ptrs = 5 if idx is None else 6
        fn.argtypes = [*[_PTR] * ptrs, _INT, _INT, _LONG, _INT, _INT, _INT, _PTR]
        fn.restype = _INT
    return fns


# ---- the layout of a call: a pure function of (S, length of the edge array)
# that the kernels are told, so that the scratch is sized from the same
# numbers and a CPU test can pin them. The source types (f32, bf16) share it.

WARP = 32
# Edges per chunk (one warp's share): the most, the fewest, and the number
# of chunks below which the chunk is halved; swept on the card, the tables
# are in the kernel source. Wide: lanes over columns alone (32 lanes an
# edge). Narrow: 1.0M edges keep 256 (3,906 chunks), a fresh view gets 64.
CHUNK_WIDE = (256, 64, 4096)
CHUNK_NARROW = (256, 64, 2048)


@dataclasses.dataclass(frozen=True)
class Layout:
    """How the kernels walk one call's edges."""

    vec: int  # columns a lane loads at once (4: 16 bytes of f32, 8 of bf16)
    lanes: int  # lanes per edge, a power of two; 32: the wide kernels
    edges_per_step: int  # edges a warp loads in one step: 32 // lanes
    chunk: int  # edges per warp


def lanes_for(s: int) -> tuple[int, int]:
    """(columns per lane, lanes per edge) for a state of ``s`` columns: 4
    columns a lane where ``s`` is a multiple of 4, else 1, and the least
    power of two of lanes that covers ``s``, at most a warp (a wider state
    goes round the warp's lanes again)."""
    vec = 4 if s % 4 == 0 else 1
    lanes = 1
    while lanes < WARP and lanes * vec < s:
        lanes *= 2
    return vec, lanes


def chunk_for(n_edges: int, s: int) -> int:
    """Edges per chunk for an edge array of ``n_edges`` at ``s`` columns:
    the largest of most, most / 2, ... fewest that still cuts the array
    into the wanted number of chunks (about one per warp the card holds at
    once), so that a short call (a fresh view, a compact round) spreads as
    wide as a window scan does. The same inputs are always cut the same
    way; the card tests replace this function to force a split."""
    most, fewest, wanted = CHUNK_WIDE if lanes_for(s)[1] == WARP else CHUNK_NARROW
    c = most
    while c > fewest and n_edges // c < wanted:
        c //= 2
    return c


def layout_for(s: int, n_edges: int) -> Layout:
    vec, lanes = lanes_for(s)
    return Layout(vec, lanes, WARP // lanes, chunk_for(n_edges, s))


def _check(what, rin, source, name, gat, row_off, row_scale) -> None:
    """Shapes, and for CUDA tensors what the kernels take; ``name`` is what
    the entry calls its source operand."""
    if rin.dim() != 2 or source.dim() != 2 or source.shape[1] != rin.shape[1]:
        raise ValueError(
            f"{what}: rin [R, S] and {name} [*, S] expected, got "
            f"{tuple(rin.shape)} and {tuple(source.shape)}"
        )
    if row_off.shape != (rin.shape[0] + 1,) or row_off.dtype != torch.int32:
        raise ValueError(f"{what}: row_off must be int32 [{rin.shape[0] + 1}]")
    operands = [rin, source, row_off]
    if gat is not None:
        if gat.dim() != 1 or gat.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{what}: gat must be a 1-D int32 or int64 tensor")
        operands.append(gat)
    if row_scale is not None:
        if row_scale.shape != (rin.shape[0],) or not row_scale.is_floating_point():
            raise ValueError(f"{what}: row_scale must be a float [{rin.shape[0]}] tensor")
        operands.append(row_scale)
    devs = {t.device for t in operands}
    if len(devs) != 1:
        raise ValueError(f"{what}: all operands must be on one device, got {devs}")
    if rin.device.type == "cpu":
        return
    if rin.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {rin.device}")
    if rin.dtype != torch.float32:
        raise TypeError(f"{what} on CUDA takes an f32 rin, got {rin.dtype}")
    if source.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} on CUDA takes f32 or bf16 {name}, got {source.dtype}")
    if row_scale is not None and row_scale.dtype != torch.float32:
        raise TypeError(f"{what} on CUDA takes an f32 row_scale, got {row_scale.dtype}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"{what} on CUDA needs contiguous operands")
    if source.shape[0] >= 2**31:
        raise ValueError(f"{what} on CUDA takes fewer than 2**31 rows of {name}")
    if rin.data_ptr() % 16 or source.data_ptr() % 16:
        raise ValueError(f"{what} on CUDA needs 16-byte-aligned rin and {name}")


def _check_site(what: str, site: str) -> None:
    if site not in SITE_LAUNCHES:
        raise ValueError(f"{what}: unknown call site {site!r}")


def _launch(entry: str, rin, source, gat, row_off, row_scale, site: str) -> None:
    """Both launches of one call on checked CUDA operands, on the current
    stream. The grid and the scratch are sized from the length of the edge
    array, which bounds ``row_off[R] - row_off[0]``: nothing is read back
    from the device. With no rows or no edge array there is no launch and
    no count."""
    n_rows, s = rin.shape
    n_edges = source.shape[0] if gat is None else gat.shape[0]
    if n_rows == 0 or n_edges == 0 or s == 0:
        return
    lay = layout_for(s, n_edges)
    n_chunks = -(-n_edges // lay.chunk)
    # uninitialised on purpose: the second pass reads only what the first wrote
    scratch = torch.empty((n_chunks, 2, s), dtype=torch.float32, device=rin.device)
    fn = _entries()[source.dtype, None if gat is None else gat.dtype]
    gat_ptr = () if gat is None else (gat.data_ptr(),)
    with torch.cuda.device(rin.device):
        stream = torch.cuda.current_stream(rin.device).cuda_stream
        err = fn(
            rin.data_ptr(), source.data_ptr(), *gat_ptr, row_off.data_ptr(),
            None if row_scale is None else row_scale.data_ptr(),
            scratch.data_ptr(), n_rows, s, n_edges, lay.chunk, lay.vec, lay.lanes, stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    LAUNCHES[entry, row_scale is not None] += 1
    SITE_LAUNCHES[site] += 1


def segsum_add_(
    rin: torch.Tensor,
    contribs: torch.Tensor,
    row_off: torch.Tensor,
    row_scale: torch.Tensor | None = None,
    site: str = "other",
) -> torch.Tensor:
    """``rin[w] += [row_scale[w] *] sum_{j in [row_off[w], row_off[w+1])}
    contribs[j]``, in place; returns ``rin``. Edges outside ``[row_off[0], row_off[R])`` are
    not read: a caller drops the phantom row's padding edges by passing
    ``rin[:n]`` and ``row_off[:n+1]``.

    contribs: [W, S], sorted by row, f32 or bf16 on CUDA, with f32
        accumulation into an f32 ``rin``.
    row_off: int32 [R+1] per-row edge ranges (``row_offsets(ids, R)`` of
        the edges' ascending row ids); the kernel and the plain version
        both read only these.
    row_scale: optional [R], one factor per row on the row's sum (f32 on
        CUDA); ``None`` is the plain sum, bit for bit what it was without
        the argument.
    site: the call site a launch is counted under (``SITES``).
    """
    _check("segsum_add_", rin, contribs, "contribs", None, row_off, row_scale)
    _check_site("segsum_add_", site)
    if rin.device.type == "cpu":
        return segsum_add_plain(rin, contribs, row_off, row_scale)
    _launch("segsum_add", rin, contribs, None, row_off, row_scale, site)
    return rin


def segsum_gather_add_(
    rin: torch.Tensor,
    table: torch.Tensor,
    gat: torch.Tensor,
    row_off: torch.Tensor,
    row_scale: torch.Tensor | None = None,
    site: str = "other",
) -> torch.Tensor:
    """``rin[w] += [row_scale[w] *] sum_{j in [row_off[w], row_off[w+1])}
    table[gat[j]]``, in place; returns ``rin``:
    ``segsum_add_(rin, table[gat], row_off, row_scale)`` without the
    ``[W, S]`` array. Entries of ``gat`` outside
    ``[row_off[0], row_off[R])`` are not read.

    table: [T, S], f32 or bf16 on CUDA, with f32 accumulation into an f32
        ``rin``; ``rin`` may have fewer or more rows than ``table``.
    gat: int32 or int64 [W], row of ``table`` for each delivery-sorted
        edge; the kernel does not check that they lie in ``[0, T)``.
    row_off: int32 [R+1], as for ``segsum_add_``.
    row_scale: optional [R], as for ``segsum_add_``.
    site: the call site a launch is counted under (``SITES``).
    """
    _check("segsum_gather_add_", rin, table, "table", gat, row_off, row_scale)
    _check_site("segsum_gather_add_", site)
    if rin.device.type == "cpu":
        return segsum_gather_add_plain(rin, table, gat, row_off, row_scale)
    _launch("segsum_gather_add", rin, table, gat, row_off, row_scale, site)
    return rin


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
