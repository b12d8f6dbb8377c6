"""CSR snapshot, signed overlay, frontier compaction and edge-balanced
expansion (port of ``pprx.engine.frontier``).

What the module does is the reference's:

- the snapshot is the window's COO sorted by the mode's gather endpoint
  (src forward, dst reverse), with row offsets; rows keep expired edges
  until the next rebuild, and the overlay's -1 entries cancel them;
- the overlay is a signed COO ring of the edge changes since the snapshot
  (-1 for an expiry, +1 for an insertion, 0 for an unused slot);
- the frontier is compacted to a fixed-size list of row ids padded with
  the phantom row N;
- expansion enumerates the frontier's snapshot EDGES, one lane each, and
  maps every lane back to its row by a scatter of row starts and a cumsum
  (a run-length decode), so a heavy row costs no more per lane than a
  light one.

How the port differs: ``jnp.nonzero(size=, fill_value=)`` is
``pprx_torch.engine.segsum.compact`` (no host sync), and the row offsets of a
sorted key come from a histogram and a cumsum, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from pprx_torch.engine.segsum import compact
from pprx_torch.engine.update import _counts


@dataclasses.dataclass
class CsrSnapshot:
    """Adjacency snapshot sorted by gather endpoint.

    offsets: int32[n+2] row pointer over vertex ids 0..n (phantom n included).
    nbr: int32[capacity] the other endpoint, row-major.
    row_len: int32[n+1] snapshot row lengths (not current degrees: rows
        keep expired edges until the next rebuild).
    """

    offsets: torch.Tensor
    nbr: torch.Tensor
    row_len: torch.Tensor


def build_snapshot(key: torch.Tensor, other: torch.Tensor, n: int) -> CsrSnapshot:
    """CSR by a stable sort of the COO window on ``key`` (the gather
    endpoint); phantom entries (key == n) sort to the tail, into the
    phantom row."""
    _, order = torch.sort(key, stable=True)
    counts = _counts(key, n + 1)
    zero = torch.zeros(1, dtype=torch.int32, device=key.device)
    return CsrSnapshot(
        offsets=torch.cat([zero, torch.cumsum(counts, 0, dtype=torch.int32)]),
        nbr=other[order],
        row_len=counts,
    )


@dataclasses.dataclass
class Overlay:
    """Signed COO ring of the edge changes since the last snapshot.

    src/dst: int32[cap]; sign: int32[cap] in {-1, 0, +1} (0: slot unused).
    Its fill is counted on the host (``2 b`` a slide).
    """

    src: torch.Tensor
    dst: torch.Tensor
    sign: torch.Tensor

    @classmethod
    def empty(cls, cap: int, n: int, device: torch.device | str) -> "Overlay":
        return cls(
            src=torch.full((cap,), n, dtype=torch.int32, device=device),
            dst=torch.full((cap,), n, dtype=torch.int32, device=device),
            sign=torch.zeros(cap, dtype=torch.int32, device=device),
        )


def compact_frontier(act_any: torch.Tensor, fcap: int, n: int) -> torch.Tensor:
    """Ids of the active vertices, padded with phantom n to ``fcap``."""
    return compact(act_any[:n], fcap, n)


def expand(
    fidx: torch.Tensor, snap: CsrSnapshot, ecap: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-balanced expansion of the frontier's snapshot rows.

    Returns (t, nbr, valid, total): for each of ``ecap`` edge lanes, ``t``
    is the frontier position of its row (to gather per-frontier values),
    ``nbr`` the neighbor (phantom where the lane is invalid), ``valid`` the
    lane's mask, and ``total`` the frontier's true edge count (an int64
    device scalar; lanes past ``ecap`` are dropped, which the caller's
    capacity choice rules out).
    """
    n = snap.row_len.shape[0] - 1
    # padded rows are phantom n, whose snapshot row holds phantom-keyed
    # entries: they get no lanes
    row_len_f = torch.where(fidx == n, 0, snap.row_len[fidx])
    starts = snap.offsets[fidx]
    cum = torch.cumsum(row_len_f, 0, dtype=torch.int32)
    total = cum[-1].long()
    cum_prev = cum - row_len_f  # each row's first lane
    # lane -> row by scatter + cumsum: each row adds 1 at its first lane
    # (clamped to ecap); empty rows stack their 1 on the next row's first
    # lane, so the running count skips them
    j = torch.arange(ecap, dtype=torch.int32, device=fidx.device)
    boundary = _counts(cum_prev.clamp(max=ecap), ecap + 1)
    t = torch.cumsum(boundary[:ecap], 0, dtype=torch.int32) - 1
    t_c = t.clamp(0, fidx.shape[0] - 1)
    pos = starts[t_c] + (j - cum_prev[t_c])
    valid = j < total
    pos = torch.where(valid, pos, 0)
    nbr = torch.where(valid, snap.nbr[pos], n)
    return t_c, nbr, valid, total
