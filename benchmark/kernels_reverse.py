"""The bytes of a reverse slide's two K1 passes over the window, for their
shares of the byte bound (``kernels.k1_share``: over 3.35 TB/s).

A reverse delivery view sorts the window's edges by ``src`` and gathers at
``dst`` (``reverse_view``). Both passes count ``kernels.k1_bytes`` on it:
every table row the edges name, the edge list, ``rin`` read and written,
the row offsets. On top of that:

- the row-sum sweep (from the ``rev.rowsum`` stamp to ``rev.corrections``):
  the zero fill of its ``[N+1, S]`` sums, and the second launch, over the
  fresh view, reading and writing ``rin`` again with its own offsets
  (the fresh view's few edges and rows are left out);
- a reverse scan round's K1 over the window (``k1.window``): the row scale
  1 / d_out of every receiving row, N floats.
"""

from __future__ import annotations

from benchmark import flight, kernels


def reverse_view(src, dst, n: int, device):
    """The window's edges sorted by ``src`` (stable), on ``device``: each
    edge's ``dst`` (``gat``) and the offsets of rows ``0..n``, int32."""
    return kernels.forward_view(dst, src, n, device)


def sweep_bytes(gat, n: int, s: int) -> int:
    return kernels.k1_bytes(gat, n, s) + 2 * n * s * 4 + (n + 1) * 4 + (n + 1) * s * 4


def round_bytes(gat, n: int, s: int) -> int:
    return kernels.k1_bytes(gat, n, s) + n * 4


def probe(cell, info: dict) -> dict:
    """The recorder's sums and the two byte counts on the run's final
    window, once a run (every reverse metric's probe calls this)."""
    out = flight.probe(cell)
    if "rev_bytes" not in cell.record:
        n, s = info["n"], info["s"]
        gat, _ = reverse_view(info["src"], info["dst"], n, cell.device)
        out["rev_bytes"] = {"sweep": sweep_bytes(gat, n, s), "round": round_bytes(gat, n, s)}
    return out


def share(record: dict, key: str, stamp: str) -> float | None:
    """``key``'s bytes over the median ``stamp`` interval of the window's
    loops, in % of the byte bound; ``None`` where either is missing."""
    got, ms = record.get("rev_bytes"), flight.median_ms(record, stamp)
    return kernels.k1_share({"bytes": got[key], "ms": ms}) if got and ms else None
