"""Edge-stream IO (counterpart of ``pprx.graph.io``): edge-list text
parsing with first-seen renumbering, the packed ``.npz`` format, and the
synthetic streams.

Every function gives the reference's output bit for bit for the same input
(same generator calls, same renumbering, same sort), and a packed file
written by either package loads in the other, so both packages can be
driven on one stream without the port importing the JAX package. The text
parser runs natively (``csrc/edgeio.cpp`` through
``pprx_torch.graph.native_io``) where a C++ compiler exists, in Python
otherwise.
"""

from __future__ import annotations

import numpy as np


def load_edge_list(
    path: str, comments: str = "#%", use_native: bool | None = None
) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse a whitespace-separated edge-list text file.

    Lines are ``src dst [timestamp ...]``; lines starting with any character
    in ``comments`` are skipped, and so are malformed ones. Vertices are
    renumbered densely by first appearance (``renumber``). If a third
    column exists, edges are sorted by it (stable) to form the stream order;
    otherwise file order is stream order.

    ``use_native=None`` uses the native parser where a C++ compiler exists
    (it is built on first use; a build that fails raises) and the Python
    one elsewhere; True requires the native parser (raises without a
    compiler); False parses in Python.

    Returns ``(src, dst, n)`` with int32 arrays in stream order.
    """
    from pprx_torch.graph import native_io

    if use_native or (use_native is None and native_io.available()):
        src, dst, ts, has_ts = native_io.parse_edgelist_raw(path)
        if has_ts and not _nondecreasing(ts):
            order = np.argsort(ts, kind="stable")
            src, dst = src[order], dst[order]
        return renumber(src, dst)
    srcs: list[int] = []
    dsts: list[int] = []
    ts: list[float] = []
    has_ts = False
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line[0] in comments:
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                s, d = int(parts[0]), int(parts[1])
            except ValueError:
                continue  # malformed line (the native parser's policy)
            t = 0.0
            if len(parts) >= 3:
                try:
                    t = float(parts[2])
                    has_ts = True
                except ValueError:
                    pass
            srcs.append(s)
            dsts.append(d)
            ts.append(t)
    src = np.asarray(srcs, dtype=np.int64)
    dst = np.asarray(dsts, dtype=np.int64)
    if has_ts and not _nondecreasing(np.asarray(ts)):
        order = np.argsort(np.asarray(ts), kind="stable")
        src, dst = src[order], dst[order]
    return renumber(src, dst)


def _nondecreasing(ts: np.ndarray) -> bool:
    """Timestamped streams usually arrive in time order: one O(M) check
    skips the stable argsort."""
    return ts.size < 2 or bool(np.all(ts[1:] >= ts[:-1]))


def renumber(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Densely renumber vertex ids by first appearance in the (src, dst)
    interleave (deterministic).

    When the raw ids are non-negative and their range is not much larger
    than the edge count, the first-seen map is built with O(M) scatters: a
    reverse-order fancy assignment leaves each id's first position as the
    final write, and ranking the present ids by that position gives the same
    mapping as sorting the interleave with ``np.unique``, which is the path
    for every other id range.
    """
    inter = np.empty(src.size * 2, dtype=np.int64)
    inter[0::2] = src
    inter[1::2] = dst
    max_id = int(inter.max()) if inter.size else -1
    min_id = int(inter.min()) if inter.size else 0
    if 0 <= min_id and 0 <= max_id and max_id + 1 <= max(2 * inter.size, 1 << 20):
        first_pos = np.full(max_id + 1, np.iinfo(np.int64).max, np.int64)
        first_pos[inter[::-1]] = np.arange(inter.size - 1, -1, -1)
        present = np.flatnonzero(first_pos != np.iinfo(np.int64).max)
        order = np.argsort(first_pos[present], kind="stable")
        rank = np.empty(max_id + 1, dtype=np.int32)
        rank[present[order]] = np.arange(present.size, dtype=np.int32)
        mapped = rank[inter]
        return mapped[0::2].copy(), mapped[1::2].copy(), int(present.size)
    uniq, first_pos, inverse = np.unique(inter, return_index=True, return_inverse=True)
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty(order.size, dtype=np.int32)
    rank[order] = np.arange(order.size, dtype=np.int32)
    mapped = rank[inverse]
    return mapped[0::2].copy(), mapped[1::2].copy(), int(uniq.size)


def save_packed(path: str, src: np.ndarray, dst: np.ndarray, n: int) -> None:
    """Pack a renumbered edge stream to ``.npz``: int32 ``src``, ``dst`` and
    an int64 ``n``, as the reference writes it."""
    np.savez_compressed(
        path,
        src=np.asarray(src, dtype=np.int32),
        dst=np.asarray(dst, dtype=np.int32),
        n=np.int64(n),
    )


def load_packed(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """``(src, dst, n)`` of a packed ``.npz`` written by either package."""
    with np.load(path) as z:
        return z["src"], z["dst"], int(z["n"])


def synthetic_powerlaw_stream(
    n: int, m: int, seed: int = 0, exponent: float = 0.8
) -> tuple[np.ndarray, np.ndarray, int]:
    """Edge stream (int32 src, dst, in stream order) whose endpoints follow
    a Zipf-like popularity (rank^-exponent) over a random permutation of
    the n vertices. Self-loops are redrawn; parallel edges stay."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-exponent)
    probs /= probs.sum()
    perm = rng.permutation(n)
    src = perm[rng.choice(n, size=m, p=probs)]
    dst = perm[rng.choice(n, size=m, p=probs)]
    bad = src == dst
    while bad.any():
        dst[bad] = perm[rng.choice(n, size=int(bad.sum()), p=probs)]
        bad = src == dst
    return src.astype(np.int32), dst.astype(np.int32), n


def synthetic_erdos_stream(n: int, m: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
    """Uniform random edge stream (Erdos-Renyi-style, parallel edges kept;
    self-loops redrawn)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    bad = src == dst
    while bad.any():
        dst[bad] = rng.integers(0, n, size=int(bad.sum()))
        bad = src == dst
    return src.astype(np.int32), dst.astype(np.int32), n
