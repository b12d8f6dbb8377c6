"""Sums over the window from the program's flight recorder
(``pprx_torch.trace``), for the per-layer metrics that read it.

``window_sums(cell)`` takes the recorder's snapshot once a run, keeps what
lies in the window, ``[cell.t_open, cell.t_open + cell.window_s]`` on the
host's clock, and returns raw sums (device ms, counts, the device's idle ms
split by the host span it fell in), cached in ``cell.record["flight"]``; a
metric's ``read`` divides them by the window's slides or requests. Where the
program has no recorder (a tree older than it), there is nothing to read:
``window_sums`` returns ``None``, each probe returns nothing and each read
``None``.

Intervals are differences of the card's clock inside one run of stamps:
a stamp's interval runs to the next stamp (a round's, ``round.*``, to the
next round's or the loop's end). The idle is the window less the device's
busy intervals, each loop graph from ``loop.head`` to ``loop.end`` (the
stamps ``loop.launch`` before it and ``loop.read`` after it run as the graph
is launched and as it completes), each
step apart (``step.<kind>`` to its ``.end``) and each top-k (``topk`` to
``topk.end``), on the host's clock by the recorder's offsets; a driver's
share of it is what falls inside a slide's host spans other than
``loop.wait``, and the rest is left to the caller (the harness, and a
graph's launch latency inside ``loop.wait``, kept apart as ``wait``).
"""

from __future__ import annotations

import numpy as np

DRIVER_PARENTS = ("slide",)


def snapshot():
    """The recorder's snapshot, or ``None`` where the program has none."""
    try:
        from pprx_torch import trace
    except ImportError:
        return None
    return trace.RECORDER.snapshot()


def probe(cell) -> dict:
    """``{"flight": window_sums(...)}`` at the first call of a run, then
    nothing (the sums are in the record already)."""
    if "flight" in cell.record:
        return {}
    snap = snapshot()
    if snap is None:
        return {}
    t0 = int(round(cell.t_open * 1e9))
    return {"flight": window_sums(snap, t0, t0 + int(round(cell.window_s * 1e9)))}


def _intervals(tags: list[str], ns: np.ndarray) -> list[tuple[str, float]]:
    """Each stamp of one loop (or one run of stamps) and its interval in
    ms: to the next stamp, or for a round to the next round or the end."""
    out = []
    for i, name in enumerate(tags[:-1]):
        j = i + 1
        if name.startswith("round."):
            while j < len(tags) - 1 and not (tags[j].startswith("round.") or tags[j] == "loop.end"):
                j += 1
        out.append((name, (ns[j] - ns[i]) / 1e6))
    return out


def _quartiles(x: np.ndarray) -> list[float]:
    return np.percentile(x, [0, 25, 50, 75, 100]).tolist() if len(x) else []


def _merge(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(gaps: np.ndarray, spans: np.ndarray) -> float:
    """ns of ``gaps`` (rows start, end) that ``spans`` (rows start, end)
    cover, the spans not overlapping one another."""
    if not len(gaps) or not len(spans):
        return 0.0
    lo = np.maximum(gaps[:, None, 0], spans[None, :, 0])
    hi = np.minimum(gaps[:, None, 1], spans[None, :, 1])
    return float(np.clip(hi - lo, 0, None).sum())


def window_sums(snap: dict, t0: int, t1: int) -> dict:
    """The sums over ``[t0, t1]`` (host ns) of a recorder's snapshot."""
    names = snap["names"]
    st, lp, sp, ct = snap["stamps"], snap["loops"], snap["spans"], snap["counts"]
    tagname = np.array(names, dtype=object)
    inside = (lp["launch"] >= t0) & (lp["done"] <= t1) & (lp["done"] >= 0)
    loops = lp["seq"][inside]
    base = int(st["seq"][0]) if len(st["seq"]) else 0
    al = snap["align"]
    mine = np.isin(al["loop"], loops)
    # the alignment of the window's loops, us: each run's band and each
    # loop's own bracket, as min, quartiles, max
    out = {"loops": int(loops.size), "dropped": int(snap["dropped"]),
           "align_us": {k: _quartiles(al[k][mine] / 1e3) for k in ("width", "bracket")}}

    by_stamp: dict[str, list[float]] = {}
    rounds_ms: dict[str, float] = {}
    prologue = {"ms": 0.0, "sort_corrections": 0.0, "kill_ring": 0.0, "first_count": 0.0}
    busy: list[tuple[float, float]] = []
    for i in np.flatnonzero(inside):
        lo, hi = int(lp["first"][i]) - base, int(lp["stop"][i]) - base
        if lo < 0 or hi <= lo:
            continue
        tags = list(tagname[st["tag"][lo:hi]])
        ns = st["ns"][lo:hi]
        if "loop.head" not in tags or "loop.end" not in tags:
            continue
        head, end = tags.index("loop.head"), tags.index("loop.end")
        busy.append((st["host"][lo + head], st["host"][lo + end]))
        for name, ms in _intervals(tags, ns):
            by_stamp.setdefault(name, []).append(ms)
            if name.startswith("round."):
                rounds_ms[name] = rounds_ms.get(name, 0.0) + ms
            if name.startswith("prologue."):
                prologue[name[len("prologue."):]] += ms
        if "prologue.first_count" in tags:
            after = tags.index("prologue.first_count") + 1
            prologue["ms"] += (ns[after] - ns[head]) / 1e6

    # device work apart from the loops: steps and the top-k, each a pair
    outside = (st["loop"] < 0) & (st["host"] >= t0) & (st["host"] <= t1)
    open_at: dict[str, tuple[float, int]] = {}
    apart: dict[str, float] = {}
    for k in np.flatnonzero(outside):
        name = names[st["tag"][k]]
        if name.endswith(".end"):
            what = name[:-len(".end")]
            if what in open_at:
                h, n0 = open_at.pop(what)
                busy.append((h, st["host"][k]))
                apart[what] = apart.get(what, 0.0) + (st["ns"][k] - n0) / 1e6
        else:
            open_at[name] = (st["host"][k], st["ns"][k])

    execs: dict[str, int] = {}
    mine = np.isin(ct["loop"], loops)
    for t, c in zip(ct["tag"][mine], ct["execs"][mine]):
        execs[names[t]] = execs.get(names[t], 0) + int(c)

    # the idle: the window less the busy intervals, split by host span
    merged = _merge([(max(a, t0), min(b, t1)) for a, b in busy if b > t0 and a < t1])
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = np.array([(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a], np.float64)
    gaps = gaps.reshape(-1, 2)
    idle_ns = float((gaps[:, 1] - gaps[:, 0]).sum()) if len(gaps) else 0.0
    parents = {names.index(p) for p in DRIVER_PARENTS if p in names}
    seqs = sp["seq"]
    parent_name = np.full(len(seqs), -1)
    has = np.isin(sp["parent"], seqs)
    parent_name[has] = sp["name"][np.searchsorted(seqs, sp["parent"][has])]
    closed = (sp["end"] >= 0) & (sp["start"] < t1) & (sp["end"] > t0)
    driver: dict[str, float] = {}
    wait_ns = 0.0
    for t in np.unique(sp["name"][closed & np.isin(parent_name, list(parents))]):
        sel = closed & (sp["name"] == t) & np.isin(parent_name, list(parents))
        got = _overlap(gaps, np.stack([sp["start"][sel], sp["end"][sel]], 1).astype(np.float64))
        if names[t] == "loop.wait":
            wait_ns += got
        else:
            driver[names[t]] = got / 1e6
    driver_ms = sum(driver.values())
    out.update(
        prologue_ms=prologue, rounds_ms=rounds_ms, round_execs=execs,
        stamp_ms={k: {"n": len(v), "sum": float(np.sum(v)), "median": float(np.median(v))}
                  for k, v in by_stamp.items()},
        apart_ms=apart, busy_ms=sum(b - a for a, b in merged) / 1e6, idle_ms=idle_ns / 1e6,
        driver_idle_ms=driver_ms, driver_idle_by_span=driver, wait_idle_ms=wait_ns / 1e6,
        caller_idle_ms=idle_ns / 1e6 - driver_ms - wait_ns / 1e6)
    return out


def per(record: dict, key: str, value) -> float | None:
    """``value`` over the window's slides or requests (``key``)."""
    items = record.get(key)
    return None if value is None or not items else value / len(items)


def sums(record: dict) -> dict | None:
    """The window's sums where the recorder gave any loop, else ``None``."""
    got = record.get("flight")
    return got if got and got["loops"] else None


def median_ms(record: dict, stamp: str) -> float | None:
    got = sums(record)
    if got is None or stamp not in got["stamp_ms"]:
        return None
    return got["stamp_ms"][stamp]["median"]

