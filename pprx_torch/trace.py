"""The port's flight recorder: host spans, device stamps and loop counters in
bounded rings in memory, always on, held process-wide as
``segsum.LAUNCHES`` is (``RECORDER``). Nothing is written out during a run:
a reader takes ``RECORDER.snapshot()`` when it wants the record.

- **Spans** (host): a name, start and end in ``time.perf_counter_ns()``,
  the span open when it began (its parent) and the id of its slide or
  request, which a child takes from its parent. The single-card stream
  drivers open them: ``slide`` (``graph.driver.WindowDriver.run``, id the
  slide's ``step_idx``) with ``slide.rebuild``, ``slide.pack``,
  ``slide.upload``, ``slide.issue``, ``loop.wait`` and ``slide.mirror``.
  A span with no parent and no id given takes its own sequence number as
  its id. ``loop.wait`` runs from a
  loop graph's launch to the return of its carry's read, and ends the
  ``*.issue`` span open at the launch; it is a driver's span's child, and
  with none open there is none.
- **Stamps** (device): a tag and the card's clock (``%globaltimer``, ns),
  written by a one-thread kernel (``csrc/loop.cu``'s ``stamp``) into a ring
  on the card: a ``RoundGraphs``' ring, which the loop graph's carry read
  copies back with the carry, where its loops, branches and steps record
  them, else the recorder's eager ring of the device, read by ``flush``. A
  call site launches the stamp, so a capture records it as a kernel node;
  on the CPU the stamp's plain version records the host clock, so the same
  code gives the same tags there. Stamps mark where an interval starts:
  ``loop.launch``, launched eagerly just before a loop graph (the card is
  idle there, so it runs within microseconds of the host's launch, which
  bounds the clocks' offset tightly; to ``loop.head``, the graph's launch
  latency); the loop graph's ``loop.head`` and ``loop.end``; ``loop.read``,
  launched eagerly after the carry's copy and written into pinned host
  memory, which the host reads with the carry (from ``loop.end``: the
  graph's completion and the copy); each branch's start,
  ``round.<kind>`` (``RoundGraphs.loop``); a ``run`` step's
  ``step.<kind>`` and ``step.<kind>.end``; the wl2 slide prologue's
  ``prologue.sort_corrections``, ``prologue.kill_ring`` and
  ``prologue.first_count``, and in reverse mode ``rev.rowsum`` and
  ``rev.corrections`` at the ends of its row-sum sweep (names that no
  ``prologue.`` reader sums); a dense round's ``k2``, each K1 launch
  (``k1``; ``k1.window``, ``k1.fresh``) and ``k1.end``; the top-k's
  ``topk`` and ``topk.end``.
- **Loops**: each loop's host launch and read-return times, its stamps,
  and the executions of each branch, read from the carry (counters), with
  the counters its prologue wrote (``RoundGraphs.count_``, read by the same
  copy): the wl2 slide's ``corr.rows``, the distinct source rows its
  corrections work on.
- **One clock**: a loop's stamps lie between its launch and its read's
  return, which brackets the offset from the card's clock to the host's
  (``brackets``). The two clocks drift apart by some microseconds a second,
  so the offset is a line in the card's clock: the line that leaves the
  widest band through every loop's bracket (``fit``), whose width, the
  tightest bracket once the drift is out, bounds the alignment error of
  the run's loops. Each loop's own bracket, the drift taken out, is what
  aligning that loop alone would leave (``align_stamps``' ``bracket``).

``dropped`` counts what a ring lost: the oldest entries, overwritten once
it is full, and stamps a device ring overwrote before the host read them.
"""

from __future__ import annotations

import array
import time
import weakref

import numpy as np
import torch

SPAN_CAP = 1 << 18
STAMP_CAP = 1 << 18
LOOP_CAP = 1 << 16
COUNT_CAP = 1 << 18
# a RoundGraphs' ring of stamps on the card (a loop's stamps and those of
# the steps before it: a slide's loop holds about 50), and the eager ring's
DEVICE_SLOTS = 1024
EAGER_SLOTS = 1 << 14
# a device loop's read copies its stamps into a staging area of this many
# (tag, reading) pairs and moves on; they reach the rings in one vectorized
# pass (``_settle``) when a reader asks or the area is full
STAGE_CAP = 1 << 16

NAMES: dict[str, int] = {}
LABELS: list[str] = []


def tag(name: str) -> int:
    """The id of a span's or stamp's name (one table for both), registered
    at its first use."""
    got = NAMES.get(name)
    if got is None:
        got = NAMES[name] = len(LABELS)
        LABELS.append(name)
    return got


LOOP_LAUNCH, LOOP_HEAD, LOOP_END = tag("loop.launch"), tag("loop.head"), tag("loop.end")
LOOP_READ, LOOP_WAIT = tag("loop.read"), tag("loop.wait")
HOST, DEVICE = 0, 1  # the clock a stamp or loop was read on


def _put(ring: np.ndarray, at: int, rows: np.ndarray) -> None:
    """``rows`` into ``ring`` from its ``at``-th entry on (modulo its
    length), as slices; of more rows than it holds, the last."""
    cap = len(ring)
    if len(rows) > cap:
        at, rows = at + len(rows) - cap, rows[-cap:]
    i = at % cap
    k = min(len(rows), cap - i)
    ring[i:i + k] = rows[:k]
    ring[:len(rows) - k] = rows[k:]


def ring_len(slots: int) -> int:
    """A device ring's length in int64: the count, the slots, the pairs."""
    return 2 + 2 * slots


def new_ring(slots: int, device) -> torch.Tensor:
    ring = torch.zeros(ring_len(slots), dtype=torch.int64, device=device)
    ring[1] = slots
    return ring


class _Span:
    __slots__ = ("rec", "name", "rid", "seq")

    def __init__(self, rec: "Recorder", name: int, rid: int | None):
        self.rec, self.name, self.rid = rec, name, rid

    def __enter__(self):
        self.seq = self.rec.begin(self.name, self.rid)
        return self.seq

    def __exit__(self, *exc):
        self.rec.end(self.seq)
        return False


class Recorder:
    """Spans, stamps, loops and counters, each a preallocated int64 ring.

    spans    name, start, end (-1 while open), parent (a span's sequence
             number, -1 for none), id
    stamps   tag, clock reading (ns), the loop it belongs to (-1: none), the
             clock (``HOST`` or ``DEVICE``)
    loops    launch, read's return (host ns), first stamp, end of its
             stamps (sequence numbers), the clock
    counts   loop, branch tag, executions (or a counter's tag and value)
    """

    def __init__(self, span_cap: int = SPAN_CAP, stamp_cap: int = STAMP_CAP,
                 loop_cap: int = LOOP_CAP, count_cap: int = COUNT_CAP):
        # spans are written a value at a time, which an array.array takes
        # some times faster than a numpy row; numpy reads it in place
        self._spans = array.array("q", bytes(8 * 5 * span_cap))
        self.spans = np.frombuffer(self._spans, np.int64).reshape(span_cap, 5)
        self.stamps = np.zeros((stamp_cap, 4), np.int64)
        self.loops = np.zeros((loop_cap, 5), np.int64)
        self.counts = np.zeros((count_cap, 3), np.int64)
        self.n_spans = self.n_stamps = self.n_loops = self.n_counts = 0
        self.stack: list[int] = []
        self.lost = 0  # stamps a device ring overwrote unread
        # device loops as read, until ``_settle``: their stamps' pairs in
        # ``_stage``, (loop, launch, done, start, stop) each, and (loop, tags,
        # executions) of every loop
        self._stage = np.zeros((STAGE_CAP, 2), np.int64)
        self._staged = 0
        self._pending: list = []
        self._pending_counts: list = []
        self.host_loop: int | None = None  # the loop a host stamp belongs to
        self.target: "DeviceRing | None" = None  # where a device stamp goes
        self._eager: dict[torch.device, DeviceRing] = {}
        self._rings: weakref.WeakSet = weakref.WeakSet()

    # ---- spans

    def span(self, name: int, rid: int | None = None) -> _Span:
        """``with rec.span(tag("x"), rid):`` a span of ``name``; ``rid``
        ``None`` takes the parent's id, or without a parent the span's own
        sequence number."""
        return _Span(self, name, rid)

    def begin(self, name: int, rid: int | None = None) -> int:
        seq = self.n_spans
        self.n_spans += 1
        parent = self.stack[-1] if self.stack else -1
        cap, a = len(self.spans), self._spans
        if rid is None:
            rid = a[5 * (parent % cap) + 4] if parent >= 0 else seq
        at = 5 * (seq % cap)
        a[at], a[at + 1], a[at + 2], a[at + 3], a[at + 4] = (
            name, time.perf_counter_ns(), -1, parent, rid)
        self.stack.append(seq)
        return seq

    def end(self, seq: int) -> None:
        """End span ``seq`` and any child of it still open; a span ended
        already is left alone."""
        if seq not in self.stack:
            return
        now, cap = time.perf_counter_ns(), len(self.spans)
        while True:
            top = self.stack.pop()
            if self.n_spans - top <= cap:
                self._spans[5 * (top % cap) + 2] = now
            if top == seq:
                return

    def wait(self) -> int:
        """``loop.wait`` begins at a loop graph's launch: it ends the
        ``*.issue`` span open there, and takes its parent. With no span
        open (no driver's) there is no ``loop.wait``: -1, which ``end``
        leaves alone."""
        if not self.stack:
            return -1
        top = self.stack[-1]
        if LABELS[self._spans[5 * (top % len(self.spans))]].endswith(".issue"):
            self.end(top)
        return self.begin(LOOP_WAIT)

    # ---- stamps

    def stamp(self, name: int, device: torch.device) -> None:
        """A stamp of ``name``: on a card the stamp kernel into the target
        ring (a ``RoundGraphs``' while it captures or runs a step) or the
        device's eager ring; on the CPU the host clock."""
        if device.type != "cuda":
            self._add_stamps(np.array([name]), np.array([time.perf_counter_ns()]),
                             -1 if self.host_loop is None else self.host_loop, HOST)
            return
        from pprx_torch.engine import loop

        if device.index is None:  # "cuda": the current device, as a tensor's
            device = torch.device("cuda", torch.cuda.current_device())
        ring = self.target
        if ring is None or ring.ring.device != device:
            ring = self._eager.get(device)
            if ring is None:
                if torch.cuda.is_current_stream_capturing():
                    return  # no ring to allocate inside a capture
                ring = self._eager[device] = DeviceRing(new_ring(EAGER_SLOTS, device))
                self.watch(ring)
        loop.stamp_(ring.ring, name)

    def watch(self, ring: "DeviceRing") -> None:
        """``flush`` reads ``ring`` too."""
        self._rings.add(ring)

    def _add_stamps(self, tags: np.ndarray, ns: np.ndarray, loop_seq, clock: int) -> int:
        rows = np.empty((len(tags), 4), np.int64)
        rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3] = tags, ns, loop_seq, clock
        return self._put_stamps(rows)

    def _put_stamps(self, rows: np.ndarray) -> int:
        first = self.n_stamps
        _put(self.stamps, first, rows)
        self.n_stamps += len(rows)
        return first

    def take(self, ring: "DeviceRing", host: np.ndarray) -> None:
        """The stamps ``ring`` holds past its last read, from ``host`` (a
        copy of the ring), in order, outside any loop."""
        self._settle()
        pairs = ring.unread(host, self)
        rows = np.empty((len(pairs), 4), np.int64)
        rows[:, :2], rows[:, 2], rows[:, 3] = pairs, -1, DEVICE
        self._put_stamps(rows)

    def flush(self) -> None:
        """Read every device ring's stamps not read yet (a sync of each
        device; outside any loop)."""
        for ring in list(self._rings):
            torch.cuda.synchronize(ring.ring.device)
            self.take(ring, ring.ring.cpu().numpy())

    # ---- loops

    def loop_begin(self) -> int:
        """A loop on the host clock: its stamps go to it until ``loop_end``."""
        self._settle()
        seq = self.n_loops
        self.n_loops += 1
        self.loops[seq % len(self.loops)] = (time.perf_counter_ns(), -1, self.n_stamps, -1, HOST)
        self.host_loop = seq
        return seq

    def loop_end(self, seq: int) -> None:
        self.loops[seq % len(self.loops), 1] = time.perf_counter_ns()
        self.loops[seq % len(self.loops), 3] = self.n_stamps
        self.host_loop = None

    def device_loop(self, launch: int, done: int, ring: "DeviceRing", host: np.ndarray,
                    last: list[int]) -> int:
        """A loop graph launched at ``launch`` whose read returned at ``done``
        (host ns), its stamps in ``host`` (the ring's copy), then ``last``
        (a tag and its reading: the read's stamp, after the copy); from its
        last ``loop.launch`` on they are the loop's. Staged as read."""
        pairs = ring.unread(host, self)
        if self._staged + len(pairs) + 1 > len(self._stage):
            self._settle()
        at = self._staged
        self._stage[at:at + len(pairs)] = pairs
        self._stage[at + len(pairs)] = last
        self._staged = at + len(pairs) + 1
        seq = self.n_loops
        self.n_loops += 1
        self._pending.append((seq, launch, done, at, self._staged))
        return seq

    def count(self, loop_seq: int, tags: list[int], execs: list[int]) -> None:
        """Each branch's executions in loop ``loop_seq``."""
        self._pending_counts.append((loop_seq, tags, execs))

    def _settle(self) -> None:
        """The staged loops and the counts, into the rings: each loop's
        stamps from its last ``loop.launch`` on owned by it, those before
        it by none."""
        if self._pending:
            seq, launch, done, start, stop = (np.array(c, np.int64) for c in zip(*self._pending))
            staged = self._stage[:self._staged]
            # each loop's last launch stamp before its stop, if it has one
            heads = np.append(np.flatnonzero(staged[:, 0] == LOOP_LAUNCH), len(staged))
            j = np.searchsorted(heads, stop) - 1
            at = heads[np.maximum(j, 0)]
            cut = np.where((j >= 0) & (at >= start), at, stop)
            sizes = stop - start
            rows = np.empty((len(staged), 4), np.int64)
            rows[:, :2], rows[:, 3] = staged, DEVICE
            rows[:, 2] = np.where(np.arange(len(staged)) >= np.repeat(cut, sizes),
                                  np.repeat(seq, sizes), -1)
            base = self._put_stamps(rows)
            _put(self.loops, int(seq[0]), np.stack(
                [launch, done, base + cut, base + stop, np.full(len(seq), DEVICE)], 1))
            self._pending, self._staged = [], 0
        counts, self._pending_counts = self._pending_counts, []
        rows = np.array([(lp, t, c) for lp, tags, execs in counts
                         for t, c in zip(tags, execs) if c], np.int64).reshape(-1, 3)
        _put(self.counts, self.n_counts, rows)
        self.n_counts += len(rows)

    # ---- reading

    @property
    def dropped(self) -> int:
        self._settle()
        return (max(0, self.n_spans - len(self.spans)) + max(0, self.n_stamps - len(self.stamps))
                + max(0, self.n_loops - len(self.loops))
                + max(0, self.n_counts - len(self.counts)) + self.lost)

    def mark(self) -> dict:
        """Where each ring stands: ``snapshot(since=mark())`` takes what
        came after."""
        self._settle()
        return {"spans": self.n_spans, "stamps": self.n_stamps, "loops": self.n_loops,
                "counts": self.n_counts, "dropped": self.dropped}

    def snapshot(self, since: dict | None = None, flush: bool = True) -> dict:
        """What the rings hold (after ``since``, a ``mark()``), as columns
        of numpy arrays in order, each stamp on the host clock too
        (``host``; ``align`` for the offsets); ``flush`` reads the device
        rings first."""
        if flush and self._rings:
            self.flush()
        self._settle()
        since = since or {}

        def rows(arr, n, key):
            lo = max(n - len(arr), since.get(key, 0))
            seq = np.arange(lo, n, dtype=np.int64)
            return seq, arr[seq % len(arr)]

        s_seq, sp = rows(self.spans, self.n_spans, "spans")
        t_seq, st = rows(self.stamps, self.n_stamps, "stamps")
        l_seq, lp = rows(self.loops, self.n_loops, "loops")
        _, ct = rows(self.counts, self.n_counts, "counts")
        loops = {"seq": l_seq, "launch": lp[:, 0], "done": lp[:, 1], "first": lp[:, 2],
                 "stop": lp[:, 3], "clock": lp[:, 4]}
        stamps = {"seq": t_seq, "tag": st[:, 0], "ns": st[:, 1], "loop": st[:, 2],
                  "clock": st[:, 3]}
        stamps["host"], align = align_stamps(stamps, loops)
        return {
            "names": list(LABELS),
            "spans": {"seq": s_seq, "name": sp[:, 0], "start": sp[:, 1], "end": sp[:, 2],
                      "parent": sp[:, 3], "rid": sp[:, 4]},
            "stamps": stamps, "loops": loops,
            "counts": {"loop": ct[:, 0], "tag": ct[:, 1], "execs": ct[:, 2]},
            "align": align,
            "dropped": self.dropped - since.get("dropped", 0),
        }


class DeviceRing:
    """A ring of stamps on the card (``new_ring``) and how far the host has
    read it."""

    def __init__(self, ring: torch.Tensor):
        self.ring = ring
        self.slots = (ring.shape[0] - 2) // 2
        self.read = 0

    def unread(self, host: np.ndarray, rec: Recorder) -> np.ndarray:
        """The (tag, ns) pairs written since the last read, from ``host`` (a
        copy of the ring), in order; what the ring overwrote first counts in
        ``rec.lost``."""
        total = int(host[0])
        lo = max(self.read, total - self.slots)
        rec.lost += lo - self.read
        self.read = total
        pairs = host[2:2 + 2 * self.slots].reshape(self.slots, 2)
        i, n = lo % self.slots, total - lo
        if i + n <= self.slots:
            return pairs[i:i + n]
        return np.concatenate([pairs[i:], pairs[:i + n - self.slots]])


DRIFT_MAX = 1e-4  # 100 ppm: more than two quartz clocks drift apart


def brackets(launch: np.ndarray, done: np.ndarray, first: np.ndarray,
             last: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each device loop's bracket on the offset ``host = device + offset``:
    its first stamp (``loop.launch``) cannot precede the launch (``offset >=
    launch - first``), its last (``loop.read``) cannot follow the read's
    return (``offset <= done - last``). int64 ns."""
    return launch - first, done - last


def fit(lo: np.ndarray, hi: np.ndarray, a: np.ndarray, b: np.ndarray) -> tuple[float, float,
                                                                                  float]:
    """The offset as a line in the card's clock, ``offset(x) = o + d x``,
    from brackets that hold at ``a`` (each lower bound, its first stamp's
    ``x``) and ``b`` (each upper bound): for a drift ``d`` the offsets
    left open are ``[max(lo - d a), min(hi - d b)]``; the drift that leaves
    the widest band (its width concave in ``d``, |d| <= ``DRIFT_MAX``; 0 for
    one loop). Returns (d, o, width): the band's middle and width at ``d``,
    the tightest bracket once the drift is taken out."""
    def band(d):
        return float(np.max(lo - d * a)), float(np.min(hi - d * b))

    x, y = (-DRIFT_MAX, DRIFT_MAX) if len(lo) > 1 else (0.0, 0.0)
    for _ in range(100):
        m1, m2 = x + (y - x) / 3, y - (y - x) / 3
        w1, w2 = (h - l for l, h in (band(m1), band(m2)))
        x, y = (m1, y) if w1 < w2 else (x, m2)
    d = (x + y) / 2
    l, h = band(d)
    return d, (l + h) / 2, h - l


def offsets(lo: np.ndarray, hi: np.ndarray, a: np.ndarray,
            b: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``fit`` over the loops in launch order; where no line meets every
    bracket (a step of a clock), the loops split in halves, each fitted
    apart. Returns each loop's (o, d, width): its run's line and band."""
    o, d, w = (np.zeros(len(lo)) for _ in range(3))
    todo = [(0, len(lo))] if len(lo) else []
    while todo:
        i, j = todo.pop()
        di, oi, wi = fit(lo[i:j], hi[i:j], a[i:j], b[i:j])
        if wi < 0 and j - i > 1:
            todo += [(i, (i + j) // 2), ((i + j) // 2, j)]
            continue
        o[i:j], d[i:j], w[i:j] = oi, di, wi
    return o, d, w


def align_stamps(stamps: dict, loops: dict) -> tuple[np.ndarray, dict]:
    """Every stamp on the host's clock (ns, float): a device loop's stamps
    by their loop's line (``offsets``), any other device stamp by the line
    of the device loop that starts nearest to it on the card's clock; and
    the alignment (``offset`` at each loop's first stamp, ``drift``,
    ``width``, its run's band, and ``bracket``, its own bracket's width with
    the drift taken out, ns, of each device loop ``loop`` whose stamps the
    rings still hold). Device readings are taken relative to the first loop's first
    stamp before any float arithmetic: the card's clock counts from 1970."""
    host = stamps["ns"].astype(np.float64)
    none = {"loop": np.zeros(0, np.int64), "offset": np.zeros(0), "drift": np.zeros(0),
            "width": np.zeros(0), "bracket": np.zeros(0)}
    on_dev = stamps["clock"] == DEVICE
    dev = np.flatnonzero(loops["clock"] == DEVICE)
    if not dev.size or not on_dev.any():
        return host, none
    # each device loop's first and last stamp, as rows of ``stamps``
    base = int(stamps["seq"][0])
    first = loops["first"][dev] - base
    last = loops["stop"][dev] - 1 - base
    ok = (first >= 0) & (last >= first) & (last < len(host))
    dev, first, last = dev[ok], first[ok], last[ok]
    if not dev.size:
        return host, none
    x0 = int(stamps["ns"][first[0]])
    lo, hi = brackets(loops["launch"][dev], loops["done"][dev], stamps["ns"][first],
                      stamps["ns"][last])
    h0 = int(lo[0])  # host = device + h0 + o + d x, x = device - x0
    a = (stamps["ns"][first] - x0).astype(np.float64)
    b = (stamps["ns"][last] - x0).astype(np.float64)
    o, d, width = offsets((lo - h0).astype(np.float64), (hi - h0).astype(np.float64), a, b)
    x = (stamps["ns"] - x0).astype(np.float64)
    seqs = loops["seq"][dev]
    pos = np.minimum(np.searchsorted(seqs, stamps["loop"]), len(seqs) - 1)
    mine = on_dev & (seqs[pos] == stamps["loop"])
    # any other device stamp: the loop whose first stamp is nearest
    j = np.zeros(len(x), np.int64)
    if len(a) > 1:
        j = np.clip(np.searchsorted(a, x), 1, len(a) - 1)
        j -= np.abs(a[j - 1] - x) <= np.abs(a[j] - x)
    k = np.where(mine, pos, j)
    host = np.where(on_dev, x + float(x0 + h0) + o[k] + d[k] * x, host)
    bracket = (hi - lo).astype(np.float64) - d * (b - a)
    return host, {"loop": seqs, "offset": float(h0) + o + d * a, "drift": d, "width": width,
                  "bracket": bracket}


RECORDER = Recorder()


def stamp(name: str, device: torch.device) -> None:
    """A stamp of ``name`` on ``device`` into the process's recorder."""
    RECORDER.stamp(tag(name), device)


def span(name: str, rid: int | None = None) -> _Span:
    """A host span of ``name`` in the process's recorder."""
    return RECORDER.span(tag(name), rid)
