"""The flight recorder (``pprx_torch.trace``) on the CPU: the stamps of a
wl2 slide and of a dense push follow their loops' round logs, spans nest,
a full ring drops its oldest entries and counts them, the bracket
arithmetic that puts the card's clock on the host's. The benchmark's
readers of the recorder are tested with the benchmark
(``benchmark/tests/test_benchmark_flight.py``), but for its window sums
over a reverse slide's sweep stamps, which are tested here."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from pprx_torch import trace
from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.engine import graphs, push
from pprx_torch.engine.state import FORWARD, REVERSE, init_state
from pprx_torch.graph.dynamic import WindowGraph
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.hybrid_stream import HybridStreamDriver
from pprx_torch.graph.io import synthetic_powerlaw_stream
from pprx_torch.graph.stream import StreamDriver
from pprx_torch.retrieve import topk

def _driver(mode=FORWARD, engine="fast"):
    """A seeded driver of ``engine``; the fast and the hybrid one rebuild
    before every fifth slide."""
    w, b = 4000, 100
    src, dst, n = synthetic_powerlaw_stream(500, w + 8 * b, seed=2)
    kind, kw = {"fast": (FastStreamDriver, dict(rebuild_every=4)), "dense": (StreamDriver, {}),
                "hybrid": (HybridStreamDriver, dict(rebuild_every=4))}[engine]
    drv = kind(src, dst, n, list(range(8)), PprConfig(alpha=0.15, eps=1e-6),
               StreamConfig(window=w, slide=b), mode=mode, device="cpu", **kw)
    drv.seed()
    return drv


def _loop_tags(snap: dict, i: int) -> list[str]:
    st, lp = snap["stamps"], snap["loops"]
    base = int(st["seq"][0])
    return [snap["names"][t]
            for t in st["tag"][lp["first"][i] - base:lp["stop"][i] - base]]


def _expected_rounds(rec: dict) -> list[str]:
    """The round stamps a logged loop gives: each round's branch by
    ``graphs.branch_names``, a scan's stats after it where they ran."""
    table = rec["table"]
    k = len(table.tiers)
    if table.dense:
        names = graphs.branch_names([(("round",), None)])
    else:
        names = graphs.branch_names([(("compact", i), None) for i in range(k)]
                                    + [(("scan",), None), (("stats",), None)])
    out = []
    for row in rec["rows"]:
        out.append(names[row[0]])
        if table.has_stats and row[0] == table.scan and row[7]:
            out.append(names[-1])
    return out


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_wl2_slide_stamps_follow_the_loop_log(monkeypatch, mode):
    """Each slide's loop: its launch and head, the prologue's three passes (in
    reverse mode the row-sum sweep stamped at both ends inside the first), then one
    stamp a round in the order of ``LOG_SINK``'s branches (compact tiers
    and scans both; a scan's stats after it), each scan with its K2 and K1
    stamps inside, then the end and the read; the counts the recorder took from the
    carry equal the stamps, and its ``corr.rows`` is the slide's distinct source rows."""
    drv = _driver(mode)
    monkeypatch.setattr(graphs, "LOG_SINK", [])
    b, w, head = drv.scfg.slide, drv.scfg.window, drv.head
    sources = [np.unique(np.concatenate([drv.stream_src[head + i * b:head + (i + 1) * b],
                                         drv.hsrc[(np.arange(b) + head + i * b) % w]]))
               for i in range(3)]
    mark = trace.RECORDER.mark()
    list(drv.run(3))
    snap = trace.RECORDER.snapshot(since=mark)
    assert len(snap["loops"]["seq"]) == len(graphs.LOG_SINK) == 3 and snap["dropped"] == 0
    sweep = ["rev.rowsum", "rev.corrections"] if mode == REVERSE else []
    both = 0
    for i, rec in enumerate(graphs.LOG_SINK):
        tags = _loop_tags(snap, i)
        assert tags[:5 + len(sweep)] == ["loop.launch", "loop.head", "prologue.sort_corrections",
                                         *sweep, "prologue.kill_ring", "prologue.first_count"]
        assert tags[-2:] == ["loop.end", "loop.read"]
        rounds = [t for t in tags if t.startswith("round.")]
        assert rounds == _expected_rounds(rec) and len(rec["rows"]) == rec["rounds"]
        both += "round.scan" in rounds and any(r.startswith("round.compact") for r in rounds)
        for j, t in enumerate(tags):
            if t == "round.scan":
                assert tags[j + 1:j + 5] == ["k2", "k1.window", "k1.fresh", "k1.end"]
        seq = snap["loops"]["seq"][i]
        mine = snap["counts"]["loop"] == seq
        counted = {snap["names"][t]: c for t, c in zip(snap["counts"]["tag"][mine],
                                                       snap["counts"]["execs"][mine])}
        assert counted.pop("corr.rows") == sources[i].size
        assert counted == {r: rounds.count(r) for r in set(rounds)}
    assert both  # a slide with compact and scan rounds
    # the fifth slide's rebuild (the fresh ring holds four) is a step apart,
    # stamped at both ends
    list(drv.run(1))
    mark = trace.RECORDER.mark()
    list(drv.run(1))
    snap = trace.RECORDER.snapshot(since=mark)
    outside = [snap["names"][t] for t, lp in zip(snap["stamps"]["tag"], snap["stamps"]["loop"])
               if lp < 0]
    assert outside == ["step.rebuild", "step.rebuild.end"]


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_the_reverse_sweep_is_stamped_and_summed_by_the_benchmark(mode):
    """A reverse slide stamps ``rev.rowsum`` and then ``rev.corrections``, once each,
    between ``prologue.sort_corrections`` and ``prologue.kill_ring``; a forward slide
    stamps neither. The benchmark's sums over the window (``benchmark.flight``) give
    each its intervals, and the prologue's passes as before: the sweep is no pass of
    its own there, and the sorts' interval ends where it starts."""
    from benchmark import flight

    drv = _driver(mode)
    mark = trace.RECORDER.mark()
    t0 = time.perf_counter_ns()
    list(drv.run(3))
    t1 = time.perf_counter_ns()
    snap = trace.RECORDER.snapshot(since=mark)
    for i in range(3):
        tags = _loop_tags(snap, i)
        rev = [t for t in tags if t.startswith("rev.")]
        if mode == FORWARD:
            assert rev == []
            continue
        assert rev == ["rev.rowsum", "rev.corrections"]
        at = tags.index("prologue.sort_corrections")
        assert tags[at:at + 4] == ["prologue.sort_corrections", "rev.rowsum", "rev.corrections",
                                   "prologue.kill_ring"]
    got = flight.window_sums(snap, t0, t1)
    assert got["loops"] == 3 and got["dropped"] == 0
    assert set(got["prologue_ms"]) == {"ms", "sort_corrections", "kill_ring", "first_count"}
    stamped = got["stamp_ms"]
    if mode == FORWARD:
        assert not any(k.startswith("rev.") for k in stamped)
        return
    for name in ("rev.rowsum", "rev.corrections"):
        assert stamped[name]["n"] == 3 and 0 < stamped[name]["sum"] < got["prologue_ms"]["ms"]
    passes = sum(got["prologue_ms"][k] for k in ("sort_corrections", "kill_ring", "first_count"))
    assert passes + stamped["rev.rowsum"]["sum"] + stamped["rev.corrections"]["sum"] <= (
        got["prologue_ms"]["ms"] * (1 + 1e-9))


def test_dense_push_stamps_follow_the_loop_log(monkeypatch):
    """A dense push: its launch and head, one ``round.dense`` a logged round with its
    ``k2``, ``k1`` and ``k1.end`` inside, the end and the read; a top-k after it is two
    stamps apart from any loop. Neither opens a host span."""
    src, dst, n = synthetic_powerlaw_stream(300, 3000, seed=4)
    src_t, dst_t = torch.from_numpy(src).long(), torch.from_numpy(dst).long()
    window = WindowGraph(src=src_t, dst=dst_t, deg=torch.bincount(src_t, minlength=n + 1).int())
    state = init_state(n, [0, 3, 7], mode=FORWARD, dtype=torch.float64, device="cpu")
    monkeypatch.setattr(graphs, "LOG_SINK", [])
    mark = trace.RECORDER.mark()
    _, st = push.push_to_convergence(state, window, PprConfig(alpha=0.15, eps=1e-6))
    topk.topk_candidates(state.p, 5)
    snap = trace.RECORDER.snapshot(since=mark)
    (rec,) = graphs.LOG_SINK
    tags = _loop_tags(snap, 0)
    assert st.rounds == rec["rounds"] > 2
    assert tags == (["loop.launch", "loop.head"] + ["round.dense", "k2", "k1", "k1.end"] * st.rounds
                    + ["loop.end", "loop.read"])
    assert [t for t in tags if t.startswith("round.")] == _expected_rounds(rec)
    outside = [snap["names"][t] for t, lp in zip(snap["stamps"]["tag"], snap["stamps"]["loop"])
               if lp < 0]
    assert outside == ["topk", "topk.end"]
    assert len(snap["spans"]["seq"]) == 0


@pytest.mark.parametrize("engine", ["fast", "dense", "hybrid"])
def test_spans_nest_and_share_their_slides_id(engine):
    """Every span lies inside its parent and carries its parent's id; a
    slide's id is its ``step_idx``, and its children are the host's steps
    in order (the fifth slide's rebuild first, where the driver rebuilds;
    the mirror last, where it keeps a host copy of the ring)."""
    drv = _driver(engine=engine)
    mark = trace.RECORDER.mark()
    first = drv.step_idx
    list(drv.run(5))
    sp = trace.RECORDER.snapshot(since=mark)["spans"]
    names = trace.LABELS
    at = {int(s): i for i, s in enumerate(sp["seq"])}
    roots = [i for i, p in enumerate(sp["parent"]) if p < 0]
    assert [names[sp["name"][i]] for i in roots] == ["slide"] * 5
    assert [int(sp["rid"][i]) for i in roots] == list(range(first, first + 5))
    for i, p in enumerate(sp["parent"]):
        assert sp["end"][i] >= sp["start"][i] >= 0
        if p >= 0:
            j = at[int(p)]
            assert sp["start"][j] <= sp["start"][i] <= sp["end"][i] <= sp["end"][j]
            assert sp["rid"][i] == sp["rid"][j]
    kids = [[names[sp["name"][i]] for i, p in enumerate(sp["parent"]) if p == sp["seq"][r]]
            for r in roots]
    if engine == "fast":
        steps = ["slide.pack", "slide.upload", "slide.issue", "slide.mirror"]
        assert kids[:4] == [steps] * 4 and kids[4] == ["slide.rebuild"] + steps
    else:  # no mirror; the dense driver never rebuilds
        steps = ["slide.pack", "slide.upload", "slide.issue"]
        first = ["slide.rebuild"] if engine == "hybrid" else []
        assert kids[:4] == [steps] * 4 and kids[4] == first + steps


def test_wait_ends_the_issue_span_and_takes_its_parent():
    """``loop.wait`` at a launch ends the ``*.issue`` span open there and
    begins under its parent; ending the issue span after does nothing."""
    rec = trace.Recorder(span_cap=16)
    with rec.span(trace.tag("slide"), 7):
        with rec.span(trace.tag("slide.issue")) as issue:
            wait = rec.wait()
            rec.end(wait)
        assert issue not in rec.stack
    snap = rec.snapshot(flush=False)
    sp = snap["spans"]
    assert [snap["names"][t] for t in sp["name"]] == ["slide", "slide.issue", "loop.wait"]
    assert sp["parent"].tolist() == [-1, 0, 0] and sp["rid"].tolist() == [7, 7, 7]
    assert sp["end"][1] <= sp["start"][2] <= sp["end"][2] <= sp["end"][0]


def test_wait_without_a_driver_span_opens_none():
    """A loop launched with no span open (a push, a top-k's caller) has no
    ``loop.wait``: ``wait`` gives -1 and ending it does nothing."""
    rec = trace.Recorder(span_cap=16)
    wait = rec.wait()
    rec.end(wait)
    assert wait == -1 and rec.n_spans == 0 and rec.stack == []


def test_ending_a_span_ends_its_open_children():
    """``end`` of a parent ends every child still open at the same time;
    a later ``end`` of such a child leaves it as it was."""
    rec = trace.Recorder(span_cap=16)
    outer = rec.begin(trace.tag("slide"), 3)
    inner = rec.begin(trace.tag("slide.pack"))
    rec.end(outer)
    sp = rec.snapshot(flush=False)["spans"]
    assert rec.stack == [] and sp["end"][0] == sp["end"][1] >= sp["start"][1]
    rec.end(inner)
    assert rec.snapshot(flush=False)["spans"]["end"][1] == sp["end"][1]


def test_a_snapshot_since_a_mark_takes_what_came_after():
    """``snapshot(since=mark())`` holds the spans, stamps, loops and counts
    after the mark alone, and the drops since it."""
    rec = trace.Recorder(span_cap=4)
    cpu = torch.device("cpu")
    with rec.span(trace.tag("slide"), 0):
        rec.stamp(trace.LOOP_HEAD, cpu)
    mark = rec.mark()
    for i in range(5):
        with rec.span(trace.tag("slide"), 10 + i):
            pass
    seq = rec.loop_begin()
    rec.stamp(trace.LOOP_END, cpu)
    rec.loop_end(seq)
    rec.count(seq, [trace.LOOP_END], [2])
    snap = rec.snapshot(since=mark, flush=False)
    assert snap["spans"]["rid"].tolist() == [11, 12, 13, 14] and snap["dropped"] == 2
    assert snap["stamps"]["tag"].tolist() == [trace.LOOP_END]
    assert snap["stamps"]["loop"].tolist() == [seq] and snap["loops"]["seq"].tolist() == [seq]
    assert snap["counts"]["execs"].tolist() == [2]


def test_a_full_ring_drops_its_oldest_and_counts_them():
    """Spans, stamps, loops and counts each keep their newest entries;
    ``dropped`` counts the rest, and a device ring read after it wrapped
    counts the stamps it overwrote. Nothing raises."""
    rec = trace.Recorder(span_cap=8, stamp_cap=16, loop_cap=4, count_cap=4)
    name = trace.tag("slide")
    for i in range(20):
        with rec.span(name, i):
            pass
    for i in range(6):
        seq = rec.loop_begin()
        for _ in range(5):
            rec.stamp(trace.LOOP_LAUNCH, torch.device("cpu"))
        rec.loop_end(seq)
        rec.count(seq, [name], [i + 1])
    assert rec.dropped == 12 + 14 + 2 + 2
    snap = rec.snapshot(flush=False)
    assert snap["spans"]["rid"].tolist() == list(range(12, 20))
    assert snap["spans"]["seq"].tolist() == list(range(12, 20))
    assert len(snap["stamps"]["seq"]) == 16 and snap["loops"]["seq"].tolist() == [2, 3, 4, 5]
    assert snap["counts"]["execs"].tolist() == [3, 4, 5, 6]
    # a device ring of 4 slots written 7 times: the host reads the last 4
    ring = trace.DeviceRing(torch.zeros(trace.ring_len(4), dtype=torch.int64))
    host = np.zeros(trace.ring_len(4), np.int64)
    host[0], host[1] = 7, 4
    for i in range(7):
        host[2 + 2 * (i % 4):4 + 2 * (i % 4)] = (100 + i, 1000 * i)
    before = rec.dropped
    rec.take(ring, host)
    # 3 overwritten on the card, 4 more of the host's full ring of 16
    assert rec.dropped == before + 3 + 4 and ring.read == 7
    got = rec.snapshot(flush=False)["stamps"]
    assert got["tag"][-4:].tolist() == [103, 104, 105, 106]
    assert got["ns"][-4:].tolist() == [3000, 4000, 5000, 6000]


def test_a_device_ring_read_twice_gives_each_stamp_once():
    """Reads of a device ring as it fills: each gives the stamps written
    since the one before, in order, across the ring's wrap, and none is
    counted lost while the host keeps up."""
    rec = trace.Recorder()
    ring = trace.DeviceRing(torch.zeros(trace.ring_len(4), dtype=torch.int64))
    host = np.zeros(trace.ring_len(4), np.int64)
    host[1] = 4
    got = []
    for upto in (3, 6, 6, 9):
        for i in range(int(host[0]), upto):
            host[2 + 2 * (i % 4):4 + 2 * (i % 4)] = (200 + i, 10 * i)
        host[0] = upto
        got.append(ring.unread(host, rec)[:, 0].tolist())
    assert got == [[200, 201, 202], [203, 204, 205], [], [206, 207, 208]]
    assert rec.lost == 0 and ring.read == 9


def test_brackets_give_the_offset_and_its_error():
    """Synthetic loops on a card whose clock runs 8 ppm slow against the
    host's, 5 ms behind at the first loop: each loop's launch precedes its
    first stamp by 3-13 us and its read returns 5-20 us after its last. No
    constant offset meets every bracket over 4 s; the fitted line finds the
    drift, its band holds the true offset at every loop, and its width is
    about the smallest latencies' sum; a step of one clock splits the
    loops into runs, each holding the truth."""
    rng = np.random.default_rng(0)
    drift, off = 8e-6, 5_000_000

    def loops(step=0):
        a = np.cumsum(rng.integers(50_000_000, 150_000_000, 40)).astype(np.int64)
        b = a + rng.integers(20_000_000, 90_000_000, 40)
        true = lambda x: off + drift * x + np.where(np.arange(40) >= 20, step, 0)  # noqa: E731
        launch = (a + true(a) - rng.integers(3_000, 13_000, 40)).astype(np.int64)
        done = (b + true(b) + rng.integers(5_000, 20_000, 40)).astype(np.int64)
        lo, hi = trace.brackets(launch, done, a, b)
        return lo, hi, a.astype(np.float64), b.astype(np.float64), true

    lo, hi, a, b, true = loops()
    assert (lo <= true(a)).all() and (hi >= true(b)).all()
    assert hi.min() - lo.max() < 0  # a constant offset meets none of them
    d, o, width = trace.fit(lo.astype(np.float64), hi.astype(np.float64), a, b)
    assert abs(d - drift) < 1e-6 and 0 <= width < 26_000
    for x in (a, b):
        assert (np.abs(o + d * x - true(x)) <= width / 2 + 1).all()
    o, d, w = trace.offsets(lo.astype(np.float64), hi.astype(np.float64), a, b)
    assert len(set(w)) == 1 and w[0] == width
    # a step of 300 us halfway: runs, each around the truth
    lo, hi, a, b, true = loops(step=300_000)
    o, d, w = trace.offsets(lo.astype(np.float64), hi.astype(np.float64), a, b)
    assert len(set(w)) > 1 and (w >= 0).all()
    assert (np.abs(o + d * a - true(a)) <= w / 2 + 1).all()
    # one loop: no drift, its own bracket
    d, o, width = trace.fit(np.array([10.0]), np.array([40.0]), np.array([0.0]), np.array([5.0]))
    assert (d, o, width) == (0.0, 25.0, 30.0)


def test_align_stamps_puts_device_stamps_on_the_host_clock():
    """A device loop's stamps land inside its bracket on the host's clock,
    a stamp apart from any loop follows the line of the loop nearest it on
    the card's clock, host stamps stay as they are; the card's readings
    (ns since 1970) keep their nanoseconds."""
    dev, host_clock = trace.DEVICE, trace.HOST
    x0 = 1_760_000_000_000_000_000  # the card's clock, about 2025
    ns = np.array([0, 50_000, 1_000_000, 9_000_000, 10_000_000, 12_000_000]) + x0
    stamps = {"seq": np.arange(7), "tag": np.zeros(7, np.int64),
              "ns": np.append(ns, 777), "loop": np.array([0, 0, 0, -1, 1, 1, -1]),
              "clock": np.array([dev] * 6 + [host_clock])}
    h = 90_000_000_000_000  # the host's clock at the first launch
    loops = {"seq": np.array([0, 1]), "launch": np.array([h - 10_000, h + 9_995_000]),
             "done": np.array([h + 1_020_000, h + 12_030_000]), "first": np.array([0, 4]),
             "stop": np.array([3, 6]), "clock": np.array([dev, dev])}
    host, align = trace.align_stamps(stamps, loops)
    assert host[6] == 777.0 and len(align["width"]) == 2 and (align["width"] >= 0).all()
    assert host[0] >= loops["launch"][0] and host[2] <= loops["done"][0]
    assert host[4] >= loops["launch"][1] and host[5] <= loops["done"][1]
    assert np.all(np.diff(host[:6]) > 0)
    # each loop's own bracket, the drift out, holds its run's band: the first
    # loop's host interval (1.03 ms) less its stamps' (1 ms), the second's
    # 2.035 ms less 2 ms, the stamps' on the host's clock
    assert (align["bracket"] >= align["width"] - 1e-6).all()
    d = align["drift"]
    assert align["bracket"] == pytest.approx(
        [1_030_000 - 1_000_000 * (1 + d[0]), 2_035_000 - 2_000_000 * (1 + d[1])], abs=1e-3)
    # the stamp apart lies nearest the second loop's first stamp: its line
    step = int(ns[3] - ns[4])
    assert host[3] == pytest.approx(host[4] + step * (1 + align["drift"][1]), abs=1.0)
    assert host[1] - host[0] == pytest.approx(50_000, rel=1e-4)


def test_branch_names_by_kind():
    """``round.<kind>``, numbered where a kind has several branches; a
    dense round is ``round.dense``."""
    keys = [((0, False, 1e-6, "compact", (8, 8, 8), 16, False), None),
            ((0, False, 1e-6, "compact", (16, 16, 16), 32, False), None),
            ((0, False, "scan"), None), ((0, "stats"), None)]
    assert graphs.branch_names(keys) == ["round.compact.0", "round.compact.1", "round.scan",
                                         "round.stats"]
    assert graphs.branch_names([(("dense", 0, 1e-6, 0.15, "round"), None)]) == ["round.dense"]
    assert graphs.step_word(("rebuild", 0, 800)) == "rebuild"
