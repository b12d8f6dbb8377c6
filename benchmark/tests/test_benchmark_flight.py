"""The benchmark's readers of the port's flight recorder
(``benchmark/flight.py`` and the eight metrics that read it) on synthetic
snapshots and records: the window's sums, each metric's ``read``, their
entries in ``BENCHMARK.json``, and a tree with no recorder."""

import numpy as np
import pytest

from benchmark import flight, harness
from pprx_torch import trace

NEW_METRICS = ("prologue_ms_per_slide.stream", "scan_rounds_per_slide.stream",
               "scan_ms_per_slide.stream", "k1_insitu_roofline.stream",
               "driver_idle_ms_per_slide.stream", "k1_insitu_roofline.retrieve",
               "k2_insitu_roofline.retrieve", "topk_ms.retrieve")


def _synthetic_snapshot() -> dict:
    """Two slides' loops on the host clock: each loop head at 10 ms a slide
    with its prologue (1 + 0.5 + 0.25 ms), a scan round (2 ms: K2 0.5, K1
    over the window 1.0, over the fresh 0.25), its stats (0.5 ms), a compact
    round (0.75 ms), the end; before the second loop a rebuild step (1 ms);
    the slides' host spans around them."""
    names = list(trace.LABELS)

    def tid(name):
        if name not in names:
            names.append(name)
        return names.index(name)

    ms = 1_000_000
    tags, ns, owner = [], [], []
    loops = []
    spans = []
    for i in range(2):
        t = 10 * ms * (i + 1)
        if i == 1:
            tags += [tid("step.rebuild"), tid("step.rebuild.end")]
            ns += [t - 2 * ms, t - ms]
            owner += [-1, -1]
        first = len(tags)
        seq = [("loop.launch", -0.25 * ms), ("loop.head", 0), ("prologue.sort_corrections", 0),
               ("prologue.kill_ring", 1 * ms), ("prologue.first_count", 1.5 * ms),
               ("round.scan", 1.75 * ms), ("k2", 1.75 * ms), ("k1.window", 2.25 * ms),
               ("k1.fresh", 3.25 * ms), ("k1.end", 3.5 * ms), ("round.stats", 3.75 * ms),
               ("round.compact", 4.25 * ms), ("loop.end", 5 * ms), ("loop.read", 5.1 * ms)]
        tags += [tid(a) for a, _ in seq]
        ns += [t + int(b) for _, b in seq]
        owner += [i] * len(seq)
        loops.append((t - 0.5 * ms, t + 5.5 * ms, first, len(tags)))
        slide0 = len(spans)
        spans.append((tid("slide"), t - 3 * ms, t + 6 * ms, -1, i))
        if i == 1:
            spans.append((tid("slide.rebuild"), t - 2.5 * ms, t - 2 * ms, slide0, i))
        spans += [(tid("slide.pack"), t - 1.8 * ms, t - 1.2 * ms, slide0, i),
                  (tid("slide.issue"), t - 0.8 * ms, t - 0.5 * ms, slide0, i),
                  (tid("loop.wait"), t - 0.5 * ms, t + 5.5 * ms, slide0, i),
                  (tid("slide.mirror"), t + 5.5 * ms, t + 5.8 * ms, slide0, i)]
    n = len(tags)
    sp = np.array(spans, np.int64)
    lp = np.array(loops, np.int64)
    return {
        "names": names,
        "spans": {"seq": np.arange(len(sp)), "name": sp[:, 0], "start": sp[:, 1],
                  "end": sp[:, 2], "parent": sp[:, 3], "rid": sp[:, 4]},
        "stamps": {"seq": np.arange(n), "tag": np.array(tags), "ns": np.array(ns, np.int64),
                   "loop": np.array(owner), "clock": np.full(n, trace.HOST),
                   "host": np.array(ns, np.float64)},
        "loops": {"seq": np.arange(2), "launch": lp[:, 0], "done": lp[:, 1],
                  "first": lp[:, 2], "stop": lp[:, 3], "clock": np.full(2, trace.HOST)},
        "counts": {"loop": np.array([0, 0, 0, 1, 1, 1]),
                   "tag": np.array([tid("round.scan"), tid("round.stats"),
                                    tid("round.compact")] * 2),
                   "execs": np.ones(6, np.int64)},
        "align": {"loop": np.arange(2), "offset": np.zeros(2), "drift": np.zeros(2),
                  "width": np.array([4000.0, 4000.0]), "bracket": np.array([5000.0, 7000.0])},
        "dropped": 0,
    }


def test_window_sums_on_a_synthetic_snapshot():
    """The prologue by pass, the rounds, the stamps' intervals, the steps
    apart and the idle, split by the slide's host spans: the window from
    5 ms to 28 ms holds 23 ms, of which the two loops (5 ms each) and the
    rebuild (1 ms) are busy; of the 12 ms idle, the rebuild's issue covers
    0.5, the packs 0.6 (the second pack runs beside the rebuild), the issues
    0.6, the mirrors 0.6, the waits 2.0 (0.5 before each loop's head and
    after its end)."""
    ms = 1_000_000
    got = flight.window_sums(_synthetic_snapshot(), 5 * ms, 28 * ms)
    assert got["loops"] == 2 and got["dropped"] == 0
    assert got["align_us"] == {"width": [4.0] * 5, "bracket": [5.0, 5.5, 6.0, 6.5, 7.0]}
    assert got["prologue_ms"] == {"ms": 3.5, "sort_corrections": 2.0, "kill_ring": 1.0,
                                  "first_count": 0.5}
    assert got["rounds_ms"] == {"round.scan": 4.0, "round.stats": 1.0, "round.compact": 1.5}
    assert got["round_execs"] == {"round.scan": 2, "round.stats": 2, "round.compact": 2}
    assert got["stamp_ms"]["k1.window"] == {"n": 2, "sum": 2.0, "median": 1.0}
    assert got["stamp_ms"]["k2"]["median"] == 0.5
    assert got["apart_ms"] == {"step.rebuild": 1.0}
    assert got["busy_ms"] == pytest.approx(11.0) and got["idle_ms"] == pytest.approx(12.0)
    assert got["driver_idle_by_span"] == pytest.approx(
        {"slide.rebuild": 0.5, "slide.pack": 0.6, "slide.issue": 0.6, "slide.mirror": 0.6})
    assert got["driver_idle_ms"] == pytest.approx(2.3)
    assert got["wait_idle_ms"] == pytest.approx(2.0)
    assert got["caller_idle_ms"] == pytest.approx(12.0 - 2.3 - 2.0)


def test_new_metrics_read_a_synthetic_record():
    """Each new metric's ``read`` on a record with the window's sums (two
    slides or requests), and ``None`` where the record has nothing of the
    recorder (a tree without one) or no loop in the window."""
    ms = 1_000_000
    sums = flight.window_sums(_synthetic_snapshot(), 5 * ms, 28 * ms)
    sums["apart_ms"]["topk"] = 380.0
    sums["stamp_ms"]["k1"] = {"n": 16, "sum": 3200.0, "median": 200.0}
    record = {"flight": sums, "slides": [{}, {}], "requests": [{}, {}],
              "k1": {"bytes": 3.35e9, "ms": 0.5}, "k2_insitu_bytes": 6.7e8}
    want = {
        "prologue_ms_per_slide.stream": 1.75,
        "scan_rounds_per_slide.stream": 1.0,
        "scan_ms_per_slide.stream": 2.5,
        "k1_insitu_roofline.stream": 100.0,  # 1 ms of the 1 ms bound
        "driver_idle_ms_per_slide.stream": 1.15,
        "k1_insitu_roofline.retrieve": 0.5,  # 1 ms of the bound over 200
        "k2_insitu_roofline.retrieve": 40.0,  # 0.2 ms over 0.5
        "topk_ms.retrieve": 190.0,
    }
    for name in NEW_METRICS:
        mod = harness.metric_module(name)
        assert mod.read(record) == pytest.approx(want[name]), name
        assert mod.read({"slides": [{}], "requests": [{}]}) is None, name
        assert mod.read({**record, "flight": {**sums, "loops": 0}}) is None, name
        assert hasattr(mod, "probe")
    # the in-situ K1 shares take their bytes from the K1 probe's record
    for name in ("k1_insitu_roofline.stream", "k1_insitu_roofline.retrieve"):
        assert harness.metric_module(name).read({**record, "k1": None}) is None, name


def test_new_metrics_are_appended_with_their_cells():
    """The eight entries sit at the end of ``per_layer``, each listing the
    one cell whose end-to-end metric it moves."""
    per_layer = harness.manifest()["per_layer"]
    assert [m["name"] for m in per_layer[-len(NEW_METRICS):]] == list(NEW_METRICS)
    for m in per_layer[-len(NEW_METRICS):]:
        cell = "stream.b160k" if m["name"].endswith(".stream") else "retrieve.s512"
        assert m["workloads"] == [cell]
        assert m["moves"] == ("updates_per_s" if cell == "stream.b160k" else "request_ms")


def test_the_probe_finds_nothing_without_a_recorder(monkeypatch):
    """A tree whose program has no recorder: the probe returns nothing."""
    monkeypatch.setattr(flight, "snapshot", lambda: None)

    class Cell:
        record: dict = {}

    assert flight.probe(Cell()) == {}
