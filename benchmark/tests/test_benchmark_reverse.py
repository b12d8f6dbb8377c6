"""The reverse cell, ``stream-rev.b160k``: its plain reference against the
port's reverse driver, ``correct`` true for a sound run and false for the
control and for each planted fault, the byte counts of its two rooflines,
and its metrics on a record of a real run.

On the CPU at a tiny size (``run_cell`` on ``cpu``); the control again on
the card at the cell's own size (``cuda`` marker), each run's readings
printed.
"""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import flight, harness, kernels, kernels_reverse
from benchmark.reference import exact, reverse

CELL = "stream-rev.b160k"
SEED = 2**31 + 99
REVERSE_METRICS = ("rowsum_ms_per_slide.rev", "sweep_roofline.rev", "k1_insitu_roofline.rev")


def tiny() -> dict:
    """A size the CPU runs in a second. ``inv_gap``'s limit is set at this
    size from its readings (sound runs 2.4e-7 or less, the control 3e-4);
    ``fresh``'s is the cell's own."""
    limits = {**harness.load_json("workloads", CELL)["limits"], "inv_gap": 1e-5}
    return {"config": {"n": 400, "window": 4000, "targets": 8}, "traffic": {"slide": 200},
            "params": {"edges_per_s": 4e6, "check_every": 2, "check_targets": 4,
                       "limits": limits}}


def run(over: dict | None = None) -> dict:
    res, _ = harness.run_cell(CELL, SEED, 0.5, False, "cpu", overrides=over or tiny())
    return res


def test_the_reference_agrees_with_the_reverse_driver_in_f64():
    """Five slides of the port's reverse driver in float64: the state keeps
    ``p = M (e_t - r)`` on the window the reference works out from the
    stream and the count of slides, to rounding, and is eps-fresh."""
    from pprx_torch.config import PprConfig, StreamConfig
    from pprx_torch.engine.state import REVERSE
    from pprx_torch.graph.fast_stream import FastStreamDriver
    from pprx_torch.graph.io import synthetic_powerlaw_stream

    w, b, eps, alpha = 3000, 150, 1e-6, 0.15
    src, dst, n = synthetic_powerlaw_stream(400, w + 8 * b, seed=3)
    targets = [0, 5, 17, 123, 311]
    drv = FastStreamDriver(src, dst, n, targets, PprConfig(alpha=alpha, eps=eps),
                           StreamConfig(window=w, slide=b), mode=REVERSE, dtype=torch.float64,
                           rebuild_every=4, device="cpu")
    drv.seed()
    assert sum(1 for _ in drv.run(5)) == 5
    wsrc, wdst = exact.window_edges(src, dst, w + 5 * b, w)
    pm = reverse.transition(wsrc, wdst, n, "cpu")
    p, r = drv.state.p.numpy(), drv.state.r.numpy()
    assert reverse.inv_gap_reverse(pm, p, r, targets, alpha, block=2) < 1e-11
    assert reverse.fresh_reverse(r, n, eps) <= 1.0
    # the same state judged on the window before the last slide is off
    wsrc, wdst = exact.window_edges(src, dst, w + 4 * b, w)
    assert reverse.inv_gap_reverse(reverse.transition(wsrc, wdst, n, "cpu"), p, r, targets,
                                   alpha) > 1e-6


def test_the_reference_solve_is_the_matrix_inverse():
    """``solve`` against ``alpha (I - (1 - alpha) P)^-1 rhs`` formed densely,
    on a graph with a dangling vertex and a parallel edge."""
    src = np.array([0, 0, 0, 1, 2, 2, 3], np.int32)
    dst = np.array([1, 2, 2, 2, 0, 3, 1], np.int32)
    n, alpha = 5, 0.2  # vertex 4 has no out-edges
    dense = reverse.transition(src, dst, n, "cpu").to_dense()
    assert torch.allclose(dense.sum(1), torch.ones(n, dtype=torch.float64))
    assert dense[0, 2] == pytest.approx(2 / 3) and dense[4, 4] == 1.0
    rhs = torch.rand((n, 3), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    want = alpha * torch.linalg.solve(torch.eye(n, dtype=torch.float64) - (1 - alpha) * dense, rhs)
    got = reverse.solve(reverse.transition(src, dst, n, "cpu"), rhs, alpha)
    assert torch.allclose(got, want, atol=1e-12, rtol=0)


def test_a_sound_run_is_correct_and_the_control_is_not():
    assert run()["correct"]
    over = tiny()
    over["config"]["delivery"] = "bfloat16"
    res = run(over)
    assert not res["correct"] and res["checks"]["inv_gap"]["value"] > over["params"]["limits"][
        "inv_gap"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_faulty_stream_is_not_correct(monkeypatch, fault):
    """A step that returns its state unchanged; half of a batch left out
    (its first half delivered twice)."""
    from pprx_torch.engine.state import PushStats
    from pprx_torch.graph import fast_stream

    real = fast_stream.wl2_slide_step

    def step(state, kg, pack, *args, **kw):
        b = (pack.shape[0] - 2) // 2
        h = b // 2
        if fault == "unchanged":
            return state, kg, PushStats()
        pack[h:b] = pack[:b - h].clone()
        pack[b + h:2 * b] = pack[b:2 * b - h].clone()
        return real(state, kg, pack, *args, **kw)

    monkeypatch.setattr(fast_stream, "wl2_slide_step", step)
    assert not run()["correct"]


@pytest.mark.parametrize("key,value", [("traffic", {"read_every": 3}),
                                       ("config", {"mode": "forward"})])
def test_the_kind_refuses_reads_and_forward_mode(key, value):
    over = tiny()
    over[key].update(value)
    with pytest.raises(SystemExit):
        run(over)


def test_the_byte_counts_of_the_two_rooflines():
    """The reverse view sorts by ``src`` and gathers at ``dst``; the sweep
    adds the fill and the fresh launch's ``rin`` and offsets to K1's count,
    the round the row scale."""
    src = torch.tensor([3, 0, 3, 1, 0, 3], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0, 2, 4, 4], dtype=torch.int32)
    n, s = 5, 8
    gat, off = kernels_reverse.reverse_view(src, dst, n, "cpu")
    assert gat.tolist() == [2, 4, 2, 1, 0, 4] and off.tolist() == [0, 2, 3, 3, 6, 6]
    k1 = kernels.k1_bytes(gat, n, s)
    assert k1 == 4 * s * 4 + 6 * 4 + 2 * n * s * 4 + (n + 1) * 4  # rows 0, 1, 2, 4 named
    assert kernels_reverse.sweep_bytes(gat, n, s) == k1 + 2 * n * s * 4 + (n + 1) * 4 + (
        n + 1) * s * 4
    assert kernels_reverse.round_bytes(gat, n, s) == k1 + n * 4
    record = {"rev_bytes": {"sweep": 3.35e9, "round": 1.0}}
    record["flight"] = {"loops": 1, "stamp_ms": {"rev.rowsum": {"n": 1, "sum": 2.0,
                                                                "median": 2.0}}}
    assert kernels_reverse.share(record, "sweep", "rev.rowsum") == pytest.approx(50.0)
    assert kernels_reverse.share(record, "round", "k1.window") is None


def test_the_metrics_read_a_reverse_run_and_nothing_from_a_forward_one():
    """The three metrics on the record of three reverse slides (the
    recorder's sums over them, byte counts given): each a finite number;
    on a forward run's sums the two of the sweep read nothing."""
    from pprx_torch import trace
    from pprx_torch.config import PprConfig, StreamConfig
    from pprx_torch.engine.state import FORWARD, REVERSE
    from pprx_torch.graph.fast_stream import FastStreamDriver
    from pprx_torch.graph.io import synthetic_powerlaw_stream

    def record(mode):
        w, b = 3000, 150
        src, dst, n = synthetic_powerlaw_stream(400, w + 8 * b, seed=3)
        drv = FastStreamDriver(src, dst, n, list(range(8)), PprConfig(alpha=0.15, eps=1e-6),
                               StreamConfig(window=w, slide=b), mode=mode, rebuild_every=4,
                               device="cpu")
        drv.seed()
        mark, t0 = trace.RECORDER.mark(), time.perf_counter_ns()
        list(drv.run(3))
        sums = flight.window_sums(trace.RECORDER.snapshot(since=mark), t0, time.perf_counter_ns())
        return {"flight": sums, "slides": [{"ms": 1.0, "rounds": 1}] * 3,
                "rev_bytes": {"sweep": 1e3, "round": 1e3}}

    rev = record(REVERSE)
    for name in REVERSE_METRICS:
        value = harness.metric_module(name).read(rev)
        assert value is not None and np.isfinite(value) and value > 0, name
    assert harness.metric_module("rowsum_ms_per_slide.rev").read(rev) == pytest.approx(
        rev["flight"]["stamp_ms"]["rev.rowsum"]["sum"] / 3)
    fwd = record(FORWARD)
    for name in REVERSE_METRICS[:2]:
        assert harness.metric_module(name).read(fwd) is None


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
def test_the_control_fails_at_the_cells_own_size(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res, _ = harness.run_cell(CELL, seed, 3.0, False, "cuda",
                              overrides={"config": {"delivery": "bfloat16"}})
    print(json.dumps({"cell": CELL, "seed": seed, "checks": res["checks"]}))
    assert not res["correct"]
