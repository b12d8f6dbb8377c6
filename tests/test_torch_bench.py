"""The milestone configs 1-4 of the port (pprx_torch.bench.run), its
headline runner (pprx_torch.bench.headline) and its throughput summary
(pprx_torch.eval.perf) against the JAX package's (and bench.py's): the same
keys (plus ``device``), the same counts, at a tiny scale on the CPU.

Both packages' ``_stream`` is replaced by the same synthetic stream on a
hundredth of the vertices and edges a config asks for, so that the configs
run their own code at a size the CPU test can afford."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import pprx.bench.run as jrun
import pprx_torch.bench.run as trun
from pprx.engine.state import PushStats as JaxPushStats
from pprx.eval.perf import summarize as jax_summarize
from pprx.graph.io import save_packed, synthetic_powerlaw_stream
from pprx_torch.bench import headline
from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.engine.state import PushStats
from pprx_torch.eval.perf import PerfReport, summarize
from pprx_torch.graph.fast_stream import FastStreamDriver

torch.set_num_threads(1)


def _small_stream(graph, n, need, seed):
    assert graph is None
    return synthetic_powerlaw_stream(max(n // 100, 50), need, seed=seed)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(jrun, "_stream", _small_stream)
    monkeypatch.setattr(trun, "_stream", _small_stream)


def _same_keys(port: dict, ref: dict):
    assert port["device"] == "cpu"
    assert set(port) == set(ref) | {"device"}
    for k in ("config", "n", "edges", "window", "slide", "sources", "batch", "k", "steps",
              "edges_updated"):
        if k in ref:
            assert port[k] == ref[k], k


def test_config1_static_forward_matches_jax():
    """Config 1 at its own scale (N=1000, 100k edges, one source): the same
    rounds, the L1 error to exact PPR within the bound in both."""
    port, ref = trun.run_config(1, device="cpu"), jrun.run_config(1)
    _same_keys(port, ref)
    assert port["rounds"] == ref["rounds"] > 0
    assert port["within_bound"] is True and ref["within_bound"] is True
    assert port["l1_bound"] == ref["l1_bound"]
    np.testing.assert_allclose(port["l1_error"], ref["l1_error"], rtol=0, atol=1e-5)
    assert "l1_error" not in trun.run_config(1, check_exact=False, device="cpu")


@pytest.mark.parametrize("idx,kw", [(2, {}), (3, {}), (3, {"s": 4})])
def test_stream_configs_match_jax(small, idx, kw):
    """Configs 2 (forward, S=16) and 3 (reverse, S=8 and a co-batch) on
    N=2000/1000, W=6000, b=200: f32 in both packages, so the round counts
    may differ by the odd round; the keys and the sizes may not."""
    args = dict(w=6000, b=200, steps=3, **kw)
    port = trun.run_config(idx, device="cpu", **args)
    ref = jrun.run_config(idx, **args)
    _same_keys(port, ref)
    assert port["steps"] == 3 and port["edges_updated"] == 3 * 2 * 200
    assert port["updates_per_sec"] > 0 and port["wall_s"] > 0
    assert abs(port["rounds"] - ref["rounds"]) <= 0.1 * ref["rounds"]
    assert port["wl_rounds"] > 0


def test_config4_retrieval_matches_jax(small):
    """Config 4 on N=5000 and its 5M edges: the dense cold push of S sources
    and the top-k read."""
    port = trun.run_config(4, s=8, k=10, device="cpu")
    ref = jrun.run_config(4, s=8, k=10)
    _same_keys(port, ref)
    assert abs(port["push_rounds"] - ref["push_rounds"]) <= 2
    assert port["retrieval_ms_exact"] > 0 and port["retrieval_ms_approx"] > 0


def test_config4_exact_check(small, monkeypatch):
    """``check_exact``: sampled sources of config 4's pushed state against
    exact PPR (L1 within the residual's, mass 1); the reference's keys stay.
    A push that drops the deliveries of the ring's last 1,000 edges (its
    delivery view built from a ring whose last 1,000 slots are the phantom
    ``(N, N)``, the degrees kept) is caught."""
    plain = trun.run_config(4, s=8, k=10, device="cpu")
    held = trun.run_config(4, s=8, k=10, device="cpu", check_exact=3)
    assert set(held) == set(plain) | {"l1_error", "residual_l1", "mass_error", "within_bound"}
    assert held["within_bound"] is True and len(held["l1_error"]) == 3
    assert all(e <= rl + 1e-5 for e, rl in zip(held["l1_error"], held["residual_l1"]))
    assert 0 < max(held["residual_l1"]) <= 1e-6 * held["edges"]

    import pprx_torch.engine.push as tpush
    from pprx_torch.graph.dynamic import WindowGraph

    view_of = tpush.delivery_view

    def dropping(graph, mode):
        src, dst = graph.src.clone(), graph.dst.clone()
        src[-1000:] = graph.n
        dst[-1000:] = graph.n
        return view_of(WindowGraph(src=src, dst=dst, deg=graph.deg), mode)

    monkeypatch.setattr(tpush, "delivery_view", dropping)
    assert trun.run_config(4, s=8, k=10, device="cpu", check_exact=3)["within_bound"] is False


def test_a_missing_graph_is_an_error_of_the_file():
    """``graph=`` is ported for every config: a file that is not there is
    an error of the file; the port has the reference's configs."""
    for idx in (1, 2, 3, 4, 5):
        with pytest.raises(FileNotFoundError):
            trun.run_config(idx, graph="some.npz", device="cpu")
    assert sorted(trun.CONFIGS) == sorted(jrun.CONFIGS)


@pytest.mark.parametrize("engine,mode", [("wl", "forward"), ("dense", "forward"),
                                         ("wlp", "forward"), ("wl", "reverse")],
                         ids=["wl", "dense", "wlp", "wl-reverse"])
def test_config5_matches_jax(engine, mode):
    """Config 5 at mesh 1x1 on a small stream (f32 on the CPU in both): the
    reference's keys plus ``device``, the same rounds and wl rounds, for
    the wl engine in both modes, the memory-proportional one and the dense
    one."""
    kw = dict(n_rows=1, engine=engine, mode=mode, n=300, w=1500, b=100, s=8, steps=3)
    ref = jrun.config5_sharded(**kw)
    out = trun.config5_sharded(**kw, device="cpu")
    assert set(out) == set(ref) | {"device"} and out["device"] == "cpu"
    for key in ("config", "mesh", "engine", "mode", "n", "window", "slide", "sources", "steps",
                "rounds", "wl_rounds"):
        assert out[key] == ref[key], key
    assert out["updates_per_sec_per_chip"] == out["updates_per_sec"] > 0


@pytest.fixture
def packed(tmp_path):
    src, dst, n = synthetic_powerlaw_stream(50, 600, seed=1)
    path = str(tmp_path / "g.npz")
    save_packed(path, src, dst, n)
    return path


@pytest.mark.parametrize("idx", [2, 3])
def test_stream_configs_on_packed_graph(packed, idx):
    """Configs 2 and 3 on a packed file of 600 edges: ``n`` from the file,
    the stream tiled cyclically to cover the window and the slides, the
    reference's sizes and keys."""
    args = dict(graph=packed, w=400, b=40, steps=2)
    port, ref = trun.run_config(idx, device="cpu", **args), jrun.run_config(idx, **args)
    _same_keys(port, ref)
    assert port["n"] == ref["n"] == 50
    assert (port["window"], port["slide"]) == (ref["window"], ref["slide"]) == (400, 40)
    assert port["steps"] == 2 and port["rounds"] > 0 and port["updates_per_sec"] > 0


def test_stream_tiles_a_short_file(packed):
    src, dst, n = trun._stream(packed, 999, 1500, seed=0)
    ref = jrun._stream(packed, 999, 1500, seed=0)
    assert n == ref[2] == 50 and src.shape == (1500,)
    np.testing.assert_array_equal(src, ref[0])
    np.testing.assert_array_equal(dst, ref[1])
    np.testing.assert_array_equal(src[600:1200], src[:600])


HEADLINE_ENV = dict(N=300, W=1500, B=100, S=4, STEPS=2, REPS=2)


def test_headline_has_bench_keys(monkeypatch, capsys):
    """The port's headline runner at tiny shapes (the same environment as
    bench.py) gives bench.py's keys plus ``impl`` and ``device``, and its
    numbers: blocks, the other delivery mode, refine, precision."""
    import bench

    for k, v in HEADLINE_ENV.items():
        monkeypatch.setenv(f"PPRX_BENCH_{k}", str(v))
    out = headline.run(device="cpu")
    monkeypatch.setenv("PPRX_BENCH_DUAL", "0")  # the keys, not the work
    monkeypatch.setenv("PPRX_BENCH_PRECISION", "0")
    bench.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == list(ref) + ["impl", "device"]
    assert list(out["config"]) == list(ref["config"]) and out["config"] == ref["config"]
    assert out["impl"] == "pprx_torch" and out["device"] == "cpu"
    assert len(out["blocks"]) == 2 and out["value"] == max(out["blocks"])
    assert out["bf16_updates_per_sec"] > 0 and out["refine_ms"] > 0
    assert out["top100_precision"] == 1.0
    assert out["l1_vs_exact_mean"] <= out["l1_bound_eps_E"]


@pytest.mark.parametrize("env,reason", [
    ({"PPRX_BENCH_SEGSUM": "0"}, "no delivery path without its segment-sum kernel"),
    ({"PPRX_BENCH_SEGSUM": "2"}, "PPRX_BENCH_SEGSUM must be '0' or '1'"),
])
def test_headline_refuses(monkeypatch, env, reason):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=reason):
        headline.run(device="cpu")


def test_headline_hybrid_engine(monkeypatch, capsys):
    """``PPRX_BENCH_ENGINE=hybrid``: bench.py's keys and config from the
    hybrid driver at its own defaults, one block, no refine and no other
    delivery mode, as bench.py runs it; top-100 against exact PPR."""
    import bench

    for k, v in {**HEADLINE_ENV, "ENGINE": "hybrid"}.items():
        monkeypatch.setenv(f"PPRX_BENCH_{k}", str(v))
    out = headline.run(device="cpu")
    monkeypatch.setenv("PPRX_BENCH_PRECISION", "0")
    bench.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == list(ref) + ["impl", "device"]
    assert out["config"] == ref["config"] and out["config"]["engine"] == "hybrid"
    assert len(out["blocks"]) == len(ref["blocks"]) == 1
    assert out["bf16_updates_per_sec"] is None and out["refine_ms"] is None
    assert out["top100_precision"] > 0.9 and out["l1_vs_exact_mean"] <= out["l1_bound_eps_E"]


def test_headline_dense_engine(monkeypatch):
    for k, v in {**HEADLINE_ENV, "ENGINE": "dense"}.items():
        monkeypatch.setenv(f"PPRX_BENCH_{k}", str(v))
    out = headline.run(device="cpu")
    assert len(out["blocks"]) == 1 and out["bf16_updates_per_sec"] is None
    assert out["refine_ms"] is None and out["top100_precision"] > 0.9


def test_restored_blocks_are_bit_identical():
    """Every block after the first starts from a clone of the state before
    the first: the same per-slide stats, and the same ``p`` and ``r`` after
    each block (the slide step writes into the graph's tensors in place, so
    a snapshot that kept any of them would start block 2 where block 1
    ended)."""
    src, dst, n = synthetic_powerlaw_stream(300, 1500 + 12 * 100, seed=7)
    cfg, scfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000), StreamConfig(1500, 100)
    drv = FastStreamDriver(src, dst, n, list(range(4)), cfg, scfg, rebuild_every=2,
                           device="cpu")
    drv.seed()
    list(drv.run(3))
    ends = []
    for _, stats in headline.timed_blocks(drv, 4, 3):
        ends.append(([dataclasses.astuple(st) for st in stats], drv.state.p.clone(),
                     drv.state.r.clone(), drv.head, drv.fcnt, drv.hsrc.copy()))
    assert len(ends) == 3 and ends[0][3] == 1500 + 7 * 100
    first = ends[0]
    for other in ends[1:]:
        assert other[0] == first[0] and other[3:5] == first[3:5]
        assert torch.equal(other[1], first[1]) and torch.equal(other[2], first[2])
        np.testing.assert_array_equal(other[5], first[5])
    # rounds were pushed; with rebuild_every=2 a block rebuilds the graph twice
    assert sum(st[0] for st in first[0]) > 0


def test_configs_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for idx in (1, 2, 3, 4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trun.run_config(idx)


def test_summarize_matches_reference():
    rng = np.random.default_rng(0)
    fields = ("rounds", "pushes", "edge_pushes", "wl_rounds", "scans_cand", "scans_fed",
              "scans_liv")
    rows = [{f: int(v) for f, v in zip(fields, rng.integers(0, 1000, len(fields)))}
            for _ in range(5)]
    got = summarize([PushStats(**r) for r in rows], 0.25, edges_per_step=40, n_chips=2)
    ref = jax_summarize([JaxPushStats(**r) for r in rows], 0.25, edges_per_step=40, n_chips=2)
    assert got.as_dict() == ref.as_dict()
    assert list(got.as_dict()) == list(ref.as_dict())
    assert [f.name for f in dataclasses.fields(PerfReport)] == [
        f.name for f in dataclasses.fields(type(ref))]
    empty = summarize([], 0.0, edges_per_step=40)
    assert empty.updates_per_sec == 0.0 and empty.steps_per_sec == 0.0
    assert empty.as_dict() == jax_summarize([], 0.0, edges_per_step=40).as_dict()
