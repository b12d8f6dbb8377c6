"""The milestone configs 1-4 of the port (pprx_torch.bench.run) and its
throughput summary (pprx_torch.eval.perf) against the JAX package's: the
same keys (plus ``device``), the same counts, at a tiny scale on the CPU.

Both packages' ``_stream`` is replaced by the same synthetic stream on a
hundredth of the vertices and edges a config asks for, so that the configs
run their own code at a size the CPU test can afford."""

import dataclasses

import numpy as np
import pytest
import torch

import pprx.bench.run as jrun
import pprx_torch.bench.run as trun
from pprx.engine.state import PushStats as JaxPushStats
from pprx.eval.perf import summarize as jax_summarize
from pprx.graph.io import synthetic_powerlaw_stream
from pprx_torch.engine.state import PushStats
from pprx_torch.eval.perf import PerfReport, summarize

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
    A push that drops an edge block's deliveries is caught."""
    plain = trun.run_config(4, s=8, k=10, device="cpu")
    held = trun.run_config(4, s=8, k=10, device="cpu", check_exact=3)
    assert set(held) == set(plain) | {"l1_error", "residual_l1", "mass_error", "within_bound"}
    assert held["within_bound"] is True and len(held["l1_error"]) == 3
    assert all(e <= rl + 1e-5 for e, rl in zip(held["l1_error"], held["residual_l1"]))
    assert 0 < max(held["residual_l1"]) <= 1e-6 * held["edges"]

    import pprx_torch.engine.push as tpush

    blocks = tpush.edge_blocks
    monkeypatch.setattr(tpush, "edge_blocks",
                        lambda n_edges, row_bytes: list(blocks(n_edges - 1000, row_bytes)))
    assert trun.run_config(4, s=8, k=10, device="cpu", check_exact=3)["within_bound"] is False


def test_what_is_not_ported_says_so():
    with pytest.raises(NotImplementedError, match="config5_sharded: not ported"):
        trun.run_config(5)
    for idx in (1, 2, 3, 4):
        with pytest.raises(NotImplementedError, match="graph=.*not ported"):
            trun.run_config(idx, graph="some.npz", device="cpu")
    assert sorted(trun.CONFIGS) == sorted(jrun.CONFIGS)


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
