"""``correct`` has to come out false for the control and for each fault a
cell can have, with the rest of a run driven as it is.

The control is the nearest precision below the configuration's float32: the
program's own bfloat16 delivery of the rows a round moves. The stream cell
takes it from its configuration (``delivery``, the fast driver's ``bf16d``);
the dense engine has no such option, so the retrieve cell's control hands
its rounds (``push.dense_round_``) the same ``moving_dtype``. The faults are planted in the program under the harness:
a step that returns its state unchanged, half of a batch left out, an
answer altered where it is produced. One card means no exchange between
cards to leave out.

On the CPU at a tiny size (the run's look for a card skipped: ``run_cell``
on ``cpu``); the control again on the card at each cell's own size
(``cuda`` marker), each run's readings printed.
"""

import json

import pytest
import torch

from benchmark import harness

STREAMS = ["stream.b160k"]
CELLS = STREAMS + ["retrieve.s512"]
SERVE = {"traffic": {"read_every": 3, "read_eps": 5e-8}, "params": {"check_every": 2}}
SEED = 2**31 + 99


def tiny(cell: str, reads: bool = False) -> dict:
    """A size the CPU runs in a second. ``inv_gap``'s limit is set at this
    size from its readings (sound runs 1e-6 or less, the controls 3e-3 or
    more); the other limits are the cell's own. ``reads``: a read after
    every 3rd slide, refined to 5e-8, and its top-k judged too."""
    limits = {**harness.load_json("workloads", cell)["limits"], "inv_gap": 3e-4}
    if cell.startswith("retrieve"):
        return {"config": {"n": 500, "edges": 5000, "sources": 16},
                "params": {"limits": limits, "check_every": 2}}
    out = {"config": {"n": 400, "window": 4000, "sources": 8}, "traffic": {"slide": 200},
           "params": {"edges_per_s": 4e6, "limits": limits}}
    if reads:
        out["traffic"].update(SERVE["traffic"])
        out["params"].update(SERVE["params"], limits={**limits, "topk_ties": 0.0})
    return out


def control(monkeypatch, cell: str, over: dict) -> dict:
    """``over`` with the cell's control switched on."""
    if cell.startswith("retrieve"):
        from pprx_torch.engine import push

        real = push.dense_round_

        def dense_round_(state, deg, views, cfg, counts, moving_dtype=None):
            real(state, deg, views, cfg, counts, torch.bfloat16)

        monkeypatch.setattr(push, "dense_round_", dense_round_)
        return over
    return {**over, "config": {**over.get("config", {}), "delivery": "bfloat16"}}


def run(cell: str, reads: bool = False, over: dict | None = None) -> dict:
    res, _ = harness.run_cell(cell, SEED, 0.5, False, "cpu",
                              overrides=tiny(cell, reads) if over is None else over)
    return res


@pytest.mark.parametrize("cell,reads", [(c, False) for c in CELLS] + [(c, True) for c in STREAMS])
def test_a_sound_run_is_correct_and_the_control_is_not(monkeypatch, cell, reads):
    assert run(cell, reads)["correct"]
    assert not run(cell, over=control(monkeypatch, cell, tiny(cell, reads)))["correct"]


def _stream_faults(monkeypatch, fault):
    from pprx_torch.engine.state import PushStats
    from pprx_torch.graph import fast_stream

    real = fast_stream.wl2_slide_step

    def step(state, kg, pack, *args, **kw):
        b = (pack.shape[0] - 2) // 2
        h = b // 2
        if fault == "unchanged":
            return state, kg, PushStats()
        if fault == "half":
            pack[h:b] = pack[:b - h].clone()
            pack[b + h:2 * b] = pack[b:2 * b - h].clone()
        out = real(state, kg, pack, *args, **kw)
        if fault == "altered":
            state.p[state.p.shape[0] // 2].add_(0.01)
        return out

    monkeypatch.setattr(fast_stream, "wl2_slide_step", step)


def _altered_topk(monkeypatch):
    from pprx_torch.retrieve import topk

    real = topk.topk_candidates

    def topk_candidates(p, k, exact=True):
        scores, ids = real(p, k, exact)
        ids = ids.clone()
        ids[:, 0] = ids[:, -1]
        return scores, ids

    monkeypatch.setattr(topk, "topk_candidates", topk_candidates)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", STREAMS)
def test_a_faulty_stream_is_not_correct(monkeypatch, cell, fault):
    _stream_faults(monkeypatch, fault)
    assert not run(cell)["correct"]


def test_an_altered_read_is_not_correct(monkeypatch):
    _altered_topk(monkeypatch)
    assert not run("stream.b160k", reads=True)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_faulty_retrieval_is_not_correct(monkeypatch, fault):
    from pprx_torch.engine import push
    from pprx_torch.engine.state import PushStats

    real = push.push_to_convergence

    def push_to_convergence(state, graph, cfg, graphs=None, view=None):
        if fault == "unchanged":
            return state, PushStats()
        if fault == "half":
            state.r[:, state.r.shape[1] // 2:] = 0.0
        return real(state, graph, cfg, graphs, view)

    if fault == "altered":
        _altered_topk(monkeypatch)
    else:
        monkeypatch.setattr(push, "push_to_convergence", push_to_convergence)
    assert not run("retrieve.s512")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_own_size(monkeypatch, cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res, _ = harness.run_cell(cell, seed, 3.0, False, "cuda", overrides=control(monkeypatch, cell, {}))
    print(json.dumps({"cell": cell, "seed": seed, "checks": res["checks"]}))
    assert not res["correct"]
