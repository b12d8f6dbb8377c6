"""The port's command line (pprx_torch.cli) against the JAX package's
(pprx.cli): every case of tests/test_cli.py that the port runs, through both
CLIs on the same packed file with ``--device cpu`` for the port, held to
each other in f64 (equal rounds and counts, errors within 1e-12, the same
ids), checkpoints crossing between the two, and what the port refuses."""

import json

import numpy as np
import pytest
import torch

from pprx import cli as jcli
from pprx.graph.io import save_packed as jax_save_packed
from pprx.graph.io import synthetic_powerlaw_stream
from pprx_torch import cli as tcli

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture
def graph_npz(tmp_path):
    src, dst, n = synthetic_powerlaw_stream(50, 600, seed=1)
    path = str(tmp_path / "g.npz")
    jax_save_packed(path, src, dst, n)
    return path


def run_cli(capsys, main, argv):
    main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def both(capsys, argv):
    """The same command through the JAX CLI and the port's (on the CPU)."""
    return run_cli(capsys, jcli.main, argv), run_cli(capsys, tcli.main, argv + CPU)


def records(path, event):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["event"] == event]


def test_convert(tmp_path, capsys):
    txt = tmp_path / "g.txt"
    txt.write_text("# c\n1 2\n2 3\n3 1\n")
    ref = run_cli(capsys, jcli.main, ["convert", str(txt), str(tmp_path / "j.npz")])
    out = run_cli(capsys, tcli.main, ["convert", str(txt), str(tmp_path / "t.npz")])
    assert out["n"] == ref["n"] == 3 and out["edges"] == ref["edges"] == 3
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(j[k], t[k])


@pytest.mark.parametrize("argv", [
    ["--queries", "0,3", "--eps", "1e-7"],
    ["--mode", "rev"],
], ids=["forward", "reverse"])
def test_static_check_exact(graph_npz, capsys, argv):
    """test_static_check_exact and test_static_reverse: the same rounds and
    pushes, and the L1 error to exact PPR within 1e-12 of the reference's
    (its exact matrix is an inverse, the port's a power iteration)."""
    ref, out = both(capsys, ["static", graph_npz, *argv, "--f64", "--check-exact"])
    assert set(out) == set(ref) | {"device"} and out["device"] == "cpu"
    assert out["rounds"] == ref["rounds"] > 0
    assert (out["pushes"], out["edge_pushes"]) == (ref["pushes"], ref["edge_pushes"])
    np.testing.assert_allclose(out["l1_error"], ref["l1_error"], rtol=0, atol=1e-12)
    assert out["l1_bound"] == ref["l1_bound"]
    assert all(e < out["l1_bound"] for e in out["l1_error"])


@pytest.mark.parametrize("engine", ["fast", "dense", "hybrid"])
def test_stream_with_checkpoint(graph_npz, tmp_path, capsys, engine):
    """Per slide, the same rounds, pushes and edge pushes in both logs; the
    same summary keys plus ``device``; the checkpoint written."""
    outs, logs = [], []
    for tag, main, dev in (("jax", jcli.main, []), ("torch", tcli.main, CPU)):
        log, ck = str(tmp_path / f"{tag}.jsonl"), str(tmp_path / f"{tag}.npz")
        outs.append(run_cli(capsys, main, [
            "stream", graph_npz, "--window", "300", "--slide", "30", "--steps", "5",
            "--engine", engine, "--log", log, "--checkpoint", ck, "--checkpoint-every", "2",
            "--f64", *dev]))
        logs.append(log)
    ref, out = outs
    assert set(out) == set(ref) | {"device"}
    assert out["steps"] == 5 and out["updates_per_sec"] > 0
    events = [json.loads(line) for line in open(logs[1])]
    assert [e["event"] for e in events][:2] == ["seed", "slide"]
    assert sum(e["event"] == "checkpoint" for e in events) == 2
    assert events[-1]["event"] == "summary"
    keys = ("step", "rounds", "pushes", "edge_pushes")
    want, got = ([tuple(r[k] for k in keys) for r in records(p, "slide")] for p in logs)
    assert got == want and len(got) == 5
    assert records(logs[1], "seed")[0]["rounds"] == records(logs[0], "seed")[0]["rounds"]


@pytest.mark.parametrize("engine,mode", [("sharded-wl", "fwd"), ("sharded", "fwd"),
                                         ("sharded", "rev"), ("sharded-wl", "rev"),
                                         ("sharded-wlp", "fwd"), ("sharded-wlp", "rev")])
def test_sharded_stream_at_mesh_1x1(graph_npz, tmp_path, capsys, engine, mode):
    """``stream --engine sharded|sharded-wl|sharded-wlp --mesh 1,1`` through
    both CLIs in f64, in both modes: per slide the same rounds, pushes and
    edge pushes, the same summary keys plus ``device``, one chip."""
    outs, logs = [], []
    for tag, main, dev in (("jax", jcli.main, []), ("torch", tcli.main, CPU)):
        log = str(tmp_path / f"{tag}.jsonl")
        outs.append(run_cli(capsys, main, [
            "stream", graph_npz, "--window", "300", "--slide", "30", "--steps", "5",
            "--engine", engine, "--mesh", "1,1", "--mode", mode, "--queries", "0,3,7",
            "--log", log, "--f64", *dev]))
        logs.append(log)
    ref, out = outs
    assert set(out) == set(ref) | {"device"}
    assert out["steps"] == 5 and out["n_chips"] == ref["n_chips"] == 1
    assert (out["rounds"], out["wl_rounds"]) == (ref["rounds"], ref["wl_rounds"])
    keys = ("step", "rounds", "pushes", "edge_pushes")
    want, got = ([tuple(r[k] for k in keys) for r in records(p, "slide")] for p in logs)
    assert got == want and len(got) == 5
    seeds = [records(p, "seed")[0] for p in logs]
    assert (seeds[1]["rounds"], seeds[1]["pushes"]) == (seeds[0]["rounds"], seeds[0]["pushes"])


def test_retrieve(graph_npz, capsys):
    ref, out = both(capsys, ["retrieve", graph_npz, "--queries", "random", "--batch", "16",
                             "--k", "10", "--f64"])
    assert set(out) == set(ref) | {"device"}
    assert out["batch"] == ref["batch"] == 16 and out["k"] == 10
    assert out["push_rounds"] == ref["push_rounds"] > 0
    assert out["top1"] == ref["top1"]
    assert out["retrieval_ms"] > 0


def test_retrieve_from_checkpoint(graph_npz, tmp_path, capsys):
    """The serving loop end to end, with the checkpoint crossing: a
    checkpoint the JAX CLI's stream wrote is served by the port's retrieve,
    and the port's by the JAX CLI's; each reads the same top1 and refines by
    the same rounds as the CLI that wrote it."""
    cks = {}
    for tag, main, dev in (("jax", jcli.main, []), ("torch", tcli.main, CPU)):
        cks[tag] = str(tmp_path / f"{tag}.npz")
        run_cli(capsys, main, ["stream", graph_npz, "--window", "300", "--slide", "30",
                               "--steps", "3", "--queries", "0,5,9", "--checkpoint", cks[tag],
                               "--checkpoint-every", "3", "--f64", *dev])
    reads = {}
    for ck_tag, ck in cks.items():
        for tag, main, dev in (("jax", jcli.main, []), ("torch", tcli.main, CPU)):
            reads[ck_tag, tag] = run_cli(capsys, main, [
                "retrieve", graph_npz, "--from-checkpoint", ck, "--k", "5",
                "--refine-eps", "1e-7", "--approx", *dev])
    for (ck_tag, tag), out in reads.items():
        assert out["k"] == 5 and out["batch"] == 3 and len(out["top1"]) == 3
        assert out["refine_eps"] == 1e-7 and out["refine_rounds"] > 0
    for ck_tag in cks:
        ref, out = reads[ck_tag, "jax"], reads[ck_tag, "torch"]
        assert set(out) == set(ref) | {"device"}
        assert out["top1"] == ref["top1"]
        assert out["refine_rounds"] == ref["refine_rounds"]
    assert reads["jax", "torch"]["top1"] == reads["torch", "torch"]["top1"]


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_hybrid_stream_checkpoint_and_retrieve(graph_npz, tmp_path, capsys, mode):
    """``stream --engine hybrid --checkpoint`` through both CLIs in f64:
    per slide the same rounds and counts, two files whose states agree at
    1e-12; ``retrieve --from-checkpoint`` reads the same top1 from either
    file through either CLI; ``--refine-eps`` on a hybrid file exits with
    the reference's message."""
    logs, cks = {}, {}
    for tag, main, dev in (("jax", jcli.main, []), ("torch", tcli.main, CPU)):
        logs[tag], cks[tag] = str(tmp_path / f"{tag}.jsonl"), str(tmp_path / f"{tag}.npz")
        run_cli(capsys, main, ["stream", graph_npz, "--window", "300", "--slide", "30",
                               "--steps", "5", "--engine", "hybrid", "--mode", mode,
                               "--queries", "0,5,9", "--log", logs[tag], "--checkpoint",
                               cks[tag], "--checkpoint-every", "5", "--f64", *dev])
    keys = ("step", "rounds", "pushes", "edge_pushes")
    want, got = ([tuple(r[k] for k in keys) for r in records(logs[t], "slide")]
                 for t in ("jax", "torch"))
    assert got == want and len(got) == 5 and sum(r[1] for r in got) > 0
    with np.load(cks["jax"]) as a, np.load(cks["torch"]) as b:
        assert json.loads(bytes(a["meta"]).decode()) == json.loads(bytes(b["meta"]).decode())
        for k in ("p", "r"):
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-12)
        for k in ("src", "dst", "deg"):
            np.testing.assert_array_equal(b[k], a[k])
    tops = set()
    for ck in cks.values():
        ref, out = both(capsys, ["retrieve", graph_npz, "--from-checkpoint", ck, "--k", "5"])
        assert set(out) == set(ref) | {"device"} and out["batch"] == ref["batch"] == 3
        assert out["top1"] == ref["top1"] and out["queries_known"] is False
        tops.add(tuple(out["top1"]))
    assert len(tops) == 1
    for main, dev in ((jcli.main, []), (tcli.main, CPU)):
        with pytest.raises(SystemExit, match="--refine-eps needs a fast-engine checkpoint"):
            main(["retrieve", graph_npz, "--from-checkpoint", cks["torch"], "--refine-eps",
                  "1e-9", *dev])


def _serve_both(capsys, tmp_path, argv):
    outs, logs = [], []
    for tag, main, dev in (("jax", jcli.main, []), ("torch", tcli.main, CPU)):
        log = str(tmp_path / f"serve_{tag}.jsonl")
        outs.append(run_cli(capsys, main, ["serve", *argv, "--log", log, "--f64", *dev]))
        logs.append(log)
    return outs, logs


def test_serve_incremental(graph_npz, tmp_path, capsys):
    """Budget mode: the reference's summary keys (less its transport note,
    plus ``updates_per_sec_end_to_end`` and ``device``), the same refine
    rounds per slide and the same ids at every read."""
    (ref, out), logs = _serve_both(capsys, tmp_path, [
        graph_npz, "--window", "300", "--slide", "25", "--steps", "8", "--queries", "0,3,7",
        "--k", "5", "--eps", "1e-6", "--eps-retrieve", "1e-7", "--refine-budget", "4",
        "--serve-every", "4", "--emit-ids", "2"])
    assert set(out) == (set(ref) - {"note"}) | {"updates_per_sec_end_to_end", "device"}
    assert out["mode"] == "serve" and out["steps"] == 8 and out["serve_events"] == 2
    assert out["slide_ms_worst"] is not None and out["retrieval_ms_mean"] is not None
    assert out["refine_budget_rounds"] == 4
    for event, key in (("ramp_refine", "rounds"), ("slide", "refine_rounds")):
        want, got = ([r[key] for r in records(p, event)] for p in logs)
        assert got == want and got
    want, got = (records(p, "serve") for p in logs)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [3, 7]
    # no two of these scores tie, so the ids agree as ranked lists
    assert [r["ids"] for r in got] == [r["ids"] for r in want]
    assert len(got[0]["ids"]) == 2 and len(got[0]["ids"][0]) == 5


def test_serve_event_mode(graph_npz, tmp_path, capsys):
    """--refine-budget 0: a full refine at each read, the same rounds as
    the reference's and the same ids."""
    (ref, out), logs = _serve_both(capsys, tmp_path, [
        graph_npz, "--window", "300", "--slide", "25", "--steps", "4", "--queries", "0,3",
        "--k", "5", "--refine-budget", "0", "--serve-every", "2", "--emit-ids", "2"])
    assert out["mode"] == "serve" and out["serve_events"] == ref["serve_events"] == 2
    want, got = ([r["rounds"] for r in records(p, "event_refine")] for p in logs)
    assert got == want and len(got) == 2
    want, got = ([r["ids"] for r in records(p, "serve")] for p in logs)
    assert got == want and len(got) == 2


def test_serve_rate_counts_slide_walls_only(graph_npz, tmp_path, capsys):
    """``updates_per_sec_incl_refine`` is 2 * slide * steps over the sum of
    the slide walls (the slide, its budgeted refine, one sync): in event
    mode the event refines and the reads are outside it, so the whole
    loop's rate (``updates_per_sec_end_to_end``) is lower."""
    log = str(tmp_path / "serve.jsonl")
    out = run_cli(capsys, tcli.main, [
        "serve", graph_npz, "--window", "300", "--slide", "25", "--steps", "6",
        "--queries", "0,3", "--k", "5", "--refine-budget", "0", "--serve-every", "2",
        "--log", log, *CPU])
    walls = [r["wall_ms"] for r in records(log, "slide")]
    assert len(walls) == 6 and len(records(log, "event_refine")) == 3
    want = 2 * 25 * 6 / (sum(walls) / 1e3)
    # each logged wall is rounded to 0.05 ms, the rate to 0.05 updates/s
    rel = 0.05 * len(walls) / sum(walls)
    assert out["updates_per_sec_incl_refine"] == pytest.approx(want, rel=rel, abs=0.05)
    assert out["updates_per_sec_end_to_end"] < out["updates_per_sec_incl_refine"]
    assert records(log, "summary")[0]["updates_per_sec_incl_refine"] == (
        out["updates_per_sec_incl_refine"])


def test_bench_config_on_packed_graph(graph_npz, capsys):
    """``bench --config 1 --graph``: config 1 on the packed file (n from the
    file, the stream tiled to its 100k edges), the reference's keys plus
    ``device`` and its rounds."""
    ref, out = both(capsys, ["bench", "--config", "1", "--graph", graph_npz])
    assert set(out) == set(ref) | {"device"}
    assert out["n"] == ref["n"] == 50 and out["edges"] == ref["edges"] == 100_000
    assert out["rounds"] == ref["rounds"] > 0 and out["within_bound"] is True


def test_bench_without_config_runs_the_headline(monkeypatch, capsys):
    """``bench`` with no ``--config`` is the headline runner, set by the
    same environment as bench.py."""
    for k, v in dict(N=300, W=1500, B=100, S=4, STEPS=2, REPS=2, DUAL=0, PRECISION=0).items():
        monkeypatch.setenv(f"PPRX_BENCH_{k}", str(v))
    out = run_cli(capsys, tcli.main, ["bench", *CPU])
    assert out["impl"] == "pprx_torch" and out["device"] == "cpu"
    assert out["config"]["window"] == 1500 and len(out["blocks"]) == 2


@pytest.mark.parametrize("argv,reason", [
    (["stream", "G", "--window", "300", "--slide", "30", "--engine", "sharded", "--mesh", "4,2"],
     r"--engine sharded: mesh 4x2 needs 8 processes, the world has 1"),
    (["static", "G", "--queries", "0,50", *CPU], r"vertex id 50 is outside \[0, n\) for n = 50"),
    (["static", "G", "--queries", "-1", *CPU], r"vertex id -1 is outside \[0, n\)"),
    (["stream", "G", "--window", "300", "--slide", "30", "--queries", "3,60", *CPU],
     r"vertex id 60 is outside \[0, n\) for n = 50"),
    (["stream", "G", "--window", "300", "--slide", "30", "--engine", "dense", "--queries",
      "50", *CPU], r"vertex id 50 is outside"),
    (["retrieve", "G", "--queries", "7,50", *CPU], r"vertex id 50 is outside"),
    (["serve", "G", "--window", "300", "--slide", "30", "--queries", "0,99", *CPU],
     r"vertex id 99 is outside \[0, n\) for n = 50"),
    (["serve", "G", "--window", "300", "--slide", "30", "--mode", "rev", *CPU],
     "forward mode only"),
    (["stream", "G", "--window", "300", "--slide", "30", "--f64", "--device", "cuda"],
     "--f64 on cuda: the fast engine's segment-sum kernel takes f32 or bf16 only"),
    (["serve", "G", "--window", "300", "--slide", "30", "--f64", "--device", "cuda"],
     "serve: --f64 on cuda"),
    (["retrieve", "G", "--from-checkpoint", "G", "--refine-eps", "1e-7", "--f64", "--device",
      "cuda"], "retrieve --refine-eps: --f64 on cuda"),
    # the dense engine's rounds run K1 and K2 on the card, which take f32
    (["static", "G", "--f64", "--device", "cuda"],
     "static: --f64 on cuda: the dense engine's kernels .* take f32 only"),
    (["retrieve", "G", "--queries", "0,5", "--f64", "--device", "cuda"],
     "retrieve: --f64 on cuda: the dense engine's kernels"),
    (["stream", "G", "--window", "300", "--slide", "30", "--engine", "dense", "--f64",
      "--device", "cuda"], "stream --engine dense: --f64 on cuda: the dense engine's kernels"),
    # so do the hybrid engine's dense scans, and the sharded dense engine's
    # rounds in a world of one shard
    (["stream", "G", "--window", "300", "--slide", "30", "--engine", "hybrid", "--f64",
      "--device", "cuda"], "stream --engine hybrid: --f64 on cuda: the hybrid engine's kernels"),
    (["stream", "G", "--window", "300", "--slide", "30", "--engine", "sharded", "--mesh", "1,1",
      "--f64", "--device", "cuda"],
     "stream --engine sharded: --f64 on cuda: the sharded dense engine's kernels in a world "
     "of one shard"),
], ids=["sharded", "static-query-n",
        "static-query-negative", "stream-query", "dense-query", "retrieve-query", "serve-query",
        "serve-reverse", "stream-f64-cuda", "serve-f64-cuda", "retrieve-f64-cuda",
        "static-f64-cuda", "retrieve-cold-f64-cuda", "stream-dense-f64-cuda",
        "stream-hybrid-f64-cuda", "stream-sharded-f64-cuda"])
def test_refusals_name_the_reason(graph_npz, monkeypatch, argv, reason):
    """What the port does not run exits with a message that names why, before
    any state is built (the f64 refusals before any device is touched)."""
    def no_state(*a, **k):
        raise AssertionError("state was built before the refusal")

    import pprx_torch.engine.state as tstate

    monkeypatch.setattr(tstate, "init_state", no_state)
    # the three single-card drivers build their state in their shell
    monkeypatch.setattr("pprx_torch.graph.driver.init_state", no_state)
    argv = [graph_npz if a == "G" else a for a in argv]
    with pytest.raises(SystemExit, match=reason):
        tcli.main(argv)


def _sharded_checkpoints(graph_npz, tmp_path, capsys, engine):
    """``stream --engine <engine> --mesh 1,1 --checkpoint`` through both
    CLIs (f64, 4 slides, a file every 2): (JAX summary, port summary), and
    the two files."""
    outs, cks = [], []
    for tag, main, dev in (("jax", jcli.main, []), ("torch", tcli.main, CPU)):
        ck = str(tmp_path / f"{tag}-{engine}.npz")
        outs.append(run_cli(capsys, main, [
            "stream", graph_npz, "--window", "300", "--slide", "30", "--steps", "4",
            "--engine", engine, "--mesh", "1,1", "--queries", "0,3,7", "--checkpoint", ck,
            "--checkpoint-every", "2", "--log", str(tmp_path / f"{tag}.jsonl"), "--f64", *dev]))
        cks.append(ck)
    return outs, cks


@pytest.mark.parametrize("engine", ["sharded", "sharded-wl", "sharded-wlp"])
def test_sharded_stream_checkpoint(graph_npz, tmp_path, capsys, engine):
    """A sharded ``stream --checkpoint`` written by each CLI: the same
    rounds, and two files of one layout (every array equal, p and r within
    1e-12; the metadata but for the reference's resolved ``segsum``), each
    of which the port resumes from where it was written."""
    from pprx_torch.dist.mesh import make_row_mesh
    from pprx_torch.graph.io import load_packed
    from pprx_torch.io.checkpoint import load_sharded_checkpoint

    (ref, out), cks = _sharded_checkpoints(graph_npz, tmp_path, capsys, engine)
    assert (out["rounds"], out["wl_rounds"]) == (ref["rounds"], ref["wl_rounds"])
    with np.load(cks[0]) as za, np.load(cks[1]) as zb:
        assert set(za.files) == set(zb.files)
        for k in set(za.files) - {"meta", "p", "r"}:
            np.testing.assert_array_equal(za[k], zb[k], k)
        for k in ("p", "r"):
            np.testing.assert_allclose(za[k], zb[k], rtol=0, atol=1e-12)
        metas = [json.loads(bytes(z["meta"]).decode()) for z in (za, zb)]
    for m in metas:
        m.get("wl_tuning", {}).pop("segsum", None)
    assert metas[0] == metas[1] and metas[1]["kind"] == "sharded"
    src, dst, _ = load_packed(graph_npz)
    for ck in cks:
        drv = load_sharded_checkpoint(ck, src, dst, make_row_mesh(1, 1), device="cpu")
        assert (drv.head, drv.step_idx) == (300 + 4 * 30, 4)


def test_sharded_checkpoint_is_refused(graph_npz, tmp_path, capsys):
    """``retrieve --from-checkpoint`` refuses a sharded checkpoint, as the
    reference does, naming the port's way to serve it (a file of either
    CLI); a dense one refuses a refine."""
    _, cks = _sharded_checkpoints(graph_npz, tmp_path, capsys, "sharded-wl")
    for ck in cks:
        with pytest.raises(SystemExit, match=r"SHARDED checkpoint; serve it through the sharded "
                           r"driver \(pprx_torch.io.checkpoint.load_sharded_checkpoint \+ "
                           r"pprx_torch.dist.retrieve.make_sharded_topk\)"):
            tcli.main(["retrieve", graph_npz, "--from-checkpoint", ck, *CPU])
        with pytest.raises(SystemExit, match=r"SHARDED checkpoint; serve it through"):
            jcli.main(["retrieve", graph_npz, "--from-checkpoint", ck])
    dense = str(tmp_path / "dense.npz")
    tcli.main(["stream", graph_npz, "--window", "300", "--slide", "30", "--steps", "1",
               "--engine", "dense", "--checkpoint", dense, "--checkpoint-every", "1",
               "--log", str(tmp_path / "log.jsonl"), *CPU])
    with pytest.raises(SystemExit, match="--refine-eps needs a fast-engine checkpoint"):
        tcli.main(["retrieve", graph_npz, "--from-checkpoint", dense, "--refine-eps", "1e-7",
                   *CPU])


def test_entry_points_default_to_the_card(graph_npz, monkeypatch):
    """Without ``--device`` a subcommand runs on the card, and raises where
    there is none: it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["static", graph_npz], ["bench", "--config", "1"],
                 ["serve", graph_npz, "--window", "300", "--slide", "30"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
