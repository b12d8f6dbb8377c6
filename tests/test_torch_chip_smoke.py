"""The smoke script's own checks (chip_smoke.py) on the CPU at a small size:
its main() needs a card, the comparisons it makes do not."""

import numpy as np
import pytest
import torch

import chip_smoke
from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.engine.push import push_to_convergence
from pprx_torch.engine.state import FORWARD, PprState, settled_distance
from pprx_torch.graph.dynamic import WindowGraph
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.io import save_packed, synthetic_powerlaw_stream

torch.set_num_threads(1)


def test_settled_distance_ignores_a_push_at_the_threshold():
    """Two states that differ by a hair at a 200-edge vertex's push
    threshold: one run pushes it and the other does not, so ``p`` differs
    by alpha * eps * deg = 3e-5, above the 1e-5 two runs of one slide are
    held to, while ``p + alpha r`` differs by alpha (1 - alpha) eps at the
    receivers and by the hair at the vertex."""
    n, d = 300, 200
    hub = np.zeros(d, np.int32)
    src = np.concatenate([hub, np.arange(1, n, dtype=np.int32)])
    dst = np.concatenate([np.arange(1, d + 1, dtype=np.int32),
                          np.roll(np.arange(1, n, dtype=np.int32), 1)])
    cfg = PprConfig(alpha=0.15, eps=1e-6)
    graph = WindowGraph.from_coo(src, dst, n, device="cpu")
    states = []
    for hair in (1.001, 0.999):
        r = torch.zeros((n + 1, 1), dtype=torch.float64)
        r[0, 0] = hair * cfg.eps * d
        st = PprState(p=torch.zeros_like(r), r=r, mode=FORWARD)
        st, stats = push_to_convergence(st, graph, cfg)
        states.append((st, stats.rounds))
    (pushed, rounds_a), (held, rounds_b) = states
    assert rounds_a >= 1 and rounds_b == 0
    assert float((pushed.p - held.p).abs().max()) > 2.9e-5
    assert settled_distance(pushed, held, cfg.alpha) < 1.5e-7
    assert settled_distance(pushed, pushed, cfg.alpha) == 0.0


def test_dense_check_on_the_cpu():
    """Phase 12 as the card runs it, on the CPU: both modes, slides of 100
    edges and of 1 edge, every query within its bound of exact PPR; each
    driver's loops through its ``RoundGraphs`` on the host (a read a round
    and one a loop), no launch here, which the card's launch check refuses;
    and the check of a loop's launches and reads, which holds on the card
    alone."""
    res = chip_smoke.dense_check(torch.device("cpu"))
    assert res["kernel_launches"] == 0 and not any(res["launches_by_entry"].values())
    for mode in ("forward", "reverse"):
        for b, slides in ((100, 8), (1, 60)):
            assert res[f"{mode}_slide{b}_err"] <= res[f"{mode}_slide{b}_bound"]
            assert res[f"{mode}_slide{b}_rounds"] > 0
            g = res[f"{mode}_slide{b}_graphs"]
            assert g["loops"] == 1 + slides and g["loop_launches"] == 0
            assert g["reads"] == res[f"{mode}_slide{b}_rounds"] + 1 + slides
    with pytest.raises(AssertionError, match="dense_driver never launched"):
        chip_smoke.check_dense_launched({"dense_driver": res["launches_by_entry"]})
    counts = {e: 1 for e in chip_smoke.DENSE_ENTRIES}
    assert chip_smoke.check_dense_launched({"p": counts}) == {"p": counts}
    import types

    g = types.SimpleNamespace(summary=lambda: {"loop_launches": 3, "reads": 3})
    assert chip_smoke.dense_loops(g, 3, torch.device("cuda"))["loops"] == 3
    with pytest.raises(AssertionError, match="4 dense loops ran as 3 loop graph launches"):
        chip_smoke.dense_loops(g, 4, torch.device("cuda"))


def test_static_check_on_the_cpu():
    """Phase 9's config 1 as the card runs it, on the CPU: within its L1
    bound through the dense engine's host loop, with the loop's summary
    (one loop, a read a round and one more) and the launches by entry
    (none here)."""
    res = chip_smoke.static_check(torch.device("cpu"), 1)
    assert res["within_bound"] and res["rounds"] > 0 and res["peak_mem_gib"] is None
    assert res["graphs"]["loops"] == 1 and res["graphs"]["reads"] == res["rounds"] + 1
    assert not any(res["launches_by_entry"].values())


def test_exact_contract_holds_bf16_mass_to_a_witness():
    """bf16 delivery loses mass whatever sums it: the contract then holds a
    run's mass to a second run's reading within 1e-4 (here both on the CPU),
    and fails when the two differ by more; without a witness it holds mass
    to 1 within 1e-3."""
    w, b = 4000, 100
    src, dst, n = synthetic_powerlaw_stream(500, w + 8 * b, seed=2)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    runs = []
    for _ in range(2):
        drv = FastStreamDriver(src, dst, n, list(range(16)), cfg, StreamConfig(window=w, slide=b),
                               dtype=torch.float32, rebuild_every=4, bf16d=True, device="cpu")
        drv.seed()
        list(drv.run(6))
        runs.append(drv)
    drv, twin = runs
    mass = chip_smoke.state_mass(twin, 4)
    assert mass.shape == (4,) and 1e-6 < np.abs(mass - 1.0).max() < 1e-2
    res = chip_smoke.exact_contract(drv, None, 10, 4, cfg.eps * w, mass)
    assert res["mass_off_ref"] == 0.0 and res["mass_bound"] == 1e-4
    assert res["mass_err_max"] == res["mass_err_max_ref"]
    with pytest.raises(AssertionError, match="contract failed"):
        chip_smoke.exact_contract(drv, None, 10, 4, cfg.eps * w, mass + 2e-4)
    # without a witness mass is held to 1 within 1e-3, which bf16 delivery misses
    assert res["mass_err_max"] > 1e-3
    with pytest.raises(AssertionError, match="'mass_bound': 0.001"):
        chip_smoke.exact_contract(drv, None, 10, 4, cfg.eps * w)


def test_prologue_split_and_round_logs_on_the_cpu(monkeypatch):
    """Phase 4's prologue line on the CPU: each slide's prologue runs apart
    before its loop (``split_prologue``, put back after), and the same
    slides' loops, logged, replay through the plain steps; a log whose
    branch the counts do not give is refused."""
    from pprx_torch.engine import graphs

    w, b = 4000, 100
    src, dst, n = synthetic_powerlaw_stream(500, w + 6 * b, seed=2)
    drv = FastStreamDriver(src, dst, n, list(range(8)), PprConfig(alpha=0.15, eps=1e-6),
                           StreamConfig(window=w, slide=b), rebuild_every=4, device="cpu")
    drv.seed()
    monkeypatch.setattr(graphs, "LOG_SINK", [])
    res = chip_smoke.prologue_split(drv, 2)
    assert res["slides"] == 2 and 0 < res["prologue_share"] < 1
    assert not drv.round_graphs.split_prologue
    assert chip_smoke.check_round_logs()["loops"] == 2 and graphs.LOG_SINK == []
    list(drv.run(1))
    rec = graphs.LOG_SINK[0]
    assert rec["rows"] and chip_smoke.check_round_logs()["rounds"] == len(rec["rows"])
    rec["rows"][0][0] = len(rec["table"].tiers) + 5  # no branch decide can give
    graphs.LOG_SINK.append(rec)
    with pytest.raises(AssertionError, match="differ from the plain steps"):
        chip_smoke.check_round_logs()


def test_serve_split_on_the_cpu(tmp_path):
    graph = str(tmp_path / "g.npz")
    save_packed(graph, *synthetic_powerlaw_stream(500, 4000 + 9 * 200, seed=7))
    res = chip_smoke.serve_split(torch.device("cpu"), graph, 4000, 200, 8, k=10)
    assert [len(res[k]) for k in ("slide_ms", "refine_ms", "read_ms")] == [8, 8, 2]
    assert all(0 <= r <= 6 for r in res["refine_rounds"]) and res["sources"] == 8


def test_cli_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 13 as the card runs it, on the CPU at a small size (the
    headline runner through its environment): every command's checks pass,
    and no run launches a kernel here, which the launch check refuses for
    the paths through the fast driver and through the dense engine."""
    for k, v in dict(N=300, W=1500, B=100, S=4, STEPS=2, REPS=2).items():
        monkeypatch.setenv(f"PPRX_BENCH_{k}", str(v))
    res = chip_smoke.cli_phase(torch.device("cpu"), str(tmp_path), n=2000, w=6000, b=300, s=16,
                               k=20, small=(300, 3000))
    paths = chip_smoke.FAST_CLI_PATHS + chip_smoke.DENSE_CLI_PATHS
    assert set(paths) | {"cli_convert", "cli_subprocess_static"} == set(res)
    assert res["cli_convert"]["edges"] == 6000 + 10 * 300
    assert res["cli_serve_budget"]["exact"]["precision_at_k"] >= 0.95
    assert len(res["cli_serve_budget"]["refine_rounds"]) == 8
    assert len(res["cli_serve_event"]["event_refines"]) == 1
    assert res["cli_retrieve_refine"]["batch"] == 16
    assert res["cli_subprocess_static"]["device"] == "cpu"
    assert all(res[p]["device"] == "cpu" for p in paths)
    assert not any(any(res[p]["launches_by_entry"].values()) for p in paths)
    with pytest.raises(AssertionError, match="cli_serve_budget never launched"):
        chip_smoke.check_cli_launches(res)
    for p in chip_smoke.FAST_CLI_PATHS:
        res[p]["launches_by_entry"] = {"segsum_add": 0, "segsum_gather_add": 3}
    with pytest.raises(AssertionError, match="cli_static never launched"):
        chip_smoke.check_cli_launches(res)
    for p in chip_smoke.DENSE_CLI_PATHS:
        res[p]["launches_by_entry"] = {e: 2 for e in chip_smoke.DENSE_ENTRIES}
    assert chip_smoke.check_cli_launches(res)["cli_bench_config2"]["segsum_gather_add"] == 3
    res["cli_static"]["launches_by_entry"]["scan_pass"] = 0
    with pytest.raises(AssertionError, match=r"cli_static never launched \['scan_pass'\]"):
        chip_smoke.check_cli_launches(res)


def test_sharded_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 14 as the card runs it, on the CPU at a small size: config 5
    (f32 and bf16) within its contract with the sharded top-k equal to the
    single-device head, the sharding tax, the dense sharded engine (phase
    12's stream, and config 5's run in both modes within their contracts),
    the collective wrappers through a gloo group of one, and the CLI; no
    run launches a kernel here, which the launch checks refuse."""
    import functools

    import pprx_torch.bench.run as trun

    dev = torch.device("cpu")
    # a window whose bound eps * W (6e-3) is above bf16's rounding of the
    # moved mass (about 1e-3 here; the headline's bound is 2.0)
    shape = dict(n=2000, w=6000, b=300, s=8)
    runs = {tag: chip_smoke.config5_check(dev, bf16d=tag == "bf16", n_check=4, k=10, **shape)
            for tag in ("f32", "bf16")}
    for tag, res in runs.items():
        assert (res["mesh"], res["engine"], res["steps"]) == ("1x1", "wl", 5)
        assert res["contract"]["mass_bound"] == (1e-4 if tag == "bf16" else 1e-3)
        assert res["contract"]["l1_max"] <= res["contract"]["l1_bound"] == 1e-6 * 6000
        assert res["topk"]["k"] == 10 and res["wl_rounds_per_slide"] > 0
    # the bf16 run is held to its twin on the CPU: here the same run twice
    assert runs["bf16"]["contract"]["mass_off_ref"] == 0.0
    assert runs["bf16"]["contract"]["mass_err_max_ref"] > 1e-6
    with pytest.raises(AssertionError, match="config5_f32 never launched"):
        chip_smoke.check_launched({"config5_f32": runs["f32"]["launches_by_entry"]})
    tax = chip_smoke.sharding_tax(dev, runs["f32"]["updates_per_sec"], **shape)
    assert tax["tax"] > 0 and tax["rebuild_every"] == 2
    dense = chip_smoke.sharded_dense_check(dev)
    assert not any(dense["launches_by_entry"].values())
    assert all(dense[f"{m}_slide{b}_err"] <= dense[f"{m}_slide{b}_bound"]
               for m in ("forward", "reverse") for b in (100, 1))
    assert dense["forward_slide100_graphs"] is None  # the loop graphs' check is the card's
    for mode in ("forward", "reverse"):
        d5 = chip_smoke.config5_check(dev, bf16d=False, n_check=4, k=10, engine="dense",
                                      mode=mode, **shape)
        assert (d5["mesh"], d5["engine"], d5["mode"], d5["steps"]) == ("1x1", "dense", mode, 5)
        assert d5["round_kinds"] == {} and d5["graphs"] is None
        c = d5["contract"]
        assert (c["l1_max"] <= c["l1_bound"]) if mode == "forward" else (
            c["max_abs_err"] <= c["bound"])
        assert d5["rounds_per_slide"] > 0 and not any(d5["launches_by_entry"].values())
        with pytest.raises(AssertionError, match=f"config5_dense_{mode} never launched"):
            chip_smoke.check_dense_launched({f"config5_dense_{mode}": d5["launches_by_entry"]})
    coll = chip_smoke.collectives_check(dev, str(tmp_path))
    assert coll.pop("backend") == "gloo" and all(coll.values())
    graph = str(tmp_path / "g.npz")
    save_packed(graph, *synthetic_powerlaw_stream(2000, 6000 + 6 * 300, seed=7))
    monkeypatch.setitem(trun.CONFIGS, 5, functools.partial(trun.config5_sharded, **shape))
    cli = chip_smoke.sharded_cli(dev, str(tmp_path), graph, 6000, 300, 8)
    assert set(cli) == set(chip_smoke.SHARDED_CLI_PATHS)
    assert cli["cli_bench_config5"]["window"] == 6000
    assert not any(any(r["launches_by_entry"].values()) for r in cli.values())


def test_sharded_phase_15_on_the_cpu(tmp_path):
    """Phase 15 as the card runs it, on the CPU at a small size: config 5
    in reverse within the reverse contract and its tax, the row-sum sweep
    against its f64 plain version on 3 slides, wlp within the exact-PPR
    contract with its round kinds and one slide's peak, a sharded
    checkpoint round trip of the reverse driver, and the two CLI commands;
    no run launches a kernel here, which the launch check refuses."""
    from pprx_torch.engine.state import REVERSE

    dev = torch.device("cpu")
    shape = dict(n=2000, w=6000, b=300, s=8)
    rev, drv = chip_smoke.config5_reverse_check(dev, n_check=4, prof=True, **shape)
    assert (rev["mesh"], rev["engine"], rev["mode"]) == ("1x1", "wl", "reverse")
    assert rev["contract"]["max_abs_err"] <= rev["contract"]["bound"]
    assert len(rev["profile"]["rounds"]) == 1
    assert drv.steps_available == chip_smoke.REVERSE_SPARE - 1
    assert not any(rev["launches_by_entry"].values())
    with pytest.raises(AssertionError, match="config5_rev never launched"):
        chip_smoke.check_launched({"config5_rev": rev["launches_by_entry"]})
    tax = chip_smoke.sharding_tax(dev, rev["updates_per_sec"], mode=REVERSE, **shape)
    assert tax["tax"] > 0
    sweep = chip_smoke.sweep_check(drv)
    assert sweep["slides"] == 3 and all(sweep["bit_identical"])
    assert max(sweep["s_old_rel_err"] + sweep["s_new_rel_err"]) <= 1e-5
    assert "slide_wl" not in vars(drv.eng)
    wlp = chip_smoke.config5_check(dev, bf16d=False, n_check=4, k=10, prof=True, engine="wlp",
                                   **shape)
    assert wlp["engine"] == "wlp" and wlp["contract"]["l1_max"] <= wlp["contract"]["l1_bound"]
    assert wlp["round_kinds"]["rescan"] >= 1 and wlp["round_kinds"]["dense"] == 0
    assert len(wlp["profile"]["rounds"]) == 1 and wlp["slide_peak_gib"] is None
    # wlp in reverse, within the reverse contract; the CPU builds no loop graph
    wlr = chip_smoke.config5_check(dev, bf16d=False, n_check=4, k=10, engine="wlp",
                                   mode="reverse", **shape)
    assert (wlr["engine"], wlr["mode"]) == ("wlp", "reverse")
    assert wlr["contract"]["max_abs_err"] <= wlr["contract"]["bound"]
    assert wlr["round_kinds"]["rescan"] >= 1 and wlr["round_kinds"]["dense"] == 0
    assert wlp["loop_rules"] == wlr["loop_rules"] == []
    ck = chip_smoke.sharded_checkpoint_check(drv, str(tmp_path), n_check=4)
    assert ck["max_abs_settled"] <= 1e-5 and len(ck["rounds"][0]) == 2
    assert ck["rounds"][0] == ck["rounds"][1] and ck["max_abs_dp"] == 0.0
    graph = str(tmp_path / "g.npz")
    save_packed(graph, *synthetic_powerlaw_stream(2000, 6000 + 6 * 300, seed=7))
    cli = chip_smoke.sharded_cli_15(dev, str(tmp_path), graph, 6000, 300, 8)
    assert set(cli) == set(chip_smoke.SHARDED_CLI_PATHS_15)
    assert not any(any(r["launches_by_entry"].values()) for r in cli.values())


def test_hybrid_phase_16_on_the_cpu(tmp_path):
    """Phase 16 as the card runs it, on the CPU at a small size: the
    headline runner on the hybrid engine, the forward driver (its rebuilds,
    rounds by kind, profile, contract and the fast driver's rate beside
    it), a checkpoint round trip, reverse within the reverse contract,
    ``worklist=False`` with sparse scan arms, and the CLI. Every path but
    the checkpoint's read runs hybrid loops (the host loop here: a read
    after each arm), each tallied by kind of arm; and the launch check
    holds a path that ran a dense scan, a scan or a count to the kernels
    those arms launch on the card."""
    dev = torch.device("cpu")
    bench = chip_smoke.hybrid_bench(dev, N=300, W=1500, B=100, S=4, STEPS=2, REPS=2)
    assert bench["device"] == "cpu" and bench["refine_ms"] is None
    assert bench["loops"]["loops"] > 0 and bench["loops"]["other_loops"] == 0
    shape = dict(n=2000, w=6000, b=300, s=8)
    fwd, drv = chip_smoke.hybrid_forward(dev, n_check=4, **shape)
    assert fwd["rebuild_every"] == 4 and fwd["rebuilds"] == 2 and len(fwd["rounds"]) == 8
    assert fwd["wl_rounds_per_slide"] > 0 and fwd["syncs_per_slide"] > fwd["rounds_per_slide"]
    # the host loop reads after the prologue and after each arm
    assert fwd["syncs_per_slide"] == fwd["rounds_per_slide"] + fwd["counts_per_slide"] + 1
    # the seed starts with a scan (sparse here: the window is small)
    assert fwd["seed_arms"]["sparse"] + fwd["seed_arms"]["dense"] > 0
    assert fwd["contract"]["l1_max"] <= fwd["contract"]["l1_bound"] == 1e-6 * 6000
    assert len(fwd["profile"]["rounds"]) == 1 and fwd["peak_mem_gib"] is None
    assert fwd["fast_over_hybrid"] > 0 and fwd["fast"]["rebuild_every"] == 3
    assert set(fwd["maintained_precision"]) == {"hybrid", "fast"}
    assert fwd["settled_vs_fast"] <= 1e-5
    # the seed, 6 warm-up, 8 timed and 1 profiled slides: a loop each
    assert fwd["loops"]["loops"] == 16 and fwd["loops"]["other_loops"] == 0
    assert drv.steps_available == 3
    ck = chip_smoke.hybrid_checkpoint_check(drv, 4, l1_bound=1e-6 * 6000)
    assert ck["max_abs_settled"] <= 1e-5 and ck["ov_count_saved"] > 0
    assert ck["rounds"][0] == ck["rounds"][1] and ck["loops"]["loops"] == 4
    rev = chip_smoke.hybrid_reverse(dev, n_check=4, **shape)
    assert rev["contract"]["max_abs_err"] <= rev["contract"]["bound"]
    assert rev["loops"]["arms"]["sparse"] + rev["loops"]["arms"]["dense"] > 0
    nowl = chip_smoke.hybrid_no_worklist(dev, n=2000, w=20_000, b=400, s=4, n_check=4)
    assert nowl["no_worklist_scan_kinds"]["sparse"] > 0
    assert nowl["no_worklist_scan_kinds"]["count"] == 0
    assert nowl["worklist_rounds"] == nowl["no_worklist_rounds"]
    graph = str(tmp_path / "g.npz")
    save_packed(graph, *synthetic_powerlaw_stream(2000, 6000 + 6 * 300, seed=7))
    cli = chip_smoke.hybrid_cli(dev, str(tmp_path), graph, 6000, 300, 8, k=10)
    assert set(cli) == set(chip_smoke.HYBRID_CLI_PATHS)
    assert all(cli[p]["loops"]["loops"] == 5 for p in chip_smoke.HYBRID_CLI_PATHS[:2])
    runs = {"hybrid_bench": bench, "hybrid_forward": fwd, "hybrid_checkpoint": ck,
            "hybrid_reverse": rev, "hybrid_no_worklist": nowl,
            **{p: cli[p] for p in chip_smoke.HYBRID_CLI_PATHS[:2]}}
    # the CPU launches no kernel: the check, held to what the card launches
    card = {"loop_prime": 1, "loop_turn": 3, "segsum_gather_add": 2, "scan_pass": 2,
            "frontier_rows": 4, "segsum_add": 0}
    by_path = {p: (card, r["loops"]["arms"]) for p, r in runs.items()}
    assert chip_smoke.check_hybrid_launched(by_path) == {p: card for p in runs}
    every = {"wl": 1, "sparse": 1, "dense": 1, "count": 1}
    for entry in ("frontier_rows", "segsum_gather_add", "scan_pass", "loop_prime", "loop_turn"):
        by_path["hybrid_reverse"] = ({**card, entry: 0}, every)
        with pytest.raises(AssertionError, match=f"hybrid_reverse ran .* never launched "
                                                 f"\\['{entry}'\\]"):
            chip_smoke.check_hybrid_launched(by_path)
    # a path with no dense scan need not launch K1 or K2
    arms = {"wl": 3, "sparse": 1, "dense": 0, "count": 1}
    assert chip_smoke.check_hybrid_launched({"p": ({**card, "scan_pass": 0}, arms)})


def test_row_pass_phase_on_the_cpu(monkeypatch):
    """Phase 3b's control flow and its kernels-line entries on the CPU at a
    small size (the wrappers run their plain versions here, so the bits
    agree trivially; CUDA's timers are replaced by stand-ins): every case
    held and timed, entries exactly at the threshold left inactive, and
    the entries carry every key the kernels line needs."""
    monkeypatch.setattr(chip_smoke, "ROWPASS_SHAPES", (
        ("headline", 501, 128, 7, 5000), ("config2", 401, 16, 2, 4000),
        ("config3", 301, 8, 3, 3000)))
    monkeypatch.setattr(chip_smoke, "ROWPASS_AT_THRESHOLD", 50)
    monkeypatch.setattr(chip_smoke, "in_turns", lambda fns, **kw: {k: 1.0 for k in fns})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rp = chip_smoke.check_rowpass(torch.device("cpu"))
    for shape in ("headline", "config2", "config3"):
        for mode in ("fwd", "rev"):
            pre = f"{shape}_{mode}_"
            assert rp[f"{pre}dangling_rows"] > 0
            for k in ("scan_pass_f32", "scan_pass_bf16", "frontier_rows"):
                assert rp[f"{pre}{k}_max_abs_err"] == 0.0
                assert rp[f"{pre}{k}_bound_by"] == "bytes"
            pairs = rp[f"{pre}rows"] * rp[f"{pre}s"]
            assert 0.3 * pairs < rp[f"{pre}scan_pass_f32_active_pairs"] < 0.7 * pairs
    assert rp["headline_fwd_scan_pass_f32_bound_ms"] == pytest.approx(
        501 * 128 * 20 / 3.35e9 + 501 * 4 / 3.35e9)
    inp = chip_smoke.rowpass_inputs(chip_smoke.window_degrees(torch.device("cpu"), 301, 3, 3000),
                                    8, 3, forward=True)
    th = chip_smoke.ROWPASS_EPS * inp["deg"].clamp(min=1).float()
    at = inp["r"].abs() == th[:, None]
    assert at.sum() >= 45 and not (at & (inp["r"].abs() > th[:, None])).any()
    launches = {"forward": {"scan_pass": 5, "frontier_rows": 2}, "hybrid_forward": {
        "scan_pass": 0, "frontier_rows": 0}}
    for name in chip_smoke.ROWPASS_KERNELS:
        entry = chip_smoke.rowpass_entry(name, rp, launches)
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(entry)
        assert entry["library_ms"] is None and entry["launches"] == launches["forward"][name]
        assert len(entry["cases"]) == (12 if name == "scan_pass" else 6)
    with pytest.raises(AssertionError, match=r"hybrid_forward ran .* never launched"):
        chip_smoke.check_hybrid_launched({"hybrid_forward": (
            {"loop_prime": 1, "loop_turn": 2, "scan_pass": 0, "segsum_gather_add": 1,
             "frontier_rows": 1}, {"wl": 0, "sparse": 0, "dense": 1, "count": 0})})


def test_config5_turn_on_the_cpu():
    """``--turns``'s config 5 shape (phase 14a's run: the sharded wl engine
    at mesh 1x1) through ``turn_record`` on the CPU at a small size, as each
    root's turn runs it: rate, rounds, round kinds, the launches by entry
    (none here) and one profiled slide; the turn's script, with this
    function's source in it, compiles; and the dense rounds' launch check
    holds a run to one ``scan_pass`` a dense round."""
    import inspect

    shapes = {sh["tag"]: sh for sh in chip_smoke.turn_shapes()}
    c5 = shapes["config5_f32"]
    assert c5["sharded"] and (c5["n"], c5["w"], c5["b"], c5["s"]) == (200_000, 2_000_000,
                                                                     160_000, 128)
    res = chip_smoke.turn_record(chip_smoke, dict(c5, n=2000, w=6000, b=300, s=8),
                                 torch.device("cpu"))
    assert res["updates_per_s"] > 0 and res["rounds_per_slide"] > 0
    assert res["round_kinds"]["dense"] >= 1 and res["peak_mem_gib"] is None
    assert not any(res["launches_by_entry"].values())
    assert len(res["profile"]["rounds"]) == 1
    compile(chip_smoke.TURN.format(turn_record=inspect.getsource(chip_smoke.turn_record)),
            "turn", "exec")
    run = {"round_kinds": {"dense": 3}, "launches_by_entry": {"scan_pass": 3, "frontier_rows": 2}}
    assert chip_smoke.check_dense_row_passes({"config5_f32": run})["config5_f32"] == {
        "dense_rounds": 3, "scan_pass": 3, "frontier_rows": 2}
    for scans, rescans in ((2, 2), (3, 0), (3, 4)):
        run["launches_by_entry"] = {"scan_pass": scans, "frontier_rows": rescans}
        with pytest.raises(AssertionError, match="config5_f32: 3 dense rounds"):
            chip_smoke.check_dense_row_passes({"config5_f32": run})


@pytest.mark.parametrize("tag", ["config5_dense_f32", "config5_dense_rev", "config5_wlp"])
def test_sharded_dense_and_wlp_turn_shapes_on_the_cpu(tag):
    """``--turns``'s shapes of phase 14c's sharded dense engine (both modes)
    and 15c's wlp, named by ``--shapes`` alone, through ``turn_record`` on
    the CPU at a small size: config 5's shapes otherwise, its engine, rate,
    rounds, the host's reads (none beside the loops' here), the driver's and
    the engine's shares of a slide, and one profiled slide."""
    extra = {sh["tag"]: sh for sh in chip_smoke.TURN_EXTRA}
    sh = extra[tag]
    assert tag not in {s["tag"] for s in chip_smoke.turn_shapes()}
    assert (sh["n"], sh["w"], sh["b"], sh["s"], sh["sharded"]) == (200_000, 2_000_000, 160_000,
                                                                   128, True)
    assert sh["reverse"] == tag.endswith("_rev")
    res = chip_smoke.turn_record(chip_smoke, dict(sh, n=2000, w=6000, b=300, s=8),
                                 torch.device("cpu"))
    assert res["updates_per_s"] > 0 and res["rounds_per_slide"] > 0
    assert res["host_reads_per_slide"] == 0 and res["engine_ms"] > 0
    assert res["graphs"]["loop_launches"] == 0 and res["graphs"]["reads"] > 0
    assert len(res["profile"]["rounds"]) == 1
    assert (res["round_kinds"] == {}) == (sh["engine"] == "dense")


def test_dense_driver_turn_on_the_cpu():
    """``--turns``'s dense driver shapes through ``turn_record`` on the CPU
    at a small size, as each root's turn runs them: the headline one keeps
    the headline stream's shapes; each run is seeded and its slides timed,
    rounds a slide counted, and its first slide split on the host clock
    into the stream module's parts (corrections, the view's sort and copy,
    the push), which sum to no more than the slide."""
    extra = {sh["tag"]: sh for sh in chip_smoke.TURN_EXTRA}
    head = extra["dense_driver_headline"]
    assert (head["n"], head["w"], head["s"]) == (200_000, 2_000_000, 128)
    assert {b for _, b, _ in head["runs"]} == {160_000}
    res = chip_smoke.turn_record(chip_smoke, dict(head, n=300, w=1500, s=4,
                                                  runs=[[0, 100, 3], [1, 100, 2]]),
                                 torch.device("cpu"))
    runs = res["dense_driver"]
    assert [(r["mode"], r["slides"], r["sources"]) for r in runs] == [(0, 3, 4), (1, 2, 4)]
    for r in runs:
        assert r["seed"]["rounds"] > 0 and r["rounds_per_slide"] > 0
        assert len(r["slide_ms_each"]) == r["slides"]
        parts = r["first_slide"]["host_ms_by_part"]
        assert set(parts) == {"corrections", "view_sort", "view_copy", "push"}
        assert sum(parts.values()) <= r["slide_ms_each"][0]
        assert r["residual_l1_max"] > 0


def test_config5_reverse_turn_on_the_cpu():
    """``--turns``'s config 5 reverse shape (phase 15a's run) through
    ``turn_record`` on the CPU at a small size: the same shapes as the
    forward one, in reverse, with its rate, rounds, dense rounds and one
    profiled slide; ``--shapes`` picks it alone and refuses an unknown
    tag."""
    shapes = {sh["tag"]: sh for sh in chip_smoke.turn_shapes()}
    rev, fwd = shapes["config5_rev"], shapes["config5_f32"]
    assert rev["reverse"] and not fwd["reverse"]
    assert {k: v for k, v in rev.items() if k not in ("tag", "reverse")} == {
        k: v for k, v in fwd.items() if k not in ("tag", "reverse")}
    res = chip_smoke.turn_record(chip_smoke, dict(rev, n=2000, w=6000, b=300, s=8),
                                 torch.device("cpu"))
    assert res["updates_per_s"] > 0 and res["rounds_per_slide"] > 0
    assert res["round_kinds"]["dense"] >= 1
    assert not any(res["launches_by_entry"].values())
    assert len(res["profile"]["rounds"]) == 1
    with pytest.raises(SystemExit, match="unknown"):
        chip_smoke.turns(["--shapes", "config5_rev,config9", "."])


def test_sharded_loop_checks():
    """Phases 14a, 15a and 15d's device-loop keys: ``sharded_loops`` is
    None off the card and for ``wlp``; on the card it holds a driver's loop
    graph launches and carry reads each to one a loop and raises
    otherwise; ``no_host_loop`` refuses ``RoundGraphs.host_loop`` on the
    card while it holds, and leaves the CPU's alone. The ``--turns``
    config 5 record carries the host's reads, the driver's and the
    engine's shares of a slide and the loop's summary."""
    import types

    from pprx_torch.engine.graphs import RoundGraphs

    def drv(summary, dev="cuda"):
        g = None if summary is None else types.SimpleNamespace(summary=lambda: dict(summary))
        return types.SimpleNamespace(device=torch.device(dev),
                                     eng=types.SimpleNamespace(round_graphs=g))

    good = {"loop_launches": 9, "reads": 9}
    assert chip_smoke.sharded_loops(drv(good, "cpu"), 9) is None
    assert chip_smoke.sharded_loops(drv(None), 9) is None
    res = chip_smoke.sharded_loops(drv(good), 9)
    assert (res["launches_per_loop"], res["reads_per_loop"], res["rounds_outside_graphs"]) == (
        1.0, 1.0, 0)
    for bad in ({"loop_launches": 8, "reads": 9}, {"loop_launches": 9, "reads": 20}):
        with pytest.raises(AssertionError, match="9 loops ran"):
            chip_smoke.sharded_loops(drv(bad), 9)
    host_loop = RoundGraphs.host_loop
    with chip_smoke.no_host_loop(torch.device("cpu")):
        assert RoundGraphs.host_loop is host_loop
    with chip_smoke.no_host_loop(torch.device("cuda")):
        with pytest.raises(AssertionError, match="on the host on the card"):
            RoundGraphs.host_loop(None)
    assert RoundGraphs.host_loop is host_loop
    c5 = {sh["tag"]: sh for sh in chip_smoke.turn_shapes()}["config5_f32"]
    res = chip_smoke.turn_record(chip_smoke, dict(c5, n=2000, w=6000, b=300, s=8),
                                 torch.device("cpu"))
    # the CPU's host loop reads its counts a round (``graphs``' reads); no
    # stats gather and no carry wait is left to count
    assert res["host_reads_per_slide"] == 0 and res["graph_launches"] == 0
    assert res["driver_host_ms"] > 0 and res["engine_ms"] > 0
    assert res["graphs"]["loop_launches"] == 0 and res["graphs"]["reads"] > 0


def test_loop_control_entries_and_turn_shape():
    """Phase 3c's parts that run without a card: each K4 kernel's entry of
    the kernels line (``loop_prime``, ``loop_turn``, ``loop_after_scan``)
    holds the contract's keys and its main-path launches; each kernel is
    timed on a case the loop graph launches it for (``K4_TIMED``,
    ``k4_launch``); ``--shapes loop_control`` runs phase 3c in each root,
    and no default ``--turns`` run does."""
    from pprx_torch.engine import loop

    assert loop.STEPS == ("prime", "turn", "after_scan")
    timing = {"ms": 0.001, "plain_ms": 0.02, "bound_ms": 2e-7, "bound_by": "bytes",
              "max_abs_err": 0}
    k4 = {**{step: dict(timing) for step in loop.STEPS}, "graph_kernel_floor_ms": 0.001,
          "body_kernel_ms": 0.001, "conditional_overhead_ms_per_round": 0.003}
    launches = {"forward": {"loop_prime": 32, "loop_turn": 552, "loop_after_scan": 320},
                "config5_f32": {"loop_prime": 10, "loop_turn": 149, "loop_after_scan": 100}}
    for step in loop.STEPS:
        entry = chip_smoke.loop_entry(step, k4, launches)
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(entry)
        assert entry["name"] == f"loop_{step}" and entry["route"] == "cuda"
        assert entry["launches"] == launches["forward"][f"loop_{step}"]
        assert entry["launches_by_path"]["config5_f32"] == launches["config5_f32"][f"loop_{step}"]
    cases = {case[0]: case for case in chip_smoke.K4_CASES}
    assert set(chip_smoke.K4_TIMED) == set(loop.STEPS)
    for step, name in chip_smoke.K4_TIMED.items():
        assert chip_smoke.k4_launch(cases[name])[0] == step
    # the hybrid rule's prime and turn are timed too, on its own cases
    assert set(chip_smoke.K4_TIMED_HYBRID) == {"prime", "turn"}
    for step, name in chip_smoke.K4_TIMED_HYBRID.items():
        assert chip_smoke.k4_launch(cases[name])[0] == step
        assert chip_smoke.k4_table(cases[name]) is chip_smoke.K4_HYBRID
    k4["hybrid_turn"] = dict(timing)
    assert chip_smoke.loop_entry("turn", k4, launches)["hybrid"] == timing
    assert chip_smoke.loop_entry("after_scan", k4, launches)["hybrid"] is None
    assert "loop_control" not in {sh["tag"] for sh in chip_smoke.turn_shapes()}
    assert len(chip_smoke.turn_shapes()) == 7
    assert chip_smoke.turns(["--shapes", "loop_control"]) == 0
    # a root's phase 3c goes under its own key: the kernel ``turn`` must
    # not overwrite the record's turn
    import types

    cs = types.SimpleNamespace(check_k4=lambda dev: {"turn": dict(timing), **k4})
    rec = chip_smoke.turn_record(cs, {"tag": "loop_control"}, torch.device("cpu"))
    assert list(rec) == ["loop_control"] and rec["loop_control"]["turn"] == timing


def test_recorded_deliveries_on_the_cpu():
    """16f's and 15c's recording on the CPU at a small size: one slide of a
    hybrid driver and one of ``wlp`` with their loops on the host, each
    hybrid arm's first delivery and the largest group sum recorded; each
    hybrid record, rebuilt as K1 takes it (``delivery_inputs``), sums what
    both forms deliver (the port's ``sparse._deliver_`` and the reference's
    scatter, ``scatter_form_``), and the group sum's what ``index_add_``
    adds. The hooks come off after."""
    from pprx_torch.bench.run import config5_run
    from pprx_torch.dist import wl as dist_wl
    from pprx_torch.engine import sparse
    from pprx_torch.engine.graphs import RoundGraphs
    from pprx_torch.engine.segsum import segment_ids, segsum_gather_add_plain
    from pprx_torch.graph.hybrid_stream import HybridStreamDriver

    hooks = (sparse._deliver_, dist_wl.segsum_gather_add_, RoundGraphs.loop)
    src, dst, n = synthetic_powerlaw_stream(2000, 6000 + 4 * 300, seed=7)
    drv = HybridStreamDriver(src, dst, n, list(range(4)), PprConfig(alpha=0.15, eps=1e-6),
                             StreamConfig(window=6000, slide=300), dtype=torch.float64,
                             device="cpu")
    drv.seed()
    with chip_smoke.recorded_deliveries() as got:
        list(drv.run(1))
    assert (sparse._deliver_, dist_wl.segsum_gather_add_, RoundGraphs.loop) == hooks
    keys = chip_smoke.hybrid_arm_keys(drv)
    assert keys["wl_top"] == ("worklist", drv.tiers[-1][1], drv.tiers[-1][2])
    assert got and all(key[0] in ("worklist", "sparse_scan") for key in got)
    assert any(key in got for key in keys.values())
    for rec in got.values():
        rin, row_off, table, gat, scale = chip_smoke.delivery_inputs(rec)
        assert scale is None and rin.shape[0] == n
        want = segsum_gather_add_plain(rin.clone(), table, gat, row_off)
        args = [rec[k] for k in ("moving_f", "t", "nbr", "valid", "mov_ov", "sca", "inv_deg",
                                 "site")]
        for form in (lambda acc: sparse._deliver_(acc, *args),
                     lambda acc: chip_smoke.scatter_form_(acc, rec)):
            acc = rec["r"].clone()
            form(acc)
            np.testing.assert_allclose(acc[:n].numpy(), want.numpy(), rtol=0, atol=1e-12)
    _, wlp = config5_run(n=2000, w=6000, b=300, s=8, engine="wlp", device="cpu")
    with chip_smoke.recorded_deliveries() as got:
        list(wlp.run(1))
    assert list(got) == [("group_sum",)]
    rec = got["group_sum",]
    lo, hi = int(rec["row_off"][0]), int(rec["row_off"][-1])
    assert not rec["rin"].any() and hi - lo == rec["gat"].shape[0]
    want = torch.zeros_like(rec["rin"]).index_add_(0, segment_ids(rec["row_off"]),
                                                   rec["table"][rec["gat"]])
    np.testing.assert_allclose(
        segsum_gather_add_plain(rec["rin"].clone(), rec["table"], rec["gat"],
                                rec["row_off"]).numpy(), want.numpy(), rtol=0, atol=1e-12)


def _faulty(gather, fault: str):
    """``gather`` with a planted fault at the first row that has two lanes
    or more: its first lane dropped (the offsets past it move down by one)
    or its last lane misrouted into the next row."""
    def faulty(rin, table, gat, row_off, row_scale=None, site="other"):
        row = int(torch.nonzero(row_off.diff() > 1)[0])
        row_off = row_off.clone()
        if fault == "dropped":
            j = int(row_off[row])
            gat = torch.cat([gat[:j], gat[j + 1:]])
            row_off[row + 1:] -= 1
        else:
            row_off[row + 1] -= 1
        return gather(rin, table, gat, row_off, row_scale, site)
    return faulty


@pytest.mark.parametrize("fault", ["dropped", "misrouted"])
def test_recorded_rows_catch_a_planted_fault(monkeypatch, fault):
    """The hold of K1 at recorded shapes (``recorded_rows``, untimed) on
    the CPU, where the gather entry runs its plain version: a recorded
    slide of a small hybrid driver passes, its values drawn anew in [0, 1)
    (``refilled``: the same shapes, another table); with one lane dropped
    or misrouted in every gather (a planted fault) it fails."""
    from pprx_torch.graph.hybrid_stream import HybridStreamDriver

    src, dst, n = synthetic_powerlaw_stream(2000, 6000 + 4 * 300, seed=7)
    drv = HybridStreamDriver(src, dst, n, list(range(4)), PprConfig(alpha=0.15, eps=1e-6),
                             StreamConfig(window=6000, slide=300), device="cpu")
    drv.seed()
    with chip_smoke.recorded_deliveries() as got:
        list(drv.run(1))
    tags = {k[0] + str(i): k for i, k in enumerate(got)}
    rec = next(iter(got.values()))
    again = chip_smoke.refilled(rec)
    assert again["moving_f"].shape == rec["moving_f"].shape
    assert 0 <= float(again["moving_f"].min()) and float(again["moving_f"].max()) < 1
    assert torch.equal(again["moving_f"], chip_smoke.refilled(rec)["moving_f"])
    assert again["nbr"] is rec["nbr"] and again["r"] is rec["r"]
    rows = chip_smoke.recorded_rows(got, tags, timed=False)
    assert rows["missing"] == [] and all(rows[f"{t}_gather_f32_max_abs_err"] < 1e-4 for t in tags)
    monkeypatch.setattr(chip_smoke, "segsum_gather_add_",
                        _faulty(chip_smoke.segsum_gather_add_, fault))
    with pytest.raises(AssertionError, match="disagrees with the plain version"):
        chip_smoke.recorded_rows(got, tags, timed=False)


def test_hybrid_turn_on_the_cpu():
    """``--turns``' hybrid shape without a worklist through ``turn_record``
    on the CPU at a small size, as each root's turn runs it: its rate, K1's
    launches a slide by call site (none here) and no arm split (no card)."""
    extra = {sh["tag"]: sh for sh in chip_smoke.TURN_EXTRA}
    sh = extra["hybrid_no_worklist"]
    res = chip_smoke.turn_record(chip_smoke, dict(sh, n=2000, w=6000, b=300, s=4, warmup=1,
                                                  steps=2), torch.device("cpu"))
    assert res["updates_per_s"] > 0 and res["arm_split"] is None
    assert res["k1_by_site_per_slide"] == {site: 0 for site in chip_smoke.segsum.SITES}
    assert len(res["profile"]["rounds"]) == 1
