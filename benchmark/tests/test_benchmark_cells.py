"""The manifest, ``BENCHMARK.json``, against the files the harness finds by
name, and the contract's rules that a file can break."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"device", "driver", "convergence loop", "dense engine", "kernels"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def names(kind: str, suffix: str) -> set[str]:
    return {p.name[: -len(suffix)] for p in (harness.HERE / kind).glob(f"*{suffix}")}


def test_the_manifest_names_exactly_the_files():
    assert names("configs", ".json") == {c["name"] for c in BENCH["configs"]}
    assert names("workloads", ".json") == set(CELLS)
    assert names("metrics", ".py") == {m["name"] for m in BENCH["per_layer"]}
    mixes = {w["traffic"] for w in BENCH["workloads"]}
    assert names("traffic", ".json") == mixes
    kinds = {harness.load_json("traffic", t)["kind"] for t in mixes}
    assert {k for k in names("traffic", ".py") if k not in ("__init__", "powerlaw")} == kinds


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    params = harness.load_json("workloads", cell)
    assert {k: params[k] for k in ("config", "traffic", "chips")} == {
        k: entry[k] for k in ("config", "traffic", "chips")}
    config = harness.load_json("configs", entry["config"])
    assert config["name"] == entry["config"]
    assert hasattr(harness.kind_module(harness.load_json("traffic", entry["traffic"])["kind"]),
                   "run")
    assert params["limits"] and all(v >= 0 for v in params["limits"].values())
    assert entry["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_loads_by_name_and_reads_nothing_from_nothing(metric):
    mod = harness.metric_module(metric)
    assert mod.read({}) is None


def test_the_contract_rules_a_file_can_break():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        config = json.loads((harness.ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] and all(k in config for k in c["reduced"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["layer"] in LAYERS and m["moves"] in e2e
        assert all(w in e2e[m["moves"]].get("workloads", CELLS) for w in m["workloads"])
    for cell in CELLS:
        ends = {m["name"] for m in harness.for_cell(BENCH["end_to_end"], cell)}
        assert "setup_s" in ends and len(ends) >= 2
        assert harness.for_cell(BENCH["per_layer"], cell)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", CELLS[0], "--seed", "7",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
