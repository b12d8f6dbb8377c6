"""The port package imports without JAX or the JAX package, and
chip_smoke.py refuses to run where it cannot measure the card."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.device import resolve_device
from pprx_torch.engine.state import init_state
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.io import synthetic_powerlaw_stream

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "pprx_torch"


def _modules():
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_without_jax():
    mods = list(_modules())
    assert "pprx_torch.engine.wl2" in mods and "pprx_torch.graph.fast_stream" in mods
    assert {f"pprx_torch.dist.{m}" for m in ("mesh", "init", "sharded", "wl", "stream",
                                             "retrieve")} <= set(mods)
    assert {"pprx_torch.io.checkpoint", "pprx_torch.eval.membound"} <= set(mods)
    assert {"pprx_torch.engine.frontier", "pprx_torch.engine.sparse",
            "pprx_torch.graph.hybrid_stream"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'pprx' not in sys.modules, 'the JAX package was imported'\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_port_file_imports_jax():
    banned = ("import jax", "from jax", "import pprx.", "from pprx.", "from pprx import")
    for f in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(banned) or s == "import pprx"), (f, s)


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, an entry point called with no ``device`` raises: it
    does not fall back to the CPU. With ``device="cpu"`` it runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst, n = synthetic_powerlaw_stream(30, 300, seed=1)
    args = (src, dst, n, [0, 3], PprConfig(alpha=0.2, eps=1e-6), StreamConfig(window=200, slide=20))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(n, [0, 3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastStreamDriver(*args, rebuild_every=2)
    from pprx_torch.dist.mesh import make_row_mesh
    from pprx_torch.dist.stream import ShardedStreamDriver

    from pprx_torch.io.checkpoint import load_sharded_checkpoint, save_sharded_checkpoint

    for engine in ("dense", "wl", "wlp"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedStreamDriver(*args, make_row_mesh(1, 1), engine=engine)
    sharded = ShardedStreamDriver(*args, make_row_mesh(1, 1), engine="wlp", device="cpu")
    sharded.seed()
    list(sharded.run(1))
    path = str(tmp_path / "sharded.npz")
    save_sharded_checkpoint(path, sharded)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_sharded_checkpoint(path, src, dst, make_row_mesh(1, 1))
    again = load_sharded_checkpoint(path, src, dst, make_row_mesh(1, 1), device="cpu")
    assert again.p.device.type == "cpu" and again.eng.proportional
    assert init_state(n, [0, 3], device="cpu").r.device.type == "cpu"
    drv = FastStreamDriver(*args, rebuild_every=2, device="cpu")
    drv.seed()
    assert len(list(drv.run(2))) == 2 and drv.state.p.device.type == "cpu"


def test_hybrid_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The hybrid driver and its checkpoint loader, called with no
    ``device``, raise without a card; with ``device="cpu"`` they run."""
    from pprx_torch.graph.hybrid_stream import HybridStreamDriver
    from pprx_torch.io.checkpoint import load_checkpoint, save_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst, n = synthetic_powerlaw_stream(30, 300, seed=1)
    args = (src, dst, n, [0, 3], PprConfig(alpha=0.2, eps=1e-6), StreamConfig(window=200, slide=20))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridStreamDriver(*args)
    drv = HybridStreamDriver(*args, device="cpu")
    drv.seed()
    assert len(list(drv.run(2))) == 2 and drv.state.p.device.type == "cpu"
    path = str(tmp_path / "hybrid.npz")
    save_checkpoint(path, drv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(path, src, dst)
    assert load_checkpoint(path, src, dst, device="cpu").graph.snap.nbr.device.type == "cpu"
