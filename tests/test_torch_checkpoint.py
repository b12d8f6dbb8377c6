"""Checkpoints of the port (pprx_torch.io.checkpoint) against the JAX
package's (pprx.io.checkpoint): files written by either package load in the
other mid-stream and continue to the same state, f64 on the CPU at 1e-12,
for the dense, the fast and the hybrid driver (its writer's tuning carried,
its snapshot rebuilt on load) in both modes, and for the sharded
drivers (dense, wl and wlp engines, both modes) at mesh 1x1 and 2x2: the
port's file is the reference's layout array by array, a file crosses
either way bit for bit, a resumed driver goes on as the one that wrote the
file (bit-identical in the port, across a fresh-ring rebuild) and as the
other package's (equal rounds, 1e-12). The 2x2 port runs in a gloo world
(tests/_torch_dist_worker.py); the JAX package on its virtual mesh."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pprx.config import PprConfig, StreamConfig
from pprx.dist.mesh import make_row_mesh as jax_mesh
from pprx.dist.stream import ShardedStreamDriver as JaxShardedDriver
from pprx.graph.fast_stream import FastStreamDriver as JaxFastDriver
from pprx.graph.hybrid_stream import HybridStreamDriver as JaxHybridDriver
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.graph.stream import StreamDriver as JaxDenseDriver
from pprx.io.checkpoint import load_checkpoint as jax_load
from pprx.io.checkpoint import load_sharded_checkpoint as jax_load_sharded
from pprx.io.checkpoint import save_checkpoint as jax_save
from pprx.io.checkpoint import save_sharded_checkpoint as jax_save_sharded
from pprx_torch.convert import pad_len, tile_offsets
from pprx_torch.dist.mesh import make_row_mesh
from pprx_torch.engine.state import FORWARD, REVERSE
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.hybrid_stream import TUNING as HYBRID_TUNING
from pprx_torch.graph.hybrid_stream import HybridStreamDriver
from pprx_torch.graph.stream import StreamDriver
from pprx_torch.io.checkpoint import (
    load_checkpoint,
    load_sharded_checkpoint,
    save_checkpoint,
    save_sharded_checkpoint,
)
from tests._torch_dist_worker import _driver, sharded_resume, stream, worlds

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)
SCFG = StreamConfig(window=250, slide=25)
N, QUERIES = 35, [0, 6, 17]
MODES = [FORWARD, REVERSE]
FAST = dict(rebuild_every=3, e_top=64, n_tiers=3)
HYBRID = dict(rebuild_every=3, ecap=16)  # sparse scan rounds and edge-bound scans
ENGINES = ["dense", "fast", "hybrid"]


def _stream():
    src, dst, _ = synthetic_powerlaw_stream(N, 500, seed=11)
    return src, dst


def _jax(engine, mode):
    src, dst = _stream()
    if engine == "fast":
        return JaxFastDriver(src, dst, N, QUERIES, CFG, SCFG, mode=mode, dtype=jnp.float64,
                             segsum=False, **FAST)
    if engine == "hybrid":
        return JaxHybridDriver(src, dst, N, QUERIES, CFG, SCFG, mode=mode, dtype=jnp.float64,
                               **HYBRID)
    return JaxDenseDriver(src, dst, N, QUERIES, CFG, SCFG, mode=mode, dtype=jnp.float64)


def _port(engine, mode):
    src, dst = _stream()
    if engine == "fast":
        return FastStreamDriver(src, dst, N, QUERIES, CFG, SCFG, mode=mode,
                                dtype=torch.float64, device="cpu", **FAST)
    if engine == "hybrid":
        return HybridStreamDriver(src, dst, N, QUERIES, CFG, SCFG, mode=mode,
                                  dtype=torch.float64, device="cpu", **HYBRID)
    return StreamDriver(src, dst, N, QUERIES, CFG, SCFG, mode=mode, dtype=torch.float64,
                        device="cpu")


def _window(drv):
    return getattr(drv.graph, "window", drv.graph)


def _assert_same(jdrv, tdrv):
    np.testing.assert_allclose(tdrv.state.p.numpy(), np.asarray(jdrv.state.p), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tdrv.state.r.numpy(), np.asarray(jdrv.state.r), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(_window(tdrv).deg.numpy(), np.asarray(_window(jdrv).deg))
    np.testing.assert_array_equal(_window(tdrv).src.numpy(), np.asarray(_window(jdrv).src))
    assert (tdrv.head, tdrv.step_idx) == (jdrv.head, jdrv.step_idx)


PORT_DRIVERS = {"dense": StreamDriver, "fast": FastStreamDriver, "hybrid": HybridStreamDriver}
JAX_DRIVERS = {"dense": JaxDenseDriver, "fast": JaxFastDriver, "hybrid": JaxHybridDriver}


def _assert_tuning(got, want):
    """The hybrid tuning of the driver that wrote a file, attribute by
    attribute, and a fresh snapshot with an empty overlay."""
    for attr in HYBRID_TUNING:
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.ov_count == 0 and not np.asarray(got.graph.ov.sign).any()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ENGINES)
def test_jax_checkpoint_resumes_in_port(tmp_path, engine, mode):
    """JAX driver, 4 slides (one slide past a rebuild: kills and a
    part-filled ring; for the hybrid driver a stale snapshot and a live
    overlay), save; the port loads it; both go on 4 slides (across the
    next rebuild): equal rounds, the same state."""
    a = _jax(engine, mode)
    a.seed()
    list(a.run(4))
    path = str(tmp_path / "ck.npz")
    jax_save(path, a)
    b = load_checkpoint(path, *_stream(), device="cpu")
    assert type(b) is PORT_DRIVERS[engine]
    if engine == "hybrid":
        assert a.ov_count == 50
        _assert_tuning(b, a)
    assert b.mode == mode and b.state.p.dtype == torch.float64
    assert dataclasses.asdict(b.cfg) == dataclasses.asdict(CFG)
    _assert_same(a, b)
    ra = [int(s.rounds) for s in a.run(4)]
    rb = [s.rounds for s in b.run(4)]
    assert ra == rb
    _assert_same(a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ENGINES)
def test_port_checkpoint_resumes_in_jax(tmp_path, engine, mode):
    """The other way: the port saves mid-stream, the JAX package loads the
    file (its fast driver resumes on its kernel, in interpret mode here, as
    the file's ``segsum`` says), both go on 4 slides."""
    b = _port(engine, mode)
    b.seed()
    list(b.run(4))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, b)
    a = jax_load(path, *_stream())
    assert type(a) is JAX_DRIVERS[engine]
    if engine == "fast":
        assert a.segsum is True and a.tiers == b.tiers and a.fcnt == b.fcnt == 25
    if engine == "hybrid":
        _assert_tuning(a, b)
    _assert_same(a, b)
    ra = [int(s.rounds) for s in a.run(4)]
    rb = [s.rounds for s in b.run(4)]
    assert ra == rb
    _assert_same(a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("slides", [0, 2, 3])
def test_port_file_holds_the_reference_layout(tmp_path, slides, mode):
    """The port's file, array by array, against the file the JAX driver
    writes in the same state (an empty, a part-filled and a full fresh
    ring): the padded delivery views, their scatter ids and tile offsets
    included; the metadata but for ``segsum``."""
    a, b = _jax("fast", mode), _port("fast", mode)
    a.seed(), b.seed()
    list(a.run(slides)), list(b.run(slides))
    jax_save(str(tmp_path / "a.npz"), a)
    save_checkpoint(str(tmp_path / "b.npz"), b)
    with np.load(tmp_path / "a.npz") as za, np.load(tmp_path / "b.npz") as zb:
        assert set(za.files) == set(zb.files)
        for k in za.files:
            if k in ("meta", "p", "r"):
                continue
            assert zb[k].dtype == za[k].dtype == np.int32, k
            np.testing.assert_array_equal(zb[k], za[k], k)
        np.testing.assert_allclose(zb["p"], za["p"], rtol=0, atol=1e-12)
        ma = json.loads(bytes(za["meta"]).decode())
        mb = json.loads(bytes(zb["meta"]).decode())
    assert mb["tuning"].pop("segsum") is True and ma["tuning"].pop("segsum") is False
    assert ma == mb


@pytest.mark.parametrize("engine", ENGINES)
def test_port_checkpoint_resumes_in_port(tmp_path, engine):
    """A resumed port driver goes on bit for bit as the one that wrote the
    file (CPU: the plain versions are deterministic; the hybrid driver's
    rebuilt snapshot stands for its stale one and the overlay)."""
    b = _port(engine, REVERSE)
    b.seed()
    list(b.run(5))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, b)
    c = load_checkpoint(path, *_stream(), device="cpu")
    if engine == "fast":
        for attr in ("tiers", "rebuild_every", "e_top", "fring", "cap0", "fcnt", "bf16d"):
            assert getattr(c, attr) == getattr(b, attr), attr
        assert FastStreamDriver.from_checkpoint(path, *_stream(), device="cpu").head == b.head
    if engine == "hybrid":
        assert b.ov_count == 100
        _assert_tuning(c, b)
    assert [s.rounds for s in b.run(4)] == [s.rounds for s in c.run(4)]
    assert torch.equal(b.state.p, c.state.p) and torch.equal(b.state.r, c.state.r)


# what each driver's file holds: its tuning's keys (none for the dense
# driver) and its arrays besides ``meta, p, r, src, dst, deg``
SAVED = {
    "dense": (None, []),
    "fast": (["tiers", "rebuild_every", "e_top", "fring", "cap0", "fcnt", "queries", "segsum",
              "bf16d"],
             [f"kg_{k}" for k in ("d_gat", "d_pos", "d_sca", "d_toff", "f_len", "f_nbr",
                                  "f_off", "fd_gat", "fd_sca", "fd_toff", "fr_gat", "fr_sca",
                                  "nbr", "offsets", "row_len", "snap_pos")]),
    "hybrid": (["fcap", "ecap", "scan_ecap", "wcap", "ovacap", "tiers", "rebuild_every",
                "worklist"], []),
}


@pytest.mark.parametrize("engine", ENGINES)
def test_saved_file_holds_the_drivers_keys(tmp_path, engine):
    """Each driver says what its file carries (``engine``, ``tuning``,
    ``extra_arrays``): the meta's keys in order, the tuning's and the
    arrays are the layout both packages read, and the file loads as the
    driver that wrote it."""
    b = _port(engine, FORWARD)
    b.seed()
    list(b.run(2))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, b)
    tuning, extra = SAVED[engine]
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        assert sorted(z.files) == sorted(["meta", "p", "r", "src", "dst", "deg", *extra])
    keys = ["n", "head", "step_idx", "mode", "engine", "cfg", "scfg"]
    assert list(meta) == keys + ([] if tuning is None else ["tuning"])
    assert meta["engine"] == engine and (meta["head"], meta["step_idx"]) == (b.head, 2)
    assert tuning is None or list(meta["tuning"]) == tuning
    assert type(load_checkpoint(path, *_stream(), device="cpu")) is type(b)


def test_other_engines_are_refused(tmp_path):
    """A hybrid file now loads as the hybrid driver; the fast driver's own
    loader refuses a dense file."""
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, _port("hybrid", FORWARD))
    assert type(load_checkpoint(path, *_stream(), device="cpu")) is HybridStreamDriver
    b = _port("dense", FORWARD)
    with pytest.raises(ValueError, match="not a fast-driver"):
        save_checkpoint(path, b)
        FastStreamDriver.from_checkpoint(path, *_stream(), device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_file_holds_the_reference_layout(tmp_path, mode):
    """The port's hybrid file against the JAX driver's in the same state
    (two slides: a stale snapshot and a live overlay, neither of which is
    written): the same arrays, p and r at 1e-12, the same metadata."""
    a, b = _jax("hybrid", mode), _port("hybrid", mode)
    a.seed(), b.seed()
    list(a.run(2)), list(b.run(2))
    jax_save(str(tmp_path / "a.npz"), a)
    save_checkpoint(str(tmp_path / "b.npz"), b)
    with np.load(tmp_path / "a.npz") as za, np.load(tmp_path / "b.npz") as zb:
        assert sorted(za.files) == sorted(zb.files) == ["deg", "dst", "meta", "p", "r", "src"]
        for k in ("src", "dst", "deg"):
            assert zb[k].dtype == za[k].dtype == np.int32
            np.testing.assert_array_equal(zb[k], za[k], k)
        for k in ("p", "r"):
            np.testing.assert_allclose(zb[k], za[k], rtol=0, atol=1e-12)
        ma, mb = (json.loads(bytes(z["meta"]).decode()) for z in (za, zb))
    assert ma == mb and mb["engine"] == "hybrid"
    assert set(mb["tuning"]) == set(HYBRID_TUNING)


def test_hybrid_runs_are_bitwise_deterministic():
    """tests/test_checkpoint.py::test_determinism_bitwise on the port, on
    the CPU: two f32 hybrid runs are bit-identical (on the card the scatters
    use atomics, and the contract is exact PPR, not bit identity)."""
    src, dst, n = synthetic_powerlaw_stream(60, 800, seed=13)
    scfg = StreamConfig(window=400, slide=40)
    cfg = PprConfig(alpha=0.15, eps=1e-7)

    def run():
        drv = HybridStreamDriver(src, dst, n, [0, 7, 31], cfg, scfg, dtype=torch.float32,
                                 device="cpu")
        drv.seed()
        list(drv.run(6))
        return drv.state

    s1, s2 = run(), run()
    assert torch.equal(s1.p, s2.p) and torch.equal(s1.r, s2.r)


@pytest.mark.parametrize("w,n_rows", [(1, 5), (2048, 256), (2049, 257), (250, 36), (75, 36)])
def test_layout_formulas_match_reference(w, n_rows):
    from pprx.engine.segsum import SEGSUM_TR, pad_len as jax_pad_len
    from pprx.engine.segsum import tile_offsets as jax_tile_offsets

    assert pad_len(w) == jax_pad_len(w)
    offs = np.sort(np.random.default_rng(w).integers(0, w + 1, n_rows + 1)).astype(np.int32)
    np.testing.assert_array_equal(
        tile_offsets(offs, n_rows), np.asarray(jax_tile_offsets(jnp.asarray(offs), n_rows, SEGSUM_TR))
    )



@pytest.mark.parametrize("mode", MODES)
def test_checkpoint_without_fresh_view_resumes(tmp_path, mode):
    """A reference fast checkpoint with its kg_fd_* arrays dropped (files
    older than the delivery-sorted fresh view): both packages rebuild the
    view from the fresh ring and go on 2 slides to the same state, with
    equal rounds."""
    a = _jax("fast", mode)
    a.seed()
    list(a.run(4))
    path = str(tmp_path / "ck.npz")
    jax_save(path, a)
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if not k.startswith("kg_fd_")}
    assert len(kept) < len(np.load(path).files)
    old = str(tmp_path / "old.npz")
    np.savez(old, **kept)
    ja, tb = jax_load(old, *_stream()), load_checkpoint(old, *_stream(), device="cpu")
    _assert_same(ja, tb)
    assert [int(s.rounds) for s in ja.run(2)] == [s.rounds for s in tb.run(2)]
    _assert_same(ja, tb)


# ---------------------------------------------------------------- sharded
SHARDED = [(engine, mode) for engine in ("dense", "wl", "wlp") for mode in MODES]
SH_CFG = PprConfig(alpha=0.15, eps=1e-8, max_rounds=10_000)
BEFORE, AFTER = 2, 4  # slides before the save and after it (fring 60: a rebuild every 2)


def _sh_tag(engine, mode, shape):
    return f"{engine}-{mode}-{shape[0]}x{shape[1]}"


def _jax_sharded(engine, mode, shape):
    src, dst, n = stream(11)
    kw = {} if engine == "dense" else dict(ccap=64, fring=60)
    drv = JaxShardedDriver(src, dst, n, [0, 5, 9, 17], SH_CFG, StreamConfig(300, 25),
                           jax_mesh(*shape), mode=mode, dtype=jnp.float64, engine=engine, **kw)
    drv.seed()
    list(drv.run(BEFORE))
    return drv


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The JAX package's 2x2 files (``BEFORE`` slides in) and its runs on
    from them, then the port's 2x2 world: ``sharded_resume`` of every
    engine and mode, each also loading the JAX file."""
    out = str(tmp_path_factory.mktemp("sharded"))
    jax_runs = {}
    for engine, mode in SHARDED:
        drv = _jax_sharded(engine, mode, (2, 2))
        path = f"{out}/jax-{_sh_tag(engine, mode, (2, 2))}.npz"
        jax_save_sharded(path, drv)
        rounds = [s["rounds"] for s in drv.run(AFTER)]
        jax_runs[engine, mode] = {"path": path, "rounds": rounds, "p": drv.host_p(),
                                  "r": drv.host_r()}

    def cases(shape):
        return {f"{e}-{m}": ("sharded_resume", dict(engine=e, mode=m, out_dir=out,
                                                     jax_file=jax_runs[e, m]["path"]))
                for e, m in SHARDED}

    get = worlds([(2, 2)], cases, tmp_path_factory, "ck")
    return out, jax_runs, lambda engine, mode: get((2, 2))[f"{engine}-{mode}"]


def _same_files(a: str, b: str, p_atol: float = 0.0):
    """Every array of two sharded files equal (p and r within ``p_atol``),
    and the metadata but for the reference's resolved ``segsum`` flag."""
    with np.load(a) as za, np.load(b) as zb:
        assert set(za.files) == set(zb.files)
        for k in za.files:
            if k == "meta":
                continue
            assert za[k].dtype == zb[k].dtype, k
            if k in ("p", "r"):
                np.testing.assert_allclose(za[k], zb[k], rtol=0, atol=p_atol, err_msg=k)
            else:
                np.testing.assert_array_equal(za[k], zb[k], k)
        ma, mb = (json.loads(bytes(z["meta"]).decode()) for z in (za, zb))
    for m in (ma, mb):
        m.get("wl_tuning", {}).pop("segsum", None)
    assert ma == mb


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("engine,mode", SHARDED)
def test_sharded_resume_in_port_is_bit_identical(tmp_path, sharded, engine, mode, shape):
    """Saved ``BEFORE`` slides in, loaded on the same mesh: the resumed
    driver runs ``AFTER`` slides (across a rebuild for the wl engines) to
    the writer's state bit for bit, with its rounds."""
    if shape == (1, 1):
        res = sharded_resume(make_row_mesh(1, 1), engine, mode, str(tmp_path))
    else:
        res = sharded[2](engine, mode)
    assert bool(res["same"])
    assert int(res["head_b"]) == 300 + BEFORE * 25
    np.testing.assert_array_equal(res["rounds_b"], res["rounds_a"])
    np.testing.assert_array_equal(res["pb"], res["pa"])


@pytest.mark.parametrize("engine,mode", SHARDED)
def test_port_sharded_file_holds_the_reference_layout(sharded, engine, mode):
    """At 2x2, the port's file and the JAX package's, written at the same
    point of the same stream: the window, the host bookkeeping and every
    shard's snapshot in the reference's layout (padded views, scatter ids,
    tile offsets) equal array by array; p and r at 1e-12."""
    out, jax_runs, _ = sharded
    _same_files(jax_runs[engine, mode]["path"], f"{out}/port-{_sh_tag(engine, mode, (2, 2))}.npz",
                p_atol=1e-12)


@pytest.mark.parametrize("engine,mode", SHARDED)
def test_jax_sharded_file_resumes_in_port(sharded, engine, mode):
    """The JAX package's 2x2 file loaded by the port's world: saved again at
    once it is the same file bit for bit; run on ``AFTER`` slides it keeps
    the JAX package's rounds and state (1e-12)."""
    out, jax_runs, get = sharded
    ref = jax_runs[engine, mode]
    _same_files(ref["path"], f"{out}/again-{_sh_tag(engine, mode, (2, 2))}.npz")
    res = get(engine, mode)
    np.testing.assert_array_equal(res["rounds_c"], ref["rounds"])
    np.testing.assert_allclose(res["pc"], ref["p"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(res["rc"], ref["r"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("engine,mode", SHARDED)
def test_port_sharded_file_resumes_in_jax(tmp_path, sharded, engine, mode):
    """The port's 2x2 file loaded by the JAX package on its 2x2 mesh: saved
    again at once it is the same file bit for bit; run on ``AFTER`` slides
    it keeps the port's rounds and state (1e-12)."""
    out, _, get = sharded
    path = f"{out}/port-{_sh_tag(engine, mode, (2, 2))}.npz"
    src, dst, _ = stream(11)
    drv = jax_load_sharded(path, src, dst, jax_mesh(2, 2))
    again = str(tmp_path / "again.npz")
    jax_save_sharded(again, drv)
    _same_files(path, again)
    res = get(engine, mode)
    assert [s["rounds"] for s in drv.run(AFTER)] == list(res["rounds_a"])
    np.testing.assert_allclose(drv.host_p(), res["pa"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(drv.host_r(), res["ra"], rtol=0, atol=1e-12)


def test_sharded_checkpoint_refusals(tmp_path):
    """A wl file whose tiers or quotas the engine does not rebuild, a file
    of another mesh, and a file that is not sharded are refused, in the
    reference's words where it has them."""
    src, dst, n = stream(11)
    mesh = make_row_mesh(1, 1)
    drv = _driver(mesh, "wl", FORWARD, 11, (0, 5, 9, 17), ccap=64, fring=60)
    path = str(tmp_path / "ck.npz")
    save_sharded_checkpoint(path, drv)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode())

    def rewrite(**tuning):
        m = json.loads(json.dumps(meta))
        m["wl_tuning"].update(tuning)
        bad = str(tmp_path / "bad.npz")
        np.savez(bad, **{**arrays, "meta": np.frombuffer(json.dumps(m).encode(), np.uint8)})
        return bad

    with pytest.raises(ValueError, match="wl checkpoint tier mismatch"):
        load_sharded_checkpoint(rewrite(tiers=[[1, 2, 3]]), src, dst, mesh, device="cpu")
    with pytest.raises(ValueError, match="wl checkpoint quota mismatch"):
        load_sharded_checkpoint(rewrite(ccaps=[7]), src, dst, mesh, device="cpu")
    jpath = str(tmp_path / "j.npz")
    jax_save_sharded(jpath, _jax_sharded("dense", FORWARD, (2, 1)))
    with pytest.raises(ValueError, match="another mesh"):
        load_sharded_checkpoint(jpath, src, dst, mesh, device="cpu")
    single = str(tmp_path / "single.npz")
    save_checkpoint(single, _port("dense", FORWARD))
    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        load_sharded_checkpoint(single, src, dst, mesh, device="cpu")

