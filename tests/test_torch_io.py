"""The port's edge-stream IO (pprx_torch.graph.io and its native parser)
against the JAX package's (pprx.graph.io): the same arrays bit for bit, and
packed files that cross between the two packages."""

import numpy as np
import pytest
import torch

from pprx.graph import io as jio
from pprx_torch import _ext
from pprx_torch.graph import io as tio
from pprx_torch.graph import native_io
from test_native_io import CASES

torch.set_num_threads(1)


def _native():
    if not native_io.available():
        pytest.skip("no C++ compiler here ($CXX or g++): the native parser cannot be built")


def write(tmp_path, text, name="g.txt"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype == np.int32 and got[2] == want[2]


@pytest.mark.parametrize("use_native", [True, False, None], ids=["native", "python", "auto"])
@pytest.mark.parametrize("text", CASES)
def test_load_edge_list_matches_reference(tmp_path, text, use_native):
    if use_native:
        _native()
    path = write(tmp_path, text)
    assert_same(tio.load_edge_list(path, use_native=use_native),
                jio.load_edge_list(path, use_native=False))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_load_edge_list_sorts_shuffled_timestamps(tmp_path, use_native):
    """50k lines with timestamps out of order: the stable sort runs (ties
    included) and the ids are renumbered after it, as in the reference."""
    if use_native:
        _native()
    rng = np.random.default_rng(0)
    m = 50_000
    src, dst = rng.integers(0, 5000, m), rng.integers(0, 5000, m)
    ts = rng.integers(0, m // 4, m) / 8  # repeats: the sort must be stable
    path = write(tmp_path, "".join(f"{s} {d} {t:.17g}\n" for s, d, t in zip(src, dst, ts)))
    got = tio.load_edge_list(path, use_native=use_native)
    assert_same(got, jio.load_edge_list(path, use_native=False))
    order = np.argsort(ts, kind="stable")
    assert not tio._nondecreasing(ts) and tio._nondecreasing(ts[order])
    assert_same(got, tio.renumber(src[order], dst[order]))


def test_renumber_both_branches_match_reference():
    """The O(M) scatter (dense ids) and the np.unique branch (ids past the
    dense gate, or negative) give the reference's mapping, and each other's."""
    rng = np.random.default_rng(5)
    for _ in range(100):
        m = int(rng.integers(1, 80))
        hi = int(rng.integers(2, 10**5))
        src, dst = rng.integers(0, hi, m), rng.integers(0, hi, m)
        dense = tio.renumber(src, dst)
        assert_same(dense, jio.renumber(src, dst))
        for off in (2**40, -hi):
            assert_same(tio.renumber(src + off, dst + off), jio.renumber(src + off, dst + off))
            assert_same(tio.renumber(src + off, dst + off), dense)
    empty = tio.renumber(np.empty(0, np.int64), np.empty(0, np.int64))
    assert empty[2] == 0 and empty[0].size == 0


def test_packed_files_cross_between_packages(tmp_path):
    src, dst, n = tio.synthetic_powerlaw_stream(40, 300, seed=3)
    tio.save_packed(str(tmp_path / "t.npz"), src, dst, n)
    jio.save_packed(str(tmp_path / "j.npz"), src, dst, n)
    for name in ("t.npz", "j.npz"):
        path = str(tmp_path / name)
        for got in (tio.load_packed(path), jio.load_packed(path)):
            assert_same(got, (src, dst, n))
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        assert all(t[k].dtype == j[k].dtype for k in t.files)


@pytest.mark.parametrize("seed", [0, 4])
def test_synthetic_erdos_stream_matches_reference(seed):
    got, want = tio.synthetic_erdos_stream(30, 500, seed=seed), jio.synthetic_erdos_stream(
        30, 500, seed=seed)
    assert_same(got, want)
    assert not np.any(got[0] == got[1])


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        tio.load_edge_list("/nonexistent/file.txt", use_native=False)
    _native()
    with pytest.raises(RuntimeError, match="native edge parse failed"):
        tio.load_edge_list("/nonexistent/file.txt", use_native=True)


@pytest.fixture
def fresh_native(monkeypatch):
    """The native library forgotten, so that the next parse builds it."""
    native_io._lib.cache_clear()
    _ext.load_host.cache_clear()
    yield
    monkeypatch.undo()
    native_io._lib.cache_clear()
    _ext.load_host.cache_clear()


def test_without_a_compiler(tmp_path, monkeypatch, fresh_native):
    """No compiler: ``use_native=None`` parses in Python, ``True`` raises."""
    monkeypatch.setattr(_ext, "find_cxx", lambda: None)
    path = write(tmp_path, CASES[1])
    assert not native_io.available()
    assert_same(tio.load_edge_list(path), jio.load_edge_list(path, use_native=False))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tio.load_edge_list(path, use_native=True)


def test_a_failed_build_raises(tmp_path, monkeypatch, fresh_native):
    """A compiler that fails makes the parse raise, also where the parser
    was auto-selected: there is no quiet fall back to Python."""
    _native()
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_ext, "CXX_FLAGS", (*_ext.CXX_FLAGS, "-fno-such-flag"))
    path = write(tmp_path, CASES[0])
    with pytest.raises(RuntimeError, match="failed"):
        tio.load_edge_list(path)
    assert not any((tmp_path / "build").glob("*.so"))


def test_build_host_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    """A second build of the same source and flags reuses the library."""
    _native()
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path)
    first = _ext.build_host("edgeio")
    again = _ext.build_host("edgeio")
    assert first.path == again.path and first.path.parent == tmp_path
    assert first.seconds > 0 and again.seconds == 0.0
