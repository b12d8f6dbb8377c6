"""Tests of the port that need a CUDA device (marker ``cuda``).

Each test decides inside its body whether a card is present and skips with
a reason otherwise. This file imports no JAX, so that on a machine with a
card and without JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \
        -o "markers=cuda: needs a CUDA device"

(``-o`` registers the marker that ``tests/conftest.py`` registers otherwise.)
"""

import numpy as np
import pytest
import torch

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.device import resolve_device
from pprx_torch.engine import segsum
from pprx_torch.engine.segsum import (
    row_offsets,
    segsum_add_,
    segsum_add_plain,
    segsum_gather_add_,
    segsum_gather_add_plain,
)
from pprx_torch.engine.state import REVERSE, PprState, init_state, settled_distance
from pprx_torch.engine.update import out_row_sums
from pprx_torch.graph.fast_stream import FastStreamDriver, window_row_sums
from pprx_torch.graph.hybrid_stream import TUNING, HybridStreamDriver
from pprx_torch.graph.io import synthetic_powerlaw_stream
from pprx_torch.graph.stream import StreamDriver
from pprx_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pprx_torch.ref.exact import exact_ppr, exact_ppr_columns

# every lanes-per-edge the kernels have (1, 2, 4, 8, 16 and the wide 32), a
# width of one column a lane (3), and widths whose last lane is idle (3, 100)
WIDTHS = [1, 3, 4, 8, 16, 32, 64, 100, 128]
# forced edges per chunk: 24 cuts inside the 32-edge blocks a warp walks, so
# rows span groups, steps, blocks and chunks
CHUNKS = [24, 64, 256]


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", WIDTHS)
def test_kernel_matches_plain(s, dtype):
    """The Hopper kernel against the plain version (in f64) on a skewed
    segment set with empty rows; rtol = atol = 1e-4 for f32 sums of up to
    ~7e4 terms in [0, 1)."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    n_rows, w = 5000, 200_000
    seg = np.minimum(rng.zipf(1.3, size=w) % (n_rows - 1), n_rows - 2).astype(np.int32)
    seg.sort()
    seg_t = torch.from_numpy(seg).to(dev)
    contrib = torch.from_numpy(rng.random((w, s), dtype=np.float32)).to(dev, dtype)
    rin = torch.from_numpy(rng.random((n_rows, s), dtype=np.float32)).to(dev)
    off = row_offsets(seg_t, n_rows)
    ref = segsum_add_plain(rin.double(), contrib.double(), off)
    before = segsum.launches()
    out = segsum_add_(rin.clone(), contrib, off)
    torch.cuda.synchronize()
    assert segsum.launches() == before + 1
    torch.testing.assert_close(out.double(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_reads_only_the_given_rows():
    """Rows [lo, hi) of a view with ``row_off[lo:hi+1]``: edges before
    ``row_off[lo]`` and past ``row_off[hi]`` are not read, as in the plain
    version (the callers drop the phantom row's edges this way)."""
    dev = _cuda()
    rng = np.random.default_rng(1)
    n_rows, w, s = 700, 30_000, 128
    seg_t = torch.from_numpy(np.sort(rng.integers(0, n_rows, w)).astype(np.int32)).to(dev)
    off = row_offsets(seg_t, n_rows)
    contrib = torch.from_numpy(rng.random((w, s), dtype=np.float32)).to(dev)
    rin = torch.from_numpy(rng.random((n_rows, s), dtype=np.float32)).to(dev)
    lo, hi = 100, 650
    ref = rin.double()
    segsum_add_plain(ref[lo:hi], contrib.double(), off[lo:hi + 1])
    out = rin.clone()
    segsum_add_(out[lo:hi], contrib, off[lo:hi + 1])
    torch.testing.assert_close(out.double(), ref, rtol=1e-5, atol=1e-5)


def _trouble_lens(case: str, c: int) -> tuple[list[int], int, int]:
    """(edges per row, edges before row_off[0], edges past row_off[R]) for
    the layouts the edge-balanced split can get wrong; ``c`` is the
    kernel's chunk size."""
    tail = [3, 0, 0, 7, 1, 1, 0, 2] * 5
    return {
        "hub_spans_many_chunks": (tail + [150 * c + 17] + tail, 0, 0),
        "hub_first": ([120 * c + 5] + tail, 0, 0),
        "hub_last": (tail + [120 * c + 5], 0, 0),
        "hub_first_sliced": ([120 * c + 5] + tail, 3 * c + 11, 77),
        "rows_end_on_chunk_boundaries": ([c, c, 2 * c, c // 2, c // 2, 0, 0, c, 3 * c], 0, 0),
        "aligned_rows_shifted_start": ([c, c, 2 * c, c], 5, 0),
        "empty_runs_across_boundaries": ([c - 1, 1] + [0] * 300 + [c + 1, c - 1] + [0] * 50, 0, 9),
        "chunk_inside_one_row": ([1, 5 * c, 1], c - 1, 0),
        "fewer_edges_than_a_chunk": ([3, 0, 4, 1], 0, 0),
        "fewer_edges_than_a_chunk_sliced": ([3, 0, 4, 1], 2 * c + 1, 40),
        "single_edge_rows": ([1] * (7 * c + 3), 0, 0),
        "no_edges_in_range": ([0, 0, 0, 0], 0, 3 * c),
    }[case]


TROUBLE = [
    "hub_spans_many_chunks", "hub_first", "hub_last", "hub_first_sliced",
    "rows_end_on_chunk_boundaries", "aligned_rows_shifted_start",
    "empty_runs_across_boundaries", "chunk_inside_one_row",
    "fewer_edges_than_a_chunk", "fewer_edges_than_a_chunk_sliced",
    "single_edge_rows", "no_edges_in_range",
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", WIDTHS)
@pytest.mark.parametrize("case", TROUBLE)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_both_entries_on_trouble_cases(monkeypatch, chunk, case, s, dtype):
    """Both entries against their plain versions in f64 where the
    edge-balanced split has its corners (rows shared between chunks, rows
    ending on chunk boundaries, empty runs, a sliced ``row_off``), and
    bit-identical results from two launches on the same inputs. rtol = atol
    = 1e-4: f32 sums of up to ~2e4 terms in [0, 1)."""
    dev = _cuda()
    # every edge array in chunks of ``chunk`` edges, whatever its length (the
    # kernels' own choice would give every small case here its smallest)
    monkeypatch.setattr(segsum, "chunk_for", lambda n_edges, s: chunk)
    lens, lead, trail = _trouble_lens(case, chunk)
    rng = np.random.default_rng(len(case) + s)
    off_np = lead + np.concatenate([[0], np.cumsum(lens)])
    w, n_rows, n_table = int(off_np[-1]) + trail, len(lens), 1000
    off = torch.from_numpy(off_np.astype(np.int32)).to(dev)
    contrib = torch.from_numpy(rng.random((w, s), dtype=np.float32)).to(dev, dtype)
    table = torch.from_numpy(rng.random((n_table, s), dtype=np.float32)).to(dev, dtype)
    rin = torch.from_numpy(rng.random((n_rows, s), dtype=np.float32)).to(dev)
    for gat_dtype in (torch.int32, torch.int64):
        gat = torch.from_numpy(rng.integers(0, n_table, w)).to(dev, gat_dtype)
        ref = segsum_gather_add_plain(rin.double(), table.double(), gat, off)
        out = segsum_gather_add_(rin.clone(), table, gat, off)
        again = segsum_gather_add_(rin.clone(), table, gat, off)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.double(), ref, rtol=1e-4, atol=1e-4)
        assert torch.equal(out, again)
    ref = segsum_add_plain(rin.double(), contrib.double(), off)
    out = segsum_add_(rin.clone(), contrib, off)
    again = segsum_add_(rin.clone(), contrib, off)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.double(), ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(out, again)


def _span_lens(spans: int, c: int) -> list[int]:
    """A hub row that reaches into ``spans`` chunks of ``c`` edges (it
    starts mid-chunk), between short rows and empty ones."""
    return [3, 0, c // 2 - 3, (spans - 1) * c + 9, 0, 5, 1] + [2] * c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", WIDTHS)
@pytest.mark.parametrize("spans", [1, 2, 3, 150])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_row_scale_on_spanning_rows(monkeypatch, chunk, spans, s, dtype):
    """Both entries with a per-row scale far from 1 where a double or a
    missing scale would show: a row inside one chunk, and rows that span 2,
    3 and 150 chunks (their partials are scaled once, on their sum).
    Against the plain version in f64, rtol = atol = 1e-4 (f32 sums of up to
    ~4e4 terms in [0, 1) times a factor in [2, 6]); two launches agree bit
    for bit."""
    dev = _cuda()
    monkeypatch.setattr(segsum, "chunk_for", lambda n_edges, s: chunk)
    lens = _span_lens(spans, chunk)
    rng = np.random.default_rng(spans + s)
    off_np = np.concatenate([[0], np.cumsum(lens)])
    w, n_rows, n_table = int(off_np[-1]), len(lens), 500
    assert (off_np[4] - 1) // chunk - off_np[3] // chunk == spans - 1
    off = torch.from_numpy(off_np.astype(np.int32)).to(dev)
    scale = torch.from_numpy(2.0 + 4.0 * rng.random(n_rows, dtype=np.float32)).to(dev)
    contrib = torch.from_numpy(rng.random((w, s), dtype=np.float32)).to(dev, dtype)
    table = torch.from_numpy(rng.random((n_table, s), dtype=np.float32)).to(dev, dtype)
    gat = torch.from_numpy(rng.integers(0, n_table, w).astype(np.int32)).to(dev)
    rin = torch.from_numpy(rng.random((n_rows, s), dtype=np.float32)).to(dev)
    before = dict(segsum.LAUNCHES)
    for kernel, plain, source in (
        (lambda r: segsum_add_(r, contrib, off, scale),
         lambda r: segsum_add_plain(r, contrib.double(), off, scale.double()), "add"),
        (lambda r: segsum_gather_add_(r, table, gat, off, row_scale=scale),
         lambda r: segsum_gather_add_plain(r, table.double(), gat, off, scale.double()),
         "gather"),
    ):
        ref = plain(rin.double())
        out, again = kernel(rin.clone()), kernel(rin.clone())
        torch.cuda.synchronize()
        torch.testing.assert_close(out.double(), ref, rtol=1e-4, atol=1e-4, msg=source)
        assert torch.equal(out, again), source
    assert segsum.launches("segsum_add", scaled=True, since=before) == 2
    assert segsum.launches("segsum_gather_add", scaled=True, since=before) == 2
    assert segsum.launches(scaled=False, since=before) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", TROUBLE)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_row_scale_on_trouble_cases(monkeypatch, chunk, case):
    """The scaled form at the corners of the edge-balanced split (every
    width, f32), sliced ``row_off`` included: ``row_scale[w]`` belongs to
    row w of the rows given."""
    dev = _cuda()
    monkeypatch.setattr(segsum, "chunk_for", lambda n_edges, s: chunk)
    lens, lead, trail = _trouble_lens(case, chunk)
    rng = np.random.default_rng(len(case))
    off_np = lead + np.concatenate([[0], np.cumsum(lens)])
    w, n_rows, n_table = int(off_np[-1]) + trail, len(lens), 1000
    off = torch.from_numpy(off_np.astype(np.int32)).to(dev)
    scale = torch.from_numpy(0.25 + rng.random(n_rows, dtype=np.float32)).to(dev)
    gat = torch.from_numpy(rng.integers(0, n_table, w)).to(dev)
    for s in WIDTHS:
        table = torch.from_numpy(rng.random((n_table, s), dtype=np.float32)).to(dev)
        rin = torch.from_numpy(rng.random((n_rows, s), dtype=np.float32)).to(dev)
        ref = segsum_gather_add_plain(rin.double(), table.double(), gat, off, scale.double())
        out = segsum_gather_add_(rin.clone(), table, gat, off, row_scale=scale)
        again = segsum_gather_add_(rin.clone(), table, gat, off, row_scale=scale)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.double(), ref, rtol=1e-4, atol=1e-4)
        assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", WIDTHS)
def test_unit_scale_matches_no_scale(s, dtype):
    """A scale of ones against no scale on skewed rows, both entries: the
    same sums (the scaled path multiplies by 1.0, which is exact), bit for
    bit."""
    dev = _cuda()
    rng = np.random.default_rng(8)
    n_rows, w = 5000, 300_000
    seg = np.minimum(rng.zipf(1.3, size=w) % (n_rows - 1), n_rows - 2).astype(np.int32)
    seg.sort()
    off = row_offsets(torch.from_numpy(seg).to(dev), n_rows)
    table = torch.from_numpy(rng.random((n_rows, s), dtype=np.float32)).to(dev, dtype)
    contrib = torch.from_numpy(rng.random((w, s), dtype=np.float32)).to(dev, dtype)
    gat = torch.from_numpy(rng.integers(0, n_rows, w).astype(np.int32)).to(dev)
    rin = torch.from_numpy(rng.random((n_rows, s), dtype=np.float32)).to(dev)
    ones = torch.ones(n_rows, device=dev)
    plain = segsum_gather_add_(rin.clone(), table, gat, off)
    scaled = segsum_gather_add_(rin.clone(), table, gat, off, row_scale=ones)
    torch.cuda.synchronize()
    assert torch.equal(plain, scaled)
    plain = segsum_add_(rin.clone(), contrib, off)
    scaled = segsum_add_(rin.clone(), contrib, off, ones)
    torch.cuda.synchronize()
    assert torch.equal(plain, scaled)


@pytest.mark.cuda
def test_row_scale_refuses():
    dev = _cuda()
    off = torch.tensor([0, 2, 4], dtype=torch.int32, device=dev)
    contrib = torch.ones(4, 4, device=dev)
    rin = torch.zeros(2, 4, device=dev)
    with pytest.raises(TypeError, match="f32 row_scale"):
        segsum_add_(rin, contrib, off, torch.ones(2, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="row_scale"):
        segsum_add_(rin, contrib, off, torch.ones(3, device=dev))
    with pytest.raises(ValueError, match="one device"):
        segsum_add_(rin, contrib, off, torch.ones(2))
    with pytest.raises(ValueError, match="contiguous"):
        segsum_add_(rin, contrib, off, torch.ones(4, device=dev)[::2])
    out = segsum_add_(rin, contrib, off, torch.tensor([0.5, 3.0], device=dev))
    assert out[:, 0].tolist() == [1.0, 6.0]


@pytest.mark.cuda
@pytest.mark.parametrize("s", WIDTHS)
def test_repeat_launches_are_bit_identical_on_skewed_rows(s):
    """What the kernels offer that ``index_add_`` on the card does not: no
    atomics, so the same inputs give the same bits, hub row included."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    n_rows, w = 5000, 300_000
    seg = np.minimum(rng.zipf(1.3, size=w) % (n_rows - 1), n_rows - 2).astype(np.int32)
    seg.sort()
    off = row_offsets(torch.from_numpy(seg).to(dev), n_rows)
    assert int(off.diff().max()) > 100 * segsum.chunk_for(w, s)
    table = torch.from_numpy(rng.random((n_rows, s), dtype=np.float32)).to(dev)
    gat = torch.from_numpy(rng.integers(0, n_rows, w).astype(np.int32)).to(dev)
    rin = torch.from_numpy(rng.random((n_rows, s), dtype=np.float32)).to(dev)
    outs = [segsum_gather_add_(rin.clone(), table, gat, off) for _ in range(3)]
    outs += [segsum_add_(rin.clone(), table[gat], off) for _ in range(3)]
    torch.cuda.synchronize()
    # the two entries add the same values in the same order
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
def test_no_edge_array_launches_nothing():
    dev = _cuda()
    rin = torch.ones(4, 8, device=dev)
    off = torch.zeros(5, dtype=torch.int32, device=dev)
    before = segsum.launches()
    segsum_add_(rin, torch.empty(0, 8, device=dev), off)
    segsum_gather_add_(rin, torch.ones(3, 8, device=dev),
                       torch.empty(0, dtype=torch.int32, device=dev), off)
    assert segsum.launches() == before
    assert bool((rin == 1).all())


@pytest.mark.cuda
def test_gather_entry_counts_and_refuses():
    dev = _cuda()
    off = torch.tensor([0, 2, 4], dtype=torch.int32, device=dev)
    gat = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=dev)
    table = torch.ones(2, 4, device=dev)
    before = dict(segsum.LAUNCHES)
    out = segsum_gather_add_(torch.zeros(2, 4, device=dev), table, gat, off)
    assert segsum.launches("segsum_gather_add", since=before) == 1
    assert segsum.launches("segsum_add", since=before) == 0
    assert bool((out == 2).all())
    with pytest.raises(TypeError, match="table"):
        segsum_gather_add_(torch.zeros(2, 4, device=dev), table.half(), gat, off)
    with pytest.raises(ValueError, match="gat"):
        segsum_gather_add_(torch.zeros(2, 4, device=dev), table, gat.short(), off)
    with pytest.raises(ValueError, match="one device"):
        segsum_gather_add_(torch.zeros(2, 4, device=dev), table, gat.cpu(), off)
    with pytest.raises(ValueError, match="contiguous"):
        segsum_gather_add_(torch.zeros(2, 4, device=dev), torch.ones(2, 8, device=dev)[:, ::2],
                           gat, off)


@pytest.mark.cuda
def test_default_device_is_the_card():
    _cuda()
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    st = init_state(10, [0, 3])
    assert st.r.device.type == "cuda"
    src, dst, n = synthetic_powerlaw_stream(300, 2000, seed=3)
    drv = FastStreamDriver(src, dst, n, [0, 5], PprConfig(alpha=0.15, eps=1e-6),
                           StreamConfig(window=1000, slide=100), rebuild_every=2)
    assert drv.device.type == "cuda" and drv.state.p.device.type == "cuda"


@pytest.mark.cuda
def test_exact_ppr_on_card_matches_cpu():
    dev = _cuda()
    src, dst, n = synthetic_powerlaw_stream(300, 2000, seed=3)
    on_card = exact_ppr(src, dst, n, [0, 5, 99], 0.15, tol=1e-13, device=dev)
    on_cpu = exact_ppr(src, dst, n, [0, 5, 99], 0.15, tol=1e-13, device="cpu")
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_kernel_refuses_other_dtypes():
    dev = _cuda()
    seg = torch.zeros(4, dtype=torch.int32, device=dev)
    off = row_offsets(seg, 2)
    with pytest.raises(TypeError, match="f32 rin"):
        segsum_add_(torch.zeros(2, 4, dtype=torch.float64, device=dev),
                    torch.ones(4, 4, dtype=torch.float64, device=dev), off)
    with pytest.raises(TypeError, match="contribs"):
        segsum_add_(torch.zeros(2, 4, device=dev),
                    torch.ones(4, 4, dtype=torch.float16, device=dev), off)


@pytest.mark.cuda
def test_fast_stream_on_card_matches_cpu_f64():
    """tests/test_torch_fast_stream.py's stream on the card in f32 (the
    kernel) against the CPU in f64 (the plain version): p within 1e-5."""
    dev = _cuda()
    n = 35
    src, dst, _ = synthetic_powerlaw_stream(n, 500, seed=11)
    cfg = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)
    scfg = StreamConfig(window=250, slide=25)
    kw = dict(rebuild_every=3, e_top=64, n_tiers=3)
    cpu = FastStreamDriver(src, dst, n, [0, 6, 17], cfg, scfg, dtype=torch.float64,
                           device="cpu", **kw)
    gpu = FastStreamDriver(src, dst, n, [0, 6, 17], cfg, scfg, dtype=torch.float32,
                           device=dev, **kw)
    before = segsum.launches()
    for d in (cpu, gpu):
        d.seed()
        list(d.run(10))
    assert segsum.launches() > before
    np.testing.assert_allclose(gpu.state.p.cpu().numpy(), cpu.state.p.numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16d", [False, True])
def test_config2_stream_on_card_matches_cpu_f64(bf16d):
    """Config 2's stream (forward, 16 sources: four lanes an edge) cut to
    N=2,000, W=20,000, b=200, on the card in f32 against the CPU port (the
    plain version, no kernel). f32 delivery, against the CPU in f64:
    ``p + alpha r`` within 1e-5 everywhere (``settled_distance``: ``p`` alone
    differs by up to alpha * eps * deg wherever a residual at its push
    threshold was pushed in one run only), and mass within 1e-3. bf16
    delivery rounds every scan round's contributions to 8 bits while ``r``
    gives up the exact amounts, so mass drifts on any device: that run is
    held to the CPU port with bf16 delivery in f32, mass within 1e-4 of its
    reading per source. Both: the forward contract against exact PPR."""
    dev = _cuda()
    w, b = 20_000, 200
    src, dst, n = synthetic_powerlaw_stream(2000, w + 20 * b, seed=2)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    scfg = StreamConfig(window=w, slide=b)
    queries = list(range(16))
    cpu = FastStreamDriver(src, dst, n, queries, cfg, scfg, rebuild_every=8, bf16d=bf16d,
                           dtype=torch.float32 if bf16d else torch.float64, device="cpu")
    gpu = FastStreamDriver(src, dst, n, queries, cfg, scfg, dtype=torch.float32,
                           rebuild_every=8, bf16d=bf16d, device=dev)
    before = segsum.launches()
    for d in (cpu, gpu):
        d.seed()
        list(d.run(12))
    assert segsum.launches() > before

    def mass(st):
        return (st.p[:n].double().sum(0) + st.r[:n].double().sum(0)).cpu().numpy()

    if bf16d:
        np.testing.assert_allclose(mass(gpu.state), mass(cpu.state), rtol=0, atol=1e-4)
    else:
        assert settled_distance(gpu.state, cpu.state, cfg.alpha) <= 1e-5
        np.testing.assert_allclose(mass(gpu.state), 1.0, rtol=0, atol=1e-3)
    p = gpu.state.p.cpu().double().numpy()
    exact = exact_ppr(gpu.hsrc, gpu.hdst, n, queries, cfg.alpha, tol=1e-11, device=dev)
    for j, pi in enumerate(exact):
        assert np.abs(p[:n, j] - pi).sum() <= cfg.eps * w


@pytest.mark.cuda
def test_reverse_stream_on_card_matches_cpu_f64():
    """The reverse stream on the card in f32 (scan rounds and row sums
    through the scaled and the plain gather entry) against the CPU in f64,
    then the reverse contract against exact columns of M: within 2 eps."""
    dev = _cuda()
    n = 35
    src, dst, _ = synthetic_powerlaw_stream(n, 500, seed=11)
    cfg = PprConfig(alpha=0.2, eps=1e-6, max_rounds=10_000)
    scfg = StreamConfig(window=250, slide=25)
    kw = dict(mode=REVERSE, rebuild_every=3, e_top=16, n_tiers=1)
    cpu = FastStreamDriver(src, dst, n, [0, 6, 17], cfg, scfg, dtype=torch.float64,
                           device="cpu", **kw)
    gpu = FastStreamDriver(src, dst, n, [0, 6, 17], cfg, scfg, dtype=torch.float32,
                           device=dev, **kw)
    before = dict(segsum.LAUNCHES)
    for d in (cpu, gpu):
        d.seed()
        list(d.run(10))
    scaled = segsum.launches("segsum_gather_add", scaled=True, since=before)
    total = segsum.launches("segsum_gather_add", since=before)
    assert scaled > 0 and total >= scaled + 20  # scans, and two row-sum launches a slide
    np.testing.assert_allclose(gpu.state.p.cpu().numpy(), cpu.state.p.numpy(), atol=1e-5)
    views = window_row_sums(gpu.state.p, gpu.graph)
    sweep = out_row_sums(gpu.state.p, gpu.graph.window)
    torch.testing.assert_close(views, sweep, rtol=1e-5, atol=1e-6)
    cols = exact_ppr_columns(gpu.hsrc, gpu.hdst, n, [0, 6, 17], cfg.alpha, device=dev)
    assert np.abs(gpu.state.p[:n].cpu().double().numpy() - cols.T).max() <= 2 * cfg.eps


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_dense_stream_on_card_matches_fast_stream(mode):
    dev = _cuda()
    n = 35
    src, dst, _ = synthetic_powerlaw_stream(n, 500, seed=11)
    cfg = PprConfig(alpha=0.2, eps=1e-6, max_rounds=10_000)
    scfg = StreamConfig(window=250, slide=25)
    a = StreamDriver(src, dst, n, [0, 6, 17], cfg, scfg, mode=mode, device=dev)
    b = FastStreamDriver(src, dst, n, [0, 6, 17], cfg, scfg, mode=mode, rebuild_every=3,
                         device=dev)
    for d in (a, b):
        d.seed()
        list(d.run(6))
    assert a.state.p.device.type == "cuda"
    torch.testing.assert_close(a.state.p, b.state.p, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(tmp_path):
    """Save on the card, load on the card and on the CPU, one slide each:
    the same state to 1e-5 (the small scatters use atomics on CUDA)."""
    dev = _cuda()
    src, dst, n = synthetic_powerlaw_stream(300, 3000, seed=3)
    cfg = PprConfig(alpha=0.15, eps=1e-6)
    a = FastStreamDriver(src, dst, n, [0, 5, 9], cfg, StreamConfig(window=1500, slide=100),
                         mode=REVERSE, rebuild_every=2, device=dev)
    a.seed()
    list(a.run(3))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, a)
    b = load_checkpoint(path, src, dst)
    c = load_checkpoint(path, src, dst, device="cpu")
    assert b.device.type == "cuda" and c.device.type == "cpu"
    for d in (a, b, c):
        list(d.run(1))
    np.testing.assert_allclose(b.state.p.cpu().numpy(), a.state.p.cpu().numpy(), atol=1e-5)
    np.testing.assert_allclose(c.state.p.numpy(), a.state.p.cpu().numpy(), atol=1e-5)


@pytest.mark.cuda
def test_cli_fast_engine_refuses_f64_on_card(tmp_path):
    """``--f64`` meets the kernels' types: the fast engine's subcommands
    exit with the reason before any work (its kernel takes f32 or bf16), and
    so do the dense and the hybrid engines' streams (their kernels take
    f32), launching nothing."""
    from pprx_torch import cli
    from pprx_torch.graph.io import save_packed

    dev = _cuda()
    graph = str(tmp_path / "g.npz")
    save_packed(graph, *synthetic_powerlaw_stream(50, 600, seed=1))
    before = segsum.launches()
    for argv in (["stream", graph, "--window", "300", "--slide", "30", "--f64"],
                 ["serve", graph, "--window", "300", "--slide", "30", "--f64"]):
        with pytest.raises(SystemExit, match="segment-sum kernel takes f32 or bf16 only"):
            cli.main(argv + ["--device", str(dev)])
    with pytest.raises(SystemExit, match="the dense engine's kernels .* take f32 only"):
        cli.main(["stream", graph, "--window", "300", "--slide", "30", "--steps", "2", "--f64",
                  "--engine", "dense", "--device", str(dev)])
    with pytest.raises(SystemExit, match="the hybrid engine's kernels .* take f32 only"):
        cli.main(["stream", graph, "--window", "300", "--slide", "30", "--steps", "2", "--f64",
                  "--engine", "hybrid", "--log", str(tmp_path / "log.jsonl")])
    assert segsum.launches() == before


@pytest.mark.cuda
def test_cli_serve_on_card_launches_the_kernel(tmp_path, capsys):
    """A small ``serve`` on the card (no ``--device``: the card is the
    default) launches the gather entry, and at every serve event each row
    of ids shares at least 9 of its 10 with the CPU run in f64 (f32 on the
    card may swap scores near the k-th place)."""
    import json

    from pprx_torch import cli
    from pprx_torch.graph.io import save_packed

    _cuda()
    graph = str(tmp_path / "g.npz")
    save_packed(graph, *synthetic_powerlaw_stream(300, 3000, seed=2))
    argv = ["serve", graph, "--window", "1500", "--slide", "100", "--steps", "8",
            "--queries", "0,3,7,11", "--k", "10", "--emit-ids", "4", "--refine-budget", "6"]
    ids = {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu", "--f64"])):
        segsum.reset_launches()
        cli.main(argv + extra + ["--log", str(tmp_path / f"{tag}.jsonl")])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["steps"] == 8 and out["serve_events"] == 2
        if tag == "card":
            assert out["device"] == torch.cuda.get_device_name(0)
            assert segsum.launches("segsum_gather_add") > 0
        with open(tmp_path / f"{tag}.jsonl") as f:
            ids[tag] = [r["ids"] for r in map(json.loads, f) if r["event"] == "serve"]
    for card, cpu in zip(ids["card"], ids["cpu"]):
        for a, b in zip(card, cpu):
            assert len(set(a) & set(b)) >= 9, (a, b)


def _shard_views(n_rows: int, rank: int, src, dst, n, s, dev):
    """Shard ``rank``'s snapshot of a K-row mesh, built without a process
    group (the views are block-local: no collective runs)."""
    from pprx_torch.dist.mesh import RowMesh
    from pprx_torch.dist.wl import ShardedWlEngine

    mesh = RowMesh(n_rows, 1, rank, None, None, tuple(range(n_rows)))
    eng = ShardedWlEngine(mesh, n, s, ecap=src.size, bcap=64, cfg=PprConfig(), device=dev)
    return eng, eng.device_graph_wl(src, dst)[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [8, 128])
def test_sharded_views_through_the_kernel(s, dtype):
    """Both shards of a 2-row mesh (at S=8: where the reference gates its
    lane-padded TPU kernel off for nondeterministic reads): the local
    segment into the shard's rows and the remote one into the global rows
    (its ranges start past the local segment) through the kernel, against
    the plain version, bit-identical on repeat; and the two segments of
    both shards together deliver every live edge once."""
    dev = _cuda()
    src, dst, n = synthetic_powerlaw_stream(20_000, 200_000, seed=3)
    total = direct = None
    for rank in range(2):
        eng, snap = _shard_views(2, rank, src, dst, n, s, dev)
        if total is None:
            total = torch.zeros((eng.n_pad, s), dtype=torch.float64)
            direct = torch.zeros_like(total)
        table = torch.rand((eng.n_local + 1, s), generator=torch.Generator().manual_seed(rank))
        table[-1] = 0  # the zero row dead edges gather
        table = table.to(dtype)
        lo, hi = eng.row0, eng.row0 + eng.n_local
        for seg, out in (("loff", total[lo:hi]), ("roff", total)):
            off, gat = snap[f"d_{seg}"], snap["d_gat"]
            rows = out.shape[0]
            got = segsum_gather_add_(torch.zeros((rows, s), device=dev), table.to(dev), gat, off)
            again = segsum_gather_add_(torch.zeros((rows, s), device=dev), table.to(dev), gat,
                                       off)
            want = segsum_gather_add_plain(torch.zeros((rows, s), dtype=torch.float64),
                                           table.double(), gat.cpu(), off.cpu())
            assert torch.equal(got, again)
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
            out += want
        mine = (src >= lo) & (src < hi)
        direct.index_add_(0, torch.from_numpy(dst[mine].astype(np.int64)),
                          table.double()[torch.from_numpy((src[mine] - lo).astype(np.int64))])
    np.testing.assert_allclose(total.numpy(), direct.numpy(), rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16d", [False, True])
def test_sharded_stream_on_card_matches_cpu(bf16d):
    """ShardedStreamDriver(engine='wl') at mesh 1x1 on a small config-5-like
    stream: the card (f32, the kernel) against the CPU (plain version; f64,
    or f32 with the same bf16 delivery): ``p + alpha r`` within 1e-5, and
    with bf16 the mass within 1e-4 of the CPU's; the card launches the
    gather entry."""
    from pprx_torch.dist.mesh import make_row_mesh
    from pprx_torch.dist.stream import ShardedStreamDriver
    from pprx_torch.engine.state import PprState

    dev = _cuda()
    n, w, b, s = 2000, 20_000, 2000, 16
    src, dst, n = synthetic_powerlaw_stream(n, w + 8 * b, seed=5)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    runs = {}
    for tag, device, dtype in (("card", dev, torch.float32),
                               ("cpu", "cpu", torch.float32 if bf16d else torch.float64)):
        segsum.reset_launches()
        drv = ShardedStreamDriver(src, dst, n, list(range(s)), cfg, StreamConfig(w, b),
                                  make_row_mesh(1, 1), engine="wl", dtype=dtype, bf16d=bf16d,
                                  device=device)
        drv.seed()
        list(drv.run(6))
        runs[tag] = (drv, segsum.launches("segsum_gather_add"))
    (card, launched), (cpu, _) = runs["card"], runs["cpu"]
    assert launched > 0
    a, c = (PprState(p=d.p[:n], r=d.r[:n]) for d in (card, cpu))
    assert settled_distance(a, c, cfg.alpha) <= 1e-5
    if bf16d:
        mass = [(d.p[:n].double().sum(0) + d.r[:n].double().sum(0)).cpu() for d in (card, cpu)]
        np.testing.assert_allclose(mass[0].numpy(), mass[1].numpy(), atol=1e-4)


@pytest.mark.cuda
def test_collective_wrappers_on_nccl(tmp_path):
    """Each wrapper once through an NCCL group of one, on the card's
    tensors, equal to its K=1 meaning (chip_smoke.py's phase 14d)."""
    import chip_smoke

    res = chip_smoke.collectives_check(_cuda(), str(tmp_path))
    assert res.pop("backend") == "nccl" and all(res.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [8, 128])
def test_reverse_rowsum_sweep_through_the_kernel(s, dtype):
    """Anomaly (ii) on the card: both shards of a 2-row mesh in reverse
    (views by destination owner), the row-sum sweep's local and remote
    segments through the kernel (with an f32 table, as ``rowsum_sweep``
    runs it; with a bf16 table through the entry), against the plain
    version, bit-identical on repeat; over both shards, every live edge
    once: the window's row sums of the table."""
    dev = _cuda()
    src, dst, n = synthetic_powerlaw_stream(20_000, 200_000, seed=4)
    total = direct = None
    for rank in range(2):
        from pprx_torch.dist.mesh import RowMesh
        from pprx_torch.dist.wl import ShardedWlEngine

        mesh = RowMesh(2, 1, rank, None, None, (0, 1))
        eng = ShardedWlEngine(mesh, n, s, ecap=src.size, bcap=64, cfg=PprConfig(), mode=REVERSE,
                              device=dev)
        snap = eng.device_graph_wl(src, dst)[-1]
        if total is None:
            total = torch.zeros((eng.n_pad, s), dtype=torch.float64)
            direct = torch.zeros_like(total)
        p = torch.rand((eng.n_local, s), generator=torch.Generator().manual_seed(rank)).to(dtype)
        table = torch.cat([p, torch.zeros((1, s), dtype=dtype)])
        lo, hi = eng.row0, eng.row0 + eng.n_local
        if dtype == torch.float32:
            got = [eng.rowsum_sweep(p.to(dev), snap) for _ in range(2)]
        else:
            got = []
            for _ in range(2):
                pair = []
                for seg, rows in (("loff", eng.n_local), ("roff", eng.n_pad)):
                    out = torch.zeros((rows, s), device=dev)
                    for v in ("d", "fd"):
                        segsum_gather_add_(out, table.to(dev), snap[f"{v}_gat"],
                                           snap[f"{v}_{seg}"])
                    pair.append(out)
                got.append(pair)
        for (a, b), seg, out in zip(zip(*got), ("loff", "roff"), (total[lo:hi], total)):
            assert torch.equal(a, b)
            want = torch.zeros((a.shape[0], s), dtype=torch.float64)
            for v in ("d", "fd"):
                segsum_gather_add_plain(want, table.double(), snap[f"{v}_gat"].cpu(),
                                        snap[f"{v}_{seg}"].cpu())
            np.testing.assert_allclose(a.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
            out += want
        mine = (dst >= lo) & (dst < hi)
        direct.index_add_(0, torch.from_numpy(src[mine].astype(np.int64)),
                          table.double()[torch.from_numpy((dst[mine] - lo).astype(np.int64))])
    np.testing.assert_allclose(total.numpy(), direct.numpy(), rtol=1e-12, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("engine,mode", [("wl", REVERSE), ("wlp", 0), ("wlp", REVERSE)])
def test_sharded_reverse_and_wlp_streams_on_card_match_cpu(monkeypatch, engine, mode):
    """The wl engine's reverse slide and the wlp loop at mesh 1x1 on a small
    config-5-like stream: the card (f32, the kernel) against the CPU (f64,
    plain version): ``p + alpha r`` within 1e-5; the card launches the
    gather entry (reverse: the sweep unscaled, the rounds scaled). Every
    wlp receive side takes the sorted delivery here (SORT_BUCKET_MIN=1 in
    both runs), as the headline's large ones do."""
    import pprx_torch.dist.wl as twl
    from pprx_torch.dist.mesh import make_row_mesh
    from pprx_torch.dist.stream import ShardedStreamDriver
    from pprx_torch.engine.state import PprState

    dev = _cuda()
    monkeypatch.setattr(twl, "SORT_BUCKET_MIN", 1)
    n, w, b, s = 2000, 20_000, 2000, 16
    src, dst, n = synthetic_powerlaw_stream(n, w + 8 * b, seed=5)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    runs = {}
    for tag, device, dtype in (("card", dev, torch.float32), ("cpu", "cpu", torch.float64)):
        segsum.reset_launches()
        drv = ShardedStreamDriver(src, dst, n, list(range(s)), cfg, StreamConfig(w, b),
                                  make_row_mesh(1, 1), mode=mode, engine=engine, dtype=dtype,
                                  device=device)
        drv.seed()
        list(drv.run(6))
        runs[tag] = (drv, segsum.launches("segsum_gather_add"),
                     segsum.launches("segsum_gather_add", scaled=True))
    (card, launched, scaled), (cpu, _, _) = runs["card"], runs["cpu"]
    assert launched > 0
    if mode == REVERSE:
        assert 0 < scaled < launched
    a, c = (PprState(p=d.p[:n], r=d.r[:n], mode=mode) for d in (card, cpu))
    assert settled_distance(a, c, cfg.alpha) <= 1e-5


def _hybrid_pair(dev, mode, worklist, **kw):
    """The hybrid driver on ``dev`` in f32 and on the CPU in f64, on a stream
    whose scan rounds run sparse (slides of 25 beside a window of 1,500:
    the overlay is small), rebuilding every 3 slides."""
    src, dst, n = synthetic_powerlaw_stream(300, 3000, seed=3)
    cfg = PprConfig(alpha=0.15, eps=1e-6)
    scfg = StreamConfig(window=1500, slide=25)
    kw = dict(mode=mode, rebuild_every=3, worklist=worklist, **kw)
    return [HybridStreamDriver(src, dst, n, [0, 5, 9], cfg, scfg, dtype=dt, device=d, **kw)
            for dt, d in ((torch.float32, dev), (torch.float64, "cpu"))]


@pytest.mark.cuda
@pytest.mark.parametrize("worklist", [True, False])
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_hybrid_stream_on_card_matches_cpu(mode, worklist):
    """The hybrid driver on the card (f32) and on the CPU (f64), 8 slides
    across rebuilds: each query held to exact PPR on the final window
    (forward: L1 within eps * W and mass within 1e-3; reverse: within
    2 eps), the two states within 1e-5; on the card each loop (the seed's,
    each slide's) one loop graph launch and one read of its carry, with no
    loop on the host, K4 launched, K3 by every scan and count, and K1 and
    K2 by every dense scan (the seed's first scans)."""
    from pprx_torch.engine import loop, rowpass
    from pprx_torch.engine.graphs import RoundGraphs

    dev = _cuda()
    gpu, cpu = _hybrid_pair(dev, mode, worklist)
    before = (dict(segsum.LAUNCHES), dict(rowpass.LAUNCHES), dict(loop.LAUNCHES))

    def refused(*a, **k):
        raise AssertionError("a hybrid loop ran on the host on the card")

    for d in (gpu, cpu):
        with pytest.MonkeyPatch.context() as mp:
            if d is gpu:
                mp.setattr(RoundGraphs, "host_loop", refused)
            st = [d.seed(), *d.run(8)]
        assert len(st) == 9
        if d is gpu:
            assert all(s.syncs == 1 for s in st)
            arms = {k: sum(s.arms[k] for s in st) for k in ("wl", "sparse", "dense", "count")}
            turns = sum(s.rounds + s.arms["count"] + 1 for s in st if s.rounds + s.arms["count"])
    g = gpu.round_graphs.summary()
    assert g["loop_launches"] == g["reads"] == 9
    assert arms["sparse"] + arms["dense"] > 0
    assert segsum.launches("segsum_gather_add", since=before[0]) >= arms["dense"]
    assert rowpass.launches("scan_pass", since=before[1]) == arms["dense"]
    assert rowpass.launches("frontier_rows", since=before[1]) >= (
        arms["sparse"] + arms["dense"] + arms["count"])
    assert loop.launches("prime", since=before[2]) == 9
    assert loop.launches("turn", since=before[2]) == turns
    assert gpu.state.p.device.type == "cuda"
    n, w, head = gpu.n, gpu.scfg.window, gpu.head
    hs, hd = gpu.stream_src[head - w:head], gpu.stream_dst[head - w:head]
    p = gpu.state.p[:n].double().cpu().numpy()
    if mode == REVERSE:
        exact = exact_ppr_columns(hs, hd, n, [0, 5, 9], 0.15, tol=1e-12, device=dev)
        assert np.abs(p - exact.T).max() <= 2e-6
        np.testing.assert_allclose(p, cpu.state.p[:n].numpy(), rtol=0, atol=1e-5)
    else:
        exact = exact_ppr(hs, hd, n, [0, 5, 9], 0.15, tol=1e-12, device=dev)
        assert max(np.abs(p[:, j] - pi).sum() for j, pi in enumerate(exact)) <= 1e-6 * w
        mass = p.sum(0) + gpu.state.r[:n].double().cpu().numpy().sum(0)
        assert np.abs(mass - 1.0).max() <= 1e-3
        assert settled_distance(gpu.state, cpu.state, 0.15) <= 1e-5


@pytest.mark.cuda
def test_hybrid_checkpoint_on_card(tmp_path):
    """A hybrid checkpoint saved on the card loads on the card and on the
    CPU with the writer's tuning; one slide each: the same state to 1e-5
    (the scatters use atomics on CUDA); the loaded driver on the card runs
    its slide as one loop graph launch and one read."""
    dev = _cuda()
    a, _ = _hybrid_pair(dev, 0, True, ecap=64)
    a.seed()
    list(a.run(4))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, a)
    b = load_checkpoint(path, a.stream_src, a.stream_dst)
    c = load_checkpoint(path, a.stream_src, a.stream_dst, device="cpu")
    assert b.device.type == "cuda" and c.device.type == "cpu"
    for d in (b, c):
        assert isinstance(d, HybridStreamDriver) and d.ov_count == 0
        for attr in TUNING:
            assert getattr(d, attr) == getattr(a, attr), attr
        assert d.ecap == 64
    for d in (a, b, c):
        list(d.run(1))
    summary = b.round_graphs.summary()
    assert summary["loop_launches"] == summary["reads"] == 1
    for d in (b, c):
        assert settled_distance(a.state, d.state, 0.15) <= 1e-5


@pytest.mark.cuda
def test_cli_hybrid_engine_on_card(tmp_path, capsys):
    """``stream --engine hybrid`` with ``--f64`` on the card exits before any
    work (its kernels take f32); in f32 it runs both modes, each loop a loop
    graph under K4 (its prime launched once a loop: the seed's and 2
    slides'), and ``retrieve --from-checkpoint`` reads its file, pushing
    nothing."""
    import json

    from pprx_torch import cli
    from pprx_torch.engine import loop
    from pprx_torch.graph.io import save_packed

    _cuda()
    graph, ck = str(tmp_path / "g.npz"), str(tmp_path / "ck.npz")
    save_packed(graph, *synthetic_powerlaw_stream(50, 600, seed=1))
    argv = ["stream", graph, "--window", "300", "--slide", "30", "--steps", "2", "--engine",
            "hybrid", "--queries", "0,3", "--log", str(tmp_path / "log.jsonl")]
    before, k4 = segsum.launches(), dict(loop.LAUNCHES)
    with pytest.raises(SystemExit, match="the hybrid engine's kernels .* take f32 only"):
        cli.main([*argv, "--f64"])
    assert segsum.launches() == before and loop.launches(since=k4) == 0
    for extra in (["--mode", "rev"], ["--checkpoint", ck, "--checkpoint-every", "2"]):
        k4 = dict(loop.LAUNCHES)
        cli.main([*argv, *extra])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["steps"] == 2 and out["device"] == torch.cuda.get_device_name(0)
        assert loop.launches("prime", k4) == 3 and loop.launches("turn", k4) > 3
    before, k4 = segsum.launches(), dict(loop.LAUNCHES)
    cli.main(["retrieve", graph, "--from-checkpoint", ck, "--k", "5"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["batch"] == 2 and len(out["top1"]) == 2
    assert segsum.launches() == before and loop.launches(since=k4) == 0


# ---- the convergence rounds as captured CUDA graphs (pprx_torch.engine.graphs)

ROUND_KINDS = ["first", "scan", "stats", "compact0", "compact1", "compact2",
               "compact0_sorted", "compact1_sorted", "compact2_sorted"]


def _graph_driver(dev, mode: int, bf16d: bool) -> FastStreamDriver:
    """A driver mid-stream at a size whose ladder has three tiers (N=20k,
    W=200k, b=20k, S=16: (1,250, 2,560, 640), (5,000, 10,240, 2,560),
    (20,001, 40,960, 10,240))."""
    n, w, b = 20_000, 200_000, 20_000
    src, dst, n = synthetic_powerlaw_stream(n, w + 4 * b, seed=5)
    drv = FastStreamDriver(src, dst, n, list(range(16)), PprConfig(alpha=0.15, eps=1e-6),
                           StreamConfig(window=w, slide=b), mode=mode, rebuild_every=3,
                           bf16d=bf16d, device=dev)
    assert len(drv.tiers) == 3
    drv.seed()
    list(drv.run(2))
    return drv


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ROUND_KINDS)
@pytest.mark.parametrize("bf16d", [False, True])
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_round_replay_matches_the_eager_round(monkeypatch, mode, bf16d, kind):
    """One round replayed from its captured graph against the same round
    function run eagerly on the same inputs (state, candidate list,
    counters), with the launches it counts. The scan round, the stats, the
    first count and the compact rounds whose delivery is sorted (the
    segment-sum kernel; ``SORT_DELIVER_MIN`` lowered) are deterministic and
    must agree bit for bit; an unsorted compact round scatters through
    ``index_add_`` atomics, whose f32 sums may differ in the last bits:
    within 1e-6 (entries are at most 1), counters equal."""
    from pprx_torch.engine import wl2
    from pprx_torch.engine.graphs import RoundGraphs

    dev = _cuda()
    if kind.endswith("_sorted"):
        monkeypatch.setattr(wl2, "SORT_DELIVER_MIN", 1)
    drv = _graph_driver(dev, mode, bf16d)
    st, kg, cfg, n = drv.state, drv.graph, drv.cfg, drv.n
    g = RoundGraphs(n, drv.tiers[-1][0], dev)
    g.bind(st, kg)
    g.c0n.fill_(int(g.cand.shape[0]))
    wl2._stats_step(st, kg, cfg, g)  # the current frontier as the list
    if kind == "first":
        fn = lambda: wl2.first_count(kg, g)  # noqa: E731
    elif kind == "scan":
        fn = lambda: wl2._scan_step(st, kg, cfg, g, bf16d)  # noqa: E731
    elif kind == "stats":
        fn = lambda: wl2._stats_step(st, kg, cfg, g)  # noqa: E731
    else:
        i = int(kind[7])
        tier = drv.tiers[i]
        rescan = tier[1] + tier[2] > max(n // 2, 4096)
        emit_w = n + 1 if rescan else drv.tiers[min(i + 1, 2)][0]
        fn = lambda: wl2._compact_step(st, kg, cfg, g, tier, emit_w, rescan)  # noqa: E731
    saved = [t.clone() for t in (st.p, st.r, g.cand, g.counts)]

    def put_back():
        for t, s in zip((st.p, st.r, g.cand, g.counts), saved):
            t.copy_(s)

    def taken():
        torch.cuda.synchronize()
        return [t.clone() for t in (st.p, st.r, g.cand, g.counts)]

    before = dict(segsum.LAUNCHES)
    fn()
    eager, eager_launches = taken(), segsum.launches(since=before)
    put_back()
    g.run(kind, fn)  # the warm-up (the round itself), then the capture
    assert (g.captures, g.eager, g.replays) == (1, 1, 0)
    put_back()
    before = dict(segsum.LAUNCHES)
    g.run(kind, fn)
    replayed = taken()
    assert g.replays == 1 and segsum.launches(since=before) == eager_launches
    if kind in ("scan",) or kind.endswith("_sorted"):
        assert eager_launches > 0
    exact = not kind.startswith("compact") or kind.endswith("_sorted")
    for a, b in zip(replayed, eager):
        if exact or not a.is_floating_point():
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_kernel_launch_lands_in_the_graph():
    """The ctypes entry launches on the capturing stream, so its kernel is
    a node of the graph: each replay adds the segment sum once more into
    ``rin`` (a kernel missing from the graph would leave ``rin`` as the
    warm-up left it), and each replay counts one launch."""
    from pprx_torch.engine.graphs import RoundGraphs

    dev = _cuda()
    rng = np.random.default_rng(4)
    n_rows, w, s = 3000, 60_000, 128
    seg = torch.from_numpy(np.sort(rng.integers(0, n_rows, w)).astype(np.int32)).to(dev)
    off = row_offsets(seg, n_rows)
    table = torch.from_numpy(rng.random((500, s), dtype=np.float32)).to(dev)
    gat = torch.from_numpy(rng.integers(0, 500, w).astype(np.int32)).to(dev)
    rin = torch.zeros(n_rows, s, device=dev)
    once = segsum_gather_add_plain(torch.zeros(n_rows, s, dtype=torch.float64, device=dev),
                                   table.double(), gat, off)
    g = RoundGraphs(10, 10, dev)
    before = dict(segsum.LAUNCHES)
    for _ in range(3):
        g.run("sum", lambda: segsum_gather_add_(rin, table, gat, off))
    torch.cuda.synchronize()
    assert (g.eager, g.replays) == (1, 2) and segsum.launches(since=before) == 3
    torch.testing.assert_close(rin.double(), 3 * once, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_failed_capture_raises():
    """A host sync inside a captured step (an ``int()`` of a device count
    in a seed's first count, the loop's prologue) makes its warm-up capture
    fail, and the failure raises: nothing ran eagerly, nothing was
    captured, and there is no fall-back to eager launches or to the host
    loop. In a process of its own, so that a failed capture leaves nothing
    behind for the other tests."""
    import subprocess
    import sys
    import textwrap

    _cuda()
    prog = textwrap.dedent("""
        import torch
        from pprx_torch.config import PprConfig, StreamConfig
        from pprx_torch.engine import wl2
        from pprx_torch.graph.fast_stream import FastStreamDriver
        from pprx_torch.graph.io import synthetic_powerlaw_stream

        first = wl2.first_count

        def with_a_sync(kg, g):
            first(kg, g)
            int(g.counts[0])

        wl2.first_count = with_a_sync
        src, dst, n = synthetic_powerlaw_stream(300, 2000, seed=3)
        drv = FastStreamDriver(src, dst, n, [0, 5], PprConfig(alpha=0.15, eps=1e-6),
                               StreamConfig(window=1000, slide=100), rebuild_every=2,
                               device="cuda")
        try:
            drv.seed()
        except RuntimeError as e:
            print("RAISED", drv.round_graphs.eager, drv.round_graphs.captures, repr(e)[:300])
        else:
            print("NO ERROR", drv.round_graphs.summary())
    """)
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("RAISED 0 0"), proc.stdout + proc.stderr[-3000:]


@pytest.mark.cuda
def test_driver_rounds_replay_once_captured():
    """A driver's slides after its loops are built run by launches alone:
    the same slides again from a restored snapshot capture nothing new, run
    no step eagerly, launch one loop graph a slide with one read each, run
    a branch a round, and land where the first pass landed (within the
    atomics' last bits, settled); the buffers keep their addresses
    throughout."""
    from pprx_torch.bench import headline
    from pprx_torch.engine.graphs import tensor_ptrs

    dev = _cuda()
    drv = _graph_driver(dev, 0, False)
    ptrs = tensor_ptrs(drv.state) + tensor_ptrs(drv.graph)
    snap = headline.snapshot(drv)
    first = [st.rounds for st in drv.run(2)]
    end = headline.snapshot(drv)
    g0 = drv.round_graphs.summary()
    headline.restore(drv, snap)
    stats = list(drv.run(2))
    again = [st.rounds for st in stats]
    g1 = drv.round_graphs.summary()
    assert tensor_ptrs(drv.state) + tensor_ptrs(drv.graph) == ptrs
    assert (g1["captures"], g1["eager_rounds"]) == (g0["captures"], g0["eager_rounds"])
    assert g1["loop_launches"] - g0["loop_launches"] == 2
    assert [st.syncs for st in stats] == [1, 1]
    assert g1["branch_execs"] - g0["branch_execs"] >= sum(again)
    assert abs(sum(again) - sum(first)) <= 1
    assert settled_distance(drv.state, end[0], 0.15) <= 1e-5


def _tensors(obj) -> list:
    """Every tensor of a dataclass of tensors (nested too), in field order."""
    import dataclasses

    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out.extend(_tensors(v))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["slide", "rebuild"])
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_slide_prologue_replay_matches_eager(mode, part):
    """A slide's prologue (sorts, corrections, kills, ring writes, fresh
    re-sort, first list and counts; the reverse one launches the row-sum
    sweep) and the kill graph's rebuild, each replayed from its captured
    graph, against the same function run eagerly from the same driver
    state: every integer tensor of the kill graph and of the round buffers
    bit for bit, ``p`` and ``r`` within 1e-6 (the corrections scatter
    through ``index_add_`` atomics), and the same launches counted."""
    from pprx_torch.bench import headline
    from pprx_torch.engine.graphs import RoundGraphs
    from pprx_torch.engine.wl2 import rebuild_kill_graph_
    from pprx_torch.graph import fast_stream

    dev = _cuda()
    drv = _graph_driver(dev, mode, False)
    b, w, h = drv.scfg.slide, drv.scfg.window, drv.head
    g = RoundGraphs(drv.n, drv.tiers[-1][0], dev)
    g.bind(drv.state, drv.graph)
    pack = torch.from_numpy(np.concatenate([
        drv.stream_src[h:h + b], drv.stream_dst[h:h + b], [h % w, drv.fcnt]]).astype(np.int32)
    ).to(dev)
    if part == "slide":
        fn = lambda: fast_stream._slide_prologue(drv.state, drv.graph, pack, drv.cfg, g)  # noqa: E731
    else:
        fn = lambda: rebuild_kill_graph_(drv.graph, drv.mode, drv.fring)  # noqa: E731
    snap = headline.snapshot(drv)
    bufs = (g.cand, g.counts, g.c0n)
    saved = [t.clone() for t in bufs]

    def put_back():
        headline.restore(drv, snap)
        for t, s in zip(bufs, saved):
            t.copy_(s)

    def taken():
        torch.cuda.synchronize()
        return [t.clone() for t in (*_tensors(drv.state), *_tensors(drv.graph), *bufs)]

    before = dict(segsum.LAUNCHES)
    fn()
    eager, eager_launches = taken(), segsum.launches(since=before)
    put_back()
    g.run(part, fn)
    put_back()
    before = dict(segsum.LAUNCHES)
    g.run(part, fn)
    replayed = taken()
    assert (g.eager, g.captures, g.replays) == (1, 1, 1)
    assert segsum.launches(since=before) == eager_launches == (2 if (part, mode) == (
        "slide", REVERSE) else 0)
    if part == "slide":
        assert not torch.equal(eager[1], snap[0].r)  # the corrections moved r
    for a, e in zip(replayed, eager):
        if a.is_floating_point():
            torch.testing.assert_close(a, e, rtol=0, atol=1e-6)
        else:
            assert torch.equal(a, e)


@pytest.mark.cuda
def test_driver_on_an_explicit_index_replays_its_rounds(monkeypatch):
    """A driver built on an explicit device index (the last card) while
    the current device is card 0 captures and launches on its own card's
    stream: two slides run by loop graphs from a snapshot land where the
    same two slides land under the host loop with every step run eagerly
    (rounds within 1, settled within 1e-5), and the loops moved the state.
    A capture recorded on another card's stream would leave it alone."""
    from pprx_torch.bench import headline
    from pprx_torch.engine.graphs import RoundGraphs

    _cuda()
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    with torch.cuda.device(0):
        drv = _graph_driver(dev, 0, False)
        list(drv.run(1))
        snap = headline.snapshot(drv)
        g0 = drv.round_graphs.summary()
        replayed = [st.rounds for st in drv.run(2)]
        g1 = drv.round_graphs.summary()
        end = headline.snapshot(drv)
        assert g1["loop_launches"] - g0["loop_launches"] == len(replayed)
        assert g1["branch_execs"] - g0["branch_execs"] >= sum(replayed)
        assert settled_distance(end[0], snap[0], 0.15) > 1e-4
        headline.restore(drv, snap)
        monkeypatch.setattr(RoundGraphs, "run", lambda g, key, fn: fn())
        monkeypatch.setattr(RoundGraphs, "loop", RoundGraphs.host_loop)
        eager = [st.rounds for st in drv.run(2)]
        torch.cuda.synchronize(dev)
    assert abs(sum(eager) - sum(replayed)) <= 1
    assert settled_distance(drv.state, end[0], 0.15) <= 1e-5


# ---- the loop on the card: K4 and the loop graphs (pprx_torch.engine.loop)

@pytest.mark.cuda
def test_k4_matches_its_plain_steps_on_the_table():
    """K4's three kernels against their plain steps on every case of the
    smoke script's table of carries, each case through the kernel the loop
    graph launches for it (``chip_smoke.k4_launch``: a ``decide`` case is a
    turn with no round pending, a ``tally`` case a turn with one): the
    whole carry equal (decisions, tallies, log), so each branch choice; one
    launch counted a case, by kernel."""
    import chip_smoke
    from pprx_torch.engine import loop

    dev = _cuda()
    before = dict(loop.LAUNCHES)
    launched = dict.fromkeys(loop.STEPS, 0)
    for case in chip_smoke.K4_CASES:
        step, carry, counts = chip_smoke.k4_launch(case)
        want = carry.clone()
        loop.step_(step, want, counts, chip_smoke.k4_table(case))
        got = carry.to(dev)
        loop.step_(step, got, counts.to(dev), chip_smoke.k4_table(case))
        assert torch.equal(got.cpu(), want), case[0]
        launched[step] += 1
    assert {step: loop.launches(step, since=before) for step in loop.STEPS} == launched
    assert launched["turn"] == sum(case[1] in ("decide", "tally", "turn")
                                   for case in chip_smoke.K4_CASES)
    with pytest.raises(ValueError, match="no kernel"):
        loop.step_("decide", carry.to(dev), counts.to(dev), chip_smoke.K4_TABLE)


@pytest.mark.cuda
@pytest.mark.parametrize("c0ok, max_rounds", [(False, 9), (False, 1), (True, 9), (False, 0)])
def test_loop_graph_leaves_the_host_loops_carry(monkeypatch, c0ok, max_rounds):
    """A loop graph of the smoke script's fill-kernel branches (every round
    leaves an active pair) against the host loop on the same branches: a
    loop cut at its cap, a one-round loop, and two that ``prime`` stops (a
    valid empty list, no round allowed) leave the same carry head and round
    log; a loop that runs launches ``turn`` its rounds + 1 times, one that
    ``prime`` stops none. Each branch counts its own runs on the card: the
    SWITCH given a value past its arms, where the loop ends, runs none."""
    import chip_smoke
    from pprx_torch.engine import graphs, loop
    from pprx_torch.engine.graphs import RoundGraphs

    dev = _cuda()
    monkeypatch.setattr(graphs, "LOG_SINK", [])
    runs = {}
    for tag in ("device", "host"):
        g = RoundGraphs(8, 8, dev)
        hits = torch.zeros(3, dtype=torch.int64, device=dev)
        branches = [(key, lambda fn=fn, i=i: (fn(), hits[i:i + 1].add_(1)))
                    for i, (key, fn) in enumerate(chip_smoke.fill_branches(g))]
        loop_fn = g.loop if tag == "device" else g.host_loop
        before = dict(loop.LAUNCHES)
        values, reads = loop_fn(None, branches, chip_smoke.FILL_TABLE, c0ok, max_rounds)
        torch.cuda.synchronize(dev)
        runs[tag] = (values[:loop.HEAD], loop.log_rows(values),
                     {step: loop.launches(step, since=before) for step in loop.STEPS})
        assert hits.tolist() == values[loop.EXECS:loop.EXECS + 3], tag
    (head, rows, launched), (host_head, host_rows, _) = runs["device"], runs["host"]
    assert head == host_head and rows == host_rows
    rounds = head[loop.ROUNDS]
    assert rounds == (0 if c0ok else max_rounds)
    assert launched == {"prime": 1, "turn": rounds + 1 if rounds else 0,
                        "after_scan": int(rounds > 0)}


@pytest.mark.cuda
def test_loop_graph_runs_its_branches_as_k4_picks_them():
    """A loop graph of one-kernel branches (the smoke script's
    ``loop_overhead``): from an invalid list one scan, its stats, then tier
    rounds up to the cap, each counted in the carry, with one read."""
    import chip_smoke

    res = chip_smoke.loop_overhead(_cuda(), rounds=33)
    assert res["loop_round_ms"] > 0 and res["graph_kernel_floor_ms"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_device_loop_slides_seed_and_refine_hold_the_contract(monkeypatch, mode):
    """A seed, slides, a refine and serve's budgeted refine (6 rounds), each
    one loop graph on the card: one read a loop (``syncs`` 1), one loop
    launch a slide and the rebuild's graph beside it where one is due, each
    loop's round log replayed through the plain ``decide`` and
    ``after_scan``, and the state held to exact PPR (forward: L1 within
    eps * W a source; reverse: within 2 eps of the columns of M)."""
    from pprx_torch.engine import graphs, loop

    dev = _cuda()
    sink = []
    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    w, b = 20_000, 200
    src, dst, n = synthetic_powerlaw_stream(2000, w + 12 * b, seed=2)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    queries = list(range(16))
    drv = FastStreamDriver(src, dst, n, queries, cfg, StreamConfig(window=w, slide=b),
                           mode=mode, rebuild_every=4, device=dev)
    g = drv.round_graphs
    stats = [drv.seed()]
    rebuilds = 0
    for _ in range(10):
        s0 = g.summary()
        rebuild = drv.fcnt + b > drv.fring
        stats += list(drv.run(1))
        s1 = g.summary()
        rebuilds += rebuild
        assert s1["loop_launches"] - s0["loop_launches"] == 1
        assert (s1["replays"] + s1["eager_rounds"]) - (s0["replays"] + s0["eager_rounds"]) == (
            rebuild)
    assert rebuilds >= 2
    stats.append(drv.refine(1e-7))
    stats.append(drv.refine(5e-8, rounds=6))
    assert stats[-1].rounds <= 6 and all(st.syncs == 1 for st in stats)
    assert len(sink) == len(stats)
    for rec, st in zip(sink, stats):
        rows = rec["rows"]
        assert len(rows) == st.rounds and sum(r[7] for r in rows) == st.stats_reads
        assert loop.replay_log(rows, rec["table"], rec["max_rounds"]) == [
            (r[0], r[7]) for r in rows]
    p = drv.state.p[:n].cpu().double().numpy()
    if mode == REVERSE:
        cols = exact_ppr_columns(drv.hsrc, drv.hdst, n, queries, cfg.alpha, device=dev)
        assert np.abs(p - cols.T).max() <= 2 * cfg.eps
    else:
        exact = exact_ppr(drv.hsrc, drv.hdst, n, queries, cfg.alpha, tol=1e-11, device=dev)
        for j, pi in enumerate(exact):
            assert np.abs(p[:, j] - pi).sum() <= cfg.eps * w


# ---- the sharded wl engine's loop at 1x1 (pprx_torch.dist.wl): one loop
# graph a loop, K4 under the sharded rule

@pytest.mark.cuda
def test_k4_sharded_rule_equals_its_plain_steps():
    """K4 under the sharded wl engine's rule (``chip_smoke.K4_SHARDED``: the
    first round runs whatever the list, the stats-skip reads ``ewr``)
    against its plain steps on each ``sharded_*`` case, through the kernel
    the loop graph launches for it (``chip_smoke.k4_launch``): the whole
    carry equal."""
    import chip_smoke
    from pprx_torch.engine import loop

    dev = _cuda()
    cases = [c for c in chip_smoke.K4_CASES if c[0].startswith("sharded_")]
    assert len(cases) >= 10
    for case in cases:
        name = case[0]
        step, carry, counts = chip_smoke.k4_launch(case)
        assert chip_smoke.k4_table(case).sharded and counts.numel() == loop.N_COUNTS
        want = carry.clone()
        loop.step_(step, want, counts, chip_smoke.K4_SHARDED)
        got = carry.to(dev)
        loop.step_(step, got, counts.to(dev), chip_smoke.K4_SHARDED)
        assert torch.equal(got.cpu(), want), name


def _sharded_driver(dev, mode, engine="wl"):
    from pprx_torch.dist.mesh import make_row_mesh
    from pprx_torch.dist.stream import ShardedStreamDriver

    w, b = 20_000, 200
    src, dst, n = synthetic_powerlaw_stream(2000, w + 10 * b, seed=2)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    return ShardedStreamDriver(src, dst, n, list(range(16)), cfg, StreamConfig(window=w, slide=b),
                               make_row_mesh(1, 1), mode=mode, engine=engine, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_sharded_device_loop_gives_the_host_loops_rounds(monkeypatch, mode):
    """``ShardedStreamDriver(engine="wl")`` at 1x1 on the card, a seed and 8
    slides (a rebuild every 2): each loop one loop graph launch and one
    read, its round log replayed through the plain steps under the sharded
    rule; the same run with the loop forced onto the host
    (``RoundGraphs.host_loop``, the branches replayed one by one) gives the
    same rounds a loop; both states held to exact PPR (forward: L1 within
    eps * W a source; reverse: within 2 eps of the columns of M)."""
    from pprx_torch.engine import graphs, loop
    from pprx_torch.engine.graphs import RoundGraphs

    dev = _cuda()
    sink = []
    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    runs = {}
    for tag in ("device", "host"):
        if tag == "host":
            monkeypatch.setattr(RoundGraphs, "loop", RoundGraphs.host_loop)
        drv = _sharded_driver(dev, mode)
        rounds = [drv.seed()["rounds"]] + [st["rounds"] for st in drv.run(8)]
        runs[tag] = (drv, rounds, drv.eng.round_graphs.summary())
    (drv, rounds, g), (host, host_rounds, hg) = runs["device"], runs["host"]
    assert rounds == host_rounds
    assert g["loop_launches"] == g["reads"] == 9 and hg["loop_launches"] == 0
    assert len(sink) == 9 and [len(rec["rows"]) for rec in sink] == rounds
    for rec in sink:
        assert rec["table"].sharded
        assert loop.replay_log(rec["rows"], rec["table"], rec["max_rounds"]) == [
            (row[0], row[7]) for row in rec["rows"]]
    w, head = drv.scfg.window, drv.head
    hs, hd = drv.stream_src[head - w:head], drv.stream_dst[head - w:head]
    for d in (drv, host):
        p = d.host_p()[:d.n].astype(np.float64)
        if mode == REVERSE:
            cols = exact_ppr_columns(hs, hd, d.n, list(range(16)), d.cfg.alpha, device=dev)
            assert np.abs(p - cols.T).max() <= 2 * d.cfg.eps
        else:
            exact = exact_ppr(hs, hd, d.n, list(range(16)), d.cfg.alpha, tol=1e-11, device=dev)
            for j, pi in enumerate(exact):
                assert np.abs(p[:, j] - pi).sum() <= d.cfg.eps * w


@pytest.mark.cuda
def test_sharded_failed_capture_raises():
    """A host sync inside the sharded engine's captured first count (the
    seed loop's prologue) makes its warm-up capture fail, and the failure
    raises: nothing ran eagerly, nothing was captured, no loop ran on the
    host. In a process of its own, as ``test_failed_capture_raises``."""
    import subprocess
    import sys
    import textwrap

    _cuda()
    prog = textwrap.dedent("""
        import torch
        from pprx_torch.config import PprConfig, StreamConfig
        from pprx_torch.dist import wl
        from pprx_torch.dist.mesh import make_row_mesh
        from pprx_torch.dist.stream import ShardedStreamDriver
        from pprx_torch.engine.graphs import RoundGraphs
        from pprx_torch.graph.io import synthetic_powerlaw_stream

        first = wl.ShardedWlEngine._first_count

        def with_a_sync(self, snap):
            first(self, snap)
            int(self.round_graphs.counts[0])

        def refused(*args, **kw):
            raise AssertionError("a loop ran on the host")

        wl.ShardedWlEngine._first_count = with_a_sync
        RoundGraphs.host_loop = refused
        src, dst, n = synthetic_powerlaw_stream(300, 2000, seed=3)
        drv = ShardedStreamDriver(src, dst, n, [0, 5], PprConfig(alpha=0.15, eps=1e-6),
                                  StreamConfig(window=1000, slide=100), make_row_mesh(1, 1),
                                  engine="wl", device="cuda")
        g = drv.eng.round_graphs
        try:
            drv.seed()
        except RuntimeError as e:
            print("RAISED", g.eager, g.captures, g.loop_launches, repr(e)[:300])
        else:
            print("NO ERROR", g.summary())
    """)
    proc = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("RAISED 0 0 0"), proc.stdout + proc.stderr[-3000:]


# ---- the row passes (pprx_torch.engine.rowpass): K2 and K3 on the card

ROW_WIDTHS = [3, 8, 16, 128]


def _row_state(dev, s: int, forward: bool, rows: int = 20_001, seed: int = 0):
    """A state on power-law out-degrees (dangling rows among them, the
    phantom row last): ``|r|`` below twice each row's threshold, a few
    hundred entries exactly at it, ``p`` >= 0; and row lengths."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, size=rows) - 1, 5000).astype(np.int32)
    deg[-1] = 0
    assert (deg[:-1] == 0).any()
    deg_t = torch.from_numpy(deg).to(dev)
    th = (1e-6 * deg_t.clamp(min=1).float()) if forward else torch.full((rows,), 1e-6, device=dev)
    r = torch.from_numpy(rng.uniform(-2, 2, (rows, s)).astype(np.float32)).to(dev) * th[:, None]
    at = torch.from_numpy(rng.integers(0, (rows - 1) * s, 300)).to(dev)
    r.view(-1)[at] = th.repeat_interleave(s)[at]
    r[-1] = 0.0
    p = torch.from_numpy(rng.random((rows, s), dtype=np.float32) * 1e-3).to(dev)
    f_len = torch.from_numpy(rng.integers(0, 4, rows).astype(np.int32)).to(dev)
    return p, r, deg_t, f_len


def _scan(fn, p, r, deg, forward, mdt):
    p, r = p.clone(), r.clone()
    moving = torch.empty(r.shape, dtype=mdt, device=r.device)
    counts = torch.zeros(2, dtype=torch.int64, device=r.device)
    row_act = None if forward else torch.empty(r.shape[0], dtype=torch.int32, device=r.device)
    fn(p, r, deg, moving, counts, row_act, eps=1e-6, alpha=0.15, forward=forward)
    return [p, r, moving, counts] + ([] if forward else [row_act])


@pytest.mark.cuda
@pytest.mark.parametrize("mdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", ROW_WIDTHS)
@pytest.mark.parametrize("forward", [True, False])
def test_scan_pass_kernel_is_the_plain_version_bit_for_bit(forward, s, mdt):
    """K2 against ``scan_pass_plain`` on the card: p, r, moving (f32, or
    bf16 rounded to nearest even), the counts and each row's count, bit for
    bit, with entries exactly at the threshold and dangling rows; two
    launches agree; one launch counted a call."""
    from pprx_torch.engine import rowpass

    dev = _cuda()
    p, r, deg, _ = _row_state(dev, s, forward)
    before = rowpass.launches()
    got = _scan(rowpass.scan_pass_, p, r, deg, forward, mdt)
    again = _scan(rowpass.scan_pass_, p, r, deg, forward, mdt)
    plain = _scan(rowpass.scan_pass_plain, p, r, deg, forward, mdt)
    torch.cuda.synchronize()
    assert rowpass.launches() == before + 2
    assert 0 < int(got[3][0]) < r[:-1].numel()
    for a, b, c in zip(got, again, plain):
        assert a.dtype == c.dtype and torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [5, 20_001])
@pytest.mark.parametrize("s", ROW_WIDTHS)
@pytest.mark.parametrize("forward", [True, False])
def test_frontier_rows_kernel_is_the_plain_version(forward, s, rows):
    """K3 against ``frontier_rows_plain`` on ``r[:n]``, on states with whole
    rows of zeros and entries exactly at the threshold, and on fewer rows
    than one warp step holds: the rows and the three counts equal; two
    launches agree; each call counted once."""
    from pprx_torch.engine import rowpass

    dev = _cuda()
    p, r, deg, f_len = _row_state(dev, s, forward, rows=rows, seed=1)
    r[::7] = 0.0  # whole rows with nothing active
    view = (r[:-1], deg[:-1], deg[:-1], f_len[:-1])
    before = rowpass.launches("frontier_rows")
    got = rowpass.frontier_rows(*view, eps=1e-6, forward=forward)
    again = rowpass.frontier_rows(*view, eps=1e-6, forward=forward)
    plain = rowpass.frontier_rows_plain(*view, eps=1e-6, forward=forward)
    torch.cuda.synchronize()
    assert rowpass.launches("frontier_rows") == before + 2
    if rows > 5:
        assert 0 < int(got[1]) < rows - 1
    for a, b, c in zip(got, again, plain):
        assert a.dtype == c.dtype and torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16d", [False, True])
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_sharded_dense_round_launches_each_row_pass_once(mode, bf16d):
    """ShardedWlEngine.push_wl at mesh 1x1 on the card, from a state with
    work at every row's threshold on a graph with dangling rows and a ladder
    so small that most rounds are dense: each dense round launches
    ``scan_pass`` once and ``frontier_rows`` at most once, no other round
    either; the state is the CPU's (f64, plain versions) within 1e-5 in
    ``p + alpha r`` (f32, and with bf16 delivery the rounding of the moved
    mass)."""
    from pprx_torch.dist.mesh import make_row_mesh
    from pprx_torch.dist.wl import ShardedWlEngine
    from pprx_torch.engine import rowpass
    from pprx_torch.engine.state import PprState
    from _torch_dist_worker import graph, threshold_state  # tests/ is on the path

    dev = _cuda()
    src, dst, n = graph("dangling", 5, 2000, 20_000)
    s, eps = 16, 1e-6
    out = {}
    for tag, device, dtype in (("card", dev, torch.float32), ("cpu", "cpu", torch.float64)):
        eng = ShardedWlEngine(make_row_mesh(1, 1), n, s, ecap=src.size, bcap=8,
                              cfg=PprConfig(alpha=0.15, eps=eps, max_rounds=10_000), mode=mode,
                              dtype=dtype, e_top=1024, fring=1024, bf16d=bf16d, device=device)
        deg, _, _, _, _, snap = eng.device_graph_wl(src, dst)
        p, r = (torch.from_numpy(a).to(device=device, dtype=dtype) for a in threshold_state(
            n, eng.n_pad, src, s, eps, mode == 0, 11))
        rowpass.reset_launches()
        p, r, rounds, *_ = eng.push_wl(p, r, deg, snap)
        torch.cuda.synchronize()
        out[tag] = (PprState(p=p[:n], r=r[:n], mode=mode), dict(rowpass.LAUNCHES),
                    dict(eng.round_kinds))
    (card, launched, kinds), (cpu, _, _) = out["card"], out["cpu"]
    assert kinds["dense"] >= 2 and launched["scan_pass"] == kinds["dense"]
    assert 1 <= launched["frontier_rows"] <= kinds["dense"]
    assert settled_distance(PprState(p=card.p.cpu().double(), r=card.r.cpu().double(),
                                     mode=mode), cpu, 0.15) <= 1e-5


@pytest.mark.cuda
def test_row_passes_refuse_on_card():
    """What the kernels do not take raises before a launch: an f64 state, an
    int64 degree, a strided view, a misaligned ``moving``, a bf16 ``r`` for
    K3; nothing is counted."""
    from pprx_torch.engine import rowpass

    dev = _cuda()
    p, r, deg, f_len = _row_state(dev, 8, True, rows=101)
    moving = torch.empty_like(r)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    kw = dict(eps=1e-6, alpha=0.15, forward=True)
    before = rowpass.launches()
    for args in ((p.double(), r.double(), deg, moving.double(), counts),
                 (p, r, deg.long(), moving, counts),
                 (p, torch.empty(101, 16, device=dev)[:, ::2], deg, moving, counts),
                 (p, r, deg, torch.empty(101 * 8 + 1, device=dev)[1:].view(101, 8), counts),
                 (p, r, deg, moving, counts.int())):
        with pytest.raises((TypeError, ValueError)):
            rowpass.scan_pass_(*args, **kw)
    with pytest.raises(TypeError):
        rowpass.frontier_rows(r.bfloat16(), deg, deg, f_len, eps=1e-6, forward=True)
    with pytest.raises(ValueError):
        rowpass.frontier_rows(r, deg.cpu(), deg, f_len, eps=1e-6, forward=True)
    assert rowpass.launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("forward", [True, False])
def test_row_passes_replay_as_eager_and_count_each_replay(forward):
    """Both row passes captured into one graph (``RoundGraphs.run``) and
    replayed: each replay's outputs equal an eager call's on the same
    inputs bit for bit, and each replay counts one launch of each kernel
    (the capture's own launches taken back)."""
    from pprx_torch.engine import rowpass
    from pprx_torch.engine.graphs import RoundGraphs

    dev = _cuda()
    p0, r0, deg, f_len = _row_state(dev, 16, forward, seed=2)
    p, r = p0.clone(), r0.clone()
    moving = torch.empty_like(r)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    out = {}

    def step():
        counts.zero_()
        rowpass.scan_pass_(p, r, deg, moving, counts, eps=1e-6, alpha=0.15, forward=forward)
        out["rows"] = rowpass.frontier_rows(r[:-1], deg[:-1], deg[:-1], f_len[:-1], eps=1e-7,
                                            forward=forward)

    g = RoundGraphs(10, 10, dev)
    g.run("rows", step)  # eager on a side stream, then the capture
    before = dict(rowpass.LAUNCHES)
    assert before["scan_pass"] >= 1
    p.copy_(p0), r.copy_(r0)
    g.run("rows", step)
    torch.cuda.synchronize()
    replayed = [t.clone() for t in (p, r, moving, counts, *out["rows"])]
    assert g.replays == 1
    assert {k: rowpass.LAUNCHES[k] - before[k] for k in before} == {
        "scan_pass": 1, "frontier_rows": 1}
    p.copy_(p0), r.copy_(r0)
    step()
    torch.cuda.synchronize()
    eager = [p, r, moving, counts, *out["rows"]]
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_reverse_corrections_in_place_round_as_out_of_place_on_card():
    """The reverse corrections in place on the card give the bits of the
    out-of-place arithmetic (``r + beta * (pp_new - pp_old)``: the product
    rounded, then the sum), on a batch whose scatter rows are distinct, so
    that no atomic order enters."""
    from pprx_torch.engine.state import PprState
    from pprx_torch.engine.update import apply_edge_batch_
    from pprx_torch.graph.dynamic import WindowGraph

    dev = _cuda()
    rng = np.random.default_rng(9)
    n, m, s, b = 2000, 20_000, 16, 200
    src = rng.integers(0, n, m)
    dst = (src + 1 + rng.integers(0, n - 1, m)) % n
    w = WindowGraph.from_coo(src, dst, n, device=dev)
    first = np.unique(src, return_index=True)[1][:b]  # one deleted edge a row
    del_src, del_dst = (torch.from_numpy(a[first]).to(dev) for a in (src, dst))
    ins_src = torch.from_numpy(rng.choice(n, b, replace=False)).to(dev)
    ins_dst = (ins_src + 1) % n
    p = torch.from_numpy(rng.random((n + 1, s), dtype=np.float32) * 1e-2).to(dev)
    r = torch.from_numpy(rng.normal(size=(n + 1, s)).astype(np.float32) * 1e-3).to(dev)
    p[-1] = r[-1] = 0.0
    rowsum = out_row_sums(p, w)
    d0 = w.deg.clone()
    deg_new = d0.clone()
    deg_new.index_add_(0, del_src.int(), torch.full((b,), -1, dtype=torch.int32, device=dev))
    deg_new.index_add_(0, ins_src.int(), torch.ones(b, dtype=torch.int32, device=dev))
    beta = (1.0 - 0.15) / 0.15
    pp_old = torch.where((d0 == 0)[:, None], p, rowsum / d0.clamp(min=1).float()[:, None])
    s_new = rowsum.index_add(0, del_src, p[del_dst], alpha=-1)
    s_new.index_add_(0, ins_src, p[ins_dst])
    pp_new = torch.where((deg_new == 0)[:, None], p, s_new / deg_new.clamp(min=1).float()[:, None])
    want = r + beta * (pp_new - pp_old)
    want[-1] = 0.0
    st = PprState(p=p.clone(), r=r.clone(), mode=REVERSE)
    apply_edge_batch_(st, w, ins_src, ins_dst, del_src, del_dst, PprConfig(alpha=0.15, eps=1e-6),
                      rowsum=rowsum)
    torch.cuda.synchronize()
    assert torch.equal(w.deg, deg_new) and torch.equal(st.p, p)
    assert torch.equal(st.r, want)


# ---- the dense engine on the card: its rounds on K2 and K1, its loop one
# conditional graph steered by K4 under the dense rule


def _dense_inputs(dev, mode, s=16, n=2000, m=20_000, seed=3):
    """A window on a power-law stream (dangling rows among them) with
    phantom padding, and the initial state of ``s`` queries."""
    from pprx_torch.graph.dynamic import WindowGraph

    src, dst, n = synthetic_powerlaw_stream(n, m, seed=seed)
    w = WindowGraph.from_coo(src, dst, n, capacity=m + 37, device=dev)
    return w, init_state(n, list(range(0, 5 * s, 5)), mode=mode, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_dense_loop_graph_leaves_the_host_loops_state(monkeypatch, mode):
    """``push_to_convergence`` on the card (one loop graph launch, one
    read) against the same push with ``RoundGraphs.loop`` forced to the
    host loop on the same card and inputs: the same rounds, pushes and edge
    pushes, and ``p`` and ``r`` bit for bit (the same kernels, K1 without
    atomics); each round launched K2 and K1 once, the loop K3 once (its
    first count), K4's prime once and turn R + 1 times. Pushed again from
    the converged state, the loop runs no round."""
    from pprx_torch.engine import loop, rowpass
    from pprx_torch.engine.graphs import RoundGraphs
    from pprx_torch.engine.push import push_to_convergence

    dev = _cuda()
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=10_000)
    w, st = _dense_inputs(dev, mode)
    before = (dict(segsum.LAUNCHES), dict(rowpass.LAUNCHES), dict(loop.LAUNCHES))
    g = RoundGraphs(w.n, 1, dev)
    _, stats = push_to_convergence(st, w, cfg, g)
    torch.cuda.synchronize()
    rounds = stats.rounds
    assert rounds > 1 and stats.syncs == 1 and g.summary()["loop_launches"] == 1
    assert segsum.launches("segsum_gather_add", since=before[0]) == rounds
    assert {k: rowpass.LAUNCHES[k] - before[1][k] for k in before[1]} == {
        "scan_pass": rounds, "frontier_rows": 1}
    assert {k: loop.LAUNCHES[k] - before[2][k] for k in before[2]} == {
        "prime": 1, "turn": rounds + 1, "after_scan": 0}
    again = push_to_convergence(st, w, cfg, g)[1]
    assert (again.rounds, again.syncs, g.summary()["loop_launches"]) == (0, 1, 2)
    w2, st2 = _dense_inputs(dev, mode)
    monkeypatch.setattr(RoundGraphs, "loop", RoundGraphs.host_loop)
    _, host = push_to_convergence(st2, w2, cfg)
    assert (host.rounds, host.pushes, host.edge_pushes) == (rounds, stats.pushes,
                                                            stats.edge_pushes)
    assert host.syncs == rounds + 1
    assert torch.equal(st.p, st2.p) and torch.equal(st.r, st2.r)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_dense_push_on_card_holds_exact_ppr(mode):
    """The dense loop on the card in f32 against exact PPR (f64 power
    iteration): forward L1 within eps * W of each source's row of M and
    the mass kept; reverse each target's column within 2 eps."""
    from pprx_torch.engine.push import push_to_convergence

    from pprx_torch.graph.dynamic import WindowGraph

    dev = _cuda()
    cfg = PprConfig(alpha=0.15, eps=1e-7, max_rounds=10_000)
    src, dst, n = synthetic_powerlaw_stream(300, 3000, seed=5)
    w = WindowGraph.from_coo(src, dst, n, device=dev)
    queries = [0, 7, 99]
    st = init_state(n, queries, mode=mode, device=dev)
    push_to_convergence(st, w, cfg)
    p = st.p[:n].double().cpu().numpy()
    if mode == REVERSE:
        exact = exact_ppr_columns(src, dst, n, queries, 0.15, tol=1e-12, device=dev)
        assert np.abs(p - exact.T).max() <= 2 * cfg.eps
    else:
        exact = exact_ppr(src, dst, n, queries, 0.15, tol=1e-12, device=dev)
        assert max(np.abs(p[:, j] - pi).sum() for j, pi in enumerate(exact)) <= cfg.eps * 3000
        assert abs(float(st.p.sum() + st.r.sum()) - len(queries)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("forward", [True, False])
def test_k1_and_k2_at_config4_width(forward):
    """Config 4's width, S = 512 (the wide layout round a warp's lanes four
    times): K2 bit for bit its plain version, f32 ``moving``, and K1's
    gather entry over a delivery-sorted power-law window within 1e-4 of
    its plain version's f64 sum (reverse with the per-row scale), two
    launches alike."""
    from pprx_torch.engine import rowpass
    from pprx_torch.engine.segsum import row_offsets, segsum_gather_add_plain

    dev = _cuda()
    s = 512
    p, r, deg, _ = _row_state(dev, s, forward, rows=5001, seed=4)
    got = _scan(rowpass.scan_pass_, p, r, deg, forward, torch.float32)
    plain = _scan(rowpass.scan_pass_plain, p, r, deg, forward, torch.float32)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    n = 5000
    src, dst, _ = synthetic_powerlaw_stream(n, 60_000, seed=4)
    sca, gat = (dst, src) if forward else (src, dst)
    order = np.argsort(sca, kind="stable")
    gat_t = torch.from_numpy(gat[order].astype(np.int32)).to(dev)
    off = row_offsets(torch.from_numpy(sca[order].astype(np.int32)).to(dev), n)
    table = got[2]
    scale = None if forward else 1.0 / deg[:n].clamp(min=1).float()
    rin = r[:n].contiguous()
    outs = [segsum_gather_add_(rin.clone(), table, gat_t, off, row_scale=scale)
            for _ in range(2)]
    ref = segsum_gather_add_plain(rin.double(), table.double(), gat_t, off,
                                  None if scale is None else scale.double())
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0].double(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k4_dense_rule_equals_its_plain_steps():
    """K4 under the dense rule: each ``dense_*`` case of the smoke script's
    table through the kernel the loop graph launches for it, whole carries
    equal; and one-arm loop graphs of fill-kernel branches (0 active at the
    start, one round, stopped at the cap, no round allowed) leave the host
    loop's carry (``chip_smoke.dense_loop_check``)."""
    import chip_smoke
    from pprx_torch.engine import loop

    dev = _cuda()
    cases = [c for c in chip_smoke.K4_CASES if c[0].startswith("dense_")]
    assert len(cases) == 12
    for case in cases:
        step, carry, counts = chip_smoke.k4_launch(case)
        want = carry.clone()
        loop.step_(step, want, counts, loop.DENSE_TABLE)
        got = carry.to(dev)
        loop.step_(step, got, counts.to(dev), loop.DENSE_TABLE)
        assert torch.equal(got.cpu(), want), case[0]
    res = chip_smoke.dense_loop_check(dev)
    assert res == {"0_active_5_rounds": 0, "1_active_1_rounds": 1, "1_active_7_rounds": 7,
                   "1_active_0_rounds": 0}


# ---- the sharded dense engine and wlp at 1x1 (pprx_torch.dist.sharded,
# pprx_torch.dist.wl): one loop graph a loop, K4 under the dense and the
# proportional rules

@pytest.mark.cuda
def test_k4_proportional_rule_equals_its_plain_steps():
    """K4 under the proportional rule (``chip_smoke.K4_PROPORTIONAL``: the
    tiers, the drain and the rescan, the pending carry in the counts'
    sixth slot) against its plain steps on each ``prop_*`` case, through
    the kernel the loop graph launches for it: the whole carry equal; and
    loop graphs of five-arm fill branches (a rescan then tiers to the cap,
    a drain that ends the loop, tiers to the cap, no round allowed) leave
    the host loop's carry (``chip_smoke.prop_loop_check``)."""
    import chip_smoke
    from pprx_torch.engine import loop

    dev = _cuda()
    cases = [c for c in chip_smoke.K4_CASES if c[0].startswith("prop_")]
    assert len(cases) == 18
    for case in cases:
        step, carry, counts = chip_smoke.k4_launch(case)
        assert chip_smoke.k4_table(case).proportional and counts.numel() == loop.N_COUNTS
        want = carry.clone()
        loop.step_(step, want, counts, chip_smoke.K4_PROPORTIONAL)
        got = carry.to(dev)
        loop.step_(step, got, counts.to(dev), chip_smoke.K4_PROPORTIONAL)
        assert torch.equal(got.cpu(), want), case[0]
    res = chip_smoke.prop_loop_check(dev)
    assert [v["rounds"] for v in res.values()] == [3, 1, 4, 0]


def _sharded_run(dev, mode, engine, tag, monkeypatch):
    """A seed and 8 slides of ``_sharded_driver``'s stream on ``engine`` at
    1x1: on the card's loop graphs, or (``tag`` "host") with
    ``RoundGraphs.loop`` forced onto the host loop, the same branches one
    by one. Returns (driver, each loop's (rounds, pushes, edge pushes), the
    round graphs' summary, launches by kernel entry)."""
    import chip_smoke
    from pprx_torch.engine.graphs import RoundGraphs

    if tag == "host":
        monkeypatch.setattr(RoundGraphs, "loop", RoundGraphs.host_loop)
    chip_smoke.reset_launches()
    drv = _sharded_driver(dev, mode, engine)
    stats = [drv.seed()] + list(drv.run(8))
    tallies = [(st["rounds"], st["pushes"], st["edge_pushes"]) for st in stats]
    return drv, tallies, drv.eng.round_graphs.summary(), chip_smoke.launches_by_entry()


def _exact_on_window(drv, dev) -> None:
    """Each query of a 1x1 driver held to exact PPR on the window it holds
    (forward L1 within eps * W; reverse within 2 eps of the columns of M)."""
    w, head = drv.scfg.window, drv.head
    hs, hd = drv.stream_src[head - w:head], drv.stream_dst[head - w:head]
    p = drv.host_p()[:drv.n].astype(np.float64)
    queries = list(range(drv.eng.s_total))
    if drv.mode == REVERSE:
        cols = exact_ppr_columns(hs, hd, drv.n, queries, drv.cfg.alpha, device=dev)
        assert np.abs(p - cols.T).max() <= 2 * drv.cfg.eps
    else:
        exact = exact_ppr(hs, hd, drv.n, queries, drv.cfg.alpha, tol=1e-11, device=dev)
        for j, pi in enumerate(exact):
            assert np.abs(p[:, j] - pi).sum() <= drv.cfg.eps * w


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "wlp"])
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_sharded_dense_and_wlp_device_loops_give_the_host_loops(monkeypatch, mode, engine):
    """The sharded dense engine and wlp at 1x1 on the card, a seed and 8
    slides: each loop one loop graph launch and one read, its round log
    replayed through the plain steps under its rule (dense, proportional);
    the same run with the loop forced onto the host, the same branches one
    by one. The dense engine's slide is deterministic (K1, K2, K3; its
    corrections summed through K1 in a sorted order): the same rounds,
    pushes and edge pushes a loop and ``p`` and ``r`` bit for bit, K1, K2,
    K3 and K4 launched. ``wlp``'s group sums and corrections run on
    atomics (F6): its seed, from one fixed state, gives the same rounds,
    pushes and edge pushes; its slides start from states that the atomics
    left apart in their last bits, so pairs at their threshold flip and
    their counts drift apart (by 2e-5 to 1.3e-4 after 8 reverse slides on
    the card): they give the same rounds, and ``p + alpha r`` within 1e-5.
    Both states held to exact PPR."""
    import chip_smoke
    from pprx_torch.engine import graphs, loop

    dev = _cuda()
    sink = []
    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    drv, tallies, g, launched = _sharded_run(dev, mode, engine, "device", monkeypatch)
    rules = [rec["table"].rule for rec in sink]
    host, host_tallies, hg, _ = _sharded_run(dev, mode, engine, "host", monkeypatch)
    if engine == "dense":
        assert tallies == host_tallies
        assert torch.equal(drv.p, host.p) and torch.equal(drv.r, host.r)
    else:
        assert tallies[0] == host_tallies[0]
        assert [t[0] for t in tallies] == [t[0] for t in host_tallies]
    assert g["loop_launches"] == g["reads"] == 9 and hg["loop_launches"] == 0
    want = loop.DENSE if engine == "dense" else loop.PROPORTIONAL
    assert rules == [want] * 9
    for rec in sink:
        assert loop.replay_log(rec["rows"], rec["table"], rec["max_rounds"]) == [
            (row[0], row[7]) for row in rec["rows"]]
    if engine == "dense":
        chip_smoke.check_dense_launched({"sharded_dense": launched})
    assert launched["loop_prime"] == 9 and launched["loop_after_scan"] == 0
    n = drv.n
    a, c = (PprState(p=d.p[:n], r=d.r[:n], mode=mode) for d in (drv, host))
    assert settled_distance(a, c, drv.cfg.alpha) <= 1e-5
    for d in (drv, host):
        _exact_on_window(d, dev)


# ---- the hybrid engine's loops (pprx_torch.engine.sparse): one loop graph
# a loop under K4's hybrid rule

@pytest.mark.cuda
def test_k4_hybrid_rule_equals_its_plain_steps():
    """K4 under the hybrid rule (``chip_smoke.K4_HYBRID``, and without a
    worklist ``K4_NOWL``: the tiers, the scan tiers, the dense scan and the
    count; the first list's validity in the counts' sixth slot) against
    its plain steps on each ``hybrid_*`` and ``nowl_*`` case, through the
    kernel the loop graph launches for it: the whole carry equal; and loop
    graphs of fill-kernel arms leave the host loop's carry, each arm's
    executions and K4's launches (``chip_smoke.hybrid_loop_check``)."""
    import chip_smoke
    from pprx_torch.engine import loop

    dev = _cuda()
    cases = [c for c in chip_smoke.K4_CASES if c[0].startswith(("hybrid_", "nowl_"))]
    assert len(cases) == 37
    for case in cases:
        table = chip_smoke.k4_table(case)
        step, carry, counts = chip_smoke.k4_launch(case)
        assert table.hybrid and counts.numel() == loop.N_COUNTS
        want = carry.clone()
        loop.step_(step, want, counts, table)
        got = carry.to(dev)
        loop.step_(step, got, counts.to(dev), table)
        assert torch.equal(got.cpu(), want), case[0]
    res = chip_smoke.hybrid_loop_check(dev)
    assert [v["rounds"] for v in res.values()] == [5, 3, 0, 4, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_hybrid_loop_graph_leaves_the_host_loops_state(monkeypatch, mode):
    """``push_to_convergence_hybrid`` on the card (one loop graph launch,
    one read) over a window whose overlay is too big for a sparse scan to
    be worth it, against the same loop forced onto the host loop on the
    same card and inputs: the same rounds, pushes and edge pushes, and
    ``p`` and ``r`` bit for bit (every round the dense scan: K2, then K1
    without atomics); each round launched K2 and K1 once, K3 once a round
    and once for the first count, K4's prime once and turn R + 1 times."""
    from pprx_torch.engine import loop, rowpass, sparse
    from pprx_torch.engine.graphs import RoundGraphs
    from pprx_torch.graph.dynamic import WindowGraph

    dev = _cuda()
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=10_000)

    def inputs():
        src, dst, n = synthetic_powerlaw_stream(3000, 30_000, seed=4)
        w = WindowGraph.from_coo(src, dst, n, device=dev)
        return sparse.HybridGraph.build(w, mode, 30_000), init_state(
            n, list(range(8)), mode=mode, device=dev)

    graph, st = inputs()
    before = (dict(segsum.LAUNCHES), dict(rowpass.LAUNCHES), dict(loop.LAUNCHES))
    _, stats = sparse.push_to_convergence_hybrid(st, graph, cfg, graph.n + 1, 30_000)
    torch.cuda.synchronize()
    rounds = stats.rounds
    assert rounds > 1 and stats.syncs == 1 and stats.arms["dense"] == rounds
    assert segsum.launches("segsum_gather_add", since=before[0]) == rounds
    assert {k: rowpass.LAUNCHES[k] - before[1][k] for k in before[1]} == {
        "scan_pass": rounds, "frontier_rows": rounds + 1}
    assert {k: loop.LAUNCHES[k] - before[2][k] for k in before[2]} == {
        "prime": 1, "turn": rounds + 1, "after_scan": 0}
    graph2, st2 = inputs()
    monkeypatch.setattr(RoundGraphs, "loop", RoundGraphs.host_loop)
    _, host = sparse.push_to_convergence_hybrid(st2, graph2, cfg, graph2.n + 1, 30_000)
    assert (host.rounds, host.pushes, host.edge_pushes) == (rounds, stats.pushes,
                                                            stats.edge_pushes)
    assert host.syncs == rounds + 1
    assert torch.equal(st.p, st2.p) and torch.equal(st.r, st2.r)


# ---- the sorted deliveries of the hybrid engine's worklist rounds and
# sparse scans, and of wlp's group sum: K1 under its call sites


def _hybrid_round_inputs(dev, mode, s=8):
    """A hybrid graph mid-stream (a snapshot one slide stale, an overlay of
    its changes) on the CPU and on ``dev``, a state of residuals in [0, 1)
    on every real row (f64 on the CPU, f32 on the card, the same values)
    and a candidate list of every row: (cpu graph, cpu state, card graph,
    card state, cpu list)."""
    from pprx_torch.convert import hybrid_graph_from_arrays, hybrid_graph_to_arrays

    src, dst, n = synthetic_powerlaw_stream(300, 3000, seed=3)
    drv = HybridStreamDriver(src, dst, n, [0, 5, 9], PprConfig(alpha=0.15, eps=1e-6),
                             StreamConfig(window=1500, slide=25), mode=mode, rebuild_every=3,
                             dtype=torch.float64, device="cpu")
    drv.seed()
    list(drv.run(2))
    graph = drv.graph
    assert int((graph.ov.sign < 0).sum()) > 0
    rng = np.random.default_rng(mode)
    r = np.zeros((n + 1, s), np.float32)
    r[:n] = rng.random((n, s), dtype=np.float32)
    st = PprState(p=torch.zeros((n + 1, s), dtype=torch.float64),
                  r=torch.from_numpy(r).double(), mode=mode)
    card = PprState(p=st.p.float().to(dev), r=st.r.float().to(dev), mode=mode)
    cand = torch.arange(n, dtype=torch.int32)
    return (graph, st, hybrid_graph_from_arrays(hybrid_graph_to_arrays(graph), device=dev),
            card, cand)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["worklist", "sparse_scan"])
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_hybrid_sorted_delivery_on_card_matches_plain(mode, arm):
    """A worklist round and a sparse scan over every row, each delivering
    sorted: on the card (f32, K1 once under the arm's call site) against
    the CPU's f64 plain version, rtol = atol = 1e-4 (the kernel checks'
    tolerance); reverse scales each receiver row's sum."""
    from pprx_torch.engine import sparse

    dev = _cuda()
    graph, st, graph_d, st_d, cand = _hybrid_round_inputs(dev, mode)
    cfg = PprConfig(alpha=0.15, eps=1e-6)
    n = graph.n
    r0 = st.r.clone()
    before = dict(segsum.SITE_LAUNCHES)
    for g, state, c in ((graph, st, cand), (graph_d, st_d, cand.to(dev))):
        if arm == "worklist":
            sparse.worklist_round(state, g, cfg, c, n + 1, 2048, 0)
        else:
            sparse.sparse_round(state, g, cfg, n + 1, 2048)
    torch.cuda.synchronize()
    assert {k: segsum.SITE_LAUNCHES[k] - before[k] for k in before} == {
        site: int(site == arm) for site in segsum.SITES}
    assert not torch.allclose(st.r, r0)  # the round moved mass
    for got, want in ((st_d.p, st.p), (st_d.r, st.r)):
        torch.testing.assert_close(got.double().cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, REVERSE])
def test_captured_worklist_arm_replays_bit_for_bit(mode):
    """A worklist round, captured into a CUDA graph and replayed twice from
    one saved state: ``p`` and ``r`` the same bits (the segment sum adds
    without atomics; the residual removal's rows are unique)."""
    from pprx_torch.engine import sparse

    dev = _cuda()
    graph, _, graph_d, st, cand = _hybrid_round_inputs(dev, mode)
    cand = cand.to(dev)
    cfg = PprConfig(alpha=0.15, eps=1e-6)

    def arm():
        sparse.worklist_round(st, graph_d, cfg, cand, graph.n + 1, 2048, 0)

    saved = (st.p.clone(), st.r.clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        arm()
    torch.cuda.current_stream().wait_stream(side)
    captured = torch.cuda.CUDAGraph()
    with torch.cuda.graph(captured):
        arm()
    outs = []
    for _ in range(2):
        st.p.copy_(saved[0])
        st.r.copy_(saved[1])
        captured.replay()
        torch.cuda.synchronize()
        outs.append((st.p.clone(), st.r.clone()))
    assert not torch.equal(outs[0][1], saved[1])
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, REVERSE])
@pytest.mark.parametrize("worklist", [True, False])
def test_hybrid_k1_launches_count_from_the_carry(worklist, mode):
    """The hybrid driver on the card, seed and 6 slides: K1's launches at
    the worklist and sparse-scan sites (each arm's captured launches times
    its executions, which the carry counts) equal those arms' executions
    (``chip_smoke.loop_tally``), and each captured worklist or sparse-scan
    arm launched K1 once, under its site."""
    import chip_smoke

    dev = _cuda()
    gpu, _ = _hybrid_pair(dev, mode, worklist)
    before = dict(segsum.SITE_LAUNCHES)
    with chip_smoke.loop_tally() as tally:
        [gpu.seed(), *gpu.run(6)]
    torch.cuda.synchronize()
    sites = {k: segsum.SITE_LAUNCHES[k] - before[k] for k in before}
    arms = tally["arms"]
    assert arms["wl" if worklist else "sparse"] > 0
    assert sites == {"worklist": arms["wl"], "sparse_scan": arms["sparse"], "group_sum": 0,
                     "other": sites["other"]}
    for key, (_, launched) in gpu.round_graphs.kept.items():
        kind = {"tier": "worklist", "scan": "sparse_scan"}.get(key[4])
        if kind is not None:
            assert launched[1] == {site: int(site == kind) for site in segsum.SITES}, key


@pytest.mark.cuda
def test_group_sum_on_card_matches_plain():
    """``sorted_bucket_rows`` on the card (f32; its group sum K1 once under
    ``group_sum``) against the CPU's f64 plain version: heavy duplicates,
    invalid lanes, the quotas' overflow into the carry."""
    import pprx_torch.dist.wl as twl

    dev = _cuda()
    rng = np.random.default_rng(4)
    k, n_local, ccap, length, s = 4, 5000, 512, 200_000, 32
    n_pad = k * n_local
    ids = rng.zipf(1.2, size=length) % (n_pad + 1)
    moving = rng.random((60_000, s), dtype=np.float32)
    rows = rng.integers(0, 60_000, size=length)
    args = (k, n_local, n_pad, ccap, min(length, n_pad))
    want = twl.sorted_bucket_rows(torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(rows),
                                  torch.from_numpy(moving).double(), *args)
    before = dict(segsum.SITE_LAUNCHES)
    got = twl.sorted_bucket_rows(torch.from_numpy(ids.astype(np.int32)).to(dev),
                                 torch.from_numpy(rows).to(dev),
                                 torch.from_numpy(moving).to(dev), *args)
    torch.cuda.synchronize()
    assert {k_: segsum.SITE_LAUNCHES[k_] - before[k_] for k_ in before} == {
        site: int(site == "group_sum") for site in segsum.SITES}
    assert int(got[4]) == int(want[4]) > 0
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a.cpu().to(b.dtype), b, rtol=1e-4, atol=1e-4)
