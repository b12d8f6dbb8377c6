"""Port of the segment sum (pprx_torch.engine.segsum): the plain versions of
both entries (``segsum_add_`` and ``segsum_gather_add_``, the gather fused
in) against the JAX Pallas kernel in interpret mode on the cases of
tests/test_segsum.py, and against numpy in f64. The Hopper kernels against
the plain versions on the card are in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pprx.engine.segsum import pad_len, segsum_add as jax_segsum_add, tile_offsets
from pprx_torch.engine import segsum
from pprx_torch.engine.segsum import (
    row_offsets,
    segment_ids,
    segsum_add_,
    segsum_gather_add_,
)

torch.set_num_threads(1)


def _mk(rng, n_rows, w, s, skew):
    """Delivery-sorted edge set as tests/test_segsum.py builds it: seg ids
    ascending, the padded tail on the last row with zero contributions."""
    if skew:
        seg = np.minimum(rng.zipf(1.3, size=w) % (n_rows - 1), n_rows - 2).astype(np.int32)
    else:
        seg = rng.integers(0, n_rows - 1, size=w).astype(np.int32)
    seg.sort()
    return seg, rng.normal(size=(w, s)), rng.normal(size=(n_rows, s))


def _port(rin, contrib, seg, n_rows):
    seg_t = torch.from_numpy(seg)
    out = torch.from_numpy(rin.copy())
    return segsum_add_(out, torch.from_numpy(contrib), row_offsets(seg_t, n_rows))


def _mk_gather(rng, w, n_table, s):
    """A table and one table row per edge, so that ``table[gat]`` stands
    for the contributions."""
    return rng.normal(size=(n_table, s)), rng.integers(0, n_table, size=w)


def _port_gather(rin, table, gat, seg, n_rows):
    out = torch.from_numpy(rin.copy())
    return segsum_gather_add_(
        out, torch.from_numpy(table), torch.from_numpy(gat),
        row_offsets(torch.from_numpy(seg), n_rows),
    )


PALLAS_CASES = [
    (513, 6000, 128, 256, 2048),
    (129, 2048, 8, 128, 256),
    (1025, 10000, 128, 512, 1024),
]


def _pallas(rin, contrib, seg, n_rows, w, s, tr, ec):
    """The JAX kernel in interpret mode on ``contrib`` padded as
    tests/test_segsum.py pads it."""
    w_pad = pad_len(w, ec)
    seg_p = np.full(w_pad, n_rows - 1, np.int32)
    seg_p[:w] = seg
    contrib_p = np.zeros((w_pad, s), np.float32)
    contrib_p[:w] = contrib
    offsets = np.concatenate([[0], np.cumsum(np.bincount(seg_p, minlength=n_rows))])
    return np.asarray(jax_segsum_add(
        jnp.asarray(rin), jnp.asarray(contrib_p), jnp.asarray(seg_p.reshape(-1, 128)),
        tile_offsets(jnp.asarray(offsets.astype(np.int32)), n_rows, tr),
        tr=tr, ec=ec, interpret=True,
    ))


@pytest.mark.parametrize("gat_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("n_rows,w,s,tr,ec", PALLAS_CASES)
def test_gather_plain_matches_pallas_interpret(rng, n_rows, w, s, tr, ec, skew, gat_dtype):
    """``segsum_gather_add_(rin, table, gat, ...)`` on CPU tensors against
    the JAX ``segsum_add(rin, table[gat], ...)``; rtol = atol = 2e-4 as for
    the unfused entry (the Pallas kernel's other f32 order)."""
    seg, _, rin = _mk(rng, n_rows, w, s, skew)
    table, gat = _mk_gather(rng, w, 777, s)
    table, rin = table.astype(np.float32), rin.astype(np.float32)
    ref = _pallas(rin, table[gat], seg, n_rows, w, s, tr, ec)
    out = _port_gather(rin, table, gat.astype(gat_dtype), seg, n_rows)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("gat_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("skew", [False, True])
def test_gather_plain_f64_matches_numpy(rng, skew, gat_dtype):
    n_rows, w, s = 300, 5000, 16
    seg, _, rin = _mk(rng, n_rows, w, s, skew)
    table, gat = _mk_gather(rng, w, 211, s)
    ref = rin.copy()
    np.add.at(ref, seg, table[gat])
    out = _port_gather(rin, table, gat.astype(gat_dtype), seg, n_rows)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("lo,hi", [(0, 300), (40, 260), (100, 101), (299, 300), (7, 7)])
def test_gather_sliced_row_off(rng, lo, hi):
    """Rows [lo, hi) of a view with ``off[lo:hi+1]``: entries of ``gat``
    before ``off[lo]`` and past ``off[hi]`` are not read (they hold an
    index outside the table here, which would raise)."""
    n_rows, w, s = 300, 5000, 4
    seg, _, rin = _mk(rng, n_rows, w, s, True)
    table, gat = _mk_gather(rng, w, 50, s)
    off = row_offsets(torch.from_numpy(seg), n_rows)
    a, b = int(off[lo]), int(off[hi])
    ref = rin.copy()
    np.add.at(ref, seg[a:b], table[gat[a:b]])
    gat = gat.copy()
    gat[:a] = 10**6
    gat[b:] = 10**6
    out = torch.from_numpy(rin.copy())
    segsum_gather_add_(out[lo:hi], torch.from_numpy(table), torch.from_numpy(gat), off[lo:hi + 1])
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("w", [0, 9])
def test_gather_no_edges(w):
    """No edge in ``[row_off[0], row_off[R])``, with and without an edge
    array: ``rin`` stays as it was and no launch is counted."""
    rin = torch.ones(4, 3, dtype=torch.float64)
    table = torch.full((5, 3), 7.0, dtype=torch.float64)
    gat = torch.zeros(w, dtype=torch.int64)
    off = torch.full((5,), min(w, 4), dtype=torch.int32)
    before = dict(segsum.LAUNCHES)
    out = segsum_gather_add_(rin, table, gat, off)
    assert out is rin and bool((rin == 1).all())
    segsum_add_(rin, table[gat], off)
    assert bool((rin == 1).all())
    assert segsum.LAUNCHES == before


def test_gather_checks():
    rin = torch.zeros(5, 3)
    table = torch.ones(4, 3)
    gat = torch.tensor([3, 2, 1, 0, 0, 1])
    off = row_offsets(torch.tensor([0, 0, 2, 2, 2, 4], dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="table"):
        segsum_gather_add_(rin, torch.ones(4, 2), gat, off)
    with pytest.raises(ValueError, match="row_off"):
        segsum_gather_add_(rin, table, gat, off[:-1])
    with pytest.raises(ValueError, match="row_off"):
        segsum_gather_add_(rin, table, gat, off.long())
    with pytest.raises(ValueError, match="gat"):
        segsum_gather_add_(rin, table, gat.float(), off)
    with pytest.raises(ValueError, match="gat"):
        segsum_gather_add_(rin, table, gat[:, None], off)
    segsum_gather_add_(rin, table, gat, off)
    np.testing.assert_array_equal(rin[:, 0].numpy(), [2, 0, 3, 0, 1])
    # rin may have more rows than the table, or fewer
    big = torch.zeros(9, 3)
    off9 = torch.cat([off, torch.full((4,), 6, dtype=torch.int32)])
    segsum_gather_add_(big, table, gat, off9)
    np.testing.assert_array_equal(big[:, 0].numpy(), [2, 0, 3, 0, 1, 0, 0, 0, 0])


def test_reset_launches():
    before = dict(segsum.LAUNCHES)
    segsum.LAUNCHES["segsum_add", False] += 3
    segsum.LAUNCHES["segsum_add", True] += 2
    segsum.LAUNCHES["segsum_gather_add", True] += 4
    assert segsum.launches(since=before) == 9
    assert segsum.launches("segsum_add", since=before) == 5
    assert segsum.launches(scaled=True, since=before) == 6
    assert segsum.launches("segsum_gather_add", scaled=False, since=before) == 0
    segsum.reset_launches()
    assert segsum.launches() == 0 and set(segsum.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("n_rows,w,s,tr,ec", PALLAS_CASES)
def test_plain_matches_pallas_interpret(rng, n_rows, w, s, tr, ec, skew):
    seg, contrib, rin = _mk(rng, n_rows, w, s, skew)
    contrib, rin = contrib.astype(np.float32), rin.astype(np.float32)
    ref = _pallas(rin, contrib, seg, n_rows, w, s, tr, ec)
    out = _port(rin, contrib, seg, n_rows)
    # tolerance of tests/test_segsum.py: the Pallas kernel sums per
    # 128-edge group by matmul, another (deterministic) f32 order
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("skew", [False, True])
def test_plain_f64_matches_numpy(rng, skew):
    n_rows, w, s = 300, 5000, 16
    seg, contrib, rin = _mk(rng, n_rows, w, s, skew)
    ref = rin.copy()
    np.add.at(ref, seg, contrib)
    out = _port(rin, contrib, seg, n_rows)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


def test_empty_rows(rng):
    """Rows before and after receive nothing; all edges hit one row."""
    n_rows, w, s = 1024, 4096, 8
    seg = np.full(w, 600, np.int32)
    out = _port(np.zeros((n_rows, s)), np.ones((w, s)), seg, n_rows).numpy()
    assert out[600, 0] == w and np.abs(out).sum() == w * s


def test_bf16_contribs_sum_in_rin_dtype(rng):
    n_rows, w, s = 200, 3000, 16
    seg, contrib, _ = _mk(rng, n_rows, w, s, True)
    c16 = torch.from_numpy(contrib.astype(np.float32)).to(torch.bfloat16)
    seg_t = torch.from_numpy(seg)
    out = segsum_add_(torch.zeros(n_rows, s), c16, row_offsets(seg_t, n_rows))
    ref = np.zeros((n_rows, s), np.float64)
    np.add.at(ref, seg, c16.float().numpy().astype(np.float64))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_row_offsets_and_checks():
    seg = torch.tensor([0, 0, 2, 2, 2, 4], dtype=torch.int32)
    off = row_offsets(seg, 5)
    np.testing.assert_array_equal(off.numpy(), [0, 2, 2, 5, 5, 6])
    np.testing.assert_array_equal(segment_ids(off).numpy(), seg.numpy())
    rin = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="row_off"):
        segsum_add_(rin, torch.ones(6, 3), row_offsets(seg, 4))
    with pytest.raises(ValueError, match="contribs"):
        segsum_add_(rin, torch.ones(6, 2), off)
    before = segsum.launches()
    segsum_add_(rin, torch.ones(6, 3), off)
    assert segsum.launches() == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(rin[:, 0].numpy(), [2, 0, 3, 0, 1])
    # edges past the last row's range (the phantom row's) are not read
    segsum_add_(rin[:4], torch.ones(6, 3), row_offsets(seg, 4))
    np.testing.assert_array_equal(rin[:, 0].numpy(), [4, 0, 6, 0, 1])
    # nor edges before the first row's: rows [2, 5) own edges [2, 6)
    segsum_add_(rin[2:], torch.arange(6.0)[:, None].expand(6, 3).contiguous(), off[2:])
    np.testing.assert_array_equal(rin[:, 0].numpy(), [4, 0, 6 + 2 + 3 + 4, 0, 1 + 5])


@pytest.mark.parametrize("skew", [False, True])
def test_offsets_round_trip(rng, skew):
    """The plain version reads the same row ranges the kernel reads: the
    segment ids rebuilt from the offsets are the ids they came from."""
    seg, _, _ = _mk(rng, 300, 5000, 1, skew)
    seg_t = torch.from_numpy(seg)
    ids = segment_ids(row_offsets(seg_t, 300))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), seg)



# ---- the per-row scale (reverse push: one 1/d_out per delivery row) ----


def _pallas_f64(rin, contrib, seg, n_rows, w, s, tr, ec):
    """The JAX kernel in interpret mode in f64 (its limb split of f64 values
    is exact to f64 rounding)."""
    w_pad = pad_len(w, ec)
    seg_p = np.full(w_pad, n_rows - 1, np.int32)
    seg_p[:w] = seg
    contrib_p = np.zeros((w_pad, s), np.float64)
    contrib_p[:w] = contrib
    offsets = np.concatenate([[0], np.cumsum(np.bincount(seg_p, minlength=n_rows))])
    return np.asarray(jax_segsum_add(
        jnp.asarray(rin), jnp.asarray(contrib_p), jnp.asarray(seg_p.reshape(-1, 128)),
        tile_offsets(jnp.asarray(offsets.astype(np.int32)), n_rows, tr),
        tr=tr, ec=ec, interpret=True,
    ))


@pytest.mark.parametrize("entry", ["add", "gather"])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("n_rows,w,s,tr,ec", PALLAS_CASES)
def test_row_scale_matches_pallas_interpret(rng, n_rows, w, s, tr, ec, skew, entry):
    """Both entries with ``row_scale`` against the JAX kernel fed
    ``contrib * scale[seg]`` (how the reference's reverse scans scale, per
    edge), f64; atol 1e-12: the same sums in another order (row sums of up
    to a few thousand N(0,1) terms)."""
    seg, contrib, rin = _mk(rng, n_rows, w, s, skew)
    scale = 1.0 / rng.integers(1, 50, size=n_rows)
    off = row_offsets(torch.from_numpy(seg), n_rows)
    out = torch.from_numpy(rin.copy())
    if entry == "add":
        segsum_add_(out, torch.from_numpy(contrib), off, torch.from_numpy(scale))
    else:
        table, gat = _mk_gather(rng, w, 777, s)
        contrib = table[gat]
        segsum_gather_add_(out, torch.from_numpy(table), torch.from_numpy(gat), off,
                           row_scale=torch.from_numpy(scale))
    ref = _pallas_f64(rin, contrib * scale[seg][:, None], seg, n_rows, w, s, tr, ec)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("lo,hi", [(0, 300), (40, 260), (299, 300), (7, 7)])
def test_row_scale_on_sliced_rows(rng, lo, hi):
    """``row_scale`` belongs to the rows given: rows [lo, hi) of a view take
    ``scale[lo:hi]``, and rows outside stay as they were."""
    n_rows, w, s = 300, 5000, 4
    seg, contrib, rin = _mk(rng, n_rows, w, s, True)
    scale = rng.normal(size=n_rows)
    off = row_offsets(torch.from_numpy(seg), n_rows)
    a, b = int(off[lo]), int(off[hi])
    ref = rin.copy()
    np.add.at(ref, seg[a:b], contrib[a:b] * scale[seg[a:b]][:, None])
    out = torch.from_numpy(rin.copy())
    segsum_add_(out[lo:hi], torch.from_numpy(contrib), off[lo:hi + 1],
                torch.from_numpy(scale[lo:hi].copy()))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


def test_row_scale_none_is_the_plain_sum(rng):
    """No scale and a scale of ones give the same sums, and ``None`` takes
    the unscaled path bit for bit (one ``index_add_`` into ``rin``)."""
    n_rows, w, s = 200, 3000, 8
    seg, contrib, rin = _mk(rng, n_rows, w, s, True)
    table, gat = _mk_gather(rng, w, 99, s)
    direct = torch.from_numpy(rin.copy()).index_add_(
        0, torch.from_numpy(seg), torch.from_numpy(contrib))
    assert torch.equal(_port(rin, contrib, seg, n_rows), direct)
    off = row_offsets(torch.from_numpy(seg), n_rows)
    ones = torch.ones(n_rows, dtype=torch.float64)
    scaled = segsum_add_(torch.from_numpy(rin.copy()), torch.from_numpy(contrib), off, ones)
    np.testing.assert_allclose(scaled.numpy(), direct.numpy(), rtol=0, atol=1e-12)
    g0 = _port_gather(rin, table, gat, seg, n_rows)
    g1 = segsum_gather_add_(torch.from_numpy(rin.copy()), torch.from_numpy(table),
                            torch.from_numpy(gat), off, ones)
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=0, atol=1e-12)


def test_row_scale_checks():
    rin = torch.zeros(5, 3)
    off = row_offsets(torch.tensor([0, 0, 2, 2, 2, 4], dtype=torch.int32), 5)
    contrib = torch.ones(6, 3)
    with pytest.raises(ValueError, match="row_scale"):
        segsum_add_(rin, contrib, off, torch.ones(4))
    with pytest.raises(ValueError, match="row_scale"):
        segsum_add_(rin, contrib, off, torch.ones(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="row_scale"):
        segsum_gather_add_(rin, contrib, torch.arange(6), off, torch.ones(5, 1))
    # f32 state with the scale in another float type: cast to rin's
    segsum_add_(rin, contrib, off, torch.tensor([2.0, 1, 0.5, 1, 3], dtype=torch.float64))
    np.testing.assert_array_equal(rin[:, 0].numpy(), [4, 0, 1.5, 0, 3])
    assert {entry for entry, _ in segsum.LAUNCHES} == set(segsum.ENTRIES)


# ---- the layout the card's kernels are told, and narrow states ----


@pytest.mark.parametrize("s", range(1, 129))
def test_layout_for_every_width(s):
    """Lanes per edge: the least power of two that covers ceil(S / VEC)
    columns-per-lane loads, at most a warp; edges per step times lanes per
    edge is a warp; every chunk is a whole number of steps. The layout does
    not depend on the source type: f32 and bf16 sources share it."""
    vec, lanes = segsum.lanes_for(s)
    assert vec == (4 if s % 4 == 0 else 1)
    need = -(-s // vec)
    assert lanes in (1, 2, 4, 8, 16, 32)
    assert lanes == 32 or (lanes >= need and lanes // 2 < need)
    assert (lanes == 32) == (need > 16)
    for n_edges in (1, 70_000, 80_000, 160_000, 1_000_000, 2_000_000, 10**8):
        lay = segsum.layout_for(s, n_edges)
        assert (lay.vec, lay.lanes) == (vec, lanes)
        assert lay.edges_per_step * lay.lanes == 32
        assert lay.chunk > 0 and lay.chunk % lay.edges_per_step == 0
        assert lay.chunk == segsum.chunk_for(n_edges, s)
        # shorter arrays never get larger chunks
        assert segsum.chunk_for(max(1, n_edges // 2), s) <= lay.chunk


@pytest.mark.parametrize("n_edges,chunk", [
    (2_000_000, 256), (320_000, 64), (458_752, 64), (1_048_576, 256), (1_048_575, 128),
    (1, 64),
])
@pytest.mark.parametrize("s", [128, 100, 68, 17])
def test_wide_chunks_are_what_they_were(s, n_edges, chunk):
    """A state that fills a warp's lanes keeps the chunks the headline
    stream was swept with: 256 edges for its window scan, 64 for its fresh
    view and its compact round."""
    assert segsum.lanes_for(s)[1] == 32
    assert segsum.chunk_for(n_edges, s) == chunk


NARROW = [1, 3, 8, 16]


@pytest.mark.parametrize("entry", ["add", "gather"])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("s", NARROW)
def test_narrow_plain_matches_pallas_interpret(rng, s, skew, entry):
    """Both entries on CPU tensors at narrow states against the JAX kernel
    in interpret mode, f32; rtol = atol = 2e-4 as at S=128 (the Pallas
    kernel's other f32 order)."""
    n_rows, w, tr, ec = 129, 2048, 128, 256
    seg, contrib, rin = _mk(rng, n_rows, w, s, skew)
    contrib, rin = contrib.astype(np.float32), rin.astype(np.float32)
    if entry == "add":
        out = _port(rin, contrib, seg, n_rows)
    else:
        table, gat = _mk_gather(rng, w, 333, s)
        table = table.astype(np.float32)
        contrib = table[gat]
        out = _port_gather(rin, table, gat, seg, n_rows)
    ref = _pallas(rin, contrib, seg, n_rows, w, s, tr, ec)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("entry", ["add", "gather"])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("s", NARROW)
def test_narrow_row_scale_matches_pallas_interpret(rng, s, skew, entry):
    """The same with ``row_scale``, f64, against the JAX kernel fed
    ``contrib * scale[seg]``; atol 1e-12 as at S=128."""
    n_rows, w, tr, ec = 129, 2048, 128, 256
    seg, contrib, rin = _mk(rng, n_rows, w, s, skew)
    scale = 1.0 / rng.integers(1, 50, size=n_rows)
    off = row_offsets(torch.from_numpy(seg), n_rows)
    out = torch.from_numpy(rin.copy())
    if entry == "add":
        segsum_add_(out, torch.from_numpy(contrib), off, torch.from_numpy(scale))
    else:
        table, gat = _mk_gather(rng, w, 333, s)
        contrib = table[gat]
        segsum_gather_add_(out, torch.from_numpy(table), torch.from_numpy(gat), off,
                           row_scale=torch.from_numpy(scale))
    ref = _pallas_f64(rin, contrib * scale[seg][:, None], seg, n_rows, w, s, tr, ec)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
