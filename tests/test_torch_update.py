"""Port of the batched corrections (pprx_torch.engine.update), forward and
reverse, against the JAX apply_edge_batch and the sequential per-edge
oracle, f64, atol 1e-12 (same arithmetic; the summation order may differ),
and, bit for bit, against the same corrections as a pass over every row
(``tests/_corrections.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pprx.config import PprConfig
from pprx.engine.state import PprState as JaxState
from pprx.engine.update import apply_edge_batch as jax_apply
from pprx.graph.dynamic import WindowGraph as JaxWindow
from pprx.ref.exact import exact_ppr_matrix
from pprx.ref.push import (
    OracleGraph, PushState, apply_edge_event, forward_push, reverse_push,
)
import _corrections  # tests/ is on the path
import pprx_torch.engine.update as tupdate
from pprx_torch.engine.state import FORWARD, REVERSE, PprState
from pprx_torch.engine.update import apply_edge_batch, out_row_sums, source_rows, window_row_sums
from pprx_torch.engine.wl2 import build_kill_graph
from pprx_torch.graph.dynamic import WindowGraph
from tests.conftest import random_multigraph

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.15, eps=1e-6)


def _batches(rng, n, src, dst, b):
    """A valid delete batch that removes every out-edge of one vertex
    (D == 0) plus random edges, and an insert batch that includes edges
    from that vertex (from dangling after the deletes) and from a vertex
    with no out-edges at all; both phantom-padded to length b."""
    hub = int(np.bincount(src, minlength=n).argmax())
    own = np.flatnonzero(src == hub)
    rest = rng.choice(np.flatnonzero(src != hub), size=b - own.size - 3, replace=False)
    sel = np.concatenate([own, rest])
    del_src = np.full(b, n, np.int32)
    del_dst = np.full(b, n, np.int32)
    del_src[: sel.size] = src[sel]
    del_dst[: sel.size] = dst[sel]
    dangling = int(np.flatnonzero(np.bincount(src, minlength=n + 1)[:n] == 0)[0])
    ins_src = rng.integers(0, n, size=b).astype(np.int32)
    ins_dst = ((ins_src + 1 + rng.integers(0, n - 1, size=b)) % n).astype(np.int32)
    ins_src[:3] = hub
    ins_src[3:5] = dangling
    ins_dst[:5] = (ins_src[:5] + 1) % n
    ins_src[-2:] = n
    ins_dst[-2:] = n
    return hub, dangling, (ins_src, ins_dst, del_src, del_dst)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, m, s, b = 30, 160, 4, 24
    src, dst = random_multigraph(rng, n, m)
    src[src == 7] = 8  # vertex 7 starts with no out-edges
    dst[src == dst] = (dst[src == dst] + 1) % n
    hub, dangling, batch = _batches(rng, n, src, dst, b)
    ins_src, ins_dst, del_src, del_dst = batch
    deg0 = np.bincount(src, minlength=n + 1)
    # the hub loses every out-edge (D == 0), then both it and a vertex that
    # never had out-edges insert (from dangling)
    assert deg0[dangling] == 0 and deg0[hub] == np.sum(del_src == hub)
    p = np.abs(rng.normal(size=(n + 1, s))) * 1e-2
    r = rng.normal(size=(n + 1, s)) * 1e-3
    p[-1] = r[-1] = 0.0

    jst, jw = jax_apply(
        JaxState(p=jnp.asarray(p), r=jnp.asarray(r), mode=FORWARD),
        JaxWindow.from_coo(src, dst, n),
        *(jnp.asarray(x) for x in (ins_src, ins_dst, del_src, del_dst)),
        CFG,
    )
    tst, tw = apply_edge_batch(
        PprState(p=torch.from_numpy(p), r=torch.from_numpy(r), mode=FORWARD),
        WindowGraph.from_coo(src, dst, n, device="cpu"),
        *(torch.from_numpy(x) for x in (ins_src, ins_dst, del_src, del_dst)),
        CFG,
    )
    np.testing.assert_array_equal(tw.deg.numpy(), np.asarray(jw.deg))
    np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=0, atol=1e-12)
    assert tst.p[-1].abs().sum() == 0 and tst.r[-1].abs().sum() == 0


def _rowsum_route(route, monkeypatch, p, window):
    """The reverse corrections' old row sums by each route: summed inside
    ``apply_edge_batch`` from the COO ring (in one block, or in blocks of 7
    edges), or handed in from the kill graph's delivery views through the
    segment sum, as the fast driver does."""
    if route == "views":
        kg = build_kill_graph(window, REVERSE, fring=8)
        n = kg.n
        return window_row_sums(p, [(kg.d_gat, kg.d_off[:n + 1]), (kg.fd_gat, kg.fd_off[:n + 1])])
    if route == "blocks":
        monkeypatch.setattr(tupdate, "EDGE_BLOCK_BYTES", 7 * p.shape[1] * p.element_size())
    return None


@pytest.mark.parametrize("route", ["sweep", "blocks", "views"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverse_batch_matches_jax(monkeypatch, seed, route):
    """Reverse corrections with every dangling case in one batch: a vertex
    that loses every out-edge and gets none (d_new == 0), one that loses
    them all and inserts again, one that was dangling (d0 == 0) and
    inserts; phantom padding in both batches and in the ring."""
    rng = np.random.default_rng(seed)
    n, m, s, b = 30, 160, 4, 32
    src, dst = random_multigraph(rng, n, m)
    src[src == 7] = 8  # vertex 7 starts with no out-edges
    dst[src == dst] = (dst[src == dst] + 1) % n
    deg0 = np.bincount(src, minlength=n + 1)
    hub = int(deg0.argmax())
    gone = int(np.flatnonzero((deg0 >= 1) & (deg0 <= 4))[0])  # loses every out-edge
    rest = rng.choice(np.flatnonzero((src != hub) & (src != gone)), size=5, replace=False)
    sel = np.concatenate([np.flatnonzero(src == hub), np.flatnonzero(src == gone), rest])
    del_src = np.full(b, n, np.int32)
    del_dst = np.full(b, n, np.int32)
    del_src[: sel.size], del_dst[: sel.size] = src[sel], dst[sel]
    ins_src = rng.integers(0, n, size=b).astype(np.int32)
    ins_src[ins_src == gone] = hub
    ins_src[:3] = hub  # inserts again after losing every out-edge
    ins_src[3:5] = 7  # inserts from dangling
    ins_dst = ((ins_src + 1 + rng.integers(0, n - 1, size=b)) % n).astype(np.int32)
    ins_src[-2:] = ins_dst[-2:] = n
    d_new = deg0 - np.bincount(del_src, minlength=n + 1) + np.bincount(ins_src, minlength=n + 1)
    assert deg0[7] == 0 and d_new[gone] == 0 and deg0[hub] == np.sum(del_src == hub)
    p = np.abs(rng.normal(size=(n + 1, s))) * 1e-2
    r = rng.normal(size=(n + 1, s)) * 1e-3
    p[-1] = r[-1] = 0.0

    jst, jw = jax_apply(
        JaxState(p=jnp.asarray(p), r=jnp.asarray(r), mode=REVERSE),
        JaxWindow.from_coo(src, dst, n, capacity=src.size + 5),
        *(jnp.asarray(x) for x in (ins_src, ins_dst, del_src, del_dst)),
        CFG,
    )
    window = WindowGraph.from_coo(src, dst, n, capacity=src.size + 5, device="cpu")
    state = PprState(p=torch.from_numpy(p), r=torch.from_numpy(r), mode=REVERSE)
    rowsum = _rowsum_route(route, monkeypatch, state.p, window)
    tst, tw = apply_edge_batch(
        state, window,
        *(torch.from_numpy(x.astype(np.int32)) for x in (ins_src, ins_dst, del_src, del_dst)),
        CFG, rowsum=rowsum,
    )
    np.testing.assert_array_equal(tw.deg.numpy(), np.asarray(jw.deg))
    np.testing.assert_array_equal(tst.p.numpy(), p)  # reverse corrections leave p alone
    np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=0, atol=1e-12)
    assert tst.r[-1].abs().sum() == 0
    np.testing.assert_array_equal(state.r.numpy(), r)  # the input state is not modified


def _colliding_batches(rng, n, src, dst, b, key_end):
    """A valid delete batch and an insert batch whose correction endpoint
    (``key_end``: 1 the destination, forward; 0 the source, reverse) falls
    on three rows for most lanes, phantom-padded to length b."""
    ends = (src, dst)[key_end]
    hot = np.bincount(ends, minlength=n).argsort()[-3:]
    sel = np.flatnonzero(np.isin(ends, hot))[: b - 4]
    del_src = np.full(b, n, np.int32)
    del_dst = np.full(b, n, np.int32)
    del_src[: sel.size], del_dst[: sel.size] = src[sel], dst[sel]
    keys = rng.choice(hot, size=b)
    others = (keys + 1 + rng.integers(0, n - 1, size=b)) % n
    ins_src, ins_dst = (others, keys) if key_end else (keys, others)
    ins_src, ins_dst = ins_src.astype(np.int32), ins_dst.astype(np.int32)
    ins_src[-2:] = ins_dst[-2:] = n
    return ins_src, ins_dst, del_src, del_dst


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
@pytest.mark.parametrize("seed", [0, 1])
def test_colliding_endpoints_match_jax_sorted_or_not(seed, mode):
    """Batches whose lanes meet in a few rows (the sums K1 takes over the
    sorted lanes): the lanes as they come (one stable sort each) and sorted
    by their row beforehand (``keys_sorted``, as the fast driver hands them
    over) both match the reference at 1e-12, and each other bit for bit:
    a stable sort keeps each row's lanes in their batch order."""
    rng = np.random.default_rng(seed)
    n, m, s, b = 30, 200, 4, 40
    src, dst = random_multigraph(rng, n, m)
    dst[src == dst] = (dst[src == dst] + 1) % n
    key_end = 1 if mode == FORWARD else 0
    batch = _colliding_batches(rng, n, src, dst, b, key_end)
    assert np.bincount(batch[key_end], minlength=n + 1)[:n].max() >= 8
    assert np.bincount(batch[2 + key_end], minlength=n + 1)[:n].max() >= 4
    p = np.abs(rng.normal(size=(n + 1, s))) * 1e-2
    r = rng.normal(size=(n + 1, s)) * 1e-3
    p[-1] = r[-1] = 0.0
    jst, jw = jax_apply(
        JaxState(p=jnp.asarray(p), r=jnp.asarray(r), mode=mode),
        JaxWindow.from_coo(src, dst, n),
        *(jnp.asarray(x) for x in batch), CFG,
    )
    # sorted by the row each lane adds to, pairs kept together
    po = np.argsort(batch[2 + key_end], kind="stable")
    pn = np.argsort(batch[key_end], kind="stable")
    ordered = (batch[0][pn], batch[1][pn], batch[2][po], batch[3][po])
    got = []
    for arrays, keys_sorted in ((batch, False), (ordered, True)):
        window = WindowGraph.from_coo(src, dst, n, device="cpu")
        state = PprState(p=torch.from_numpy(p), r=torch.from_numpy(r), mode=mode)
        rowsum = None if mode == FORWARD else out_row_sums(state.p, window)
        tst, tw = apply_edge_batch(state, window, *(torch.from_numpy(x) for x in arrays), CFG,
                                   rowsum=rowsum, keys_sorted=keys_sorted)
        np.testing.assert_array_equal(tw.deg.numpy(), np.asarray(jw.deg))
        np.testing.assert_allclose(tst.p.numpy(), np.asarray(jst.p), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tst.r.numpy(), np.asarray(jst.r), rtol=0, atol=1e-12)
        got.append(tst)
    assert torch.equal(got[0].p, got[1].p) and torch.equal(got[0].r, got[1].r)


@pytest.mark.parametrize("block_edges", [1, 7, 64, 10**6])
def test_out_row_sums_in_blocks(monkeypatch, block_edges):
    """The COO sweep cut into edge blocks of any size, against numpy; the
    ring's phantom padding adds nothing."""
    rng = np.random.default_rng(4)
    n, m, s = 25, 130, 3
    src, dst = random_multigraph(rng, n, m)
    p = rng.normal(size=(n + 1, s))
    p[-1] = 0.0
    monkeypatch.setattr(tupdate, "EDGE_BLOCK_BYTES", block_edges * s * 8)
    got = out_row_sums(torch.from_numpy(p),
                       WindowGraph.from_coo(src, dst, n, capacity=m + 9, device="cpu"))
    ref = np.zeros_like(p)
    np.add.at(ref, src, p[dst])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("route", ["sweep", "views"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reverse_batches_match_oracle_and_keep_invariant(monkeypatch, seed, route):
    """Reverse mode on a pushed state: the port equals the sequential
    per-edge oracle (pprx.ref.push.apply_edge_event) to 1e-12, and the
    reverse invariant p + M r = M[:, t] holds on the new graph to 1e-10."""
    alpha = 0.2
    cfg = PprConfig(alpha=alpha, eps=1e-6)
    rng = np.random.default_rng(seed)
    n, targets = 12, [0, 5]
    src, dst = random_multigraph(rng, n, 40)
    graphs = [OracleGraph(n, src, dst) for _ in targets]
    sts = [PushState.init(n, t, "reverse") for t in targets]
    for g, st in zip(graphs, sts):
        reverse_push(g, st, alpha, eps=1e-4)
    pad = np.zeros((1, len(targets)))
    state = PprState(
        p=torch.from_numpy(np.vstack([np.stack([st.p for st in sts], 1), pad])),
        r=torch.from_numpy(np.vstack([np.stack([st.r for st in sts], 1), pad])),
        mode=REVERSE,
    )
    for step in range(4):
        cur_src, cur_dst = graphs[0].coo()
        ins_src = rng.integers(0, n, size=6)
        if step == 0:  # every out-edge of one vertex, and none comes: left dangling
            lone = int(cur_src[0])
            sel = np.flatnonzero(cur_src == lone)
            ins_src[ins_src == lone] = (lone + 1) % n
        else:
            sel = rng.choice(cur_src.size, size=5, replace=False)
        if step == 1:
            ins_src[0] = lone  # inserts from dangling
        del_src, del_dst = cur_src[sel], cur_dst[sel]
        ins_dst = (ins_src + 1 + rng.integers(0, n - 1, size=6)) % n
        window = WindowGraph.from_coo(cur_src, cur_dst, n, device="cpu")
        state, _ = apply_edge_batch(
            state, window,
            *(torch.from_numpy(x.astype(np.int32)) for x in (ins_src, ins_dst, del_src, del_dst)),
            cfg, rowsum=_rowsum_route(route, monkeypatch, state.p, window),
        )
        for g, st in zip(graphs, sts):
            for u, w in zip(del_src.tolist(), del_dst.tolist()):
                apply_edge_event(g, st, u, w, insert=False, alpha=alpha)
            for u, w in zip(ins_src.tolist(), ins_dst.tolist()):
                apply_edge_event(g, st, u, w, insert=True, alpha=alpha)
        p, r = state.p.numpy()[:n], state.r.numpy()[:n]
        M = exact_ppr_matrix(*graphs[0].coo(), n, alpha)
        for j, (t, st) in enumerate(zip(targets, sts)):
            np.testing.assert_allclose(p[:, j], st.p, rtol=0, atol=1e-12)
            np.testing.assert_allclose(r[:, j], st.r, rtol=0, atol=1e-12)
            np.testing.assert_allclose(p[:, j] + M @ r[:, j], M[:, t], rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_batches_match_oracle_and_keep_invariant(seed):
    """Batches of deletes then inserts on a pushed state: the port equals the
    sequential per-edge oracle (pprx.ref.push.apply_edge_event) to 1e-12, and
    the push invariant p + r M = M[q] holds on the new graph to 1e-10 (the
    tolerance of tests/test_invariant.py)."""
    alpha = 0.2
    cfg = PprConfig(alpha=alpha, eps=1e-6)
    rng = np.random.default_rng(seed)
    n, queries = 12, [0, 5]
    src, dst = random_multigraph(rng, n, 40)
    graphs = [OracleGraph(n, src, dst) for _ in queries]
    sts = [PushState.init(n, q, "forward") for q in queries]
    for g, st in zip(graphs, sts):
        forward_push(g, st, alpha, eps=1e-4)
    pad = np.zeros((1, len(queries)))
    state = PprState(
        p=torch.from_numpy(np.vstack([np.stack([st.p for st in sts], 1), pad])),
        r=torch.from_numpy(np.vstack([np.stack([st.r for st in sts], 1), pad])),
        mode=FORWARD,
    )
    for step in range(4):
        cur_src, cur_dst = graphs[0].coo()
        if step == 0:  # every out-edge of one vertex: D == 0
            sel = np.flatnonzero(cur_src == cur_src[0])
        else:
            sel = rng.choice(cur_src.size, size=5, replace=False)
        del_src, del_dst = cur_src[sel], cur_dst[sel]
        ins_src = rng.integers(0, n, size=6)
        ins_dst = (ins_src + 1 + rng.integers(0, n - 1, size=6)) % n
        if step == 0:
            ins_src[0] = cur_src[0]  # and insert from it: from dangling
        state, _ = apply_edge_batch(
            state, WindowGraph.from_coo(cur_src, cur_dst, n, device="cpu"),
            *(torch.from_numpy(x.astype(np.int32)) for x in (ins_src, ins_dst, del_src, del_dst)),
            cfg,
        )
        for g, st in zip(graphs, sts):
            for u, w in zip(del_src.tolist(), del_dst.tolist()):
                apply_edge_event(g, st, u, w, insert=False, alpha=alpha)
            for u, w in zip(ins_src.tolist(), ins_dst.tolist()):
                apply_edge_event(g, st, u, w, insert=True, alpha=alpha)
        p, r = state.p.numpy()[:n], state.r.numpy()[:n]
        M = exact_ppr_matrix(*graphs[0].coo(), n, alpha)
        for j, (q, st) in enumerate(zip(queries, sts)):
            np.testing.assert_allclose(p[:, j], st.p, rtol=0, atol=1e-12)
            np.testing.assert_allclose(r[:, j], st.r, rtol=0, atol=1e-12)
            np.testing.assert_allclose(p[:, j] + r[:, j] @ M, M[q], rtol=0, atol=1e-10)


# ---- the row work on the batch's source rows alone, against the pass over
# every row

ROW_CASES = ["deleted_to_dangling", "insert_from_dangling", "degree_kept", "hub_in_both",
             "phantom_padded", "rows_cover_the_state"]


def _fill(rng, src, dst, n, b, del_idx, ins_from, spare=(), pad=0):
    """A valid deletion batch (the edges ``del_idx``, then other edges whose
    source is not in ``spare``) and an insertion batch (from ``ins_from``,
    then from sources not in ``spare``), each ``b`` lanes, the last ``pad``
    phantom (u = w = n)."""
    del_idx = list(del_idx)
    others = np.flatnonzero(~np.isin(src, list(spare)) & ~np.isin(np.arange(src.size), del_idx))
    del_idx += rng.choice(others, size=b - pad - len(del_idx), replace=False).tolist()
    free = np.setdiff1d(np.arange(n), list(spare))
    ins_src = np.concatenate([ins_from, rng.choice(free, size=b - pad - len(ins_from))])
    ins_dst = (ins_src + 1 + rng.integers(0, n - 1, size=ins_src.size)) % n
    phantom = np.full(pad, n)
    return tuple(np.concatenate([x, phantom]).astype(np.int32) for x in (
        ins_src, ins_dst, src[del_idx], dst[del_idx]))


def _row_case(case, rng):
    """A window and a batch that holds ``case``, and the case's row: its
    source row, whose degree the batch sets as the case says."""
    n, m, b = (8, 30, 6) if case == "rows_cover_the_state" else (40, 240, 12)
    src, dst = random_multigraph(rng, n, m)
    src[src == 3] = 4  # vertex 3 starts with no out-edges
    dst[src == dst] = (dst[src == dst] + 1) % n
    deg = np.bincount(src, minlength=n)
    hub = int(deg.argmax())
    few = int(np.flatnonzero((deg >= 1) & (deg <= 3))[0]) if case != "rows_cover_the_state" else 0
    if case == "deleted_to_dangling":  # loses every out-edge, gets none
        v, batch = few, _fill(rng, src, dst, n, b, np.flatnonzero(src == few), [], spare=[few])
    elif case == "insert_from_dangling":
        v, batch = 3, _fill(rng, src, dst, n, b, [], [3, 3], spare=[3])
    elif case == "degree_kept":  # two out-edges go, two come
        v = hub
        batch = _fill(rng, src, dst, n, b, np.flatnonzero(src == hub)[:2], [hub, hub], spare=[hub])
    elif case == "hub_in_both":
        v = hub
        batch = _fill(rng, src, dst, n, b, np.flatnonzero(src == hub)[:4], [hub] * 5)
    else:  # phantom lanes in both batches; the list covers every row or not
        v, batch = None, _fill(rng, src, dst, n, b, [], [], pad=b // 3)
    return src, dst, n, v, batch


@pytest.mark.parametrize("case", ROW_CASES)
@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_source_row_corrections_equal_the_full_pass(mode, case):
    """The corrections with their row work on the batch's source rows alone
    give the bits of the same corrections over every row (the lanes as they
    come, and sorted by their row as the fast driver hands them over; f32
    and f64), and leave every other row (forward: every row neither a
    source nor a destination) bit for bit as it was. The list holds the
    distinct source rows, ascending, then the phantom row, and counts them."""
    rng = np.random.default_rng(ROW_CASES.index(case))
    src, dst, n, v, batch = _row_case(case, rng)
    ins_src, ins_dst, del_src, del_dst = batch
    d0 = np.bincount(src, minlength=n + 1)
    d_new = d0 - np.bincount(del_src, minlength=n + 1) + np.bincount(ins_src, minlength=n + 1)
    want_case = {"deleted_to_dangling": lambda: d0[v] > 0 and d_new[v] == 0,
                 "insert_from_dangling": lambda: d0[v] == 0 and d_new[v] == 2,
                 "degree_kept": lambda: d_new[v] == d0[v] and v in del_src and v in ins_src,
                 "hub_in_both": lambda: (del_src == v).sum() == 4 and (ins_src == v).sum() == 5,
                 "phantom_padded": lambda: (del_src == n).sum() == (ins_src == n).sum() == 4,
                 "rows_cover_the_state": lambda: del_src.size + ins_src.size >= n + 1}
    assert want_case[case]()
    sources = np.setdiff1d(np.concatenate([del_src, ins_src]), [n])
    rows, count = source_rows(torch.from_numpy(del_src), torch.from_numpy(ins_src), n + 1)
    size = min(del_src.size + ins_src.size, n + 1)
    assert int(count) == sources.size
    assert rows.tolist() == sources.tolist() + [n] * (size - sources.size)
    kept = np.setdiff1d(np.arange(n), np.concatenate(
        [sources, np.concatenate([del_dst, ins_dst]) if mode == FORWARD else []]))
    assert kept.size  # rows the corrections leave alone

    key = 1 if mode == FORWARD else 0
    pn = np.argsort(batch[key], kind="stable")
    po = np.argsort(batch[2 + key], kind="stable")
    ordered = (ins_src[pn], ins_dst[pn], del_src[po], del_dst[po])
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    for dtype, int_type in bits.items():
        p = torch.from_numpy(np.abs(rng.normal(size=(n + 1, 4))) * 1e-2).to(dtype)
        r = torch.from_numpy(rng.normal(size=(n + 1, 4)) * 1e-3).to(dtype)
        p[-1] = r[-1] = 0.0
        for arrays, keys_sorted in ((batch, False), (ordered, True)):
            tensors = [torch.from_numpy(x) for x in arrays]
            out = []
            for apply in (tupdate.apply_edge_batch_, _corrections.full_pass_):
                window = WindowGraph.from_coo(src, dst, n, capacity=src.size + 3, device="cpu")
                state = PprState(p=p.clone(), r=r.clone(), mode=mode)
                rowsum = None if mode == FORWARD else out_row_sums(state.p, window)
                out.append(apply(state, window, *tensors, CFG, rowsum=rowsum,
                                 keys_sorted=keys_sorted))
            (got, got_w), (want, want_w) = out
            assert torch.equal(got_w.deg, want_w.deg)
            assert torch.equal(got.p.view(int_type), want.p.view(int_type))
            assert torch.equal(got.r.view(int_type), want.r.view(int_type))
            at = torch.from_numpy(kept)
            assert torch.equal(got.p[at].view(int_type), p[at].view(int_type))
            assert torch.equal(got.r[at].view(int_type), r[at].view(int_type))
            if mode != FORWARD:
                assert torch.equal(got.p.view(int_type), p.view(int_type))
