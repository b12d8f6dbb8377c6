"""The slide corrections as a pass over every row of the state: the plain
witness that ``pprx_torch.engine.update.apply_edge_batch_``, which does the
row work on the batch's source rows alone, is held to bit for bit, on the
CPU and on the card (the same K1 sums, the same elementwise operations).
Shared by the CPU tests, the card tests and ``chip_smoke.py``'s timing of
both forms; no JAX here."""

import torch

from pprx_torch.engine.state import FORWARD
from pprx_torch.engine.update import _add_lanes_, _counts, out_row_sums


def full_pass_(state, graph, ins_src, ins_dst, del_src, del_dst, cfg, rowsum=None,
               keys_sorted=False):
    """``apply_edge_batch_``'s result, with every row-wise operation over
    all ``N + 1`` rows: in place on ``state.r``, forward ``state.p``, and
    ``graph.deg``; returns ``(state, graph)``."""
    dtype = state.r.dtype
    n_rows = state.p.shape[0]
    alpha = cfg.alpha
    beta = (1.0 - alpha) / alpha
    d0 = graph.deg
    k_del = _counts(del_src, n_rows)
    k_ins = _counts(ins_src, n_rows)
    p, r = state.p, state.r
    deg_new = d0 - k_del + k_ins
    deg_new[-1:].fill_(0)

    if state.mode != FORWARD:
        if rowsum is None:
            rowsum = out_row_sums(p, graph)
        d0f = d0.clamp(min=1).to(dtype)
        d_newf = deg_new.clamp(min=1).to(dtype)
        diff = rowsum.clone()
        _add_lanes_(diff, del_src, p[del_dst].neg_(), None, keys_sorted)
        _add_lanes_(diff, ins_src, p, ins_dst, keys_sorted)
        diff.div_(d_newf[:, None])
        torch.where((deg_new == 0)[:, None], p, diff, out=diff)
        diff.addcdiv_(rowsum, d0f[:, None], value=-1)
        diff.addcmul_(p, (d0 == 0).to(dtype)[:, None], value=-1)
        r.add_(diff.mul_(beta))
        r[-1] = 0.0
        graph.deg.copy_(deg_new)
        return state, graph

    d0f = d0.clamp(min=1).to(dtype)
    _add_lanes_(r, del_dst, (beta * p[del_src] / d0f[del_src, None]).neg_(), None, keys_sorted)
    D = d0 - k_del
    touched = k_del > 0
    full = touched & (D == 0)
    s1 = torch.where(touched, D.clamp(min=1).to(dtype) / d0f, 1.0)
    kd = k_del.to(dtype)
    num = torch.where(full, kd - alpha, kd)
    r_add = torch.where(touched, num / (alpha * d0f), 0.0)

    d1 = D
    d1f = d1.clamp(min=1).to(dtype)
    _add_lanes_(r, ins_dst, beta * (p[ins_src] * s1[ins_src, None]) / d1f[ins_src, None], None,
                keys_sorted)
    touched = k_ins > 0
    from_dangling = touched & (d1 == 0)
    ki = k_ins.to(dtype)
    s2 = torch.where(
        touched, torch.where(from_dangling, ki, (d1 + k_ins).to(dtype) / d1f), 1.0
    )
    num = torch.where(from_dangling, ki - alpha, ki)
    denom = torch.where(from_dangling, alpha, alpha * d1f)
    r_sub = torch.where(touched, num / denom, 0.0)

    r.addcmul_(p, (r_add - r_sub * s1)[:, None])
    p.mul_((s1 * s2)[:, None])
    p[-1] = 0.0
    r[-1] = 0.0
    graph.deg.copy_(deg_new)
    return state, graph
