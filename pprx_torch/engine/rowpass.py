"""Row passes over the ``[N+1, S]`` push state: a scan round's elementwise
work and the post-delivery rescan, each one pass over the state.

- ``scan_pass_`` (K2): the activity test, the mass taken off ``r`` onto
  ``p`` in place, the ``moving`` rows the segment sum delivers, and the
  round's counts (active pairs; forward the edge pushes; reverse each row's
  active pairs, which the caller gathers over its edge views);
- ``frontier_rows`` (K3): which rows hold an active pair, with the next
  frontier's counts;
- ``corr_forward_`` and ``corr_reverse_``: a slide's corrections' row work
  (``pprx_torch.engine.update``) on a list of rows, the batch's source
  rows padded with the phantom row, which they skip.

No Pallas kernel stands behind them: on the TPU, XLA fused the same ops of
``dense_round_sorted`` (``pprx/engine/wl2.py:177-290``) and of the rescan
(``:506-516``, ``:639-649``) into a few loops. Eager torch makes each op a
pass of its own over the state, so on CUDA tensors both run the
hand-written Hopper kernels of ``pprx_torch/csrc/rowpass.cu`` (built at
first use by ``pprx_torch._ext``), which give the plain versions' bits. On
CPU tensors they run the plain versions, ``scan_pass_plain`` and
``frontier_rows_plain``: the torch code of ``pprx_torch.engine.wl2`` that
the kernels replace (and ``corr_forward_plain``, ``corr_reverse_plain``:
the corrections' torch code on the list's rows, gathered and written back).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pprx_torch import _ext
from pprx_torch.engine.segsum import lanes_for

# Calls that launched a kernel since the last reset, by entry (as
# ``segsum.LAUNCHES``).
LAUNCHES = {"scan_pass": 0, "frontier_rows": 0, "corr_forward": 0, "corr_reverse": 0}
ENTRIES = tuple(LAUNCHES)

THREADS = 256  # a block's threads: rowpass.cu's kThreads


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def launches(entry: str | None = None, since: dict | None = None) -> int:
    """Launches counted since the last reset, or since ``since`` (an earlier
    ``dict(LAUNCHES)``): of one entry or of both."""
    return sum(count - (since[key] if since else 0)
               for key, count in LAUNCHES.items() if entry in (None, key))


def active_mask(r: torch.Tensor, deg: torch.Tensor, eps: float, forward: bool) -> torch.Tensor:
    """The push threshold test, ``[R, S]`` bool: ``|r| > eps * max(deg, 1)``
    per row forward, ``|r| > eps`` reverse."""
    absr = r.abs()
    if forward:
        thresh = eps * deg.clamp(min=1).to(r.dtype)
        return absr > thresh[:, None]
    return absr > eps


def scan_pass_plain(p, r, deg, moving, counts, row_act=None, *, eps, alpha, forward) -> None:
    """The plain version of ``scan_pass_``, in ``r``'s dtype."""
    act = active_mask(r, deg, eps, forward)
    mass = torch.where(act, r, 0.0)
    dangling = (deg == 0)[:, None]
    p.add_(torch.where(dangling, mass, alpha * mass))
    r.sub_(mass)
    inv_deg = 1.0 / deg.clamp(min=1).to(r.dtype)
    if forward:
        moving.copy_((1.0 - alpha) * mass * inv_deg[:, None])
        counts[1].add_((act * deg[:, None]).sum())
    else:
        beta = (1.0 - alpha) / alpha
        moving.copy_(torch.where(dangling, beta * mass, (1.0 - alpha) * mass))
    counts[0].add_(act.sum())
    if row_act is not None:
        row_act.copy_(act.sum(dim=1))


def frontier_rows_plain(r, deg, row_len, f_len, *, eps, forward):
    """The plain version of ``frontier_rows``."""
    any2 = active_mask(r, deg, eps, forward).any(dim=1)
    cn2 = any2.sum()
    fed2 = torch.where(any2, row_len, 0).sum()
    fre2 = torch.where(any2, f_len, 0).sum()
    return any2, cn2, fed2, fre2


def corr_forward_plain(r, p, rows, c_r, c_p) -> None:
    """The plain version of ``corr_forward_``: the listed rows gathered,
    updated and written back (the phantom row's padding too)."""
    p_rows = p[rows]
    r.index_copy_(0, rows, r[rows].addcmul_(p_rows, c_r[rows, None]))
    p.index_copy_(0, rows, p_rows.mul_(c_p[rows, None]))


def corr_reverse_plain(r, p, rowsum, diff, rows, deg_new, d0, beta) -> None:
    """The plain version of ``corr_reverse_``, in ``diff``."""
    dtype = r.dtype
    diff.div_(deg_new.clamp(min=1).to(dtype)[rows, None])
    p_rows = p[rows]
    torch.where((deg_new[rows] == 0)[:, None], p_rows, diff, out=diff)
    diff.addcdiv_(rowsum[rows], d0.clamp(min=1).to(dtype)[rows, None], value=-1)
    diff.addcmul_(p_rows, (d0[rows] == 0).to(dtype)[:, None], value=-1)
    # beta * diff rounded, then added: the out-of-place form's two roundings
    r.index_copy_(0, rows, r[rows].add_(diff.mul_(beta)))


_PTR, _INT, _LONG, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def _entries() -> dict:
    """The C entry points of the built ``rowpass`` library."""
    lib = _ext.load("rowpass")
    fns = {torch.float32: lib.pprx_scan_pass_f32, torch.bfloat16: lib.pprx_scan_pass_bf16}
    for fn in fns.values():
        # p, r, deg, moving, counts, row_act, n_rows, s, vec, lanes, blocks,
        # forward, eps, alpha, 1 - alpha, beta, stream
        fn.argtypes = [*[_PTR] * 6, _LONG, *[_INT] * 5, *[_FLOAT] * 4, _PTR]
        fn.restype = _INT
    rows = lib.pprx_frontier_rows
    # r, deg, row_len, f_len, any, counts, n_rows, s, vec, lanes, blocks,
    # forward, eps, stream
    rows.argtypes = [*[_PTR] * 6, _LONG, *[_INT] * 5, _FLOAT, _PTR]
    rows.restype = _INT
    fns["frontier_rows"] = rows
    fwd = lib.pprx_corr_forward
    # r, p, rows, c_r, c_p, t, n, s, vec, lanes, blocks, stream
    fwd.argtypes = [*[_PTR] * 5, _LONG, _LONG, *[_INT] * 4, _PTR]
    fwd.restype = _INT
    fns["corr_forward"] = fwd
    rev = lib.pprx_corr_reverse
    # r, p, rowsum, diff, rows, deg_new, d0, t, n, s, vec, lanes, blocks, beta, stream
    rev.argtypes = [*[_PTR] * 7, _LONG, _LONG, *[_INT] * 4, _FLOAT, _PTR]
    rev.restype = _INT
    fns["corr_reverse"] = rev
    return fns


def _f32(x: float) -> float:
    """``x`` as torch rounds a Python scalar for an f32 op."""
    return float(np.float32(x))


def _grid(r: torch.Tensor, n_rows: int | None = None) -> tuple[int, int, int]:
    """(columns per lane, lanes per row, blocks) of a launch over ``r``'s
    rows (or ``n_rows`` of them: a list's entries): a warp takes ``32 //
    lanes`` rows a step, and the blocks are as many as the steps need; the
    kernel runs one wave of them at most, which strides over the rest."""
    s = r.shape[1]
    n_rows = r.shape[0] if n_rows is None else n_rows
    vec, lanes = lanes_for(s)
    steps = -(-n_rows // (32 // lanes))
    return vec, lanes, min(-(-steps // (THREADS // 32)), 2**31 - 1)


def _check(what: str, state: dict, rows: dict, r: torch.Tensor) -> None:
    """``state``: the ``[R, S]`` operands by name, ``rows``: the ``[R]``
    integer ones; all on one device, the CPU or a card."""
    if r.dim() != 2:
        raise ValueError(f"{what}: r must be [R, S], got {tuple(r.shape)}")
    for name, t in state.items():
        if t.shape != r.shape:
            raise ValueError(f"{what}: {name} must be {tuple(r.shape)}, got {tuple(t.shape)}")
    for name, t in rows.items():
        if t.shape != r.shape[:1]:
            raise ValueError(f"{what}: {name} must be [{r.shape[0]}], got {tuple(t.shape)}")
        if t.is_floating_point():
            raise TypeError(f"{what}: {name} must be an integer tensor, got {t.dtype}")
    operands = {**state, **rows}
    devs = {t.device for t in operands.values()}
    if len(devs) != 1:
        raise ValueError(f"{what}: all operands must be on one device, got {devs}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {r.device}")


F32, I32 = (torch.float32,), (torch.int32,)


def _check_kernel(what: str, operands: dict, state: tuple[str, ...]) -> None:
    """What the kernels take: ``operands`` maps a name to (tensor, the
    dtypes taken); every one contiguous, those named in ``state`` 16-byte
    aligned."""
    for name, (t, dtypes) in operands.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{what} on CUDA takes {name} in {dtypes}, got {t.dtype}")
    if not all(t.is_contiguous() for t, _ in operands.values()):
        raise ValueError(f"{what} on CUDA needs contiguous operands")
    if any(operands[name][0].data_ptr() % 16 for name in state):
        raise ValueError(f"{what} on CUDA needs 16-byte-aligned {', '.join(state)}")


def scan_pass_(
    p: torch.Tensor,
    r: torch.Tensor,
    deg: torch.Tensor,
    moving: torch.Tensor,
    counts: torch.Tensor,
    row_act: torch.Tensor | None = None,
    *,
    eps: float,
    alpha: float,
    forward: bool,
) -> None:
    """A scan round's elementwise work, in one pass over ``[R, S]``: for
    every row ``v`` with ``th = eps * max(deg[v], 1)`` forward, ``eps``
    reverse, and ``m = r`` where ``|r| > th``, else 0:
    ``p += m`` on a dangling row (``deg == 0``), else ``alpha * m``;
    ``r -= m``; ``moving = (1 - alpha) * m / max(deg, 1)`` forward, and in
    reverse ``beta * m`` on a dangling row, else ``(1 - alpha) * m``
    (``beta = (1 - alpha) / alpha``). ``p``, ``r`` and ``moving`` are
    written in place.

    counts: int64 [2]; ``counts[0]`` gains the active pairs, forward
        ``counts[1]`` the edge pushes (active pairs times the row's degree).
    row_act: optional int32 [R]: each row's active pairs.

    On CUDA: f32 ``p`` and ``r``, int32 ``deg``, f32 or bf16 ``moving``
    (round to nearest even), all contiguous and 16-byte aligned.
    """
    _check("scan_pass_", {"p": p, "r": r, "moving": moving},
           {"deg": deg} | ({} if row_act is None else {"row_act": row_act}), r)
    if counts.shape != (2,) or counts.dtype != torch.int64 or counts.device != r.device:
        raise ValueError("scan_pass_: counts must be int64 [2] on r's device")
    if r.device.type == "cpu":
        scan_pass_plain(p, r, deg, moving, counts, row_act, eps=eps, alpha=alpha,
                        forward=forward)
        return
    _check_kernel("scan_pass_", {
        "p": (p, F32), "r": (r, F32), "moving": (moving, (torch.float32, torch.bfloat16)),
        "deg": (deg, I32), **({} if row_act is None else {"row_act": (row_act, I32)}),
    }, ("p", "r", "moving"))
    n_rows, s = r.shape
    if n_rows == 0 or s == 0:
        return
    vec, lanes, blocks = _grid(r)
    with torch.cuda.device(r.device):
        err = _entries()[moving.dtype](
            p.data_ptr(), r.data_ptr(), deg.data_ptr(), moving.data_ptr(), counts.data_ptr(),
            None if row_act is None else row_act.data_ptr(), n_rows, s, vec, lanes, blocks,
            int(forward), _f32(eps), _f32(alpha), _f32(1.0 - alpha),
            _f32((1.0 - alpha) / alpha), torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_pass kernel launch failed: cudaError {err}")
    LAUNCHES["scan_pass"] += 1


def frontier_rows(
    r: torch.Tensor,
    deg: torch.Tensor,
    row_len: torch.Tensor,
    f_len: torch.Tensor,
    *,
    eps: float,
    forward: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Which rows of ``r`` ([R, S]) hold an active pair (the threshold of
    ``scan_pass_``), in one read of ``r``: (``any2`` bool [R], and int64
    device scalars ``cn2 = sum any2``, ``fed2 = sum any2 * row_len``,
    ``fre2 = sum any2 * f_len``). ``deg``, ``row_len`` and ``f_len``: [R].

    On CUDA: f32 ``r``, int32 ``deg``, ``row_len`` and ``f_len``, all
    contiguous, ``r`` 16-byte aligned.
    """
    _check("frontier_rows", {"r": r}, {"deg": deg, "row_len": row_len, "f_len": f_len}, r)
    if r.device.type == "cpu":
        return frontier_rows_plain(r, deg, row_len, f_len, eps=eps, forward=forward)
    _check_kernel("frontier_rows", {"r": (r, F32), "deg": (deg, I32), "row_len": (row_len, I32),
                                    "f_len": (f_len, I32)}, ("r",))
    n_rows, s = r.shape
    any2 = torch.empty(n_rows, dtype=torch.bool, device=r.device)
    counts = torch.zeros(3, dtype=torch.int64, device=r.device)
    if n_rows and s:
        vec, lanes, blocks = _grid(r)
        with torch.cuda.device(r.device):
            err = _entries()["frontier_rows"](
                r.data_ptr(), deg.data_ptr(), row_len.data_ptr(), f_len.data_ptr(),
                any2.data_ptr(), counts.data_ptr(), n_rows, s, vec, lanes, blocks,
                int(forward), _f32(eps), torch.cuda.current_stream(r.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"frontier_rows kernel launch failed: cudaError {err}")
        LAUNCHES["frontier_rows"] += 1
    return any2, counts[0], counts[1], counts[2]


def _check_list(what: str, r: torch.Tensor, rows: torch.Tensor, per_row: dict,
                blocks: dict) -> None:
    """The corrections' operands: ``r``'s ``[R, S]`` shape for ``blocks``
    given as ``"name": (tensor, rows)`` (``rows`` None: R), an int64 list
    ``rows`` and the ``[R]`` operands ``per_row``, on one device."""
    if r.dim() != 2:
        raise ValueError(f"{what}: r must be [R, S], got {tuple(r.shape)}")
    if rows.dim() != 1 or rows.dtype != torch.int64:
        raise ValueError(f"{what}: rows must be a 1-D int64 tensor")
    for name, (t, n) in blocks.items():
        want = (r.shape[0] if n is None else n, r.shape[1])
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} must be {want}, got {tuple(t.shape)}")
    for name, t in per_row.items():
        if t.shape != r.shape[:1]:
            raise ValueError(f"{what}: {name} must be [{r.shape[0]}], got {tuple(t.shape)}")
    devs = {t.device for t in (rows, *per_row.values(), *(t for t, _ in blocks.values()))}
    if len(devs) != 1:
        raise ValueError(f"{what}: all operands must be on one device, got {devs}")


def _launch_list(entry: str, r: torch.Tensor, rows: torch.Tensor, ptrs: list,
                 last: tuple = ()) -> None:
    t = rows.shape[0]
    if t == 0 or r.shape[1] == 0:
        return
    vec, lanes, blocks = _grid(r, t)
    with torch.cuda.device(r.device):
        err = _entries()[entry](*ptrs, t, r.shape[0] - 1, r.shape[1], vec, lanes, blocks, *last,
                                torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    LAUNCHES[entry] += 1


def corr_forward_(r: torch.Tensor, p: torch.Tensor, rows: torch.Tensor, c_r: torch.Tensor,
                  c_p: torch.Tensor) -> None:
    """The forward corrections' row pass on the listed rows: for each ``u``
    of ``rows`` (int64) below ``R - 1``, ``r[u] += p[u] * c_r[u]`` (torch's
    ``addcmul``: one fma on the card) and ``p[u] *= c_p[u]``, in place.
    ``R - 1``, the phantom row, pads the list: the kernel skips it, the
    plain version writes it too (its caller zeroes it). ``c_r``, ``c_p``:
    [R].

    On CUDA: f32 ``r``, ``p``, ``c_r`` and ``c_p``, all contiguous, ``r``
    and ``p`` 16-byte aligned.
    """
    _check_list("corr_forward_", r, rows, {"c_r": c_r, "c_p": c_p}, {"p": (p, None)})
    if r.device.type == "cpu":
        corr_forward_plain(r, p, rows, c_r, c_p)
        return
    _check_kernel("corr_forward_", {"r": (r, F32), "p": (p, F32), "c_r": (c_r, F32),
                                    "c_p": (c_p, F32), "rows": (rows, (torch.int64,))},
                  ("r", "p"))
    _launch_list("corr_forward", r, rows, [r.data_ptr(), p.data_ptr(), rows.data_ptr(),
                                           c_r.data_ptr(), c_p.data_ptr()])


def corr_reverse_(r: torch.Tensor, p: torch.Tensor, rowsum: torch.Tensor, diff: torch.Tensor,
                  rows: torch.Tensor, deg_new: torch.Tensor, d0: torch.Tensor,
                  beta: float) -> None:
    """The reverse corrections' row pass on the listed rows: for the ``i``-th
    entry ``u`` of ``rows`` (int64) below ``R - 1``, with ``diff[i]`` the new
    sums of ``p`` over ``u``'s out-row, ``x = diff[i] / max(deg_new[u], 1)``,
    or ``p[u]`` where ``deg_new[u] == 0``; ``x -= rowsum[u] / max(d0[u],
    1)``; ``x -= p[u] * (d0[u] == 0)``; ``r[u] += beta * x`` (the product
    rounded, then the sum), in place. ``R - 1`` pads the list, as for
    ``corr_forward_``. ``diff``: [T, S], T the list's length; the plain
    version works in it. ``deg_new``, ``d0``: [R].

    On CUDA: f32 ``r``, ``p``, ``rowsum`` and ``diff``, int32 ``deg_new``
    and ``d0``, all contiguous, the f32 ones 16-byte aligned.
    """
    _check_list("corr_reverse_", r, rows, {"deg_new": deg_new, "d0": d0},
                {"p": (p, None), "rowsum": (rowsum, None), "diff": (diff, rows.shape[0])})
    if r.device.type == "cpu":
        corr_reverse_plain(r, p, rowsum, diff, rows, deg_new, d0, beta)
        return
    _check_kernel("corr_reverse_", {
        "r": (r, F32), "p": (p, F32), "rowsum": (rowsum, F32), "diff": (diff, F32),
        "rows": (rows, (torch.int64,)), "deg_new": (deg_new, I32), "d0": (d0, I32),
    }, ("r", "p", "rowsum", "diff"))
    _launch_list("corr_reverse", r, rows, [
        r.data_ptr(), p.data_ptr(), rowsum.data_ptr(), diff.data_ptr(), rows.data_ptr(),
        deg_new.data_ptr(), d0.data_ptr()], (_f32(beta),))
