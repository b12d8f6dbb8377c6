"""Row passes over the ``[N+1, S]`` push state: a scan round's elementwise
work and the post-delivery rescan, each one pass over the state.

- ``scan_pass_`` (K2): the activity test, the mass taken off ``r`` onto
  ``p`` in place, the ``moving`` rows the segment sum delivers, and the
  round's counts (active pairs; forward the edge pushes; reverse each row's
  active pairs, which the caller gathers over its edge views);
- ``frontier_rows`` (K3): which rows hold an active pair, with the next
  frontier's counts.

No Pallas kernel stands behind them: on the TPU, XLA fused the same ops of
``dense_round_sorted`` (``pprx/engine/wl2.py:177-290``) and of the rescan
(``:506-516``, ``:639-649``) into a few loops. Eager torch makes each op a
pass of its own over the state, so on CUDA tensors both run the
hand-written Hopper kernels of ``pprx_torch/csrc/rowpass.cu`` (built at
first use by ``pprx_torch._ext``), which give the plain versions' bits. On
CPU tensors they run the plain versions, ``scan_pass_plain`` and
``frontier_rows_plain``: the torch code of ``pprx_torch.engine.wl2`` that
the kernels replace.
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
LAUNCHES = {"scan_pass": 0, "frontier_rows": 0}
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
    return fns


def _f32(x: float) -> float:
    """``x`` as torch rounds a Python scalar for an f32 op."""
    return float(np.float32(x))


def _grid(r: torch.Tensor) -> tuple[int, int, int]:
    """(columns per lane, lanes per row, blocks) of a launch over ``r``: a
    warp takes ``32 // lanes`` rows a step, and the blocks are as many as
    the steps need; the kernel runs one wave of them at most, which strides
    over the rest."""
    n_rows, s = r.shape
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
