"""Top-k-by-PPR-score retrieval head (port of ``pprx.retrieve.topk``).

``p`` is vertex-major [N+1, S]; each query's top-k runs over its column,
the phantom row excluded. Scores come out descending and equal scores in
ascending vertex id, as ``lax.top_k`` and the sharded head
(``pprx_torch.dist.retrieve``) give them; ``ids`` index p's rows and the
scores are p's own values. On a CUDA tensor the head is one hand-written
kernel, K5 (``pprx_torch/csrc/topk.cu``, built at first use by
``pprx_torch._ext``), which reads p where it lies: a sampled threshold a
column, one filtering pass, a select and sort of each column's few
candidates, and another pass over a column only where its candidates
overflow their list. On a CPU tensor it is the plain version,
``topk_plain``: a stable sort of each column, descending. Torch has nothing
like ``lax.approx_max_k``, so ``exact=False`` is exact too. The
reference's chunked two-stage reduction (``exact_topk_rows``,
``TOPK_LANES_MAX``) guards a TPU compile-time cliff and is not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from pprx_torch import _ext, trace
from pprx_torch.engine.segsum import lanes_for
from pprx_torch.engine.state import PprState

# Calls that launched the kernel since the last reset (as ``segsum.LAUNCHES``).
LAUNCHES = {"topk": 0}

# Rows a sampled row stands for: about k * SAMPLE_STRIDE candidates a column
# pass the filter, against N / SAMPLE_STRIDE rows the sample reads.
SAMPLE_STRIDE = 128

# The kernel's counts on each card (int64 [4], ``csrc/topk.cu``): calls,
# extra column passes, candidates the filter kept summed over the columns,
# most kept by one column. Never reset; read them off the timed path.
COUNTS: dict[torch.device, torch.Tensor] = {}
CALLS, EXTRA_PASSES, KEPT, MOST_KEPT = range(4)

# A column's candidate count sits CNT_STRIDE int32 from the next one's
# (``csrc/topk.cu``'s kCntStride: a cache line each).
CNT_STRIDE = 32

# Elements a plain sort takes at once: columns in blocks, so that its
# temporaries stay near this many elements whatever the shape.
PLAIN_BLOCK = 1 << 27


def reset_launches() -> None:
    LAUNCHES["topk"] = 0


def launches() -> int:
    return LAUNCHES["topk"]


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's shape rule for N rows and top ``k``: rows 0, ``stride``,
    2 ``stride``, ... sampled (``m`` of them, at least ``k``); each column's
    list holds ``cap`` ranks, the sample's and then the filter's candidates:
    a rank of a random sample's k-th largest in the column is about ``k *
    stride``, with a spread of about ``sqrt(k) * stride``. ``cap`` is at most
    N, and above ``k`` wherever it is below N, so that a column that overflows
    it sheds ranks on every pass it takes again."""

    stride: int
    m: int
    cap: int


def plan(n: int, k: int) -> Plan:
    stride = max(1, min(SAMPLE_STRIDE, n // k))
    m = -(-n // stride)
    want = math.ceil((k + 4 * math.sqrt(k) + 8) * stride)
    return Plan(stride, m, min(n, max(m, want)))


def counts(device: torch.device) -> torch.Tensor:
    """The kernel's counts on ``device`` (a tensor there: read it off the
    timed path); zeros before its first call there."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in COUNTS:
        COUNTS[device] = torch.zeros(4, dtype=torch.int64, device=device)
    return COUNTS[device]


def topk_plain(p: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: each column of ``p[:-1]`` stably sorted, descending
    (equal scores in ascending row), its first ``k``; the columns in blocks
    of about ``PLAIN_BLOCK`` elements."""
    n, s = p.shape[0] - 1, p.shape[1]
    scores = torch.empty((s, k), dtype=p.dtype, device=p.device)
    ids = torch.empty((s, k), dtype=torch.int64, device=p.device)
    step = max(1, PLAIN_BLOCK // max(n, 1))
    for lo in range(0, s, step):
        hi = min(s, lo + step)
        sc, ix = torch.sort(p[:-1, lo:hi].T, dim=1, descending=True, stable=True)
        scores[lo:hi], ids[lo:hi] = sc[:, :k], ix[:, :k]
    return scores, ids


_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _entry():
    """The C entry point of the built ``topk`` library."""
    fn = _ext.load("topk").pprx_topk_f32
    # p, n_rows, s, k, stride, m, cap, vec, lanes, buf, cnt, theta, scores,
    # ids, counts, stream
    fn.argtypes = [_PTR, _LONG, _INT, _INT, _LONG, _LONG, _LONG, _INT, _INT, *[_PTR] * 6, _PTR]
    fn.restype = _INT
    return fn


def topk_kernel(p: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 on a CUDA ``p``: f32, contiguous, 16-byte aligned, fewer than 2^31
    rows; the same bits as ``topk_plain``."""
    if p.dtype != torch.float32:
        raise TypeError(f"topk_candidates on CUDA takes f32 p, got {p.dtype}")
    if not p.is_contiguous() or p.data_ptr() % 16:
        raise ValueError("topk_candidates on CUDA needs a contiguous, 16-byte-aligned p")
    n, s = p.shape[0] - 1, p.shape[1]
    if n >= 2**31 - 1 or s >= 2**31:
        raise ValueError(f"topk_candidates on CUDA takes fewer than 2^31 rows, got {n}")
    scores = torch.empty((s, k), dtype=torch.float32, device=p.device)
    ids = torch.empty((s, k), dtype=torch.int64, device=p.device)
    if s == 0:
        return scores, ids
    pl = plan(n, k)
    vec, lanes = lanes_for(s)
    buf = torch.empty((s, pl.cap), dtype=torch.int64, device=p.device)
    cnt = torch.empty(s * CNT_STRIDE, dtype=torch.int32, device=p.device)
    theta = torch.empty(s, dtype=torch.int64, device=p.device)
    with torch.cuda.device(p.device):
        err = _entry()(
            p.data_ptr(), n, s, k, pl.stride, pl.m, pl.cap, vec, lanes, buf.data_ptr(),
            cnt.data_ptr(), theta.data_ptr(), scores.data_ptr(), ids.data_ptr(),
            counts(p.device).data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk kernel launch failed: cudaError {err}")
    LAUNCHES["topk"] += 1
    return scores, ids


def topk_candidates(
    p: torch.Tensor, k: int, exact: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k vertices by reserve score: (scores [S, k], ids [S, k]
    int64), scores descending per query, equal scores in ascending id.
    ``exact`` is accepted for the reference's signature; both values give
    the exact answer. ``1 <= k <= N``. The flight recorder stamps its device
    work at ``topk`` and ``topk.end``."""
    del exact  # see module docstring
    if p.dim() != 2:
        raise ValueError(f"topk_candidates: p must be [N+1, S], got {tuple(p.shape)}")
    if not 1 <= k <= p.shape[0] - 1:
        raise ValueError(f"topk_candidates: k must be in [1, {p.shape[0] - 1}], got {k}")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_candidates: unsupported device {p.device}")
    trace.stamp("topk", p.device)
    out = topk_plain(p, k) if p.device.type == "cpu" else topk_kernel(p, k)
    trace.stamp("topk.end", p.device)
    return out


def retrieve(state: PprState, k: int = 100, exact: bool = True):
    """Candidate generation from a converged push state."""
    return topk_candidates(state.p, k, exact)
