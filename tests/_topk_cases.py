"""Inputs of the top-k head's tests, shared by the CPU tests of its plain
version and the card tests of its kernel (no JAX here): states with ties,
zeros, negative scores and a phantom row that would win if it were read, and
the answer by an independent sort."""

import numpy as np
import torch

SHAPES = [1, 8, 16, 128, 512]  # S: every width the port runs, and one
TOPS = [1, 7, 100, None]  # k; None: k = N
TIED_ROWS = 300  # rows of column 0 tied at its k-th position


def state(n: int, s: int, k: int, seed: int = 0) -> torch.Tensor:
    """A [n + 1, s] f32 state: normal scores (about half negative); column 0
    has k // 2 rows above TIED_ROWS rows tied at the k-th position; column 1
    is all zero, -0.0 in every third row; column 2 all negative; the phantom
    row is +inf."""
    rng = np.random.default_rng([seed, n, s, k])
    p = rng.standard_normal((n + 1, s)).astype(np.float32)
    rows = rng.permutation(n)
    tied = min(TIED_ROWS, n - k // 2)
    p[:n, 0] = np.minimum(p[:n, 0], 2.0)
    p[rows[: k // 2], 0] = 4.0 + rng.random(k // 2, dtype=np.float32)
    p[rows[k // 2: k // 2 + tied], 0] = 3.0
    if s > 1:
        p[:, 1] = 0.0
        p[0:n:3, 1] = -0.0
    if s > 2:
        p[:, 2] = -np.abs(p[:, 2]) - 1e-3
    p[n] = np.inf
    return torch.from_numpy(p)


def expected(p: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(scores, ids) [S, k] by numpy's lexsort: score descending, then row
    ascending, the phantom row left out."""
    x = p[:-1].cpu().numpy()
    rows = np.arange(x.shape[0])
    ids = np.stack([np.lexsort((rows, -x[:, j]))[:k] for j in range(x.shape[1])])
    return np.take_along_axis(x.T, ids, axis=1), ids


def same_bits(got: tuple[torch.Tensor, torch.Tensor], want) -> None:
    """Scores equal bit for bit (a -0.0 is not a 0.0), ids equal."""
    sc, ids = (t.cpu().numpy() for t in got)
    wsc, wids = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t) for t in want)
    assert ids.dtype == np.int64 and sc.dtype == np.float32
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_array_equal(sc.view(np.int32), wsc.astype(np.float32).view(np.int32))
