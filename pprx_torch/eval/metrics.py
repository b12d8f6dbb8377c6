"""Accuracy against exact PPR (counterpart of ``pprx.eval.metrics``): L1 and
max error of a reserve vector, top-k precision and tie-aware recall."""

from __future__ import annotations

import numpy as np


def l1_error(approx: np.ndarray, exact: np.ndarray) -> float:
    return float(np.abs(np.asarray(approx) - np.asarray(exact)).sum())


def max_error(approx: np.ndarray, exact: np.ndarray) -> float:
    return float(np.abs(np.asarray(approx) - np.asarray(exact)).max())


def precision_at_k(pred_ids: np.ndarray, exact_scores: np.ndarray, k: int) -> float:
    """|top-k(pred) ∩ top-k(exact)| / k. Ties at the k-th exact score count
    as hits (any vertex scoring at least the k-th exact score), so an exact
    answer always scores 1.0."""
    pred = np.asarray(pred_ids)[:k]
    exact_scores = np.asarray(exact_scores)
    kth = np.sort(exact_scores)[-k]
    return float(np.sum(exact_scores[pred] >= kth)) / k


def recall_at_k_ties(pred_ids: np.ndarray, exact_scores: np.ndarray, k: int) -> float:
    """Tie-aware recall@k: hits strictly above the k-th exact score count
    fully; hits at it count only up to the boundary's free slots (k minus
    the count strictly above), so tied vertices can never stand in for a
    missed better one. Plain set recall where the boundary has no tie."""
    pred = np.asarray(pred_ids)[:k]
    exact_scores = np.asarray(exact_scores)
    kth = np.sort(exact_scores)[-k]
    above = int(np.sum(exact_scores > kth))
    sc = exact_scores[pred]
    return (int(np.sum(sc > kth)) + min(int(np.sum(sc == kth)), k - above)) / k
