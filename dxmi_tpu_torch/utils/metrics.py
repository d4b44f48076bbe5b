"""Anomaly-detection metrics (``dxmi_tpu.utils.metrics``, ``metrics.py:9-61``):
AUROC by the rank statistic with ties at their average rank, average
precision, and both from two sets of energies (higher = more anomalous).
numpy only."""
from __future__ import annotations

import numpy as np


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUROC of binary ``labels`` by ``scores`` (sklearn's
    ``roc_auc_score``)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("need both classes for AUROC")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUPR: the mean precision at each positive, ranked by score."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)[np.argsort(-scores,
                                                        kind="mergesort")]
    n_pos = labels.sum()
    if n_pos == 0:
        raise ValueError("no positives")
    precision = np.cumsum(labels) / np.arange(1, len(labels) + 1)
    return float((precision * labels).sum() / n_pos)


def anomaly_scores_from_energy(energies_in: np.ndarray,
                               energies_out: np.ndarray) -> dict:
    """``{'auroc', 'aupr'}`` of telling ``energies_out`` (anomalous, label
    1) from ``energies_in`` (nominal, 0)."""
    scores = np.concatenate([energies_in, energies_out])
    labels = np.concatenate([np.zeros(len(energies_in)),
                             np.ones(len(energies_out))])
    return {"auroc": roc_auc(scores, labels),
            "aupr": average_precision(scores, labels)}
