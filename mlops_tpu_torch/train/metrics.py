"""Binary-classification metrics: the JAX package's ``train/metrics.py``
in torch, f32 throughout, on whatever device the logits lie on.

``validation_{accuracy, roc_auc, f1, precision, recall}_score`` are the
reference's per-trial validation metrics."""

from __future__ import annotations

import torch


def roc_auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """ROC-AUC as the Mann-Whitney U statistic with average ranks for
    ties (``sklearn.metrics.roc_auc_score`` up to floating point); 0.5
    when a class is absent."""
    scores = scores.float()
    labels = labels.float()
    n = scores.shape[0]
    sorted_scores = torch.sort(scores).values
    first = torch.searchsorted(sorted_scores, scores, side="left")
    last = torch.searchsorted(sorted_scores, scores, side="right")
    ranks = (first + last + 1).float() / 2.0  # 1-indexed average ranks
    n_pos = labels.sum()
    n_neg = n - n_pos
    u = torch.sum(ranks * labels) - n_pos * (n_pos + 1.0) / 2.0
    auc = u / torch.clamp(n_pos * n_neg, min=1.0)
    return torch.where((n_pos == 0) | (n_neg == 0), torch.full_like(auc, 0.5), auc)


def binary_metrics(
    logits: torch.Tensor, labels: torch.Tensor, threshold: float = 0.5
) -> dict[str, torch.Tensor]:
    """accuracy / roc_auc / f1 / precision / recall of raw logits at a
    probability threshold."""
    labels = labels.float()
    probs = torch.sigmoid(logits.float())
    preds = (probs >= threshold).float()
    tp = torch.sum(preds * labels)
    fp = torch.sum(preds * (1.0 - labels))
    fn = torch.sum((1.0 - preds) * labels)
    precision = tp / torch.clamp(tp + fp, min=1.0)
    recall = tp / torch.clamp(tp + fn, min=1.0)
    f1 = 2.0 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return {
        "accuracy": torch.mean((preds == labels).float()),
        "roc_auc": roc_auc(probs, labels),
        "f1": f1,
        "precision": precision,
        "recall": recall,
    }
