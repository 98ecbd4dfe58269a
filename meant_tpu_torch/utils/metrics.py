"""Device-side classification metrics (counterpart of
meant_tpu/utils/metrics.py).

The confusion matrix accumulates on the device as per-batch deltas; the
metrics (accuracy, macro/micro F1, precision, recall, MCC) derive from it
once per epoch, when `compute` fetches it. AUROC is exact, from collected
scores, via the rank statistic.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_delta(probs: torch.Tensor, labels: torch.Tensor,
                    num_classes: int) -> torch.Tensor:
    """One batch's (C, C) int64 confusion matrix on the batch's device;
    rows are targets, columns predictions. probs: (b, C); labels: (b,).
    (index_add_, not bincount: bincount on a CUDA tensor reads its max back
    to the host.)"""
    idx = labels.to(torch.int64) * num_classes + probs.argmax(dim=-1)
    cm = torch.zeros(num_classes * num_classes, dtype=torch.int64,
                     device=probs.device)
    cm.index_add_(0, idx, torch.ones_like(idx))
    return cm.reshape(num_classes, num_classes)


def metrics_from_confusion(cm) -> dict:
    """torchmetrics-compatible multiclass metrics from a confusion matrix
    (rows = target, cols = prediction)."""
    cm = np.asarray(cm, dtype=np.float64)
    total = cm.sum()
    tp = np.diag(cm)
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    accuracy = tp.sum() / max(total, 1)
    # micro precision == micro recall == micro f1 == accuracy (multiclass)
    s, c = total, tp.sum()
    sum_pk_tk = (predicted * support).sum()
    denom = np.sqrt(max(s ** 2 - (predicted ** 2).sum(), 0)) * \
        np.sqrt(max(s ** 2 - (support ** 2).sum(), 0))
    mcc = (c * s - sum_pk_tk) / denom if denom > 0 else 0.0
    return {
        "accuracy": float(accuracy),
        "f1_macro": float(f1.mean()),
        "f1_micro": float(accuracy),
        "precision_macro": float(precision.mean()),
        "precision_micro": float(accuracy),
        "recall_macro": float(recall.mean()),
        "recall_micro": float(accuracy),
        "mcc": float(mcc),
        "per_class_f1": f1.tolist(),
        "confusion": cm.tolist(),
    }


def binary_auroc(scores, labels) -> float:
    """Exact AUROC via the Mann-Whitney rank statistic (ties get average
    ranks). scores: positive-class score per sample."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    pos, neg = scores[labels == 1], scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return 0.0
    all_scores = np.concatenate([neg, pos])
    order = np.argsort(all_scores, kind="mergesort")
    _, inv, counts = np.unique(all_scores[order], return_inverse=True,
                               return_counts=True)
    cum = np.concatenate([[0], np.cumsum(counts)])
    avg = (cum[:-1] + cum[1:] + 1) / 2.0
    ranks = np.empty(len(order), dtype=np.float64)
    ranks[order] = avg[inv]
    r_pos = ranks[len(neg):].sum()
    return float((r_pos - len(pos) * (len(pos) + 1) / 2)
                 / (len(pos) * len(neg)))


class F1Metrics:
    """Stateful metrics of one set (same printout labels as the reference's
    utils/f1_metrics.py); the confusion matrix stays on `device` until
    `compute`."""

    def __init__(self, num_classes: int, set_name: str, device=None):
        self.num_classes = num_classes
        self.set_name = set_name
        self.cm = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                              device=device)
        self._scores = []
        self._labels = []

    def update_cm(self, cm_delta: torch.Tensor) -> None:
        self.cm += cm_delta

    def compute(self) -> dict:
        m = metrics_from_confusion(self.cm.cpu().numpy())
        if self._scores and self.num_classes == 2:
            m["auroc"] = binary_auroc(np.concatenate(self._scores)[:, 1],
                                      np.concatenate(self._labels))
        return m

    def show(self):
        m = self.compute()
        name = self.set_name
        print(name + " accuracy: ", m["accuracy"])
        print("Macro " + name + " f1: ", m["f1_macro"])
        print("Micro " + name + " f1: ", m["f1_micro"])
        print("Macro " + name + " precision: ", m["precision_macro"])
        print("Micro " + name + " precision: ", m["precision_micro"])
        print("Macro " + name + " recall: ", m["recall_macro"])
        print("Micro " + name + " recall: ", m["recall_micro"])
        return m["f1_macro"], m["f1_micro"]
