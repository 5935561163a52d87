"""Anomaly-detection evaluation (``iotml.evaluate.anomaly``'s twin).

The reference validates model quality in notebook cells (creditcard
notebook, cells 19-26): per-row reconstruction-error MSE, a fixed
decision threshold (5.0), the confusion matrix, the ROC curve and its
AUC, and a precision/recall analysis.  Here it is a library:

- ``reconstruction_errors`` scores an eval set on the device in chunks
  of 8,192 rows: the model's forward and the row mean of squares, with
  the last chunk zero-padded to the chunk size when the set is larger
  than one chunk, as the JAX package pads it;
- the curves, AUC, AP and the confusion counts are the JAX package's
  numpy code, unchanged: every distinct score is a candidate threshold
  (a sort-and-cumsum sweep), AUC by trapezoids, AP by steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def _recon_err(module, params, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        pred = torch.func.functional_call(module, params, (x,))
        return torch.mean(torch.square(pred - x), dim=-1)


def reconstruction_errors(model, params, x, batch_size: int = 8192,
                          device: DeviceLike = None) -> np.ndarray:
    """Per-row reconstruction MSE (the anomaly score) of ``x`` under
    ``model`` (an ``AutoencoderSpec``) with ``params`` (a state_dict),
    computed on ``device`` (``cuda`` unless given) in fixed-size chunks.

    The notebook's ``np.mean(np.power(data - predictions, 2), axis=1)``."""
    dev = resolve_device(device)
    module = model.build(dev)
    params = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                 else v).to(dev)
              for k, v in params.items()}
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    out = np.empty((n,), np.float32)
    for start in range(0, n, batch_size):
        chunk = x[start:start + batch_size]
        rows = chunk.shape[0]
        if rows < batch_size and n > batch_size:
            pad = np.zeros((batch_size - rows,) + x.shape[1:], np.float32)
            chunk = np.concatenate([chunk, pad])
        err = _recon_err(module, params, torch.from_numpy(chunk).to(dev))
        out[start:start + rows] = err.cpu().numpy()[:rows]
    return out


def confusion_at_threshold(scores, labels, threshold: float) -> Dict[str, float]:
    """Confusion matrix + derived metrics at a fixed decision threshold.

    `scores > threshold` ⇒ predicted anomaly (the notebook's
    `error_df.Reconstruction_error > threshold` rule, fixed threshold 5).
    labels: 1 = anomaly, 0 = normal.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    pred = scores > threshold
    tp = int(np.sum(pred & labels))
    fp = int(np.sum(pred & ~labels))
    fn = int(np.sum(~pred & labels))
    tn = int(np.sum(~pred & ~labels))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {"tp": tp, "fp": fp, "fn": fn, "tn": tn,
            "precision": precision, "recall": recall, "f1": f1,
            "accuracy": (tp + tn) / max(len(labels), 1)}


def _sorted_sweep(scores, labels):
    """Descending-score sweep: cumulative TP/FP at every distinct threshold."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(np.float64)
    order = np.argsort(-scores, kind="mergesort")
    scores, labels = scores[order], labels[order]
    # indices where the score strictly drops — thresholds between ties are
    # not realizable decision points.
    distinct = np.where(np.diff(scores))[0]
    idx = np.concatenate([distinct, [len(scores) - 1]])
    tps = np.cumsum(labels)[idx]
    fps = (idx + 1) - tps
    return scores[idx], tps, fps


def roc_curve(scores, labels):
    """(fpr, tpr, thresholds), thresholds descending. labels: 1 = anomaly."""
    thr, tps, fps = _sorted_sweep(scores, labels)
    p = tps[-1] if len(tps) else 0.0
    n = fps[-1] if len(fps) else 0.0
    tpr = np.concatenate([[0.0], tps / p if p else np.zeros_like(tps)])
    fpr = np.concatenate([[0.0], fps / n if n else np.zeros_like(fps)])
    thresholds = np.concatenate([[np.inf], thr])
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Trapezoidal area under a curve given by (x, y) points."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    integrate = getattr(np, "trapezoid", None) or np.trapz
    return float(integrate(y, x))


def precision_recall_curve(scores, labels):
    """(precision, recall, thresholds), thresholds descending.

    Ends with the conventional (precision=1, recall=0) anchor point.
    """
    thr, tps, fps = _sorted_sweep(scores, labels)
    p = tps[-1] if len(tps) else 0.0
    precision = tps / np.maximum(tps + fps, 1.0)
    recall = tps / p if p else np.zeros_like(tps)
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return precision, recall, thr[::-1]


def average_precision(scores, labels) -> float:
    """AP = Σ (R_i − R_{i−1}) · P_i over the descending-threshold sweep."""
    thr, tps, fps = _sorted_sweep(scores, labels)
    p = tps[-1] if len(tps) else 0.0
    if not p:
        return 0.0
    precision = tps / np.maximum(tps + fps, 1.0)
    recall = tps / p
    prev_r = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - prev_r) * precision))


@dataclasses.dataclass
class AnomalyReport:
    """Everything the reference's eval cells produce, in one object."""

    threshold: float
    confusion: Dict[str, float]
    roc_auc: float
    avg_precision: float
    mean_error_normal: float
    mean_error_anomaly: float
    n: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        c = self.confusion
        return (f"n={self.n} thr={self.threshold:g} "
                f"auc={self.roc_auc:.4f} ap={self.avg_precision:.4f} "
                f"P={c['precision']:.3f} R={c['recall']:.3f} F1={c['f1']:.3f} "
                f"err(normal)={self.mean_error_normal:.4g} "
                f"err(anomaly)={self.mean_error_anomaly:.4g}")


def evaluate_detector(model, params, x, labels,
                      threshold: float = 5.0,
                      scores: Optional[np.ndarray] = None,
                      device: DeviceLike = None) -> AnomalyReport:
    """The notebook's protocol in one call.

    threshold=5.0 is the reference's fixed creditcard threshold (cell 24);
    pass `scores` to skip the forward pass (already-computed errors);
    otherwise they are computed on ``device`` (``cuda`` unless given).
    """
    if scores is None:
        scores = reconstruction_errors(model, params, x, device=device)
    labels = np.asarray(labels).astype(bool)
    fpr, tpr, _ = roc_curve(scores, labels)
    normal_err = scores[~labels]
    anom_err = scores[labels]
    return AnomalyReport(
        threshold=threshold,
        confusion=confusion_at_threshold(scores, labels, threshold),
        roc_auc=auc(fpr, tpr),
        avg_precision=average_precision(scores, labels),
        mean_error_normal=float(normal_err.mean()) if len(normal_err) else 0.0,
        mean_error_anomaly=float(anom_err.mean()) if len(anom_err) else 0.0,
        n=len(scores))
