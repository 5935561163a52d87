"""Persisted model-quality report (``iotml.evaluate.report``'s twin).

The reference's evaluation lives in notebook cells that render ROC/AUC,
precision-recall, and reconstruction-error threshold plots
(reference `python-scripts/autoencoder-anomaly-detection/` cells 21-26).
`write_report` turns an `AnomalyReport` + raw scores into:

- `report.json` — every scalar the notebook prints, plus downsampled
  ROC/PR curve points (machine-readable, diffable between runs);
- `report.svg` — a three-panel figure (ROC with AUC, PR with AP,
  reconstruction-error histogram with the decision threshold), the same
  three visuals the notebook renders (matplotlib, imported when a report
  is written).

Both land in a directory that can be pushed through `ArtifactStore`
(local or gs://) right beside the model it describes.  The code is the
JAX package's numpy and matplotlib code, unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .anomaly import (AnomalyReport, precision_recall_curve, roc_curve)


def _downsample(xs: np.ndarray, ys: np.ndarray, max_points: int = 256):
    if len(xs) <= max_points:
        return xs, ys
    idx = np.linspace(0, len(xs) - 1, max_points).astype(int)
    return xs[idx], ys[idx]


def write_report(report: AnomalyReport, scores, labels, out_dir: str,
                 store=None, name: str = "eval-report") -> dict:
    """Write report.json + report.svg under out_dir; optionally upload the
    directory through an ArtifactStore as `name`.  Returns the paths."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    os.makedirs(out_dir, exist_ok=True)

    fpr, tpr, _ = roc_curve(scores, labels)
    prec, rec, _ = precision_recall_curve(scores, labels)
    fpr_s, tpr_s = _downsample(np.asarray(fpr), np.asarray(tpr))
    rec_s, prec_s = _downsample(np.asarray(rec), np.asarray(prec))

    json_path = os.path.join(out_dir, "report.json")
    payload = dict(report.as_dict())
    payload["curves"] = {
        "roc": {"fpr": fpr_s.tolist(), "tpr": tpr_s.tolist()},
        "pr": {"recall": rec_s.tolist(), "precision": prec_s.tolist()},
    }
    with open(json_path, "w") as f:
        json.dump(payload, f, indent=2)

    svg_path = os.path.join(out_dir, "report.svg")
    _render_svg(report, scores, labels, fpr_s, tpr_s, rec_s, prec_s,
                svg_path)

    uploaded: Optional[str] = None
    if store is not None:
        uploaded = store.upload_tree(out_dir, name)
    return {"json": json_path, "svg": svg_path, "uploaded": uploaded}


def _render_svg(report: AnomalyReport, scores, labels,
                fpr, tpr, rec, prec, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")  # headless; must precede pyplot import
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    ax = axes[0]
    ax.plot(fpr, tpr, lw=1.5)
    ax.plot([0, 1], [0, 1], ls="--", lw=0.8, color="gray")
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.set_title(f"ROC (AUC = {report.roc_auc:.4f})")

    ax = axes[1]
    ax.plot(rec, prec, lw=1.5)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_ylim(-0.02, 1.02)
    ax.set_title(f"Precision-Recall (AP = {report.avg_precision:.4f})")

    ax = axes[2]
    normal, anom = scores[~labels], scores[labels]
    bins = np.histogram_bin_edges(scores, bins=50)
    if len(normal):
        ax.hist(normal, bins=bins, alpha=0.6, label="normal", log=True)
    if len(anom):
        ax.hist(anom, bins=bins, alpha=0.6, label="anomaly", log=True)
    ax.axvline(report.threshold, color="red", ls="--", lw=1.2,
               label=f"threshold = {report.threshold:g}")
    ax.set_xlabel("reconstruction error")
    ax.set_ylabel("count (log)")
    ax.set_title("Error distribution")
    ax.legend(fontsize=8)

    c = report.confusion
    fig.suptitle(
        f"n={report.n}  P={c['precision']:.3f} R={c['recall']:.3f} "
        f"F1={c['f1']:.3f}", fontsize=10)
    fig.tight_layout()
    fig.savefig(path, format="svg")
    plt.close(fig)
