"""Stream scorer with ordered write-back (``iotml.serve.scorer``'s twin).

One long-lived scorer drains whatever the stream holds, scores it in
super-batches (one device forward each), and writes each row's
prediction back through the ordered ``OutputSequence``.  Each payload is
``np.array2string`` of the output row, like the reference's callback,
formatted a super-batch at a time by the native engine
(``fastfmt.format_rows``, byte-identical); with a threshold set,
``|anomaly|err`` or ``|normal|err`` follows.

The scoring contract is kept: super-batches, suspend and resume under
``max_rows``, threshold verdicts, live quality counts, per-label error
histograms, and over a ``StreamConsumer`` one offset commit per
completed drain.  Watermarks, tracing, chaos points, per-car health, the
feature-store join and ``run_forever`` are not ported.
"""

from __future__ import annotations

import itertools
import time
from typing import Optional

import numpy as np
import torch

from ..data.dataset import SensorBatches
from ..models.autoencoder import AutoencoderSpec
from ..stream.producer import OutputSequence
from ..utils.device import DeviceLike, resolve_device
from .fastfmt import format_rows


def format_prediction(row: np.ndarray) -> str:
    """Reference-parity payload of one row: np.array2string of the output
    vector (``format_rows`` formats a block of rows the same)."""
    return np.array2string(row)


#: log-spaced reconstruction-error bucket edges for live quality histograms
#: (64 buckets spanning 1e-4..1e2 + one overflow bucket)
ERR_BUCKETS = np.geomspace(1e-4, 1e2, 65)


def hist_auc(anom: np.ndarray, normal: np.ndarray) -> Optional[float]:
    """ROC AUC from per-label score histograms (ties counted half)."""
    a_tot, n_tot = int(anom.sum()), int(normal.sum())
    if not a_tot or not n_tot:
        return None
    n_below = np.concatenate([[0], np.cumsum(normal)[:-1]])
    wins = float(np.sum(anom * (n_below + normal / 2.0)))
    return wins / (a_tot * n_tot)


def row_errors(preds: np.ndarray, xs: np.ndarray,
               verdict_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-row reconstruction MSE of [S, B, F] predictions, over the
    ``verdict_mask`` features when given."""
    sq = np.square(preds - xs)
    if verdict_mask is not None:
        return sq[:, :, verdict_mask].mean(axis=2)
    return sq.mean(axis=2)


class StreamScorer:
    """Score a batch stream; write ordered predictions back.

    Args:
      model/params: ``AutoencoderSpec`` + a state_dict (tensors or numpy).
      batches: SensorBatches over the input rows (only_normal=False: the
        predict path scores everything).
      out: OutputSequence for the predictions.
      threshold: optional reconstruction-error threshold; rows then get
        an anomaly verdict appended.
      verdict_mask: optional boolean [F] restricting the per-row error
        mean (verdicts, quality histograms) to a feature subset.
      device: where the forward runs (``cuda`` unless given).
    """

    #: upper bound on batches stacked into one device forward
    max_super_batches = 128

    def __init__(self, model: AutoencoderSpec, params, batches: SensorBatches,
                 out: OutputSequence, threshold: Optional[float] = None,
                 verdict_mask=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.build(self.device).eval()
        self.batches = batches
        self.out = out
        self.threshold = threshold
        self.verdict_mask = (np.asarray(verdict_mask, bool)
                             if verdict_mask is not None else None)
        self.scored = 0
        #: suspended (iterator, index_base) of a max_rows-truncated drain
        self._resume = None
        #: confusion counts of the threshold verdicts against the labels
        #: (batches built with keep_labels=True); padding rows excluded,
        #: unlabeled rows count as negatives
        self.quality = {"tp": 0, "fp": 0, "fn": 0, "tn": 0}
        #: per-label reconstruction-error histograms (log buckets)
        self.err_hist = {"true": np.zeros(len(ERR_BUCKETS) + 1, np.int64),
                         "false": np.zeros(len(ERR_BUCKETS) + 1, np.int64)}
        #: wall seconds per leg: read + batch, and transfer + forward + copy back
        self.seconds = {"host_pipeline": 0.0, "device_compute": 0.0}
        self.set_params(params)

    def set_params(self, params) -> None:
        """Swap the model weights in place; takes effect at the next
        super-batch and cannot drop or reorder output."""
        self.model.load_state_dict(
            {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
             else v for k, v in params.items()})

    def score_available(self, max_rows: Optional[int] = None) -> int:
        """Drain whatever the stream holds; returns rows scored.

        Each super-batch of up to ``max_super_batches`` batches is one
        device forward.  ``max_rows`` bounds one call: a call that stops
        with data left keeps its iterator suspended, and the next call
        resumes exactly where it stopped.  Over a consumer, offsets
        commit once per COMPLETED drain, after every polled row was
        scored: the cursor runs ahead of the scored rows inside the
        batcher, so a commit at a ``max_rows`` cut would lose rows on a
        crash-resume (at-least-once, never a skip)."""
        start = self.scored
        if self._resume is not None:
            it, it_base = self._resume
            self._resume = None
        else:
            # batch.first_index restarts per iterator; rebase globally
            it, it_base = iter(self.batches), self.scored
        while True:
            t0 = time.perf_counter()
            bs = list(itertools.islice(it, self.max_super_batches))
            self.seconds["host_pipeline"] += time.perf_counter() - t0
            if not bs:
                break
            self._score_super_batch(bs, it_base)
            self.out.flush()
            if max_rows is not None and self.scored - start >= max_rows:
                self._resume = (it, it_base)
                break
        if self._resume is None and self.batches.consumer is not None:
            self.batches.consumer.commit()
        return self.scored - start

    def _score_super_batch(self, bs, base: int) -> None:
        xs = np.stack([b.x for b in bs])  # [S, B, F]
        S, B, F = xs.shape
        # pad the batch count to a power of two: drains vary in size, and
        # a few fixed shapes keep the forward's launch configs reusable
        S_pad = 1 << max(0, (S - 1).bit_length())
        xs_in = xs if S_pad == S else np.concatenate(
            [xs, np.zeros((S_pad - S, B, F), xs.dtype)])
        t0 = time.perf_counter()
        with torch.no_grad():
            x_dev = torch.from_numpy(xs_in.reshape(S_pad * B, F)).to(
                self.device)
            preds = self.model(x_dev).cpu().numpy()
        self.seconds["device_compute"] += time.perf_counter() - t0
        preds = preds.reshape(S_pad, B, F)[:S]
        errs = row_errors(preds, xs, self.verdict_mask)  # [S, B]
        # one formatting call over every valid row of the super-batch
        msgs = iter(format_rows(np.concatenate(
            [preds[k, : b.n_valid] for k, b in enumerate(bs)])))
        for k, b in enumerate(bs):
            err = errs[k]
            if self.threshold is not None and b.labels is not None \
                    and b.n_valid:
                flag = err[: b.n_valid] > self.threshold
                truth = b.labels[: b.n_valid] == "true"
                self.quality["tp"] += int(np.sum(flag & truth))
                self.quality["fp"] += int(np.sum(flag & ~truth))
                self.quality["fn"] += int(np.sum(~flag & truth))
                self.quality["tn"] += int(np.sum(~flag & ~truth))
                buckets = np.searchsorted(ERR_BUCKETS, err[: b.n_valid])
                for lab, sel in (("true", truth), ("false", ~truth)):
                    if np.any(sel):
                        self.err_hist[lab] += np.bincount(
                            buckets[sel], minlength=len(ERR_BUCKETS) + 1)
            for i in range(b.n_valid):
                msg = next(msgs)
                if self.threshold is not None:
                    verdict = "anomaly" if err[i] > self.threshold else "normal"
                    msg = f"{msg}|{verdict}|{err[i]:.6f}"
                self.out.setitem(base + b.first_index + i, msg)
            self.scored += b.n_valid
