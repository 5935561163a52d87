"""Stream scorer with ordered write-back (``iotml.serve.scorer``'s twin).

One long-lived scorer drains whatever the stream holds, scores it in
super-batches (one device forward each), and writes each row's
prediction back through the ordered ``OutputSequence``.  Each payload is
``np.array2string`` of the output row, like the reference's callback,
formatted a super-batch at a time by the native engine
(``fastfmt.format_rows``, byte-identical); with a threshold set,
``|anomaly|err`` or ``|normal|err`` follows.  Windowed batches (the
LSTM's [B, T, F] rows) are scored the same way: the error is the mean
over every non-batch axis of (prediction − input window)², as the JAX
package computes it, and each [look_back, F] payload is
``np.array2string`` of that block.

The scoring contract is kept: super-batches, suspend and resume under
``max_rows``, threshold verdicts, live quality counts, per-label error
histograms, over a consumer one offset commit per completed drain, and
``run_forever``, the long-lived loop that rewinds to the committed
offsets and backs off when the broker connection fails.  With a
``carhealth`` detector (``serve.carhealth``) each scored batch's keys and
errors feed it, and its alert transitions go to ``carhealth_topic`` on
the output broker.  Watermarks, tracing, chaos points and the
feature-store join are not ported.
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
from ..utils.backoff import ExpBackoff
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
    """Per-row error of [S, B, ...] predictions against their inputs:
    the mean of squares over every non-batch axis, over the
    ``verdict_mask`` features when given ([S, B, F] rows only)."""
    sq = np.square(preds - xs)
    if verdict_mask is not None and sq.ndim == 3:
        return sq[:, :, verdict_mask].mean(axis=2)
    return sq.mean(axis=tuple(range(2, sq.ndim)))


class StreamScorer:
    """Score a batch stream; write ordered predictions back.

    Args:
      model/params: ``AutoencoderSpec`` (or ``LSTMSpec``, over windowed
        batches) + a state_dict (tensors or numpy).
      batches: SensorBatches over the input rows (only_normal=False: the
        predict path scores everything).
      out: OutputSequence for the predictions.
      threshold: optional reconstruction-error threshold; rows then get
        an anomaly verdict appended.
      verdict_mask: optional boolean [F] restricting the per-row error
        mean (verdicts, quality histograms, the car EMAs) to a feature
        subset.
      carhealth: optional ``CarHealthDetector``, fed each batch's (keys,
        per-row errors) when the batches keep keys, and the per-feature
        errors and values when its feature heads are on.
      carhealth_topic: where its alert transitions are published (one
        ``produce_many`` a batch with transitions), on ``out``'s broker.
      device: where the forward runs (``cuda`` unless given).
    """

    #: upper bound on batches stacked into one device forward
    max_super_batches = 128

    def __init__(self, model: AutoencoderSpec, params, batches: SensorBatches,
                 out: OutputSequence, threshold: Optional[float] = None,
                 verdict_mask=None, carhealth=None,
                 carhealth_topic: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        #: the forward's module; its own weights are never read: every
        #: forward takes ``self.params``
        self.model = model.build(self.device).eval()
        #: the serving weights, a dict of device tensors that
        #: ``set_params`` replaces whole
        self.params = dict(self.model.state_dict())
        self.batches = batches
        self.out = out
        self.threshold = threshold
        self.verdict_mask = (np.asarray(verdict_mask, bool)
                             if verdict_mask is not None else None)
        self.carhealth = carhealth
        self.carhealth_topic = carhealth_topic
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
        #: wall seconds per leg: read + batch, transfer + forward + copy
        #: back, and the ordered flush to the output (write_back)
        self.seconds = {"host_pipeline": 0.0, "device_compute": 0.0,
                        "write_back": 0.0}
        #: device_compute of the first super-batch alone: a cold process
        #: pays its first forward's setup there
        self.first_forward_s: Optional[float] = None
        #: run_forever's rounds, and its rewinds to the committed offsets
        #: after a ConnectionError
        self.rounds = 0
        self.rewinds = 0
        #: registry version of the loaded weights (None = not stamped)
        self.model_version: Optional[int] = None
        #: the weights are loaded (None params: not yet, as a scorer that
        #: waits for its first model starts)
        self.params_loaded = False
        if params is not None:
            self.set_params(params)

    def set_params(self, params, version: Optional[int] = None) -> None:
        """Swap the model weights: a new dict of device tensors (one copy
        each) replaces ``self.params`` in a single reference swap, so a
        super-batch in flight on another thread finishes on the old
        weights and the next one runs on the new; no output is dropped or
        reordered (the ``OutputSequence`` index stream is untouched).
        ``version`` stamps ``model_version``; a car-health detector is
        told, since new weights shift every car's error together."""
        if set(params) != set(self.params):
            raise ValueError(f"params keys {sorted(params)} are not the "
                             f"model's {sorted(self.params)}")
        new = {}
        for k, ref in self.params.items():
            v = params[k]
            v = v.detach() if torch.is_tensor(v) \
                else torch.as_tensor(np.asarray(v))
            if tuple(v.shape) != tuple(ref.shape):
                raise ValueError(f"params[{k!r}] has shape "
                                 f"{tuple(v.shape)}, the model "
                                 f"{tuple(ref.shape)}")
            # a copy: the caller's tensor may be a buffer a later fit
            # overwrites
            new[k] = v.to(self.device, ref.dtype, copy=True)
        self.params = new
        self.params_loaded = True
        if version is not None:
            self.model_version = version
        if self.carhealth is not None:
            self.carhealth.notify_model_swap()

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
            t0 = time.perf_counter()
            self.out.flush()
            self.seconds["write_back"] += time.perf_counter() - t0
            if max_rows is not None and self.scored - start >= max_rows:
                self._resume = (it, it_base)
                break
        if self._resume is None and self.batches.consumer is not None:
            self.batches.consumer.commit()
        return self.scored - start

    def _score_super_batch(self, bs, base: int) -> None:
        xs = np.stack([b.x for b in bs])  # [S, B, F] (or [S, B, T, F])
        S, B = xs.shape[:2]
        row_shape = xs.shape[2:]
        # pad the batch count to a power of two: drains vary in size, and
        # a few fixed shapes keep the forward's launch configs reusable
        S_pad = 1 << max(0, (S - 1).bit_length())
        xs_in = xs if S_pad == S else np.concatenate(
            [xs, np.zeros((S_pad - S, B) + row_shape, xs.dtype)])
        t0 = time.perf_counter()
        with torch.no_grad():
            x_dev = torch.from_numpy(
                xs_in.reshape((S_pad * B,) + row_shape)).to(self.device)
            preds = torch.func.functional_call(
                self.model, self.params, (x_dev,)).cpu().numpy()
        seconds = time.perf_counter() - t0
        self.seconds["device_compute"] += seconds
        if self.first_forward_s is None:
            self.first_forward_s = seconds
        preds = preds.reshape((S_pad, B) + preds.shape[1:])[:S]
        errs = row_errors(preds, xs, self.verdict_mask)  # [S, B]
        # per-feature errors and values for the detector's feature heads
        # ([S, B, F] rows only: a window has no single per-feature value)
        heads = self.carhealth is not None and \
            self.carhealth.feature_heads and xs.ndim == 3
        sq = np.square(preds - xs) if heads else None
        # one formatting call over every valid row of the super-batch;
        # windowed rows are [look_back, F] blocks, which numpy formats
        valid = np.concatenate([preds[k, : b.n_valid]
                                for k, b in enumerate(bs)])
        msgs = iter(format_rows(valid) if valid.ndim == 2
                    else [format_prediction(r) for r in valid])
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
            if self.carhealth is not None and b.keys is not None \
                    and b.n_valid:
                n = b.n_valid
                trans = self.carhealth.update(
                    b.keys[:n], err[:n],
                    ferrs=sq[k][:n] if heads else None,
                    fvals=xs[k][:n] if heads else None)
                if trans and self.carhealth_topic is not None:
                    self.carhealth.publish_transitions(
                        self.out.broker, self.carhealth_topic, trans)
            for i in range(b.n_valid):
                msg = next(msgs)
                if self.threshold is not None:
                    verdict = "anomaly" if err[i] > self.threshold else "normal"
                    msg = f"{msg}|{verdict}|{err[i]:.6f}"
                self.out.setitem(base + b.first_index + i, msg)
            self.scored += b.n_valid

    def run_forever(self, poll_interval_s: float = 0.2,
                    max_rounds: Optional[int] = None) -> None:
        """The long-lived loop: drain, sleep ``poll_interval_s`` after an
        idle round, repeat (``max_rounds`` bounds it; None runs forever).

        A ``ConnectionError`` out of a drain rewinds the input to the
        committed offsets and re-drains after a backoff that grows from
        ``max(poll_interval_s, 0.01)`` to ``max(2.0, base)`` and resets
        after a clean round.  Rows of the failed drain that were already
        written are written again at new indices (at-least-once, as a
        crash-restart is)."""
        base = max(poll_interval_s, 0.01)  # 0 busy-polls; failures still
        # must not busy-spin
        backoff = ExpBackoff(base_s=base, cap_s=max(2.0, base))
        start = self.rounds
        while max_rounds is None or self.rounds - start < max_rounds:
            self.rounds += 1
            try:
                n = self.score_available()
            except ConnectionError:
                self.batches.consumer.rewind_to_committed()
                self.rewinds += 1
                time.sleep(backoff.next_delay())
                continue
            backoff.reset()
            if n == 0:
                time.sleep(poll_interval_s)
