"""Creditcard fraud workflow (``iotml.data.creditcard``'s twin) — the
reference's second anomaly dataset.

The reference ships a Kafka pair for the Kaggle creditcard set
(`python-scripts/autoencoder-anomaly-detection/`): a producer that streams
raw CSV lines onto a topic (`Sensor-Kafka-Producer-From-CSV.py:5-15`) and a
consumer that `decode_csv`s 31 columns — Time, V1..V28, Amount, Class —
stacks the first 30 as features and trains the 30-dim autoencoder
(`Sensor-Kafka-Consumer-and-TensorFlow-Model-Training.py:32-49`).  The
notebook variant additionally StandardScaler-transforms Time/Amount, which
the streaming variant leaves as a TODO ("may require all data
available"); the scaler here fits off the stream as it goes.

Kaggle data does not ship with the repository, so `synth_creditcard_csv`
generates a statistically-shaped stand-in (unit-normal V columns, frauds
drawn off-distribution), byte for byte the JAX package's file.  All of
this is host numpy, the JAX package's code unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..stream.broker import Broker
from ..stream.consumer import StreamConsumer
from .dataset import Batch

N_FEATURES = 30  # Time + V1..V28 + Amount (Class is the label, not a feature)
COLUMNS = ["Time"] + [f"V{i}" for i in range(1, 29)] + ["Amount", "Class"]
# columns the notebook StandardScaler-transforms (reference consumer TODO)
SCALED_COLUMNS = (0, 29)  # Time, Amount


def synth_creditcard_csv(path: str, n_rows: int = 2000,
                         fraud_rate: float = 0.05, seed: int = 0) -> int:
    """Write a synthetic creditcard.csv: header + n_rows data lines.

    Normal rows: V ~ N(0,1) (the Kaggle set's PCA components are
    standardized), Time uniform over a day, Amount log-normal.  Fraud rows
    (Class=1): a random subset of V columns shifted by ±3-5σ — structurally
    separable, like the real set.  Returns the fraud count.
    """
    rng = np.random.default_rng(seed)
    n_fraud = 0
    with open(path, "w") as fh:
        fh.write(",".join(f'"{c}"' for c in COLUMNS) + "\n")
        for i in range(n_rows):
            is_fraud = rng.random() < fraud_rate
            v = rng.normal(0.0, 1.0, 28)
            if is_fraud:
                n_fraud += 1
                hot = rng.choice(28, size=8, replace=False)
                v[hot] += rng.choice([-1.0, 1.0], size=8) * rng.uniform(3.0, 5.0, 8)
            t = float(i)  # monotone event time, like the real set
            amount = float(np.round(rng.lognormal(3.0, 1.0), 2))
            row = [f"{t:.1f}"] + [f"{x:.6f}" for x in v] + \
                [f"{amount:.2f}", str(int(is_fraud))]
            fh.write(",".join(row) + "\n")
    return n_fraud


def produce_csv_lines(broker: Broker, topic: str, csv_path: str,
                      limit: Optional[int] = None) -> int:
    """Producer parity: skip the header, publish each raw CSV line as one
    message (Sensor-Kafka-Producer-From-CSV.py:8-14). Returns the count."""
    broker.create_topic(topic)
    n = 0
    with open(csv_path) as fh:
        next(fh)  # header
        for line in fh:
            line = line.rstrip()
            if not line:
                continue
            broker.produce(topic, line.encode())
            n += 1
            if limit and n >= limit:
                break
    return n


def decode_csv_batch(values) -> tuple:
    """Consumer parity: decode CSV-line messages into (x [B,30] float32,
    y [B] int32) — process_csv + process_x_y in the reference consumer."""
    rows = np.empty((len(values), N_FEATURES + 1), np.float64)
    for i, v in enumerate(values):
        if isinstance(v, bytes):
            v = v.decode()
        parts = v.replace('"', "").split(",")
        rows[i] = [float(p) for p in parts]
    return rows[:, :N_FEATURES].astype(np.float32), rows[:, N_FEATURES].astype(np.int32)


class StandardScaler:
    """Per-column (x − mean) / std, fittable incrementally off the stream.

    Closes the reference's TODO (consumer comment: runtime StandardScaler
    "may require all data available which may defeat the purpose of
    'streaming'") via Welford/Chan parallel-merge moments: each batch folds
    into running (n, mean, M2), so the scaler converges online without a
    second pass over the log.
    """

    def __init__(self, columns=None):
        self.columns = columns  # None = all
        self.n = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None
        self.frozen = False

    def freeze(self) -> "StandardScaler":
        """Stop accumulating moments: transform-only from here on.  Train
        fits the scaler; eval must score with the *training* moments, or
        the model sees differently-scaled inputs than it trained on."""
        self.frozen = True
        return self

    def partial_fit(self, x: np.ndarray) -> "StandardScaler":
        if self.frozen:
            return self
        x = np.asarray(x, np.float64)
        if self.mean is None:
            self.mean = np.zeros(x.shape[1])
            self.m2 = np.zeros(x.shape[1])
        nb = x.shape[0]
        if nb == 0:
            return self
        bmean = x.mean(axis=0)
        bm2 = ((x - bmean) ** 2).sum(axis=0)
        delta = bmean - self.mean
        tot = self.n + nb
        self.mean = self.mean + delta * (nb / tot)
        self.m2 = self.m2 + bm2 + delta ** 2 * (self.n * nb / tot)
        self.n = tot
        return self

    def fit(self, x: np.ndarray) -> "StandardScaler":
        self.n = 0
        self.mean = self.m2 = None
        return self.partial_fit(x)

    @property
    def std(self) -> np.ndarray:
        # population std, like sklearn's StandardScaler
        return np.sqrt(np.maximum(self.m2 / max(self.n, 1), 1e-12))

    def transform(self, x: np.ndarray) -> np.ndarray:
        out = np.array(x, np.float32, copy=True)
        cols = self.columns if self.columns is not None else range(out.shape[1])
        for c in cols:
            out[:, c] = (out[:, c] - self.mean[c]) / self.std[c]
        return out

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)


@dataclasses.dataclass
class CreditcardBatches:
    """Fixed-shape [B, 30] batches off a CSV-line topic.

    Mirrors the reference consumer's knobs (batch 32, eof=True) plus the
    framework contracts: tail padding + validity mask, `only_normal`
    training filter (train on Class==0, the notebook's protocol), optional
    scaler for Time/Amount, and `epochs()` replay for multi-epoch fit.
    """

    consumer: StreamConsumer
    batch_size: int = 32
    only_normal: bool = False
    scaler: Optional[StandardScaler] = None
    pad_tail: bool = True

    def __iter__(self) -> Iterator[Batch]:
        self.consumer.seek_to_start()
        buf_x, buf_y = [], []
        emitted = 0

        def flush(xs, ys, first):
            x = np.stack(xs)
            y = np.asarray(ys, np.int32)
            n_valid = x.shape[0]
            if n_valid < self.batch_size:
                if not self.pad_tail:
                    return None
                pad = self.batch_size - n_valid
                x = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])
                y = np.concatenate([y, np.zeros((pad,), np.int32)])
            return Batch(x=x, n_valid=n_valid, first_index=first, labels=y)

        while True:
            msgs = self.consumer.poll(4096)
            if not msgs:
                break
            x, y = decode_csv_batch([m.value for m in msgs])
            if self.scaler is not None:
                self.scaler.partial_fit(x)
                x = self.scaler.transform(x)
            if self.only_normal:
                keep = y == 0
                x, y = x[keep], y[keep]
            for i in range(x.shape[0]):
                buf_x.append(x[i])
                buf_y.append(y[i])
                if len(buf_x) == self.batch_size:
                    yield flush(buf_x, buf_y, emitted)
                    emitted += self.batch_size
                    buf_x, buf_y = [], []
        if buf_x:
            b = flush(buf_x, buf_y, emitted)
            if b is not None:
                yield b

    def epochs(self, n: int):
        """Replay the stream n times (KafkaDataset re-read semantics)."""
        for _ in range(n):
            yield iter(self)
