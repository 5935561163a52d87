"""Creditcard fraud job (``iotml.cli.creditcard``'s twin): producer,
consumer and evaluation in one process.

The reference splits this across two scripts and a notebook
(`Sensor-Kafka-Producer-From-CSV.py`, `Sensor-Kafka-Consumer-and-TensorFlow-
Model-Training.py`, eval cells 21-26 of the fraud notebook).  One command
here runs the same pipeline against the in-process broker: CSV → topic
(raw lines) → decode → scale → filter(Class==0) → train the 30-dim
autoencoder (one launch of the fused-fit kernel on the card) → score the
full stream with the scaler frozen → threshold/ROC/AUC report.

    python -m iotml_torch.cli.creditcard synth[:n_rows]       # synthetic
    python -m iotml_torch.cli.creditcard /path/creditcard.csv # the Kaggle file

The job runs on ``cuda``; ``run(argv, device="cpu")`` runs it on the CPU
from Python.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from ..data.creditcard import (SCALED_COLUMNS, CreditcardBatches,
                               StandardScaler, produce_csv_lines,
                               synth_creditcard_csv)
from ..evaluate import evaluate_detector
from ..models.autoencoder import CREDITCARD_AUTOENCODER
from ..stream.broker import Broker
from ..stream.consumer import StreamConsumer
from ..train.loop import Trainer
from ..utils.device import DeviceLike


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="iotml_torch.cli.creditcard",
                                description=__doc__)
    p.add_argument("csv", help="path to creditcard.csv, or 'synth[:n_rows]'")
    p.add_argument("--epochs", type=int, default=5,
                   help="reference consumer: nb_epoch=5")
    p.add_argument("--batch-size", type=int, default=32,
                   help="reference consumer: batch_size=32")
    p.add_argument("--threshold", type=float, default=5.0,
                   help="reference notebook decision threshold (cell 24)")
    p.add_argument("--no-scale", action="store_true",
                   help="skip Time/Amount standardization (the reference "
                        "streaming consumer's unscaled behavior)")
    p.add_argument("--topic", default="creditcard")
    return p


def run(argv=None, device: DeviceLike = None) -> dict:
    """Run the job; prints and returns ``{"records", "final_loss",
    "report"}``.  ``device`` is where the model trains and scores
    (``cuda`` unless given)."""
    args = build_parser().parse_args(argv)

    tmp = None
    csv_path = args.csv
    if csv_path.startswith("synth"):
        n_rows = int(csv_path.split(":", 1)[1]) if ":" in csv_path else 2000
        tmp = tempfile.NamedTemporaryFile(suffix=".csv", delete=False)
        tmp.close()
        csv_path = tmp.name
        synth_creditcard_csv(csv_path, n_rows=n_rows)

    try:
        broker = Broker()
        n = produce_csv_lines(broker, args.topic, csv_path)

        scaler = None if args.no_scale else StandardScaler(columns=SCALED_COLUMNS)
        train_batches = CreditcardBatches(
            StreamConsumer(broker, [f"{args.topic}:0:0"], group="creditcard"),
            batch_size=args.batch_size, only_normal=True, scaler=scaler)
        trainer = Trainer(CREDITCARD_AUTOENCODER, device=device)
        # fit_compiled reads the batcher once: the scaler sees one pass
        history = trainer.fit_compiled(train_batches, epochs=args.epochs)

        # score the *whole* stream (frauds included) with the TRAINING
        # moments frozen — eval must see the same scale the model trained on
        if scaler is not None:
            scaler.freeze()
        eval_batches = CreditcardBatches(
            StreamConsumer(broker, [f"{args.topic}:0:0"], group="creditcard-eval"),
            batch_size=args.batch_size, scaler=scaler)
        xs, ys = [], []
        for b in eval_batches:
            xs.append(b.x[: b.n_valid])
            ys.append(b.labels[: b.n_valid])
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        report = evaluate_detector(CREDITCARD_AUTOENCODER, trainer.state.params,
                                   x, y, threshold=args.threshold,
                                   device=trainer.device)
        out = {"records": n, "final_loss": history["loss"][-1],
               "report": report.as_dict()}
        print(json.dumps(out))
        return out
    finally:
        if tmp is not None:
            os.unlink(tmp.name)


if __name__ == "__main__":
    run()
