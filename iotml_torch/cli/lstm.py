"""LSTM streaming app (``iotml.cli.lstm``'s twin) — the reference's
supervised next-step predictor CLI:

    python -m iotml_torch.cli.lstm <servers> <topic> <offset> \\
        <result_topic> <train|predict> <model-file> <artifact-root>

The positional contract is `LSTM-TensorFlow-IO-Kafka/cardata-v2.py`'s
(the autoencoder CLI's shape), with `emulator[:n]` standing in for a
cluster, like `cli.cardata`.

Reference semantics kept (LSTM cardata-v1.py:165-200, v2 adds mode+GCS):
windows of `look_back` consecutive records with the next record as target
(window(look_back, shift=1) + skip(look_back)), MSE loss, 5 epochs; predict
mode loads the stored model and writes next-step predictions to the result
topic in stream order.  The reference's batch of 1 is re-batched into
[B, T, F] windows, as the JAX package does: same objective, same
architecture.  The fit is the autograd step loop on the card (the fused
kernel is the autoencoder's); ``main(argv, device="cpu")`` runs the job on
the CPU from Python.  A model file named ``*.h5`` is refused with exit 1,
as the JAX CLI refuses it.
"""

from __future__ import annotations

from ..models.lstm import LSTMSpec
from ..utils.device import DeviceLike
from ._app import run_streaming_app

NB_EPOCH = 5
BATCH_SIZE = 64       # reference trains batch=1; re-batched
LOOK_BACK = 1
TRAIN_TAKE = 1000     # reference: 1000 train steps (batch 1) = 1000 windows
PREDICT_TAKE = 200    # reference: 200 predict steps

USAGE = ("usage: python -m iotml_torch.cli.lstm <servers> <topic> <offset> "
         "<result_topic> <mode:train|predict> <model-file> <artifact-root>\n"
         "  servers: emulator[:n_records] | host:port[,host:port...]")


def main(argv=None, *, device: DeviceLike = None, devices=None) -> int:
    n_batches = max(1, TRAIN_TAKE // BATCH_SIZE)
    return run_streaming_app(
        argv, prog="lstm", usage=USAGE,
        make_model=lambda: LSTMSpec(features=18, look_back=LOOK_BACK),
        group="cardata-lstm", epochs=NB_EPOCH, batch_size=BATCH_SIZE,
        take_batches=n_batches, predict_skip=n_batches,
        predict_take=max(1, PREDICT_TAKE // BATCH_SIZE),
        supervised=True, window=LOOK_BACK, device=device,
        devices=devices)


if __name__ == "__main__":
    raise SystemExit(main())
