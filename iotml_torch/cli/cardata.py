"""Reference-compatible CLI for the car-sensor autoencoder train/predict
jobs (``iotml.cli.cardata``'s twin):

    python -m iotml_torch.cli.cardata <servers> <topic> <offset> \\
        <result_topic> <train|predict> <model-file> <artifact-root>

The reference entry point is ``python3 cardata-v3.py <servers> <topic>
<offset> <result_topic> <mode> <model-file> <project>``
(cardata-v3.py:24-37); the positional contract is the same, and
``<project>`` becomes the artifact-store root (a local dir or a gs://
bucket).  ``<servers>`` is ``emulator[:n_records]``, the in-process
broker with generated fleet data; ``--train.<field>=...`` flags and
``IOTML_TRAIN_*`` env override the train knobs.

Train mode mirrors cardata-v3: filter label=="false", batch 100, take 100
batches, 20 epochs (one launch of the fused-fit kernel on the card), then
store the model.  Predict mode loads the stored model, scores batches
100..199, and writes np.array2string rows to <result_topic> in stream
order.  The job runs on ``cuda``; ``main(argv, device="cpu")`` runs it
on the CPU from Python.
"""

from __future__ import annotations

from ..models.autoencoder import CAR_AUTOENCODER
from ..utils.device import DeviceLike
from ._app import run_streaming_app

NB_EPOCH = 20
BATCH_SIZE = 100
TAKE_BATCHES = 100
PREDICT_SKIP = 100  # data_offset in the reference (cardata-v3.py:269)

USAGE = ("usage: python -m iotml_torch.cli.cardata <servers> <topic> "
         "<offset> <result_topic> <mode:train|predict> <model-file> "
         "<artifact-root>\n"
         "  servers: emulator[:n_records]")


def main(argv=None, *, device: DeviceLike = None) -> int:
    return run_streaming_app(
        argv, prog="cardata", usage=USAGE, make_model=lambda: CAR_AUTOENCODER,
        group="cardata-autoencoder", epochs=NB_EPOCH, batch_size=BATCH_SIZE,
        take_batches=TAKE_BATCHES, predict_skip=PREDICT_SKIP,
        predict_take=TAKE_BATCHES, h5_interop=True, device=device)


if __name__ == "__main__":
    raise SystemExit(main())
