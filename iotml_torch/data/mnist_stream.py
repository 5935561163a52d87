"""MNIST-over-the-broker smoke test data path
(``iotml.data.mnist_stream``'s twin).

The reference's ingestion smoke test produces raw MNIST bytes onto two
topics — images on `xx`, labels on `yy` — then consumes both with
`KafkaDataset`, `decode_raw`s them back into tensors, zips and trains a
small Dense classifier (reference `confluent-tensorflow-io-kafka.py:5-58`).
The point is isolating ingestion bugs from model bugs (the no-broker
control model is `models.mnist.MNISTBaseline`).

Byte format parity: one message per example; the image message is the 784
raw uint8 pixels (`.tobytes()`/`decode_raw(..., tf.uint8)` round-trip), the
label message is a single uint8.

The MNIST files are not in the repository and nothing is fetched, so
`synth_mnist` generates MNIST-shaped data with learnable class structure
(a fixed random prototype per digit + pixel noise); `load_mnist_idx`
reads the classic IDX files from a local path.  All of this is host
numpy, the JAX package's code unchanged.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from ..stream.broker import Broker
from ..stream.consumer import StreamConsumer
from .dataset import Batch


def synth_mnist(n: int = 2000, seed: int = 0,
                image_shape: Tuple[int, int] = (28, 28)):
    """(images uint8 [n,28,28], labels uint8 [n]) with class structure."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(0, 256, (10,) + image_shape, dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    noise = rng.integers(-40, 41, (n,) + image_shape)
    images = np.clip(protos[labels].astype(np.int16) + noise, 0, 255) \
        .astype(np.uint8)
    return images, labels


def load_mnist_idx(images_path: str, labels_path: str):
    """Read the classic IDX files when they are available locally."""
    with open(images_path, "rb") as fh:
        magic, n, rows, cols = struct.unpack(">IIII", fh.read(16))
        if magic != 2051:
            raise ValueError(f"bad IDX image magic {magic}")
        images = np.frombuffer(fh.read(), np.uint8).reshape(n, rows, cols)
    with open(labels_path, "rb") as fh:
        magic, n2 = struct.unpack(">II", fh.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX label magic {magic}")
        labels = np.frombuffer(fh.read(), np.uint8)
    if n != n2:
        raise ValueError(f"image/label count mismatch {n} != {n2}")
    return images, labels


def produce_mnist(broker: Broker, images: np.ndarray, labels: np.ndarray,
                  image_topic: str = "xx", label_topic: str = "yy") -> int:
    """Producer parity: raw pixel bytes on `xx`, one-byte labels on `yy`
    (confluent-tensorflow-io-kafka.py:5-18)."""
    broker.create_topic(image_topic)
    broker.create_topic(label_topic)
    for img, lab in zip(images, labels):
        broker.produce(image_topic, img.tobytes())
        broker.produce(label_topic, bytes([int(lab)]))
    return len(images)


class MnistBatches:
    """Zip the image and label topics into fixed-shape supervised batches.

    Mirrors the reference's `tf.data.Dataset.zip((dataset, dataset_label))
    .batch(batch_size)`; message i on `xx` pairs with message i on `yy` by
    offset — the ingestion invariant this smoke test exists to validate.
    """

    def __init__(self, broker: Broker, batch_size: int = 32,
                 image_topic: str = "xx", label_topic: str = "yy",
                 image_shape: Tuple[int, int] = (28, 28),
                 take: Optional[int] = None):
        self.broker = broker
        self.batch_size = batch_size
        self.image_topic = image_topic
        self.label_topic = label_topic
        self.image_shape = image_shape
        self.take = take

    def __iter__(self) -> Iterator[Batch]:
        xs = StreamConsumer(self.broker, [f"{self.image_topic}:0:0"],
                            group="mnist-x")
        ys = StreamConsumer(self.broker, [f"{self.label_topic}:0:0"],
                            group="mnist-y")
        emitted_batches = 0
        flat = int(np.prod(self.image_shape))
        buf_x, buf_y = [], []
        while True:
            mx = xs.poll(1024)
            my = ys.poll(1024)
            if not mx and not my:
                break
            for ix, iy in zip(mx, my):
                if ix.offset != iy.offset:
                    raise ValueError(
                        f"image/label stream misaligned: {ix.offset} vs "
                        f"{iy.offset}")
                img = np.frombuffer(ix.value, np.uint8)
                if img.size != flat:
                    raise ValueError(f"image message has {img.size} bytes, "
                                     f"expected {flat}")
                buf_x.append(img.reshape(self.image_shape))
                buf_y.append(iy.value[0])
                if len(buf_x) == self.batch_size:
                    yield Batch(x=np.stack(buf_x).astype(np.float32),
                                n_valid=self.batch_size,
                                first_index=emitted_batches * self.batch_size,
                                y=np.asarray(buf_y, np.int32))
                    emitted_batches += 1
                    buf_x, buf_y = [], []
                    if self.take and emitted_batches >= self.take:
                        return
        if buf_x:
            n_valid = len(buf_x)
            pad = self.batch_size - n_valid
            x = np.concatenate([np.stack(buf_x).astype(np.float32),
                                np.zeros((pad,) + self.image_shape, np.float32)])
            y = np.concatenate([np.asarray(buf_y, np.int32),
                                np.zeros((pad,), np.int32)])
            yield Batch(x=x, n_valid=n_valid,
                        first_index=emitted_batches * self.batch_size, y=y)

    def epochs(self, n: int):
        for _ in range(n):
            yield iter(self)
