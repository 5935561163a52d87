"""MNIST ingestion smoke test — broker path vs no-broker control
(``iotml.cli.mnist_smoke``'s twin).

The reference pair: produce MNIST bytes to topics `xx`/`yy`, consume via
KafkaDataset, train Flatten→Dense(128)→Dense(10)
(`confluent-tensorflow-io-kafka.py`), with an in-memory control model
(`confluent-tensorflow-io-kafka-simplified.py`) to tell ingestion bugs from
model bugs.  The same experiment here: both paths train on identical data;
the smoke test passes when the streamed path's loss curve falls and the
two paths' record counts agree.

    python -m iotml_torch.cli.mnist_smoke [--n 2000 --epochs 2 --batch-size 32]

It runs on ``cuda``; ``run(argv, device="cpu")`` runs it on the CPU from
Python.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..data.mnist_stream import MnistBatches, produce_mnist, synth_mnist
from ..models.mnist import MNISTBaseline, MNISTClassifier
from ..stream.broker import Broker
from ..train.optim import Adam
from ..utils.device import DeviceLike, resolve_device


def classifier_fit(model, images, labels, batch_size: int, epochs: int,
                   learning_rate: float = 1e-3) -> dict:
    """Cross-entropy fit of ``model`` (an MNIST module, whose weights are
    the initial params) on its device: the data moves there once, every
    epoch runs the whole-batch steps in order (the tail is dropped), Adam
    (optax's), softmax cross-entropy on integer labels; per-epoch means
    of the loss and accuracy, read back in one sync.  The model is
    applied with ``train=False``, as the JAX package applies it: dropout
    never fires."""
    device = next(model.parameters()).device
    n = (images.shape[0] // batch_size) * batch_size
    xs = torch.from_numpy(np.ascontiguousarray(
        images[:n].reshape((-1, batch_size) + images.shape[1:]),
        np.float32)).to(device)
    ys = torch.from_numpy(labels[:n].reshape(-1, batch_size).astype(
        np.int64)).to(device)

    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tx = Adam(learning_rate)
    opt_state = tx.init(params)

    def loss_fn(p, x, y):
        logits = torch.func.functional_call(model, p, (x,))
        return F.cross_entropy(logits, y), logits

    losses, accs = [], []
    for _ in range(epochs):
        ep_loss, ep_acc = [], []
        for x, y in zip(xs, ys):
            p = {k: v.requires_grad_(True) for k, v in params.items()}
            loss, logits = loss_fn(p, x, y)
            grads = torch.autograd.grad(loss, list(p.values()))
            params, opt_state = tx.update(
                dict(zip(p.keys(), grads)), opt_state,
                {k: v.detach() for k, v in p.items()})
            ep_loss.append(loss.detach())
            ep_acc.append((logits.detach().argmax(-1) == y)
                          .to(torch.float32).mean())
        losses.append(torch.mean(torch.stack(ep_loss)))
        accs.append(torch.mean(torch.stack(ep_acc)))
    losses, accs = torch.stack([torch.stack(losses),
                                torch.stack(accs)]).cpu().numpy()
    return {"params": params, "loss": losses.tolist(),
            "accuracy": accs.tolist(), "records": n}


def run(argv=None, device: DeviceLike = None) -> dict:
    p = argparse.ArgumentParser(prog="iotml_torch.cli.mnist_smoke",
                                description=__doc__)
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=32)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    images, labels = synth_mnist(args.n)

    # --- streamed path: produce → topics xx/yy → zip-consume → train
    broker = Broker()
    produced = produce_mnist(broker, images, labels)
    batches = list(MnistBatches(broker, batch_size=args.batch_size))
    streamed_records = sum(b.n_valid for b in batches)
    sx = np.concatenate([b.x[: b.n_valid] for b in batches])
    sy = np.concatenate([b.y[: b.n_valid] for b in batches])
    streamed = classifier_fit(MNISTClassifier(device=dev), sx, sy,
                              args.batch_size, args.epochs)

    # --- control path: identical data straight from memory, control model
    control = classifier_fit(MNISTBaseline(device=dev),
                             images.astype(np.float32), labels,
                             args.batch_size, args.epochs)

    out = {
        "produced": produced,
        "streamed_records": streamed_records,
        "ingestion_intact": bool(streamed_records == produced
                                 and np.array_equal(sx, images.astype(np.float32))
                                 and np.array_equal(sy, labels)),
        "streamed": {"loss": streamed["loss"], "accuracy": streamed["accuracy"]},
        "control": {"loss": control["loss"], "accuracy": control["accuracy"]},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    run()
