"""iotml_torch — the car-sensor anomaly-detection pipeline on PyTorch and CUDA.

A second implementation of ``iotml`` for NVIDIA Hopper cards, beside the
JAX package, with the same subpackage layout so each module's
counterpart is easy to find (``iotml_torch/models/autoencoder.py`` ↔
``iotml/models/autoencoder.py``):

- ``cli``     the reference cardata job's CLI (``python -m
              iotml_torch.cli.cardata``), the long-lived scorer
              (``cli.serve``), the live services (``cli.live``), the
              creditcard job (``cli.creditcard``), the LSTM job
              (``cli.lstm``) and the MNIST smoke (``cli.mnist_smoke``);
              ``config`` their train and serve knobs
- ``core``    record schema copy + per-field affine normalization
- ``gen``     car-fleet generator (same numpy draws as ``iotml.gen``)
              and its Avro publish
- ``data``    consumer or in-memory row source → fixed-shape batches
              (rows or LSTM windows); creditcard CSV and MNIST topics;
              the device prefetcher
- ``stream``  in-process broker, consumer, consumer-group
              coordinator, ordered write-back, and the native C++
              engines' bindings (``cpp/``: Avro codec, payload
              formatter)
- ``models``  dense autoencoder, SensorFormer, LSTM, MNIST
              (``nn.Module``s) + weight converters
- ``evaluate`` reconstruction errors on the card, ROC/PR/AUC/AP,
              the anomaly report and its JSON + SVG
- ``train``   optax-parity Adam, autograd step loop, ``Trainer``,
              checkpoints and the artifact store
- ``ops``     the CUDA kernels (fused whole fit, flash-attention
              forward and backward) and their plain versions; Avro
              codec with schema resolution, and Confluent framing
- ``serve``   super-batched stream scorer, fast payload formatting
- ``obs``     the metrics registry and its ``/metrics`` + ``/healthz``
              server, record tracing, event-time watermarks, profiler
              captures (``torch.profiler``), ``python -m
              iotml_torch.obs trace``
- ``chaos``   the fault points and their engine
- ``store``   ``fsync_dir``
- ``parallel`` the one-device sequence-parallel step
- ``analysis`` the checkers: lint, wire-protocol conformance, trace
              discipline, registry drift, lock order (``python -m
              iotml_torch.analysis``), the runtime lock-order detector
              and build guard, and their pytest plugin
- ``utils``   device policy, bounded exponential backoff

The package imports torch and numpy only — never jax or ``iotml``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
