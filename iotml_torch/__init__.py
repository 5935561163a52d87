"""iotml_torch — the car-sensor anomaly-detection pipeline on PyTorch and CUDA.

A second implementation of ``iotml`` for NVIDIA Hopper cards, beside the
JAX package, with the same subpackage layout so each module's
counterpart is easy to find (``iotml_torch/models/autoencoder.py`` ↔
``iotml/models/autoencoder.py``):

- ``core``    record schema copy + per-field affine normalization
- ``gen``     car-fleet generator (same numpy draws as ``iotml.gen``)
- ``data``    in-memory row source → fixed-shape batches
- ``stream``  ordered prediction write-back
- ``models``  dense autoencoder, SensorFormer (``nn.Module``s) +
              weight converters
- ``train``   optax-parity Adam, autograd step loop, ``Trainer``
- ``ops``     the CUDA kernels (fused whole fit, flash-attention
              forward) and their plain versions
- ``serve``   super-batched stream scorer
- ``utils``   device policy

The package imports torch and numpy only — never jax or ``iotml``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
