"""Keras-HDF5 exporter (``iotml.models.h5_export``'s twin), the reverse
of ``h5_import``.

The reference moves models from train to predict as Keras ``.h5`` blobs
(cardata-v3.py:227-231 uploads, :255-261 loads them into
``tf.keras.models.load_model``).  This writes the port's autoencoder
params in the byte layout of the reference's own checkpoints, through
``utils.hdf5`` (no ``h5py``):

- root attrs ``backend`` / ``keras_version`` / ``model_config`` /
  ``training_config``: ``model_config`` is the functional-Model JSON a
  Keras ``load_model`` rebuilds the architecture from (InputLayer + 4
  Dense, tanh/relu/tanh/relu, L1 activity regularizer on the first
  layer, GlorotUniform init), ``training_config`` the Adam/MSE/accuracy
  compile settings (cardata-v3.py:190-194); both strings are the JAX
  package's, byte for byte, in both styles;
- ``model_weights/<layer>/<layer>/{kernel:0,bias:0}`` datasets with the
  ``layer_names`` / ``weight_names`` attributes Keras' HDF5 loader walks.

Keras Dense kernels are [in, out] like flax's, so the port's params pass
through ``models.convert.params_to_jax`` and on unchanged.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from ..utils import hdf5
from .convert import params_to_jax

_LAYER_ORDER = ("encoder0", "encoder1", "decoder0", "decoder1")
_ACTIVATIONS = ("tanh", "relu", "tanh", "relu")


def _dense_config(name: str, units: int, activation: str,
                  activity_l1: float = 0.0) -> dict:
    cfg = {
        "name": name, "trainable": True, "dtype": "float32",
        "units": units, "activation": activation, "use_bias": True,
        "kernel_initializer": {"class_name": "GlorotUniform",
                               "config": {"seed": None}},
        "bias_initializer": {"class_name": "Zeros", "config": {}},
        "kernel_regularizer": None, "bias_regularizer": None,
        "activity_regularizer": None,
        "kernel_constraint": None, "bias_constraint": None,
    }
    if activity_l1:
        cfg["activity_regularizer"] = {
            "class_name": "L1L2", "config": {"l1": activity_l1, "l2": 0.0}}
    return cfg


def _model_config(input_dim: int, units: list, activity_l1: float,
                  style: str = "reference") -> str:
    """Functional-model config JSON.

    style="reference" reproduces the reference checkpoint's byte layout
    exactly — including its pre-TF2 single-nested `inbound_nodes`
    (`[['input_1', 0, 0, {}]]`), which Keras 3 can no longer deserialize
    (it rejects the reference's own artifacts identically).
    style="modern" emits the TF2-era triple-nested form
    (`[[['input_1', 0, 0, {}]]]`) that current Keras' legacy-h5 loader
    accepts — same weights, same architecture, loadable today."""
    modern = style == "modern"
    layers = [{
        "name": "input_1", "class_name": "InputLayer",
        "config": {"batch_input_shape": [None, input_dim],
                   "dtype": "float32", "sparse": False, "name": "input_1"},
        "inbound_nodes": [],
    }]
    prev = "input_1"
    for i, n in enumerate(units):
        name = "dense" if i == 0 else f"dense_{i}"
        node = [prev, 0, 0, {}]
        layers.append({
            "name": name, "class_name": "Dense",
            "config": _dense_config(name, n, _ACTIVATIONS[i],
                                    activity_l1 if i == 0 else 0.0),
            "inbound_nodes": [[node]] if modern else [node],
        })
        prev = name
    io_in, io_out = ["input_1", 0, 0], [prev, 0, 0]
    return json.dumps({"class_name": "Model", "config": {
        "name": "model", "layers": layers,
        "input_layers": [io_in] if modern else io_in,
        "output_layers": [io_out] if modern else io_out}})


_TRAINING_CONFIG = json.dumps({
    "optimizer_config": {"class_name": "Adam", "config": {
        "name": "Adam", "learning_rate": 0.001, "decay": 0.0,
        "beta_1": 0.9, "beta_2": 0.999, "epsilon": 1e-07,
        "amsgrad": False}},
    "loss": "mean_squared_error", "metrics": ["accuracy"],
    "weighted_metrics": None, "sample_weight_mode": None,
    "loss_weights": None,
})


def autoencoder_params_to_h5(params: Dict[str, torch.Tensor], path,
                             activity_l1: float = 1e-7,
                             style: str = "reference"):
    """Write the port's autoencoder params (a state_dict on any device)
    as a reference-compatible Keras h5 at ``path`` (a file name or a
    writable binary file object); returns ``path``.

    style: "reference" (default) matches the reference checkpoints'
    byte layout field for field; "modern" differs only in the
    model_config nesting, so current Keras can ``load_model`` it (see
    ``_model_config``)."""
    tree = params_to_jax(params)
    stack = [tree[name] for name in _LAYER_ORDER]
    input_dim = int(stack[0]["kernel"].shape[0])
    units = [int(layer["kernel"].shape[1]) for layer in stack]
    keras_names = ["dense" if i == 0 else f"dense_{i}"
                   for i in range(len(stack))]

    with hdf5.File(path, "w") as f:
        f.attrs["backend"] = np.bytes_(b"tensorflow")
        f.attrs["keras_version"] = np.bytes_(b"2.2.4-tf")
        f.attrs["model_config"] = np.bytes_(
            _model_config(input_dim, units, activity_l1, style).encode())
        f.attrs["training_config"] = np.bytes_(_TRAINING_CONFIG.encode())
        mw = f.create_group("model_weights")
        layer_names = ["input_1"] + keras_names
        mw.attrs["layer_names"] = np.array(
            [n.encode() for n in layer_names],
            dtype=f"|S{max(len(n) for n in layer_names)}")
        mw.attrs["backend"] = np.bytes_(b"tensorflow")
        mw.attrs["keras_version"] = np.bytes_(b"2.2.4-tf")

        g_in = mw.create_group("input_1")
        g_in.attrs["weight_names"] = np.array([], dtype="float64")
        for kname, layer in zip(keras_names, stack):
            g = mw.create_group(kname)
            wn = [f"{kname}/kernel:0".encode(), f"{kname}/bias:0".encode()]
            g.attrs["weight_names"] = np.array(
                wn, dtype=f"|S{max(len(w) for w in wn)}")
            inner = g.create_group(kname)
            inner.create_dataset("kernel:0", data=layer["kernel"])
            inner.create_dataset("bias:0", data=layer["bias"])
    return path
