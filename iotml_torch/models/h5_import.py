"""Keras-HDF5 importer (``iotml.models.h5_import``'s twin).

The reference ships trained weights as Keras ``.h5`` files and its
train→GCS→predict handoff moves models as h5 blobs (cardata-v3.py:227,
:255-261).  This reads the Keras v2 HDF5 layout (``model_weights/
<layer>/<layer>/{kernel:0,bias:0}``), through ``utils.hdf5`` (no
``h5py``), into the port's params, so files written by Keras, by the JAX
package or by ``h5_export`` load alike.

Keras Dense kernels are [in, out], as flax's are, so the map is name
order only; ``models.convert.params_from_jax`` makes the state_dict.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import hdf5
from .convert import params_from_jax


def _layer_names(f) -> List[str]:
    g = f["model_weights"]
    names = g.attrs.get("layer_names")
    if names is not None:
        return [n.decode() if isinstance(n, bytes) else n for n in names]
    return list(g.keys())


def read_keras_dense_stack(path) -> List[dict]:
    """Return [{'kernel': np[in,out], 'bias': np[out]}, ...] for each
    weighted layer, in model order.  ``path`` is a file name or the
    file's bytes."""
    out = []
    f = hdf5.File(path)
    g = f["model_weights"]
    for name in _layer_names(f):
        if name not in g:
            continue
        grp = g[name]
        # the v2 layout nests once more under the layer name
        inner = grp[name] if name in grp else grp
        found = {}

        def visit(key, obj):
            if isinstance(obj, hdf5.Dataset):
                leaf = key.split("/")[-1].split(":")[0]
                found[leaf] = np.asarray(obj)

        inner.visititems(visit)
        if "kernel" in found:
            out.append({"kernel": found["kernel"],
                        "bias": found.get("bias")})
    return out


def autoencoder_params_from_h5(path, expect_dims: Optional[tuple] = None
                               ) -> Dict[str, torch.Tensor]:
    """Map a reference autoencoder h5 onto the port's params (a state_dict
    of CPU float32 tensors).

    The reference model is 4 Dense layers; the port names them encoder0,
    encoder1, decoder0, decoder1 in the same order."""
    stack = read_keras_dense_stack(path)
    if len(stack) != 4:
        raise ValueError(f"expected 4 Dense layers, found {len(stack)} in "
                         f"{path if isinstance(path, str) else 'the file'}")
    names = ["encoder0", "encoder1", "decoder0", "decoder1"]
    tree = {}
    for name, layer in zip(names, stack):
        tree[name] = {"kernel": layer["kernel"].astype(np.float32),
                      "bias": layer["bias"].astype(np.float32)}
    if expect_dims:
        k0 = tree["encoder0"]["kernel"]
        if (k0.shape[0], k0.shape[1]) != tuple(expect_dims[:2]):
            raise ValueError(f"dims mismatch: {k0.shape} vs {expect_dims}")
    return params_from_jax(tree)
