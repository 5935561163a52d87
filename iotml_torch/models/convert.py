"""Weights across frameworks: flax param trees ↔ the port's state_dicts.

Weights cross as numpy arrays.  A flax ``DenseAutoencoder`` param tree
is ``{layer: {"kernel": [in, out], "bias": [out]}}``; the port's
state_dict is ``{"layer.weight": [out, in], "layer.bias": [out]}``.
Both directions are exact (a transpose and a copy).  Adam state crosses
the same way, so a JAX ``TrainState`` (params + optax ``count, mu, nu``)
carries over whole.

A flax ``SensorFormer`` tree maps the same way, plus: ``pos`` is
``{"embedding": [max_len, d]}`` (``pos.weight``); LayerNorm ``scale`` is
the port's ``weight``; ``attn.qkv`` is ``DenseGeneral((3, H, D))`` with
kernel [d, 3, H, D] and bias [3, H, D] (``nn.Linear(d, 3HD)``, weight =
``kernel.reshape(d, 3HD).T``); ``attn.out`` is ``DenseGeneral(d,
axis=(-2, -1))`` with kernel [H, D, d] (``nn.Linear(HD, d)``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..train.optim import AdamState
from .autoencoder import LAYERS


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) → state_dict of CPU float32 tensors."""
    out = {}
    for layer in LAYERS:
        kernel = np.asarray(tree[layer]["kernel"], np.float32)
        out[f"{layer}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.T))
        out[f"{layer}.bias"] = torch.from_numpy(
            np.array(tree[layer]["bias"], np.float32))
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """state_dict (any device) → flax param tree of numpy float32 arrays."""
    return {layer: {"kernel": np.ascontiguousarray(
                        _host(state[f"{layer}.weight"]).T),
                    "bias": _host(state[f"{layer}.bias"]).copy()}
            for layer in LAYERS}


def adam_from_optax(count, mu, nu) -> AdamState:
    """optax ``ScaleByAdamState`` fields → the port's ``AdamState``."""
    return AdamState(count=int(np.asarray(count)),
                     mu=params_from_jax(mu), nu=params_from_jax(nu))


def adam_to_optax(state: AdamState) -> Tuple[np.ndarray, dict, dict]:
    """The port's ``AdamState`` → (int32 count, mu tree, nu tree)."""
    return (np.asarray(state.count, np.int32),
            params_to_jax(state.mu), params_to_jax(state.nu))


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _dense_from_jax(out: dict, name: str, leaf: dict) -> None:
    kernel = _f32(leaf["kernel"])
    out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
        kernel.reshape(kernel.shape[0], -1).T))
    out[f"{name}.bias"] = torch.from_numpy(_f32(leaf["bias"]).reshape(-1)
                                           .copy())


def _norm_from_jax(out: dict, name: str, leaf: dict) -> None:
    out[f"{name}.weight"] = torch.from_numpy(_f32(leaf["scale"]).copy())
    out[f"{name}.bias"] = torch.from_numpy(_f32(leaf["bias"]).copy())


def sensorformer_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax ``SensorFormer`` param tree (numpy leaves) → state_dict of CPU
    float32 tensors for ``iotml_torch.models.transformer.SensorFormer``."""
    out: Dict[str, torch.Tensor] = {}
    _dense_from_jax(out, "embed", tree["embed"])
    out["pos.weight"] = torch.from_numpy(
        _f32(tree["pos"]["embedding"]).copy())
    blocks = sorted((k for k in tree if k.startswith("block")),
                    key=lambda k: int(k[len("block"):]))
    for b in blocks:
        blk = tree[b]
        _norm_from_jax(out, f"{b}.ln1", blk["ln1"])
        _dense_from_jax(out, f"{b}.attn.qkv", blk["attn"]["qkv"])
        kernel = _f32(blk["attn"]["out"]["kernel"])  # [H, D, d]
        out[f"{b}.attn.out.weight"] = torch.from_numpy(np.ascontiguousarray(
            kernel.reshape(-1, kernel.shape[-1]).T))
        out[f"{b}.attn.out.bias"] = torch.from_numpy(
            _f32(blk["attn"]["out"]["bias"]).copy())
        _norm_from_jax(out, f"{b}.ln2", blk["ln2"])
        _dense_from_jax(out, f"{b}.mlp_in", blk["mlp_in"])
        _dense_from_jax(out, f"{b}.mlp_out", blk["mlp_out"])
    _norm_from_jax(out, "ln_f", tree["ln_f"])
    _dense_from_jax(out, "head", tree["head"])
    return out


def sensorformer_params_to_jax(state: Dict[str, torch.Tensor],
                               num_heads: int) -> dict:
    """SensorFormer state_dict (any device) → flax param tree of numpy
    float32 arrays.  ``num_heads`` shapes the ``qkv`` / ``out`` kernels
    ([d, 3, H, D], [H, D, d]), which the state_dict's 2-D weights do not
    record."""
    def dense(name):
        return {"kernel": np.ascontiguousarray(_host(state[f"{name}.weight"]).T),
                "bias": _host(state[f"{name}.bias"]).copy()}

    def norm(name):
        return {"scale": _host(state[f"{name}.weight"]).copy(),
                "bias": _host(state[f"{name}.bias"]).copy()}

    tree = {"embed": dense("embed"),
            "pos": {"embedding": _host(state["pos.weight"]).copy()},
            "ln_f": norm("ln_f"), "head": dense("head")}
    blocks = sorted({k.split(".")[0] for k in state if k.startswith("block")},
                    key=lambda k: int(k[len("block"):]))
    for b in blocks:
        qkv = dense(f"{b}.attn.qkv")
        d = qkv["kernel"].shape[0]
        H = num_heads
        D = qkv["kernel"].shape[1] // (3 * H)
        out = dense(f"{b}.attn.out")
        tree[b] = {
            "ln1": norm(f"{b}.ln1"), "ln2": norm(f"{b}.ln2"),
            "attn": {"qkv": {"kernel": qkv["kernel"].reshape(d, 3, H, D),
                             "bias": qkv["bias"].reshape(3, H, D)},
                     "out": {"kernel": out["kernel"].reshape(H, D, -1),
                             "bias": out["bias"]}},
            "mlp_in": dense(f"{b}.mlp_in"), "mlp_out": dense(f"{b}.mlp_out")}
    return tree
