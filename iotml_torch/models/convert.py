"""Weights across frameworks: flax param trees ↔ the port's state_dicts.

Weights cross as numpy arrays.  A flax ``DenseAutoencoder`` param tree
is ``{layer: {"kernel": [in, out], "bias": [out]}}``; the port's
state_dict is ``{"layer.weight": [out, in], "layer.bias": [out]}``.
Both directions are exact (a transpose and a copy).  Adam state crosses
the same way, so a JAX ``TrainState`` (params + optax ``count, mu, nu``)
carries over whole, and so does one of the online learner's
``inject_hyperparams(optax.adam)`` (``count``, ``hyperparams`` and the
inner ``count, mu, nu``).

A flax ``SensorFormer`` tree maps the same way, plus: ``pos`` is
``{"embedding": [max_len, d]}`` (``pos.weight``); LayerNorm ``scale`` is
the port's ``weight``; ``attn.qkv`` is ``DenseGeneral((3, H, D))`` with
kernel [d, 3, H, D] and bias [3, H, D] (``nn.Linear(d, 3HD)``, weight =
``kernel.reshape(d, 3HD).T``); ``attn.out`` is ``DenseGeneral(d,
axis=(-2, -1))`` with kernel [H, D, d] (``nn.Linear(HD, d)``).

A flax ``LSTMSeq2Seq`` tree (flax 0.12) holds its four cells in creation
order as ``OptimizedLSTMCell_0`` … ``_3`` (enc0, enc1, dec0, dec1), each
``{ii, if, ig, io: {kernel [in, u]}, hi, hf, hg, ho: {kernel [u, u],
bias [u]}}``, and ``head: {kernel [32, F], bias [F]}``; a tree keyed
``enc0`` … ``dec1`` (``{name: {"cell": ...}}``) reads the same.  The MNIST
models are ``Dense_0`` and ``Dense_1``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..train.optim import HYPERPARAMS, AdamState, InjectableAdamState
from .autoencoder import LAYERS
from .lstm import GATES
from .moe import EXPERT_LEAVES


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


def inject_adam_from_optax(count, hyperparams, inner) -> InjectableAdamState:
    """optax ``InjectHyperparamsState`` fields over ``optax.adam`` — its
    ``count``, ``hyperparams`` dict and inner ``ScaleByAdamState`` (or
    its ``(count, mu, nu)``) — → the port's ``InjectableAdamState``."""
    inner_count, mu, nu = inner
    return InjectableAdamState(
        count=int(np.asarray(count)),
        hyperparams={k: torch.tensor(np.float32(hyperparams[k]))
                     for k in HYPERPARAMS},
        inner=adam_from_optax(inner_count, mu, nu))


def inject_adam_to_optax(state: InjectableAdamState):
    """The port's ``InjectableAdamState`` → (int32 count, {name: float32
    scalar}, (int32 count, mu tree, nu tree)), the fields of optax's
    ``InjectHyperparamsState`` and of its inner ``ScaleByAdamState``."""
    return (np.asarray(state.count, np.int32),
            {k: np.asarray(state.hyperparams[k].item(), np.float32)
             for k in HYPERPARAMS},
            adam_to_optax(state.inner))


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
    for b in _blocks(tree):
        blk = tree[b]
        _attn_block_from_jax(out, b, blk)
        _dense_from_jax(out, f"{b}.mlp_in", blk["mlp_in"])
        _dense_from_jax(out, f"{b}.mlp_out", blk["mlp_out"])
    _norm_from_jax(out, "ln_f", tree["ln_f"])
    _dense_from_jax(out, "head", tree["head"])
    return out


def _attn_block_from_jax(out: dict, b: str, blk: dict) -> None:
    """A block's two LayerNorms and its attention (``qkv``, ``out``)."""
    _norm_from_jax(out, f"{b}.ln1", blk["ln1"])
    _dense_from_jax(out, f"{b}.attn.qkv", blk["attn"]["qkv"])
    kernel = _f32(blk["attn"]["out"]["kernel"])  # [H, D, d]
    out[f"{b}.attn.out.weight"] = torch.from_numpy(np.ascontiguousarray(
        kernel.reshape(-1, kernel.shape[-1]).T))
    out[f"{b}.attn.out.bias"] = torch.from_numpy(
        _f32(blk["attn"]["out"]["bias"]).copy())
    _norm_from_jax(out, f"{b}.ln2", blk["ln2"])


def _blocks(keys) -> list:
    return sorted({k.split(".")[0] for k in keys if k.startswith("block")},
                  key=lambda k: int(k[len("block"):]))


def sensorformer_params_to_jax(state: Dict[str, torch.Tensor],
                               num_heads: int) -> dict:
    """SensorFormer state_dict (any device) → flax param tree of numpy
    float32 arrays.  ``num_heads`` shapes the ``qkv`` / ``out`` kernels
    ([d, 3, H, D], [H, D, d]), which the state_dict's 2-D weights do not
    record."""
    tree = _outer_to_jax(state)
    for b in _blocks(state):
        tree[b] = {**_attn_block_to_jax(state, b, num_heads),
                   "mlp_in": _dense_to_jax(state, f"{b}.mlp_in"),
                   "mlp_out": _dense_to_jax(state, f"{b}.mlp_out")}
    return tree


def _dense_to_jax(state, name: str) -> dict:
    return {"kernel": np.ascontiguousarray(_host(state[f"{name}.weight"]).T),
            "bias": _host(state[f"{name}.bias"]).copy()}


def _norm_to_jax(state, name: str) -> dict:
    return {"scale": _host(state[f"{name}.weight"]).copy(),
            "bias": _host(state[f"{name}.bias"]).copy()}


def _outer_to_jax(state) -> dict:
    """embed, pos, ln_f and head of a SensorFormer-shaped state_dict."""
    return {"embed": _dense_to_jax(state, "embed"),
            "pos": {"embedding": _host(state["pos.weight"]).copy()},
            "ln_f": _norm_to_jax(state, "ln_f"),
            "head": _dense_to_jax(state, "head")}


def _attn_block_to_jax(state, b: str, num_heads: int) -> dict:
    """A block's LayerNorms and attention as flax leaves."""
    qkv = _dense_to_jax(state, f"{b}.attn.qkv")
    d = qkv["kernel"].shape[0]
    H = num_heads
    D = qkv["kernel"].shape[1] // (3 * H)
    out = _dense_to_jax(state, f"{b}.attn.out")
    return {"ln1": _norm_to_jax(state, f"{b}.ln1"),
            "ln2": _norm_to_jax(state, f"{b}.ln2"),
            "attn": {"qkv": {"kernel": qkv["kernel"].reshape(d, 3, H, D),
                             "bias": qkv["bias"].reshape(3, H, D)},
                     "out": {"kernel": out["kernel"].reshape(H, D, -1),
                             "bias": out["bias"]}}}


def sensorformer_adam_from_optax(count, mu, nu) -> AdamState:
    """optax ``ScaleByAdamState`` fields over a flax ``SensorFormer``
    param tree → the port's ``AdamState``."""
    return AdamState(count=int(np.asarray(count)),
                     mu=sensorformer_params_from_jax(mu),
                     nu=sensorformer_params_from_jax(nu))


def sensorformer_adam_to_optax(state: AdamState, num_heads: int
                               ) -> Tuple[np.ndarray, dict, dict]:
    """The port's SensorFormer ``AdamState`` → (int32 count, mu tree, nu
    tree); ``num_heads`` as in ``sensorformer_params_to_jax``."""
    return (np.asarray(state.count, np.int32),
            sensorformer_params_to_jax(state.mu, num_heads),
            sensorformer_params_to_jax(state.nu, num_heads))


def moe_sensorformer_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax ``MoESensorFormer`` param tree (numpy leaves) → state_dict of
    CPU float32 tensors for ``iotml_torch.models.moe.MoESensorFormer``:
    the SensorFormer's leaves, with each block's ``moe`` (``router``
    kernel [d, E] → ``moe.router.weight`` [E, d]; the expert leaves as
    they are) in place of the MLP."""
    out: Dict[str, torch.Tensor] = {}
    _dense_from_jax(out, "embed", tree["embed"])
    out["pos.weight"] = torch.from_numpy(
        _f32(tree["pos"]["embedding"]).copy())
    for b in _blocks(tree):
        blk = tree[b]
        _attn_block_from_jax(out, b, blk)
        moe = blk["moe"]
        out[f"{b}.moe.router.weight"] = torch.from_numpy(
            np.ascontiguousarray(_f32(moe["router"]["kernel"]).T))
        for leaf in EXPERT_LEAVES:
            out[f"{b}.moe.{leaf}"] = torch.from_numpy(_f32(moe[leaf]).copy())
    _norm_from_jax(out, "ln_f", tree["ln_f"])
    _dense_from_jax(out, "head", tree["head"])
    return out


def moe_sensorformer_params_to_jax(state: Dict[str, torch.Tensor],
                                   num_heads: int) -> dict:
    """MoESensorFormer state_dict (any device) → flax param tree of
    numpy float32 arrays; ``num_heads`` as in
    ``sensorformer_params_to_jax``."""
    tree = _outer_to_jax(state)
    for b in _blocks(state):
        moe = {"router": {"kernel": np.ascontiguousarray(
            _host(state[f"{b}.moe.router.weight"]).T)}}
        for leaf in EXPERT_LEAVES:
            moe[leaf] = _host(state[f"{b}.moe.{leaf}"]).copy()
        tree[b] = {**_attn_block_to_jax(state, b, num_heads), "moe": moe}
    return tree


def moe_sensorformer_adam_from_optax(count, mu, nu) -> AdamState:
    """optax ``ScaleByAdamState`` fields over a flax ``MoESensorFormer``
    param tree → the port's ``AdamState``."""
    return AdamState(count=int(np.asarray(count)),
                     mu=moe_sensorformer_params_from_jax(mu),
                     nu=moe_sensorformer_params_from_jax(nu))


def moe_sensorformer_adam_to_optax(state: AdamState, num_heads: int
                                   ) -> Tuple[np.ndarray, dict, dict]:
    """The port's MoESensorFormer ``AdamState`` → (int32 count, mu tree,
    nu tree)."""
    return (np.asarray(state.count, np.int32),
            moe_sensorformer_params_to_jax(state.mu, num_heads),
            moe_sensorformer_params_to_jax(state.nu, num_heads))


#: the LSTM's cells in flax's creation order
LSTM_CELLS = ("enc0", "enc1", "dec0", "dec1")


def _lstm_cell_tree(tree, i: int, name: str) -> dict:
    if name in tree:
        return tree[name]["cell"]
    return tree[f"OptimizedLSTMCell_{i}"]


def lstm_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax ``LSTMSeq2Seq`` param tree (numpy leaves) → state_dict of CPU
    float32 tensors for ``iotml_torch.models.lstm.LSTMSeq2Seq``."""
    out: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(LSTM_CELLS):
        cell = _lstm_cell_tree(tree, i, name)
        for g in GATES:
            out[f"{name}.i{g}.weight"] = torch.from_numpy(
                np.ascontiguousarray(_f32(cell[f"i{g}"]["kernel"]).T))
            _dense_from_jax(out, f"{name}.h{g}", cell[f"h{g}"])
    _dense_from_jax(out, "head", tree["head"])
    return out


def lstm_params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """LSTM state_dict (any device) → flax param tree of numpy float32
    arrays, in the layout flax 0.12 builds (``OptimizedLSTMCell_i``)."""
    def kernel(name):
        return np.ascontiguousarray(_host(state[f"{name}.weight"]).T)

    tree = {"head": {"kernel": kernel("head"),
                     "bias": _host(state["head.bias"]).copy()}}
    for i, name in enumerate(LSTM_CELLS):
        cell = {}
        for g in GATES:
            cell[f"i{g}"] = {"kernel": kernel(f"{name}.i{g}")}
            cell[f"h{g}"] = {"kernel": kernel(f"{name}.h{g}"),
                             "bias": _host(state[f"{name}.h{g}.bias"]).copy()}
        tree[f"OptimizedLSTMCell_{i}"] = cell
    return tree


def lstm_adam_from_optax(count, mu, nu) -> AdamState:
    """optax ``ScaleByAdamState`` fields over a flax ``LSTMSeq2Seq`` param
    tree → the port's ``AdamState``."""
    return AdamState(count=int(np.asarray(count)),
                     mu=lstm_params_from_jax(mu), nu=lstm_params_from_jax(nu))


def lstm_adam_to_optax(state: AdamState) -> Tuple[np.ndarray, dict, dict]:
    """The port's LSTM ``AdamState`` → (int32 count, mu tree, nu tree)."""
    return (np.asarray(state.count, np.int32),
            lstm_params_to_jax(state.mu), lstm_params_to_jax(state.nu))


#: the MNIST models' layers (flax's auto names)
MNIST_LAYERS = ("Dense_0", "Dense_1")


def mnist_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax ``MNISTClassifier`` / ``MNISTBaseline`` tree → state_dict of
    CPU float32 tensors."""
    out: Dict[str, torch.Tensor] = {}
    for name in MNIST_LAYERS:
        _dense_from_jax(out, name, tree[name])
    return out


def mnist_params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """MNIST state_dict (any device) → flax param tree of numpy float32
    arrays."""
    return {name: {"kernel": np.ascontiguousarray(
                       _host(state[f"{name}.weight"]).T),
                   "bias": _host(state[f"{name}.bias"]).copy()}
            for name in MNIST_LAYERS}
