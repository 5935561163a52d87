"""Adam with optax's state and arithmetic, as plain tensor ops.

The JAX package trains with ``optax.adam`` (b1 .9, b2 .999, eps 1e-8).
Its state is ``(count, mu, nu)`` and one update is

    mu = (1 - b1)·g + b1·mu          nu = (1 - b2)·g² + b2·nu
    t = count + 1                    p += -lr · (mu / (1 - b1^t))
                                             / (sqrt(nu / (1 - b2^t)) + eps)

with eps outside the sqrt.  ``torch.optim.Adam`` keeps another state
(per-parameter step tensors) and rounds in another order, so it cannot
hand its state to the fused kernel or take a JAX ``TrainState`` whole;
this class can.  Updates are functional: new tensors, inputs untouched.

``InjectableAdam`` is ``optax.inject_hyperparams(optax.adam)``, the
online learner's optimizer: the learning rate is optimizer STATE, so a
drift-triggered boost is a state edit (``set_learning_rate``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]

#: optax.adam's defaults, the only ones the JAX package trains with (and
#: the fused kernel's)
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    count: int  # updates applied so far (optax's int32 count)
    mu: Params
    nu: Params


class Adam:
    def __init__(self, learning_rate: float = 1e-3):
        self.learning_rate = learning_rate

    def init(self, params: Params) -> AdamState:
        return AdamState(count=0,
                         mu={k: torch.zeros_like(v) for k, v in params.items()},
                         nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: Params, state: AdamState, params: Params):
        """→ (new_params, new_state)."""
        t = state.count + 1
        # bias corrections in float32 on the host, like optax's
        # ``1 - decay**count``: Python scalars, so no device sync
        bc1 = (1 - torch.tensor(B1, dtype=torch.float32) ** t).item()
        bc2 = (1 - torch.tensor(B2, dtype=torch.float32) ** t).item()
        new_p, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - B1) * g + B1 * state.mu[k]
            nu[k] = (1 - B2) * (g * g) + B2 * state.nu[k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
            new_p[k] = params[k] + (-self.learning_rate) * u
        return new_p, AdamState(count=t, mu=mu, nu=nu)


#: the injectable state's hyperparameters, in optax's (sorted) leaf order
HYPERPARAMS = ("b1", "b2", "eps", "eps_root", "learning_rate")


@dataclasses.dataclass
class InjectableAdamState:
    """optax's ``InjectHyperparamsState`` over ``optax.adam``: its own
    update ``count``, the hyperparameters as float32 scalars and the
    inner ``AdamState``.  The hyperparameters are 0-dim float32 CPU
    tensors, so reading or editing the rate never waits for the card."""

    count: int
    hyperparams: Dict[str, torch.Tensor]
    inner: AdamState


class InjectableAdam:
    """Adam whose hyperparameters live in the state, with
    ``inject_hyperparams``'s arithmetic: every factor is the float32
    state value (``1 - b1`` is rounded in float32, where ``Adam`` rounds
    the double ``1 - 0.9``), and the step is scaled by the state's
    float32 rate."""

    def __init__(self, learning_rate: float = 1e-3):
        self.learning_rate = learning_rate

    def init(self, params: Params) -> InjectableAdamState:
        values = dict(b1=B1, b2=B2, eps=EPS, eps_root=0.0,
                      learning_rate=self.learning_rate)
        return InjectableAdamState(
            count=0,
            hyperparams={k: torch.tensor(values[k], dtype=torch.float32)
                         for k in HYPERPARAMS},
            inner=Adam(self.learning_rate).init(params))

    def update(self, grads: Params, state: InjectableAdamState,
               params: Params):
        """→ (new_params, new_state)."""
        hp = state.hyperparams
        b1, b2 = hp["b1"], hp["b2"]
        inner = state.inner
        t = inner.count + 1
        # host float32 scalars: the factors optax computes on the traced
        # hyperparameters, without a device sync
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        one_b1, one_b2 = 1 - b1, 1 - b2
        step = -hp["learning_rate"]
        new_p, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu[k] = one_b1 * g + b1 * inner.mu[k]
            nu[k] = one_b2 * (g * g) + b2 * inner.nu[k]
            u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2 + hp["eps_root"])
                                 + hp["eps"])
            new_p[k] = params[k] + step * u
        return new_p, InjectableAdamState(
            count=state.count + 1, hyperparams=hp,
            inner=AdamState(count=t, mu=mu, nu=nu))


def set_learning_rate(state: InjectableAdamState,
                      lr: float) -> InjectableAdamState:
    """The state with its rate replaced by float32 ``lr``: the runtime
    rate change of ``inject_hyperparams``, a state edit."""
    hp = dict(state.hyperparams)
    hp["learning_rate"] = torch.tensor(lr, dtype=torch.float32)
    return dataclasses.replace(state, hyperparams=hp)
