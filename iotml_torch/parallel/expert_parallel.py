"""Expert parallelism: the MoE expert weights cut over an 'expert' mesh
axis (``iotml.parallel.expert_parallel``'s twin).

Tokens shard over the batch (rows cut over the product of the data and
expert axes, data-major), the expert FFN weights over 'expert', and two
tiled all-to-alls inside the MoE layer (``models.moe``) move the token
slots expert-major and back within one expert group: the GShard
dispatch.

Gradients are JAX's: the replicated leaves' are summed over every shard;
an expert slice's over the data axis, since the all-to-all's transpose
already brings every token's share to the slice's expert shard
(``sharded_step``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.moe import EXPERT_LEAVES, MoEBlock
from ..train.loop import TrainState
from .mesh import (Mesh, NamedSharding, P, ShardedTensor, axis_size,
                   block_of, psum)
from .sharded_step import (init_state, make_sharded_step, shard_leaves,
                           shard_modules)

def expert_param_specs(params, ep_axis: str = "expert") -> Dict[str, P]:
    """A spec a leaf: the MoE expert weights cut their leading ``[E]``
    over the expert axis; the router and everything else replicated."""
    def spec(name: str) -> P:
        parts = name.split(".")
        if "moe" in parts and parts[-1] in EXPERT_LEAVES:
            return P(ep_axis)
        return P()

    return {name: spec(name) for name in params}


def shard_expert_params(params, mesh: Mesh, ep_axis: str = "expert"
                        ) -> Dict[str, ShardedTensor]:
    """Whole leaves → ``ShardedTensor``s cut by ``expert_param_specs``."""
    return shard_leaves(params, mesh, expert_param_specs(params, ep_axis))


def make_ep_train_step(model, optimizer, mesh: Mesh, data_axis: str = "data",
                       ep_axis: str = "expert", aux_weight: float = 0.01):
    """Build ``(init, step, put_x)`` for expert (and data) parallel
    next-step training of a ``MoESensorFormer``.

    The mesh is ``(data_axis, ep_axis)``.  Rows are cut over both axes'
    product, so every shard works a token block; the expert weights are
    cut over ``ep_axis``, and the model's all-to-alls ride it.  The loss
    is ``mse + aux_weight · mean over shards of aux``, and ``step``
    returns ``{"loss", "mse"}``; ``step.value_and_grad(state, x)`` gives
    them and the gradients without the update, and ``step.dropped()``
    the tokens over capacity in the last call, summed over this
    process's shards and every MoE block."""
    if set(mesh.axis_names) != {data_axis, ep_axis}:
        raise ValueError(f"an expert-parallel mesh has the axes "
                         f"{(data_axis, ep_axis)}, not {mesh.axis_names}")
    modules = [m.set_ep_axis(ep_axis) for m in shard_modules(model, mesh)]
    axes = (data_axis, ep_axis)
    x_sharding = NamedSharding(mesh, P(axes))

    def local_loss(i, params, x_local):
        pred, aux = torch.func.functional_call(modules[i], params,
                                               (x_local,))
        se = torch.sum(torch.square(pred[:, :-1] - x_local[:, 1:]))
        cnt = torch.tensor(float(pred[:, :-1].numel()),
                           device=x_local.device)
        mse = psum(se, axes) / psum(cnt, axes)
        aux_mean = psum(aux, axes) / axis_size(axes)
        loss = mse + aux_weight * aux_mean
        return loss, {"loss": loss, "mse": mse}

    def local_args(coords, x: ShardedTensor):
        return (x.piece(block_of(mesh, x.sharding.spec, coords),
                        mesh.devices[coords]),)

    step = make_sharded_step(mesh, optimizer, local_loss, local_args)

    def dropped() -> int:
        return sum(int(m.moe.dropped) for module in modules
                   for m in module.modules() if isinstance(m, MoEBlock))

    step.dropped = dropped

    def init() -> TrainState:
        params = {k: v.detach() for k, v in model.state_dict().items()}
        return init_state(params, mesh, expert_param_specs(params, ep_axis),
                          optimizer)

    def put_x(x) -> ShardedTensor:
        from .data_parallel import put_global

        if isinstance(x, ShardedTensor):
            return x
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return put_global(np.asarray(x, np.float32), x_sharding)

    return init, step, put_x
