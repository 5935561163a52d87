"""Pipeline parallelism: SensorFormer blocks staged over a 'pipe' mesh
axis (``iotml.parallel.pipeline``'s twin), GPipe style.

- The layer stack is held stacked: each block leaf gets a leading
  ``[num_layers]`` axis, cut ``P('pipe')``, so a stage's device holds
  only its own ``[L/S, …]`` slice and that slice's Adam moments.
- The schedule runs M + S − 1 ticks.  Each tick every stage applies its
  blocks to the microbatch it holds, then a ``ppermute`` shifts the
  activations one stage on around the ring.  Stage 0 injects microbatch
  t at tick t; the last stage banks the output of microbatch t − (S − 1).
- Backward is autograd's: the transpose of each shift is the shift the
  other way round, so microbatch gradients accumulate as in GPipe.
- Embed, position, final norm and head are small and replicated; the
  loss counts on the last stage only.

A stage's bubble ticks (before its first microbatch arrives, after its
last has left) are skipped: the JAX package computes them but banks
nothing from them, so no result changes, and a forward under
``attn_mode='flash'`` launches the causal flash kernel exactly
``num_layers × n_microbatches`` times (the backward the same of each of
its two kernels).  A skipped tick passes its input on.  The stages run
in one process: the 'pipe' axis may not be the mesh's process axis (the
'data' axis may), since the last tick's shift reaches no loss and its
backward would not run on every process.

The bubble share is (S − 1)/(M + S − 1): pick n_microbatches ≥ 4·S.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..train.loop import TrainState
from .mesh import (Mesh, NamedSharding, P, ShardedTensor, axis_index,
                   axis_layout, axis_size, block_of, global_axis_size,
                   ppermute, psum, shard_map)
from .sharded_step import init_state, make_sharded_step, shard_modules


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def pipeline_schedule(stage_fn: Callable, stage_params, mbs,
                      axis: str = "pipe"):
    """Run ``stage_fn(stage_params, x)`` as a pipeline over mesh axis
    ``axis``.  Call inside ``shard_map``: ``stage_params`` is this
    stage's slice, ``mbs`` ``[M, …microbatch…]``, the same on every
    stage (only stage 0 reads it).  Returns the ``[M, …]`` outputs on
    every stage (one psum)."""
    n = axis_size(axis)
    idx = axis_index(axis)
    M = mbs.shape[0]
    perm = _ring_perm(n)
    buf = torch.zeros_like(mbs[0])
    outs = [None] * M
    for t in range(M + n - 1):
        mb = t - idx  # the microbatch this stage holds at tick t
        if 0 <= mb < M:
            out = stage_fn(stage_params, mbs[t] if idx == 0 else buf)
            if idx == n - 1:
                outs[mb] = out
        else:  # a bubble tick: nothing to compute
            out = buf
        buf = ppermute(out, axis, perm)
    banked = torch.stack(outs) if idx == n - 1 else torch.zeros_like(mbs)
    # only the last stage holds the outputs; the psum gives them to all
    return psum(banked, axis)


def _one_process(mesh: Mesh, pipe_axis: str, other: str) -> None:
    if axis_layout(mesh, pipe_axis)[1] > 1:
        raise ValueError(f"the {pipe_axis!r} axis runs in one process; "
                         f"make {other!r} the mesh's process axis")


def pipeline_apply(stage_fn: Callable, mesh: Mesh, axis: str = "pipe"):
    """(stacked_params, mbs) → the ``[M, …]`` outputs: the stacked
    leaves' leading layer axis cut over ``axis``, ``mbs`` whole on
    every stage."""
    _one_process(mesh, axis, "another axis")

    def body(stacked_local, mbs):
        return pipeline_schedule(stage_fn, stacked_local, mbs, axis)

    return shard_map(body, mesh, in_specs=(P(axis), P()), out_specs=P())


def stack_blocks(params: Dict[str, torch.Tensor], num_layers: int
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A SensorFormer state_dict → (static, blocks): ``blocks[name]``
    stacks ``block{i}.name`` over i on a leading ``[num_layers]`` axis."""
    static = {k: v for k, v in params.items() if not k.startswith("block")}
    names = [k[len("block0."):] for k in params if k.startswith("block0.")]
    blocks = {name: torch.stack([params[f"block{i}.{name}"]
                                 for i in range(num_layers)])
              for name in names}
    return static, blocks


def unstack_blocks(static: Dict[str, torch.Tensor],
                   blocks: Dict[str, torch.Tensor], num_layers: int
                   ) -> Dict[str, torch.Tensor]:
    params = dict(static)
    for i in range(num_layers):
        for name, a in blocks.items():
            params[f"block{i}.{name}"] = a[i]
    return params


def make_pp_train_step(model, optimizer, mesh: Mesh, n_microbatches: int,
                       data_axis: str = "data", pipe_axis: str = "pipe"):
    """Build ``(init, step, put_x)`` for pipeline (and data) parallel
    next-step training of a SensorFormer.

    The mesh is ``(data_axis, pipe_axis)``: rows cut over data, the
    layer stack over pipe.  ``model.num_layers`` must divide by the pipe
    size and each data shard's rows by ``n_microbatches``.  The state's
    params are ``{'static': embed / pos / ln_f / head, replicated;
    'blocks': stacked [L, …] leaves cut P(pipe)}``, each leaf a
    ``ShardedTensor``; ``step.value_and_grad(state, x)`` gives the loss
    and gradients without the update."""
    n_pipe = global_axis_size(mesh, pipe_axis)
    L = model.num_layers
    if L % n_pipe:
        raise ValueError(f"num_layers={L} not divisible by pipe={n_pipe}")
    if model.attn_mode == "ring":
        # ring attention needs a 'seq' axis; each pipeline stage sees the
        # full sequence, so there is nothing to ring over
        raise ValueError("attn_mode='ring' cannot compose with pipeline "
                         "parallelism; use 'dense' or 'flash' (full T per "
                         "stage) or train via make_sp_train_step")
    _one_process(mesh, pipe_axis, data_axis)
    per_stage = L // n_pipe
    modules = shard_modules(model, mesh)
    x_sharding = NamedSharding(mesh, P(data_axis))

    def local_loss(i, params, x_local):
        static, blocks = params["static"], params["blocks"]
        m = modules[i]
        Bl, T, F = x_local.shape
        if Bl % n_microbatches:
            raise ValueError(f"{Bl} rows a data shard do not split into "
                             f"{n_microbatches} microbatches")

        def stage_fn(blocks_local, h):
            for j in range(per_stage):
                h = torch.func.functional_call(
                    m.block0, {k: v[j] for k, v in blocks_local.items()},
                    (h,))
            return h

        def sub(prefix):
            return {k[len(prefix) + 1:]: v for k, v in static.items()
                    if k.startswith(prefix + ".")}

        h = torch.func.functional_call(m.embed, sub("embed"), (x_local,))
        h = h + torch.func.functional_call(
            m.pos, sub("pos"), (torch.arange(T, device=x_local.device),))
        mbs = h.reshape(n_microbatches, Bl // n_microbatches, T, h.shape[-1])
        outs = pipeline_schedule(stage_fn, blocks, mbs, pipe_axis)
        idx, n = axis_index(pipe_axis), axis_size(pipe_axis)
        if idx == n - 1:
            # next-step MSE, counted on the last stage only
            h = outs.reshape(Bl, T, -1)
            h = torch.func.functional_call(m.ln_f, sub("ln_f"), (h,))
            pred = torch.func.functional_call(m.head, sub("head"), (h,))
            se = torch.sum(torch.square(pred[:, :-1] - x_local[:, 1:]))
            cnt = torch.tensor(float(pred[:, :-1].numel()),
                               device=x_local.device)
        else:
            se = torch.zeros((), device=x_local.device)
            cnt = torch.zeros((), device=x_local.device)
        loss = psum(se, (data_axis, pipe_axis)) \
            / psum(cnt, (data_axis, pipe_axis))
        return loss, {"loss": loss}

    def local_args(coords, x: ShardedTensor):
        return (x.piece(block_of(mesh, x.sharding.spec, coords),
                        mesh.devices[coords]),)

    step = make_sharded_step(mesh, optimizer, local_loss, local_args)

    def init() -> TrainState:
        static, blocks = stack_blocks(
            {k: v.detach() for k, v in model.state_dict().items()}, L)
        return init_state({"static": static, "blocks": blocks}, mesh,
                          {"blocks": P(pipe_axis)}, optimizer)

    def put_x(x) -> ShardedTensor:
        from .data_parallel import put_global

        if isinstance(x, ShardedTensor):
            return x
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return put_global(np.asarray(x, np.float32), x_sharding)

    return init, step, put_x
