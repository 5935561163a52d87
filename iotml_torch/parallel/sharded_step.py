"""The optimizer step the model-parallel trainers share: params held as
pieces over a mesh, one backward through a sharded loss, and the
gradient sums JAX's ``shard_map`` transpose makes.

A step's params are a dict (or a dict of dicts) of ``ShardedTensor``s,
one a leaf, cut by the leaf's spec: ``P()`` (one whole copy a device that runs a shard),
``P('pipe')`` (a pipeline stage's ``[L/S, …]`` slice of the stacked
blocks) or ``P('expert')`` (an expert shard's ``[E/ep, …]`` slice).  A
block that several devices use has a piece on each.  The optimizer
state covers the pieces (keys ``(leaf path…, piece)``), so a device holds the
moments of its own pieces only.

``make_sharded_step`` runs a per-shard loss body under
``mesh.run_shards`` on each shard's pieces, seeds one backward with
``Σ loss / shards`` (the body's loss is replicated: a psum, and JAX's
transpose hands each replica ``1/shards`` of the cotangent), then sums
each block's piece gradients in piece order, sums across processes by
one ``all_reduce`` the leaves whose spec does not name the process axis,
gives each piece its block's sum and runs the optimizer a piece at a
time.  Collectives are library calls; no kernel here is hand-made.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Tuple

import torch

from ..train.loop import TrainState
from .mesh import (Mesh, NamedSharding, P, ShardedTensor,
                   axis_layout, block_of, cut, positions, process_world,
                   run_shards, spec_axes)

Specs = Dict[str, P]


def shard_modules(model: torch.nn.Module, mesh: Mesh) -> list:
    """One copy of ``model`` a shard of ``mesh``: ``functional_call``
    binds a shard's params into its own copy, since the shards' bodies
    interleave at every collective."""
    return [copy.deepcopy(model) for _ in range(mesh.size)]


def _process_part(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """The part of a whole leaf this process holds: cut along the
    dimension whose spec names the process axis."""
    for k, entry in enumerate(spec):
        axes = spec_axes(entry)
        if mesh.process_axis in axes:
            local, procs, rank = axis_layout(mesh, mesh.process_axis)
            if procs == 1:
                continue
            if axes != (mesh.process_axis,):
                raise ValueError(f"a leaf cut over {axes} with the process "
                                 f"axis {mesh.process_axis!r} among them")
            step = x.shape[k] // procs
            x = x.narrow(k, rank * step, step)
    return x


def _leaves(tree, prefix=()):
    """(path, leaf) of a dict of leaves or of such dicts, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree(items) -> dict:
    """The nested dict of (path, leaf) pairs."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _spec(specs: Specs, path: tuple):
    """A leaf's spec: its subtree's (``{'blocks': P('pipe')}``) or its
    own (``{'block0.moe.w1': P('expert')}``); replicated otherwise."""
    if len(path) > 1 and path[0] in specs:
        return specs[path[0]]
    return specs.get(path[-1], P())


def shard_leaves(params: dict, mesh: Mesh, specs: Specs) -> dict:
    """Whole leaves → pieces: each leaf cut by its spec (replicated when
    it has none), one piece a (block, device) its shards use."""
    out = []
    for path, full in _leaves(params):
        spec = _spec(specs, path)
        part = _process_part(full.detach(), mesh, spec)
        shards, blocks, seen = [], [], set()
        for c in positions(mesh):
            dev = mesh.devices[c]
            b = block_of(mesh, spec, c)
            if (b, dev) in seen:
                continue
            seen.add((b, dev))
            shards.append(cut(part, mesh, spec, c).to(dev, copy=True)
                          .contiguous())
            blocks.append(b)
        out.append((path, ShardedTensor(
            shards, NamedSharding(mesh, P(*spec)), blocks)))
    return _tree(out)


def flat(params: dict) -> Dict[tuple, torch.Tensor]:
    """{(leaf path..., piece index): piece}: what the optimizer
    updates."""
    return {path + (j,): s for path, st in _leaves(params)
            for j, s in enumerate(st.shards)}


def init_state(params: dict, mesh: Mesh, specs: Specs, tx) -> TrainState:
    """A step-0 ``TrainState`` over the mesh from whole leaves."""
    pieces = shard_leaves(params, mesh, specs)
    return TrainState(step=0, params=pieces, opt_state=tx.init(flat(pieces)))


def host_params(params: dict) -> dict:
    """Each leaf whole on the host (this process's part)."""
    return _tree((path, st.numpy()) for path, st in _leaves(params))


def _local(params: dict, mesh: Mesh, coords: tuple) -> dict:
    dev = mesh.devices[coords]
    return _tree((path, st.piece(block_of(mesh, st.sharding.spec, coords),
                                 dev))
                 for path, st in _leaves(params))


def _like(params: dict, pieces: Callable) -> dict:
    """``params`` with each leaf's shards replaced by ``pieces(path,
    leaf)``."""
    return _tree((path, ShardedTensor(pieces(path, st), st.sharding,
                                      st.blocks))
                 for path, st in _leaves(params))


def make_sharded_step(mesh: Mesh, tx, body: Callable,
                      local_args: Callable) -> Callable:
    """``step(state, *args) → (state, metrics)`` over ``mesh``.

    ``local_args(coords, *args)`` gives a shard its inputs;
    ``body(i, params, *inputs)`` is shard ``i``'s loss body and returns
    ``(loss, metrics)``, both replicated over the mesh (psums).  The
    metrics are shard 0's, detached; ``step.value_and_grad(state,
    *args)`` returns ``(metrics, grads)`` with each leaf's gradient as a
    ``ShardedTensor`` shaped like its params, before any update."""
    coords = positions(mesh)
    world, _ = process_world()
    n_global = len(coords) * world

    def value_and_grad(state: TrainState, *args):
        leaves = _like(state.params, lambda _p, st: [
            s.detach().requires_grad_(True) for s in st.shards])

        def shard(i):
            return body(i, _local(leaves, mesh, coords[i]),
                        *local_args(coords[i], *args))

        results = run_shards(mesh, shard)
        home = mesh.devices[coords[0]]
        total = sum(loss.to(home) for loss, _ in results) / n_global
        pieces = flat(leaves)
        grads = torch.autograd.grad(total, list(pieces.values()),
                                    allow_unused=True)
        by_piece = {key: torch.zeros_like(pieces[key]) if g is None else g
                    for key, g in zip(pieces, grads)}
        summed = _block_sums(leaves, by_piece, mesh, world)
        out = _like(leaves, lambda path, st: [
            summed[(path, b)].to(s.device)
            for b, s in zip(st.blocks, st.shards)])
        metrics = {k: v.detach() for k, v in results[0][1].items()}
        return metrics, out

    def step(state: TrainState, *args) -> Tuple[TrainState, dict]:
        metrics, grads = value_and_grad(state, *args)
        new, opt_state = tx.update(flat(grads), state.opt_state,
                                   flat(state.params))
        params = _like(state.params, lambda path, st: [
            new[path + (j,)] for j in range(len(st.shards))])
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state), metrics

    step.value_and_grad = value_and_grad
    return step


def _block_sums(leaves, by_piece, mesh: Mesh, world: int
                ) -> Dict[Tuple[tuple, tuple], torch.Tensor]:
    """Each leaf block's gradient: its pieces' sum in piece order on the
    block's first piece's device, then, for leaves replicated across
    processes, one ``all_reduce`` of all of them in one flat buffer."""
    summed: Dict[Tuple[tuple, tuple], torch.Tensor] = {}
    specs = {}
    for path, st in _leaves(leaves):
        specs[path] = st.sharding.spec
        for j, b in enumerate(st.blocks):
            g = by_piece[path + (j,)]
            key = (path, b)
            summed[key] = g if key not in summed \
                else summed[key] + g.to(summed[key].device)
    if world > 1:
        crossing = [key for key in summed
                    if mesh.process_axis not in
                    {a for e in specs[key[0]] for a in spec_axes(e)}]
        if crossing:
            home = summed[crossing[0]].device
            buf = torch.cat([summed[k].to(home).reshape(-1)
                             for k in crossing])
            torch.distributed.all_reduce(buf)
            sizes = [summed[k].numel() for k in crossing]
            for k, piece in zip(crossing, torch.split(buf, sizes)):
                summed[k] = piece.reshape(summed[k].shape).to(
                    summed[k].device)
    return summed
