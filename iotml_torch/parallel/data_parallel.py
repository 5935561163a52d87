"""Data-parallel training and scoring over a device mesh
(``iotml.parallel.data_parallel``'s twin).

The batch's rows split over the mesh's ``data`` axis, and the step is
written out shard by shard, where the JAX package lets XLA partition
one program:

- each shard runs the forward and the backward on its own rows, on its
  own device;
- the gradients are summed in shard order on the first shard's device
  (one flat buffer holding every gradient, the loss and the accuracy's
  numerator) and, when the job has more than one process, summed again
  across processes by one ``torch.distributed.all_reduce``;
- one Adam update is applied to each distinct device's copy of the
  params, so the copies stay bit-identical; shards on one device share
  one copy.

The global loss is not a mean of shard losses.  The masked MSE divides
by the whole batch's valid count × features and the activity penalty
by its row count, padding and dry feeds' zero shards included
(``train.loop.make_loss_fn``'s ``denom``/``rows`` hooks), so each
shard's loss is its share of the batch's and the shards' gradients sum
to the batch's gradient.  A batch of 100 rows on 8 shards is padded to
104 rows, as in the JAX package, and trains as the single-device step
on those 104 rows does.

A ``model`` axis larger than 1 is accepted and its layout reported
(``param_specs``: the Dense weights whose output dimension divides
evenly, as the JAX package cuts them), but no tensor is cut over it:
every data-axis device holds the whole params, so the step is the
unsharded one.

``DistributedDataParallel`` is not used: it averages the ranks'
gradients, which is the mean of per-rank losses, not the batch's loss.
Collectives are library calls; no kernel of this module is hand-made.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..train.loop import TrainState, loss_denominator, make_loss_fn, \
    row_losses
from ..train.optim import Adam, InjectableAdamState
from . import distributed
from .mesh import Mesh, NamedSharding, P, ShardedTensor, batch_sharding, \
    data_devices, split_rows

Params = Dict[str, torch.Tensor]


def _model_size(mesh: Mesh, model_axis: Optional[str]) -> int:
    return mesh.shape.get(model_axis, 1) if model_axis else 1


def param_specs(params: Params, mesh: Mesh,
                model_axis: Optional[str] = "model") -> Dict[str, P]:
    """A spec a param: a Dense weight ([out, in]) whose output dimension
    divides by the model axis is cut over it (``P(model_axis, None)``,
    JAX's ``P(None, model_axis)`` on its [in, out] kernel); everything
    else is replicated.  With a model axis of 1 this is pure data
    parallelism."""
    m = _model_size(mesh, model_axis)

    def spec(name: str, leaf: torch.Tensor) -> P:
        if m > 1 and name.rsplit(".", 1)[-1] == "weight" \
                and leaf.dim() == 2 and leaf.shape[0] % m == 0:
            return P(model_axis, None)
        return P()

    return {k: spec(k, v) for k, v in params.items()}


def _grid(mesh: Mesh, model_axis: Optional[str]) -> np.ndarray:
    """The mesh's devices as [data, model] (model 1 without the axis)."""
    names = mesh.axis_names
    if "data" not in names or set(names) - {"data", model_axis}:
        raise ValueError(f"data-parallel mesh axes must be 'data' and "
                         f"optionally {model_axis!r}, got {names}")
    order = [names.index("data")] + \
        [i for i, n in enumerate(names) if n != "data"]
    return np.transpose(mesh.devices, order).reshape(
        mesh.shape["data"], -1)


def _distinct(devices) -> List[torch.device]:
    out: List[torch.device] = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def _host_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def put_global(x: np.ndarray, sharding: NamedSharding) -> ShardedTensor:
    """Host array → ``ShardedTensor``.  ``P('data')``: the rows are cut
    into contiguous blocks, one a data-axis shard on its device (the row
    count must divide); ``P()``: a whole copy on each distinct device.
    Under ``torch.distributed`` ``x`` is this process's share of the
    global batch, which is the processes' shares in rank order."""
    mesh = sharding.mesh
    if sharding.spec and sharding.spec[0] == "data":
        devs = data_devices(mesh)
        if x.shape[0] % len(devs):
            raise ValueError(f"{x.shape[0]} rows do not split over a "
                             f"{len(devs)}-shard data axis")
        return ShardedTensor([_host_tensor(b, d) for b, d in
                              zip(np.split(x, len(devs)), devs)], sharding)
    if sharding.spec and any(a is not None for a in sharding.spec):
        raise ValueError(f"put_global cuts rows over 'data' or "
                         f"replicates, not {sharding.spec!r}")
    return ShardedTensor([_host_tensor(x, d) for d in
                          _distinct(mesh.devices.flat)], sharding)


def shard_params(params: Params, mesh: Mesh,
                 model_axis: Optional[str] = "model"
                 ) -> Dict[str, ShardedTensor]:
    """Each param as a ``ShardedTensor`` over the first data shard's
    model-axis devices: a cut weight as one output-rows block a device,
    every other param whole on the first device."""
    specs = param_specs(params, mesh, model_axis)
    row = list(_grid(mesh, model_axis)[0])
    out = {}
    for k, v in params.items():
        blocks = v.chunk(len(row), dim=0) if specs[k] else (v,)
        out[k] = ShardedTensor([b.to(d) for b, d in zip(blocks, row)],
                               NamedSharding(mesh, specs[k]))
    return out


def make_device_normalized_step(raw, normalizer):
    """Fold the affine normalization into a step: the host ships raw
    float32 columns (the batcher runs ``core.normalize.RAW_COLUMNS``)
    and ``(x * scale + shift) * mask`` runs on the device over each
    batch, with the same ``Normalizer``'s constants the host path uses,
    so the two agree to float32 rounding (~1 ulp: the host twin rounds
    once from float64).  The target is normalized the same way.

    ``raw`` is ``(state, x, y, mask) → (state, metrics)``: the
    single-device step, or the sharded trainer's, whose ``x`` and ``y``
    are ``ShardedTensor``s folded shard by shard on their devices."""
    host = [np.asarray(a, np.float32) for a in
            (normalizer.scale, normalizer.shift, normalizer.mask)]
    on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def fold_one(x: torch.Tensor) -> torch.Tensor:
        c = on.get(x.device)
        if c is None:
            c = on[x.device] = tuple(torch.from_numpy(a).to(x.device)
                                     for a in host)
        return (x * c[0] + c[1]) * c[2]

    def fold(x):
        if isinstance(x, ShardedTensor):
            return ShardedTensor([fold_one(s) for s in x.shards],
                                 x.sharding)
        return fold_one(x)

    def step(state, x, y, mask):
        folded = fold(x)
        return raw(state, folded, folded if y is x else fold(y), mask)

    return step


def _opt_on(opt, device):
    """An Adam state's moments on ``device``."""
    if isinstance(opt, InjectableAdamState):
        return dataclasses.replace(opt, hyperparams=dict(opt.hyperparams),
                                   inner=_opt_on(opt.inner, device))
    return dataclasses.replace(
        opt, mu={k: v.to(device) for k, v in opt.mu.items()},
        nu={k: v.to(device) for k, v in opt.nu.items()})


class ShardedTrainer:
    """The mesh-parallel twin of ``train.loop.Trainer``: the same step
    math, with the batch's rows split over the ``data`` axis.

    ``model`` is a model spec (``AutoencoderSpec``), built on the first
    data shard's device with weights from ``seed``.  ``normalizer=``
    folds the affine normalization onto the devices (the host ships raw
    columns, ``make_device_normalized_step``); ``row_loss=True`` adds
    the per-row pre-update loss to the metrics as a ``ShardedTensor``
    whose shards stay on their devices (the per-device drift signal).

    Each distinct data-axis device holds the whole params and Adam
    moments.  A ``model`` axis is the JAX layout's metadata
    (``param_specs``): it cuts no tensor here, and its devices beyond
    the data axis's compute nothing."""

    def __init__(self, model, mesh: Mesh, seed: int = 0,
                 learning_rate: float = 1e-3, supervised: bool = False,
                 tx=None, model_axis: str = "model", normalizer=None,
                 row_loss: bool = False):
        self.mesh = mesh
        self.model_axis = model_axis
        self._devices = list(_grid(mesh, model_axis)[:, 0])
        self._home = self._devices[0]  # where the shards' sums meet
        self.model = model.build(self._home,
                                 torch.Generator().manual_seed(seed))
        self.tx = tx if tx is not None else Adam(learning_rate)
        self.supervised = supervised
        self.normalizer = normalizer
        self.row_loss = row_loss
        self._loss_fn = make_loss_fn(self.model, supervised)
        self._data_sharding = batch_sharding(mesh)
        #: (states, x, y, mask) → (states, metrics), the fold outside
        self._run = self._raw_step if normalizer is None else \
            make_device_normalized_step(self._raw_step, normalizer)
        #: distinct data-axis device → its replica's TrainState
        self._states: Dict[torch.device, TrainState] = {}
        self._shapes: List[Tuple[str, torch.Size]] = []
        #: multi-process: the one local batch shape every process agreed
        #: on at the first step (see _agree)
        self._agreed_shape: Optional[tuple] = None

    @property
    def data_sharding(self) -> NamedSharding:
        return self._data_sharding

    @property
    def device(self) -> torch.device:
        """The first data shard's device, where ``state`` is read."""
        return self._home

    # ------------------------------------------------------------ state
    def init(self, from_state: Optional[TrainState] = None) -> TrainState:
        """Build (or adopt: a warm start from a host ``TrainState``) the
        state and lay a replica of it on each data-axis device."""
        st = from_state if from_state is not None else \
            TrainState.create(self.model, self.tx)
        self.state = st
        return self.state

    @property
    def state(self) -> Optional[TrainState]:
        """The first data shard's device's replica (all are equal)."""
        return self._states.get(self._home)

    @state.setter
    def state(self, st: Optional[TrainState]) -> None:
        if st is None:
            self._states = {}
            return
        self._shapes = [(k, v.shape) for k, v in st.params.items()]
        self._states = {
            dev: TrainState(step=st.step,
                            params={k: v.to(dev)
                                    for k, v in st.params.items()},
                            opt_state=_opt_on(st.opt_state, dev))
            for dev in _distinct(self._devices)}

    # ------------------------------------------------------------ input
    def put_batch(self, x: np.ndarray, y: np.ndarray, mask: np.ndarray):
        """Host batch → row-sharded ``ShardedTensor``s.  Rows are
        zero-padded to a multiple of the data axis (the masked loss
        ignores padding rows), so any batch size runs on any mesh.
        Under ``torch.distributed`` the arrays are this process's rows
        and every process must bring the same local shape (``_agree``)."""
        d = len(self._devices)

        def put(a):
            return ShardedTensor([_host_tensor(b, dev) for b, dev in
                                  zip(split_rows(a, d), self._devices)],
                                 self._data_sharding)

        return put(x), put(y), put(mask)

    def _agree(self, shape: tuple) -> None:
        """Multi-process: every process must present the same local
        shape, or the gradient buffers differ and a collective hangs.
        The check is one collective at the first step, which every
        process reaches together; a later change (a ragged tail one
        process hit) raises here, locally, without desynchronizing a
        collective."""
        if distributed.process_count() == 1:
            return
        if self._agreed_shape is None:
            s = torch.tensor(list(shape), dtype=torch.float64)
            t = torch.cat([s, -s]).to(self._home)
            torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
            hi, lo = t.cpu().numpy().reshape(2, -1)
            if not (np.array_equal(hi, s.numpy())
                    and np.array_equal(-lo, s.numpy())):
                raise ValueError(
                    f"multi-process batch shape mismatch: this process "
                    f"has {tuple(shape)}, the processes span "
                    f"{tuple(int(v) for v in -lo)}..{tuple(int(v) for v in hi)}"
                    f" — every process must feed identical local batch "
                    f"shapes")
            self._agreed_shape = tuple(shape)
        elif tuple(shape) != self._agreed_shape:
            raise ValueError(
                f"multi-process batch shape changed mid-run: "
                f"{tuple(shape)} != agreed {self._agreed_shape} — use "
                f"fixed-size batches on every process (SensorBatches "
                f"pad_tail=True, or pad_tail=False which drops ragged "
                f"tails) and equal step counts")

    # ------------------------------------------------------------- step
    def _raw_step(self, states: Dict[torch.device, TrainState],
                  x: ShardedTensor, y: ShardedTensor, mask: ShardedTensor):
        """One optimizer step over a row-sharded batch: (states, metrics),
        the metrics device scalars on the first shard's device and
        ``row_loss`` a ``ShardedTensor``.  Nothing syncs the host."""
        self._agree(x.shape)
        world = distributed.process_count()
        rows = x.shape[0] * world
        msum = sum(m.sum().to(self._home) for m in mask.shards)
        if world > 1:
            torch.distributed.all_reduce(msum)
        features = math.prod((y if self.supervised else x).shape[1:])
        denom = loss_denominator(msum, features)
        flat, row_loss = None, []
        for dev, xd, yd, md in zip(self._devices, x.shards, y.shards,
                                   mask.shards):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in states[dev].params.items()}
            loss, (pred, target) = self._loss_fn(
                leaves, xd, yd, md, denom.to(dev), rows)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            pred = pred.detach()
            m = md.reshape(md.shape + (1,) * (pred.dim() - 1))
            hits = torch.sum((pred == target).to(torch.float32) * m)
            part = torch.cat([g.reshape(-1) for g in grads]
                             + [loss.detach().reshape(1), hits.reshape(1)])
            part = part.to(self._home)
            flat = part if flat is None else flat + part
            if self.row_loss:
                row_loss.append(row_losses(pred, target, md))
        if world > 1:
            torch.distributed.all_reduce(flat)
        pieces = torch.split(flat, [math.prod(s) for _k, s in self._shapes]
                             + [1, 1])
        grads = {k: pieces[i].reshape(s)
                 for i, (k, s) in enumerate(self._shapes)}
        new = {}
        for dev, st in states.items():
            params, opt_state = self.tx.update(
                {k: g.to(dev) for k, g in grads.items()}, st.opt_state,
                st.params)
            new[dev] = TrainState(step=st.step + 1, params=params,
                                  opt_state=opt_state)
        metrics = {"loss": pieces[-2].reshape(()),
                   "accuracy": pieces[-1].reshape(()) / denom}
        if self.row_loss:
            metrics["row_loss"] = ShardedTensor(row_loss,
                                                self._data_sharding)
        return new, metrics

    def _step(self, x: ShardedTensor, y: ShardedTensor,
              mask: ShardedTensor) -> dict:
        self._states, metrics = self._run(self._states, x, y, mask)
        return metrics

    def step(self, x: np.ndarray, y: np.ndarray, mask: np.ndarray) -> dict:
        if not self._states:
            self.init()
        return self._step(*self.put_batch(x, y, mask))

    def fit(self, batches, epochs: int = 1,
            prefetch_depth: Optional[int] = None) -> dict:
        """Epochs × steps with host↔device overlap: a
        ``DevicePrefetcher`` cuts and stages the next batch's shards on
        their devices while the current step runs, and the step losses
        stay on the device until the epoch ends (one sync an epoch)."""
        from ..data.prefetch import DevicePrefetcher

        history = {"loss": [], "records": [], "seconds": []}
        epoch_iter = batches.epochs(epochs) if hasattr(batches, "epochs") \
            else (iter(batches) for _ in range(epochs))
        for it in epoch_iter:
            t0 = time.perf_counter()
            it = iter(it)
            if not self._states:
                first = next(it, None)
                if first is None:
                    history["loss"].append(float("nan"))
                    history["records"].append(0)
                    history["seconds"].append(time.perf_counter() - t0)
                    continue
                self.init()
                it = itertools.chain([first], it)
            losses, records = [], 0
            with DevicePrefetcher(it, depth=prefetch_depth,
                                  sharding=self._data_sharding) as pf:
                for (xd, yd, md), b in pf:
                    m = self._step(xd, yd if yd is not None else xd, md)
                    losses.append(m["loss"])
                    records += b.n_valid
            mean = float("nan")
            if losses:
                # lint-ok: T2 the epoch's one sync, for its step losses
                mean = float(np.mean(torch.stack(losses).cpu().tolist()))
            history["loss"].append(mean)
            history["records"].append(records)
            history["seconds"].append(time.perf_counter() - t0)
        return history


def make_sharded_eval_step(model: torch.nn.Module, mesh: Mesh):
    """(params, x) → the model's output, row-sharded like ``x`` (a host
    array, padded and cut over 'data', or a ``ShardedTensor``): each
    shard runs on its device under a copy of ``params`` there."""
    sharding = batch_sharding(mesh)
    devices = data_devices(mesh)

    def ev(params: Params, x) -> ShardedTensor:
        if not isinstance(x, ShardedTensor):
            x = ShardedTensor([_host_tensor(b, d) for b, d in
                               zip(split_rows(x, len(devices)), devices)],
                              sharding)
        outs, on = [], {}
        with torch.no_grad():
            for xd in x.shards:
                p = on.get(xd.device)
                if p is None:
                    p = on[xd.device] = {k: v.to(xd.device)
                                         for k, v in params.items()}
                outs.append(torch.func.functional_call(model, p, (xd,)))
        return ShardedTensor(outs, sharding)

    return ev
