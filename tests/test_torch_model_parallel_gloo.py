"""The model-parallel paths across OS processes: two processes joined by
``torch.distributed`` over gloo on the CPU, each holding 1 or 2 local
shards of the mesh's first axis (the one that continues across
processes), run ring attention (forward and gradients), the
sequence-parallel step and the expert-parallel step; the results must
equal one process holding every shard.

Across processes the ring's rotations and the next-step shift are
``batch_isend_irecv`` P2P sends (and their backward the sends the other
way), the expert all-to-alls ``all_to_all_single``, the psums and the
gradient sums ``all_reduce``.  The same numpy draws and seeded weights
go in on both sides.  Tolerances: outputs rtol 1e-6 / atol 1e-7 (the
same arithmetic; only sums across processes change order), gradients
and losses rtol 1e-5 / atol 1e-7.

Run as a script, this file is one worker process (the test starts two).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from iotml_torch.models.moe import MoESensorFormer  # noqa: E402
from iotml_torch.models.transformer import SensorFormer  # noqa: E402
from iotml_torch.parallel import expert_parallel, seq_parallel  # noqa: E402
from iotml_torch.parallel.mesh import make_mesh  # noqa: E402
from iotml_torch.parallel.ring_attention import make_ring_attention  # noqa: E402
from iotml_torch.train.optim import Adam  # noqa: E402

#: the rendezvous and collective limit, and the whole run's
TIMEOUT_S = 120.0
OUT_TOL = dict(rtol=1e-6, atol=1e-7)
SUM_TOL = dict(rtol=1e-5, atol=1e-7)
STEPS = 2


def _draws():
    r = np.random.default_rng(17)
    qkv = [r.normal(size=(2, 32, 2, 8)).astype(np.float32) for _ in range(3)]
    x_sp = r.normal(size=(2, 32, 18)).astype(np.float32)
    x_ep = r.normal(size=(8, 8, 6)).astype(np.float32)
    return qkv, x_sp, x_ep


def _part(a: np.ndarray, axis: int, rank: int, world: int) -> np.ndarray:
    return np.split(a, world, axis=axis)[rank]


def _grads(grads) -> dict:
    return {k: v.numpy().tolist() for k, v in grads.items()}


def run(n_local: int, rank: int = 0, world: int = 1) -> dict:
    """Ring attention, the sp step and the EP step on ``n_local`` CPU
    shards of this process (of ``world``): this process's part of each
    result."""
    cpu = [torch.device("cpu")] * n_local
    qkv, x_sp, x_ep = _draws()
    out = {}

    # ring attention: T cut over 'seq', the process axis
    ts = [torch.from_numpy(_part(a, 1, rank, world)).requires_grad_(True)
          for a in qkv]
    ring = make_ring_attention(make_mesh((n_local,), ("seq",), cpu), "seq")
    o = ring(*ts)
    g = torch.autograd.grad(sum(torch.sin(s).sum() for s in o.shards), ts)
    out["ring"] = o.numpy().tolist()
    out["ring_grads"] = [t.numpy().tolist() for t in g]

    # the sequence-parallel step: ('data', 'seq'), seq across processes
    model = SensorFormer(features=18, d_model=16, num_heads=2, num_layers=2,
                         attn_mode="ring", device="cpu",
                         generator=torch.Generator().manual_seed(3))
    mesh = make_mesh((n_local, 1), ("seq", "data"), cpu)
    init, step, put_x = seq_parallel.make_sp_train_step(model, Adam(1e-3),
                                                        mesh)
    state, x = init(), put_x(_part(x_sp, 1, rank, world))
    metrics, grads = step.value_and_grad(state, x)
    out["sp_grads"] = _grads(grads)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, x)
        losses.append(float(m["loss"]))
    out["sp_losses"] = losses

    # the expert-parallel step: ('data', 'expert'), experts across
    model = MoESensorFormer(features=6, d_model=16, num_heads=2,
                            num_layers=1, num_experts=4,
                            capacity_factor=1.0, device="cpu",
                            generator=torch.Generator().manual_seed(5))
    mesh = make_mesh((n_local, 1), ("expert", "data"), cpu)
    init, step, put_x = expert_parallel.make_ep_train_step(
        model, Adam(1e-3), mesh)
    state, x = init(), put_x(_part(x_ep, 0, rank, world))
    metrics, grads = step.value_and_grad(state, x)
    out["ep_grads"] = _grads(grads)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, x)
        losses.append([float(m["loss"]), float(m["mse"])])
    out["ep_losses"] = losses
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(n_local: int, tmp_path) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    paths = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(r), "2",
         str(n_local), str(paths[r])], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            log, _ = p.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads(path.read_text()) for path in paths]


def _close(got, want, what, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **tol)


@pytest.mark.parametrize("n_local", [1, 2])
def test_two_gloo_processes_equal_one_process(n_local, tmp_path):
    ranks = _spawn(n_local, tmp_path)
    whole = run(2 * n_local)
    _close(np.concatenate([r["ring"] for r in ranks], axis=1), whole["ring"],
           "ring forward", **OUT_TOL)
    for i, name in enumerate("qkv"):
        _close(np.concatenate([r["ring_grads"][i] for r in ranks], axis=1),
               whole["ring_grads"][i], f"ring d{name}", **SUM_TOL)
    for r in ranks:
        # replicated leaves: every process holds the whole sum
        for k, g in whole["sp_grads"].items():
            _close(r["sp_grads"][k], g, f"sp grad {k}", **SUM_TOL)
        _close(r["sp_losses"], whole["sp_losses"], "sp losses", **SUM_TOL)
        _close(r["ep_losses"], whole["ep_losses"], "ep losses", **SUM_TOL)
    for k, g in whole["ep_grads"].items():
        if ".moe." in k and k.rsplit(".", 1)[-1] in expert_parallel \
                .EXPERT_LEAVES:
            # expert leaves: each process holds its experts' slice
            got = np.concatenate([r["ep_grads"][k] for r in ranks])
        else:
            got = ranks[1]["ep_grads"][k]
            _close(ranks[0]["ep_grads"][k], g, f"ep grad {k}", **SUM_TOL)
        _close(got, g, f"ep grad {k}", **SUM_TOL)


def _worker(argv) -> int:
    port, rank, world, n_local, path = argv
    rank, world, n_local = int(rank), int(world), int(n_local)
    import datetime

    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = run(n_local, rank, world)
    finally:
        torch.distributed.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
