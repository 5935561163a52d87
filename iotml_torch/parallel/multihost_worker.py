"""One process's role in a multi-process training rehearsal
(``iotml.parallel.multihost_worker``'s twin).

    python -m iotml_torch.parallel.multihost_worker <coordinator> \\
        <nprocs> <pid> <servers> <topic> <n_partitions> [steps] \\
        [--device D] [--shards N] [--backend nccl|gloo]

What each pod of ``deploy/model-training-multihost.yaml`` does, scaled
down:

1. join the process group (``parallel.distributed.initialize``, over
   ``<coordinator>``; ``--backend`` nccl for a CUDA device unless given,
   gloo for the CPU; ranks sharing a card must take gloo);
2. consume only this process's partition share (``assign_partitions``)
   from the Kafka wire server at ``<servers>``;
3. drive a ``ShardedTrainer`` over ``--shards`` local shards on
   ``--device`` (``cuda`` unless given; the shards may share it), so
   the data axis is processes × local shards and each step's gradient
   sum crosses the processes;
4. require the loss to fall, print ``MULTIHOST pid=<p>/<n> devices=<d>
   partitions=[...] loss a->b rate=... rows=... ok`` and, on the next
   line, ``MULTIHOST-LOSSES <json>`` with the whole loss trajectory.

``spawn_rehearsal`` seeds a broker, serves it over the wire, starts the
workers as child processes and always kills the stragglers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.parallel.multihost_worker")
    ap.add_argument("coordinator")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("servers")
    ap.add_argument("topic")
    ap.add_argument("n_partitions", type=int)
    ap.add_argument("steps", type=int, nargs="?", default=6)
    ap.add_argument("--device", default=None,
                    help="where the local shards run (cuda unless given)")
    ap.add_argument("--shards", type=int, default=1,
                    help="local data-axis shards on --device")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the reduction's backend (nccl for a CUDA "
                         "device, gloo for the CPU)")
    ap.add_argument("--timeout-s", type=float, default=120.0,
                    help="rendezvous and collective timeout")
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 6:
        print("usage: multihost_worker <coordinator> <nprocs> <pid> "
              "<servers> <topic> <n_partitions> [steps]")
        return 1
    args = _parser().parse_args(argv)
    from ..data.dataset import SensorBatches
    from ..models.autoencoder import CAR_AUTOENCODER
    from ..stream.consumer import StreamConsumer
    from ..stream.kafka_wire import KafkaWireBroker
    from . import distributed
    from .data_parallel import ShardedTrainer
    from .mesh import make_mesh

    device = distributed.rank_device(args.device)
    joined = distributed.initialize(
        args.coordinator, args.nprocs, args.pid, backend=args.backend,
        device=device, timeout_s=args.timeout_s)
    try:
        if not joined and args.nprocs > 1:
            raise AssertionError("initialize() joined no process group")
        assert distributed.process_count() == args.nprocs, \
            distributed.process_count()
        # the data plane: this process consumes its partition share only
        parts = distributed.assign_partitions(args.n_partitions,
                                              args.nprocs, args.pid)
        client = KafkaWireBroker(args.servers)
        try:
            consumer = StreamConsumer(
                client, distributed.consumer_specs(args.topic, parts),
                group=f"multihost-{args.pid}")
            # pad_tail=False drops the ragged tail: every batch has the
            # fixed local shape the multi-process step requires
            batches = list(SensorBatches(consumer, batch_size=32,
                                         only_normal=True, pad_tail=False))
        finally:
            client.close()
        assert batches, f"process {args.pid}: no data in partitions {parts}"
        # the collective plane: processes × local shards
        mesh = make_mesh((args.shards,), ("data",),
                         devices=[device] * args.shards)
        trainer = ShardedTrainer(CAR_AUTOENCODER, mesh)
        losses = []
        t0 = None
        rows = 0
        for i in range(args.steps):
            b = batches[i % len(batches)]
            if i == 1:
                # step 0 warms up: the timed window covers the rest
                t0 = time.perf_counter()
                rows = 0
            m = trainer.step(b.x, b.x, b.mask)
            losses.append(float(m["loss"]))
            rows += b.n_valid
    finally:
        distributed.shutdown()
    assert all(v == v and abs(v) != float("inf") for v in losses), losses
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    dt = (time.perf_counter() - t0) if t0 is not None else 0.0
    rate = rows / dt if dt > 0 else 0.0
    print(f"MULTIHOST pid={args.pid}/{args.nprocs} "
          f"devices={args.nprocs * args.shards} partitions={parts} "
          f"loss {losses[0]:.6f}->{losses[-1]:.6f} rate={rate:.1f} "
          f"rows={rows} ok", flush=True)
    print("MULTIHOST-LOSSES " + json.dumps(losses), flush=True)
    return 0


def spawn_rehearsal(steps: int = 6, timeout: float = 420.0,
                    n_partitions: int = 4, n_procs: int = 2,
                    shards: int = 2, device: str = "cuda",
                    backend=None, broker=None):
    """Start the ``n_procs``-process rehearsal and return (procs, outs).

    Seeds a broker (40 cars × 60 ticks over ``n_partitions``; or serves
    the given one), serves it over the Kafka wire, scrubs the children's
    environment of an inherited pod topology, starts the workers and
    always kills stragglers, so a worker that dies early does not leave
    its peers waiting at the rendezvous.  ``timeout`` bounds the whole
    rehearsal (a worker still running then raises TimeoutExpired)."""
    import os
    import socket
    import subprocess

    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..stream.broker import Broker
    from ..stream.kafka_wire import KafkaWireServer

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if broker is None:
        broker = Broker()
        gen = FleetGenerator(FleetScenario(num_cars=40, failure_rate=0.02))
        gen.publish(broker, "SENSOR", n_ticks=60, partitions=n_partitions)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()

    env = dict(os.environ)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    for k in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        env.pop(k, None)
    extra = ["--device", device, "--shards", str(shards),
             "--timeout-s", str(timeout)]
    if backend is not None:
        extra += ["--backend", backend]
    with KafkaWireServer(broker) as srv:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "iotml_torch.parallel.multihost_worker",
             coord, str(n_procs), str(pid), f"127.0.0.1:{srv.port}",
             "SENSOR", str(n_partitions), str(steps)] + extra,
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for pid in range(n_procs)]
        outs = []
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                out, _ = p.communicate(
                    timeout=max(0.0, deadline - time.monotonic()))
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return procs, outs


if __name__ == "__main__":
    raise SystemExit(main())
