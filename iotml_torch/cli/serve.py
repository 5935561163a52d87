"""Long-lived continuous scorer, the serve-side entry point
(``iotml.cli.serve``'s twin):

    python -m iotml_torch.cli.serve <servers> <topic> \\
        <offset|committed|group> <result_topic> <model-file> <artifact-root>

What ``deploy/model-predictions.yaml`` runs: restore the model once, then
poll the stream, score what arrives and write ordered predictions back,
committing the consumer group's offsets after each completed drain so a
restart resumes where it stopped.  ``<offset>`` is an absolute offset
for every partition, ``committed`` (resume from the group's committed
offsets, 0 where none), or ``group`` (replicas of this command split the
partitions through a group coordinator and rebalance when one joins,
leaves or crashes: over ``host:port`` the replicas are separate
processes and the coordinator lives in the server, reached through
``RemoteGroupCoordinator``).  ``<servers>`` is ``emulator[:n_records]``,
the in-process broker with generated fleet data, or ``host:port[,...]``,
a Kafka server reached by the wire client with the ``broker`` section's
SASL/PLAIN credentials; ``--serve.*`` flags and ``IOTML_SERVE_*`` env set
the poll interval and the anomaly threshold.

The model is the port's checkpoint (npz + JSON, as ``cli.cardata``
train stores it).  Scoring runs on ``cuda``; ``main(argv,
device="cpu")`` runs it on the CPU from Python.  The closing line is
followed by a ``stats: {...}`` JSON line, which names the broker kind
(``emulator`` or ``wire``).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

from ..config import load_config
from ..data.dataset import SensorBatches
from ..models.autoencoder import CAR_AUTOENCODER
from ..serve.scorer import StreamScorer
from ..stream import native
from ..stream.consumer import StreamConsumer
from ..stream.group import GroupConsumer
from ..stream.producer import OutputSequence
from ..train.artifacts import ArtifactStore
from ..train.checkpoint import CheckpointManager
from ..utils.device import DeviceLike, resolve_device
from . import _app

USAGE = ("usage: python -m iotml_torch.cli.serve <servers> <topic> "
         "<offset|committed|group> <result_topic> <model-file> "
         "<artifact-root>\n"
         "  servers: emulator[:n_records] | host:port[,...]\n"
         "  offset:  absolute | committed (resume cursor) | group (elastic "
         "replica membership)")

GROUP = "iotml-serve"


def main(argv=None, max_rounds=None, *, device: DeviceLike = None) -> int:
    """Serve until ``max_rounds`` rounds have run (None: forever); returns
    the process exit code (1 on an argument or config error)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        cfg, argv = load_config(argv)
    except ValueError as e:
        print(f"config error: {e}")
        return 1
    print("Options: ", argv)
    if len(argv) != 6:
        print(USAGE)
        return 1
    servers, topic, offset, result_topic, model_file, artifact_root = argv
    offset = offset.strip().lower()
    device = resolve_device(device)  # no card and no device: raise now

    with _app.connected(servers, topic, cfg) as conn:
        broker = conn.broker
        store = ArtifactStore(artifact_root)

        print("Downloading model", model_file)
        restore_dir = tempfile.mkdtemp(prefix="iotml_torch_serve_")
        try:
            payload = CheckpointManager.load_dir(store.download_tree(
                model_file, os.path.join(restore_dir, "ckpt")))
        finally:
            shutil.rmtree(restore_dir, ignore_errors=True)

        if offset == "group":
            consumer = GroupConsumer(conn.coordinator(GROUP), [topic])
        elif offset == "committed":
            parts = _app.topic_partitions(broker, topic)
            consumer = StreamConsumer.from_committed(broker, topic, parts,
                                                     group=GROUP, eof=False)
        else:
            consumer = StreamConsumer(
                broker, [f"{topic}:{p}:{int(offset)}"
                         for p in _app.topic_partitions(broker, topic)],
                group=GROUP, eof=False)

        batches = SensorBatches(consumer, batch_size=cfg.train.batch_size)
        out = OutputSequence(broker, result_topic, partition=0)
        scorer = StreamScorer(CAR_AUTOENCODER, payload["params"], batches, out,
                              threshold=cfg.serve.threshold or None,
                              device=device)
        print(f"serving: polling {topic} every {cfg.serve.poll_interval_s}s "
              f"→ {result_topic}")
        before = dict(native.stats)
        t0 = time.perf_counter()
        scorer.run_forever(poll_interval_s=cfg.serve.poll_interval_s,
                           max_rounds=max_rounds)
        seconds = time.perf_counter() - t0
        print(f"serve loop exited after scoring {scorer.scored} records")
        print("stats:", json.dumps({
            "mode": "serve", "broker": conn.kind,
            "rows": scorer.scored, "rounds": scorer.rounds,
            "rewinds": scorer.rewinds, "serve_seconds": seconds,
            "first_forward_s": scorer.first_forward_s,
            "host_pipeline_s": scorer.seconds["host_pipeline"],
            "device_compute_s": scorer.seconds["device_compute"],
            "write_back_s": scorer.seconds["write_back"],
            **_app._stats_delta(before, "decode_rows", "decode_s",
                                "format_rows", "format_s")}))
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
