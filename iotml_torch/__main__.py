"""Top-level CLI index: ``python -m iotml_torch`` lists the port's entry
points (``iotml.__main__``'s copy over the port's modules).

The reference scatters its runnable surface across shell scripts, kubectl
plugins, and positional-arg Python files; here one command shows the map.
"""

from __future__ import annotations

import sys

COMMANDS = [
    ("iotml_torch.cli.demo", "the whole reference pipeline end-to-end in "
                             "one command (fleet → KSQL → train → serve → "
                             "anomalies)"),
    ("iotml_torch.cli.up", "whole platform in one process (Kafka wire + "
                           "MQTT + Schema-Registry/KSQL/Connect REST + "
                           "metrics + fleet)"),
    ("iotml_torch.cli.cardata", "car-sensor autoencoder: streaming "
                                "train/predict (reference cardata-v3.py "
                                "contract)"),
    ("iotml_torch.cli.lstm", "LSTM seq2seq: streaming train/predict "
                             "(reference LSTM cardata-v2.py contract)"),
    ("iotml_torch.cli.serve", "long-lived scorer with ordered write-back "
                              "(offset|committed|group elastic modes)"),
    ("iotml_torch.cli.live", "continuous trainer / live scorer over a "
                             "Kafka wire server"),
    ("iotml_torch.cli.creditcard", "creditcard fraud demo: produce + "
                                   "train + eval"),
    ("iotml_torch.cli.mnist_smoke", "MNIST ingest smoke test + in-memory "
                                    "control"),
    ("iotml_torch.cli.devsim", "scenario-driven device fleet "
                               "(run/jobs/show/log/abort/example)"),
    ("iotml_torch.twin", "drill: kill the twin service, rebuild it from "
                         "the compacted CAR_TWIN changelog"),
    ("iotml_torch.gateway", "drill/front/fleet: the sharded twin serving "
                            "plane (shard kill, federated MQTT fronts)"),
    ("iotml_torch.chaos", "run/schedule: fault-injection scenarios and "
                          "their invariant verdicts"),
    ("iotml_torch.online", "drill/run: drift detection and online "
                           "adaptation"),
    ("iotml_torch.mlops", "drill/registry: the model lifecycle"),
    ("iotml_torch.supervise", "drill: the self-healing runtime's live "
                              "drills"),
    ("iotml_torch.replication", "drill: replicated durability (failover, "
                                "double fault, reassign)"),
    ("iotml_torch.cluster", "up/add-broker/drain-broker/drill: the "
                            "partitioned cluster"),
    ("iotml_torch.obs.dashboards", "generate the Grafana dashboard "
                                   "ConfigMap"),
    ("iotml_torch.obs", "trace/dlq/fleet/tsdb: span-log breakdowns, the "
                        "dead-letter queue, fleet scrapes, the TSDB"),
]


def main() -> int:
    print("iotml_torch — the PyTorch/CUDA port of iotml. Entry points:\n")
    for mod, desc in COMMANDS:
        print(f"  python -m {mod:30s} {desc}")
    print("\nSee README.md (\"The PyTorch/CUDA port\") and PERF.md.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
