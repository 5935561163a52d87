"""Sharded scatter-gather twin serving (``iotml.gateway``'s copy).

The serving plane over the digital twin: the TwinTable partitions
across cluster shards keyed by the changelog partitioning, each shard
shadowed by a warm standby rebuilt continuously from the compacted
changelog (the Kafka Streams standby-replica pattern), a scatter-gather
router on the Connect REST shapes, and a federated multi-process MQTT
ingest front so the reference's full 100,000-car fleet runs live.

Layers (one direction, no cycles):

    fronts.py   federated MQTT ingest (front processes + fleet driver)
    shards.py   GatewayShard / TwinStandby / GatewayCluster (primaries,
                warm standbys, promotion, the leadership map)
    router.py   GatewayClient (smart, scatter-gather, feature-store
                duck-type) + GatewayRouter (fleet-facing REST mounts)
    drill.py    live shard-kill / standby-promotion drill

The serving plane is host code: nothing here launches a kernel.  The
scorer that joins through ``GatewayClient`` runs its model where its
device says.
"""

from .drill import GatewayDrillReport, run_gateway_drill
from .fronts import (FederatedFleet, FrontProcess, MqttFront, front_for,
                     run_federated_fleet)
from .router import (GatewayClient, GatewayError, GatewayRouter,
                     partition_for_key, shard_for_key)
from .shards import (GatewayCluster, GatewayShard, StandbyDriver,
                     TwinStandby)

__all__ = [
    "FederatedFleet",
    "FrontProcess",
    "GatewayClient",
    "GatewayCluster",
    "GatewayDrillReport",
    "GatewayError",
    "GatewayRouter",
    "GatewayShard",
    "MqttFront",
    "StandbyDriver",
    "TwinStandby",
    "front_for",
    "partition_for_key",
    "run_federated_fleet",
    "run_gateway_drill",
    "shard_for_key",
]
