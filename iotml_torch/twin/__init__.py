"""The per-car digital twin as a queryable feature store
(``iotml.twin``'s copy).

The reference maintains a digital twin of every car in MongoDB via a
Kafka Connect sink (one document per car, latest state wins).  This
package is the streaming-native version of that layer: `TwinService`
materialises per-car state (latest sensor reading + rolling-window
aggregates) straight from the sensor stream, changelogs every update to
the compacted ``CAR_TWIN`` topic (the store's key-based compaction keeps
it at ~one record per car), and rebuilds its table FROM that changelog
after a crash — the Kafka Streams state-store pattern, with the commit
log as the only storage.

Exposed two ways: over the connect REST surface (``GET /twin/<car_id>``,
``connect.ConnectServer.attach_twin``) and as a `TwinFeatureStore` the
`StreamScorer` joins against (per-car historical features concatenated
onto the live row before scoring).  Sharded by partition: one service
instance owns a partition subset and changelogs into the same
partitions it consumes.
"""

from .features import TwinFeatureStore
from .service import CHANGELOG_TOPIC, TwinService
from .state import CarTwin, TwinTable

__all__ = ["CarTwin", "TwinTable", "TwinService", "TwinFeatureStore",
           "CHANGELOG_TOPIC"]
