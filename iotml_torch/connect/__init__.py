"""The port's Kafka Connect (``iotml.connect``): the worker runtime, the
reference's three connectors and the Connect REST server, which also
serves the digital twin (``twin``) and the telemetry TSDB."""

from .connectors import (DocumentStoreSink, FileStreamSource, HoistFieldKey,
                         ObjectStoreSink)
from .runtime import ConnectWorker, SinkConnector, SourceConnector, SourceRecord
from .server import ConnectServer

__all__ = ["ConnectWorker", "ConnectServer", "SourceConnector",
           "SinkConnector", "SourceRecord", "FileStreamSource",
           "DocumentStoreSink", "ObjectStoreSink", "HoistFieldKey"]
