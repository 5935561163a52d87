"""The port's stream layer (``iotml.stream``): the in-process broker, its
consumers, producer, group coordinator, the Kafka wire protocol, the
native engines, the schema registry and its REST server, and the CSV
replay source."""

from .broker import Broker, TopicSpec, Message  # noqa: F401
from .consumer import StreamConsumer, parse_spec  # noqa: F401
from .producer import OutputSequence  # noqa: F401
from .csv_source import replay_csv  # noqa: F401
from .group import GroupCoordinator, GroupConsumer  # noqa: F401
from .registry import SchemaRegistry, RegisteredSchema, parse_avsc  # noqa: F401
from .registry_server import SchemaRegistryServer  # noqa: F401
