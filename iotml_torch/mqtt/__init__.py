"""MQTT ingestion layer (``iotml.mqtt``'s twin): the broker core, the
wire protocol and its threaded and epoll fronts, the Kafka-extension
bridge, the native ingest front, and the device-simulator scenarios
(reference L1/L2, SURVEY §1)."""

from .broker import MqttBroker, QueueClient  # noqa: F401
from .bridge import KafkaBridge, TopicMapping  # noqa: F401
from .scenario import (EVALUATION_SCENARIO, Scenario, ScenarioRunner,  # noqa: F401
                       parse_scenario)
from .topic_tree import TopicTree, topic_matches  # noqa: F401
from .wire import MqttClient, MqttProtocol, MqttServer  # noqa: F401
from .eventserver import MqttEventServer  # noqa: F401
