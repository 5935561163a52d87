"""The KSQL stage (``iotml.streamproc``): the continuous tasks
(``tasks``), the dead-letter queue (``dlq``), the SQL dialect and its
engine (``sql``) and the KSQL REST server (``server``)."""

from .tasks import JsonToAvro, RekeyByCar, TumblingCounter, StreamTask  # noqa: F401
from .sql import (SqlEngine, SqlError, REFERENCE_PIPELINE_DDL,  # noqa: F401
                  install_reference_pipeline)
from .server import KsqlServer  # noqa: F401
