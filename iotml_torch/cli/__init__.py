"""Reference-contract CLIs (``iotml.cli``): ``cardata``, ``serve``,
``live``, ``creditcard``, ``lstm`` and ``mnist_smoke``."""
