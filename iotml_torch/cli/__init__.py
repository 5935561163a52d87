"""Reference-contract CLIs (``iotml.cli``): ``cardata`` so far."""
