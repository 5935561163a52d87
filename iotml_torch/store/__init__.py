"""Storage helpers (``iotml.store``): only ``segment.fsync_dir`` is ported."""
