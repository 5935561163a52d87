"""Storage helpers (``iotml.store``): only ``segment.atomic_write`` and
``segment.fsync_dir`` are ported."""
