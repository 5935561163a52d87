"""Supervision (``iotml.supervise``): only ``topology.Topology`` is ported,
the cell the model registry publishes its serving flips through.  The
supervisor and its thread registry are ROADMAP A14."""
