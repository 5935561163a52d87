"""Supervision (``iotml.supervise``): ported are ``topology.Topology``,
the cell the model registry publishes its serving flips through, and
``drill.DrillReport``, the online drill's report.  The supervisor, its
thread registry and the live drills are ROADMAP A14."""
