"""Supervision (``iotml.supervise``): ported are ``topology.Topology``,
the cell the model registry publishes its serving flips through,
``drill.DrillReport``, the online drill's report, and ``registry``, the
process-wide registry of background threads and supervisors that the
REST and KSQL servers register their threads in.  The supervisor itself
and the live drills are ROADMAP A14."""
