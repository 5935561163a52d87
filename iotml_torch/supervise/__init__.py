"""Supervision (``iotml.supervise``): the supervisor (``supervisor``:
loop and probed units, heartbeats, wedge detection, restarts under
backoff within a restart-storm budget), ``topology.Topology``, the cell
the model registry publishes its serving flips through,
``drill.DrillReport`` with the drill helpers the alert-burn drill uses,
and ``registry``, the process-wide registry of background threads and
supervisors.  ``Platform.supervised()`` and the live leader-kill,
scorer-crash and broker-restart drills are ROADMAP A14."""
