"""Supervision (``iotml.supervise``): the supervisor (``supervisor``:
loop and probed units, heartbeats, wedge detection, restarts under
backoff within a restart-storm budget), ``topology.Topology`` (the
published (leader, epoch) cell the wire clients resolve and the model
registry publishes its serving flips through), ``drill`` (the live
leader-kill, broker-restart, mqtt-flap and scorer-crash drills,
``python -m iotml_torch.supervise drill``, and the ``DrillReport`` the
other drills use), and ``registry``, the process-wide registry of
background threads and supervisors.  ``Platform.supervised()`` and
``python -m iotml_torch.cli.up --supervise`` run the platform under a
supervisor."""
