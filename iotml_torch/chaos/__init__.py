"""Chaos (``iotml.chaos``): the fault points and their engine (``faults``),
the seeded fault schedules (``scenarios``, ``python -m iotml_torch.chaos
schedule``) and the scenario runner with its invariant verdicts
(``runner``, ``python -m iotml_torch.chaos run --scenario S``; the twin
service's ``compaction-under-crash`` is ROADMAP A16)."""
