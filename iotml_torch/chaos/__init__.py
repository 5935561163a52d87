"""Chaos (``iotml.chaos``): the fault points and their engine (``faults``),
the seeded fault schedules (``scenarios``, ``python -m iotml_torch.chaos
schedule``) and the invariant verdicts the drills use (``runner``); the
scenario runner and its topologies are ROADMAP A14."""
