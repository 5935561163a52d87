"""Chaos (``iotml.chaos``): the fault points and their engine (``faults``),
the seeded fault schedules (``scenarios``, ``python -m iotml_torch.chaos
schedule``) and the scenario runner with its invariant verdicts
(``runner``; its ``cluster`` topology, ``python -m iotml_torch.chaos run
--scenario rebalance-under-chaos``).  The runner's other topologies are
ROADMAP A14."""
