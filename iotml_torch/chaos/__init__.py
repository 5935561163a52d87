"""Chaos (``iotml.chaos``): the fault points and their engine (``faults``)
and the invariant verdicts the online drill uses (``runner``); the
scenario schedules and the scenario runner are ROADMAP A14."""
