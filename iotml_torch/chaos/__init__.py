"""Chaos (``iotml.chaos``): only the invariant verdicts the online drill
uses are ported (``runner``); the fault engine, the schedules and the
scenario runner are ROADMAP A14."""
