"""Parallel training (``iotml.parallel``'s twin): the one-device form of
the sequence-parallel SensorFormer step so far."""
