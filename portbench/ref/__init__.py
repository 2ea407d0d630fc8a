"""Frozen copies of the port's transmitter, crypto and decoders, and the
plain float64 reference of the verify (``verify.py``), which imports
nothing of the program."""
