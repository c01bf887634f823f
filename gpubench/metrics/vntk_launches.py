"""Constraint-kernel launches a retrieve in the window (the port's
``kernels/vntk.py`` ``LAUNCHES`` counters, summed)."""


def read(rec):
    return rec.launches / rec.rounds if rec.rounds and rec.launches else None
