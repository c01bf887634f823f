"""The share of a round in which no operation runs on the device, in %:
1 - (the union of the device's busy intervals in a round of the
device-only trace / the untraced window's seconds a round).  The traced
rounds' own wall time is not the base: recording every launch slows the
host, and with it the rounds (by about half at B = 2 on the H100)."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s <= 0 or not rec.rounds:
        return None
    busy = rec.trace.busy_s / rec.trace_rounds
    return 100.0 * (1.0 - busy / (rec.window_s / rec.rounds))
