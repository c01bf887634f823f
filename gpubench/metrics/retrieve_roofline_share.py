"""A retrieve's least time on the card (each pass bound by its operations
or its least bytes, ``harness/work.py``) over its mean time in the window,
in %."""
from gpubench.harness.work import least_seconds


def read(rec):
    if not rec.rounds or not rec.passes:
        return None
    least = least_seconds(rec.cfg["model"], rec.passes)
    return 100.0 * least / (rec.window_s / rec.rounds)
