"""Requests answered in the window over the window's seconds (host clock)."""


def read(rec):
    return rec.requests / rec.window_s if rec.window_s > 0 else None
