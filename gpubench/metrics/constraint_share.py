"""The constraint kernels' (``vntk_*``) device time over the device's busy
time in the traced rounds, in % (the paper's overhead ratio)."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s <= 0:
        return None
    s = sum(v for name, v in rec.trace.device_s.items() if "vntk_" in name)
    return 100.0 * s / rec.trace.busy_s if s > 0 else None
