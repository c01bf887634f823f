"""Model operations of the window's retrieves over the window's seconds and
the card's dense matmul peak in the configuration's dtype, in % (host clock;
see ``harness/work.py``)."""
from gpubench.harness.work import peak_flops


def read(rec):
    if not rec.rounds or not rec.passes:
        return None
    flops = sum(p.flops for p in rec.passes) * rec.rounds
    return 100.0 * flops / rec.window_s / peak_flops(rec.cfg["model"])
