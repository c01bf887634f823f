"""The closed loop: one client submits the traffic's ``batch`` requests,
drains them with one ``serve()`` call, and submits the next ``batch`` when
that call returns.  A request's latency runs from its round's submit to that
call's return.
"""
from __future__ import annotations

import time

from gpubench.harness.runner import Window


def window(system, reqs, served: list, *, seconds: float | None = None,
           rounds: int | None = None) -> Window:
    """Serve rounds until ``seconds`` have passed since the window began
    (the round then running ends it) or, given ``rounds``, that many rounds.
    Each answered request is appended to ``served``."""
    w = Window(start=time.perf_counter())
    while True:
        idx = reqs.round()
        cids = [reqs.cid(i) for i in idx]
        t_sub = time.perf_counter()
        out = system.serve(reqs.histories[idx], cids)
        t_done = time.perf_counter()
        w.calls += 1
        w.serve_s += t_done - t_sub
        for pos, (i, o) in enumerate(zip(idx, out)):
            w.attempted += 1
            if o is None:
                w.failed += 1
                continue
            w.latencies_s.append(t_done - t_sub)
            served.append({"history": reqs.histories[i], "cid": cids[pos],
                           "pos": pos, "sids": o["sids"],
                           "scores": o["scores"]})
        w.seconds = t_done - w.start
        if (w.calls >= rounds if rounds is not None
                else w.seconds >= seconds):
            return w
