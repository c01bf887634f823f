"""The one traffic generator: a traffic file's parameters -> requests.

A traffic file (``gpubench/traffic/<name>.json``) states:

* ``loop``: the file ``gpubench/loops/<loop>.py`` that issues the requests
  in the window (``closed``: one client, ``batch`` requests a round);
* ``batch``: requests a ``serve()`` call at most (the engine's batch);
* ``history_items``: catalog items a history holds (their SIDs, in order);
* ``constraint_ids``: ``null`` (every request under the one set) or
  ``{"dist": "zipf", "s": ...}`` over the configuration's slots in order;
* ``pool``: requests drawn ahead; rounds take them in turn, wrapping;
* ``warmup_rounds``: ``serve()`` calls in set-up;
* ``check_requests``: answered requests the reference re-derives;
* ``trace_rounds``: ``serve()`` calls the profiler records in a
  ``--trace 1`` run.

A loop's further parameters (a rate, bursts) go in the same file; the loop
reads them, and the run's seed, from :class:`Requests`.

Every seed draws the same number of requests of the same sizes; the seed
only picks which items and which slots.
"""
from __future__ import annotations

import numpy as np

from gpubench.harness.data import stream_seed

__all__ = ["Requests", "make_requests", "zipf_ids", "poisson_arrivals"]


class Requests:
    """A pool of requests: ``histories`` (P, S) int32, ``cids`` (P,) int or
    None, with the ``traffic`` file's parameters and the run's ``seed``;
    :meth:`round` hands out the next ``batch``."""

    def __init__(self, histories: np.ndarray, cids, traffic: dict,
                 seed: int):
        self.histories = histories
        self.cids = cids
        self.traffic = traffic
        self.seed = seed
        self.batch = traffic["batch"]
        self._next = 0

    def round(self) -> list:
        """The next round's request indices into the pool."""
        P = self.histories.shape[0]
        idx = [(self._next + i) % P for i in range(self.batch)]
        self._next = (self._next + self.batch) % P
        return idx

    def cid(self, i: int):
        return None if self.cids is None else int(self.cids[i])


def zipf_ids(rng: np.random.Generator, n: int, n_slots: int,
             s: float) -> np.ndarray:
    """``n`` ids in [0, n_slots), P(k) proportional to 1 / (k + 1)^s."""
    p = 1.0 / np.arange(1, n_slots + 1) ** s
    return rng.choice(n_slots, size=n, p=p / p.sum())


def poisson_arrivals(rng: np.random.Generator, rate: float,
                     n: int) -> np.ndarray:
    """Seconds after the start at which ``n`` open-loop requests are due:
    exponential gaps of mean ``1 / rate`` (the JAX harness's load
    generator's schedule), for an open-loop file under ``loops/``."""
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def make_requests(traffic: dict, catalog: np.ndarray, n_slots: int,
                  seed: int) -> Requests:
    """The pool of ``traffic["pool"]`` requests over ``catalog`` (N, L)."""
    rng = np.random.default_rng(stream_seed(seed, "requests"))
    P, items = traffic["pool"], traffic["history_items"]
    idx = rng.integers(0, catalog.shape[0], size=(P, items))
    hist = catalog[idx].reshape(P, -1).astype(np.int32)
    dist = traffic.get("constraint_ids")
    if dist is None:
        cids = None
    elif dist["dist"] == "zipf":
        cids = zipf_ids(rng, P, n_slots, dist["s"])
    else:
        raise ValueError(f"unknown constraint-id distribution {dist!r}")
    return Requests(hist, cids, traffic, seed)
