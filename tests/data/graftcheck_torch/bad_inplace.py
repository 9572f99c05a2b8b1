"""Seeded-bad fixture: a scrape that reads a pool a dispatch writes in
place (``read-of-inplace-buffer``).

``_decode_fn`` (registered through ``GRAFTCHECK_DISPATCH_BODIES``) writes
its ``k``/``v`` arguments in place, so ``self._k``/``self._v`` of
``LeakyEngine`` are in-place buffers; ``scrape`` — a metrics thread's
read, not on the step path and under no lock the step holds — reads
their values while a step may have writes queued.
"""
import threading

import torch

GRAFTCHECK_DISPATCH_BODIES = ("_decode_fn",)


def _decode_fn(k, v, lens, x):
    k[:, lens] = x
    v[:, lens] = x
    return lens + 1


class LeakyEngine:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._k = torch.zeros(4, 8)
        self._v = torch.zeros(4, 8)
        self._lens = torch.zeros((), dtype=torch.long)
        self._steps = 0

    def step(self, x) -> None:
        self._lens = _decode_fn(self._k, self._v, self._lens, x)
        with self._mu:
            self._steps += 1

    def scrape(self) -> dict:
        with self._mu:
            steps = self._steps
        return {"steps": steps,
                "pool_norm": float(self._k.norm())}   # read-of-inplace-buffer
