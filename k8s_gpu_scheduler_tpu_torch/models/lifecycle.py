"""Serving preemption lifecycle: SIGTERM → drain → persist → resume (port
of the JAX package's ``models/lifecycle.py``).

A serve loop installs :class:`PreemptionGuard`, checks it between waves,
and on a request drains the engine to a directory on the pod's volume
(:func:`drain_to_checkpoint`); the replacement process calls
:func:`resume_or_fresh` and every interrupted stream resumes where it
stopped. A ``testing.faults.Preempted`` injection drives the same helpers
in tests, with no signal. The fleet router persists its request journal
the same way (``persist_journal``/``load_journal``).

Persistence is the port's own: ``snap.to_pytree()`` (a dict of numpy
arrays) is written as one ``.npz`` (``allow_pickle=False``) into a step
directory ``<directory>/<step>/``, through a temporary file and
``os.replace``. Each persist writes the step after the latest one and then
removes the older steps, so one snapshot is kept and a second preemption
of the same pod lineage never collides with the first.
"""
from __future__ import annotations

import logging
import os
import shutil
import signal
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .snapshot import ServingSnapshot

log = logging.getLogger(__name__)

SNAPSHOT_STEP = 0          # the first step of a directory's lineage
_FILE = "snapshot.npz"


class PreemptionGuard:
    """SIGTERM-to-drain bridge for a serve loop. The handler only sets an
    event: the loop polls ``requested`` at its wave boundary and drains
    there, never from inside a step. ``request()`` is the programmatic
    trigger."""

    def __init__(self, signum: int = signal.SIGTERM) -> None:
        self._event = threading.Event()
        self._signum = signum
        self._prev = None
        self._installed = False

    def install(self) -> "PreemptionGuard":
        """Register the handler (main thread only) and keep the previous
        one for ``uninstall``."""
        self._prev = signal.signal(self._signum, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(self._signum, self._prev or signal.SIG_DFL)
            self._installed = False

    def _on_signal(self, signum, frame) -> None:
        self._event.set()

    def request(self) -> None:
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()


def _steps(directory: str) -> list:
    """The step directories under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isfile(
                      os.path.join(directory, d, _FILE)))


def _persist_pytree(tree: Dict[str, np.ndarray], directory: str) -> int:
    """Write ``tree`` as ``<directory>/<step>/snapshot.npz``, the step one
    past the latest, then remove the older steps; returns the step. The
    file lands through a temporary name and ``os.replace``, so a reader
    never sees half a snapshot."""
    steps = _steps(directory)
    step = SNAPSHOT_STEP if not steps else steps[-1] + 1
    step_dir = os.path.join(directory, str(step))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, _FILE + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **tree)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, os.path.join(step_dir, _FILE))
    for old in steps:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
    return step


def _load_pytree(directory: str) -> Optional[Dict[str, np.ndarray]]:
    """The latest persisted dict under ``directory``, or None."""
    steps = _steps(directory)
    if not steps:
        return None
    path = os.path.join(directory, str(steps[-1]), _FILE)
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def persist_snapshot(snap: ServingSnapshot, directory: str) -> None:
    """Write a drained snapshot under ``directory``."""
    _persist_pytree(snap.to_pytree(), directory)


def drain_to_checkpoint(engine, directory: str) -> ServingSnapshot:
    """The SIGTERM handler's action: drain the engine (admission stops,
    every referenced page is gathered to the host) and persist the
    snapshot. Returns it so the caller can log what was saved."""
    snap = engine.drain()
    persist_snapshot(snap, directory)
    log.info("drained %d in-flight request(s) to %s",
             snap.n_requests_in_flight, directory)
    return snap


def load_snapshot(directory: str) -> Optional[ServingSnapshot]:
    """Latest persisted serving snapshot under ``directory``, or None
    when there is none (first boot)."""
    tree = _load_pytree(directory)
    return None if tree is None else ServingSnapshot.from_pytree(tree)


def persist_journal(journal, directory: str) -> None:
    """Persist a fleet request journal (``fleet/journal.py``
    ``RequestJournal``) the same way: the snapshot carries a replica's KV
    state for cooperative recovery, the journal the router's delivery
    record for recovery after a crash that never drained. Keep the two in
    distinct directories (each is its own step lineage)."""
    _persist_pytree(journal.to_pytree(), directory)


def load_journal(directory: str):
    """Latest persisted request journal under ``directory``, or None
    when there is none (a fresh router)."""
    from ..fleet.journal import RequestJournal

    tree = _load_pytree(directory)
    return None if tree is None else RequestJournal.from_pytree(tree)


def resume_or_fresh(make_engine: Callable[[], object],
                    directory: Optional[str]) -> Tuple[object, int]:
    """Build a fresh engine and, when ``directory`` holds a snapshot,
    restore it: every interrupted stream resumes, with the downtime
    charged to the latency records. Returns ``(engine, resumed request
    count)``."""
    eng = make_engine()
    if not directory:
        return eng, 0
    snap = load_snapshot(directory)
    if snap is None:
        return eng, 0
    resumed = eng.restore(snap)
    log.info("resumed %d serving request(s) from %s", resumed, directory)
    return eng, resumed
