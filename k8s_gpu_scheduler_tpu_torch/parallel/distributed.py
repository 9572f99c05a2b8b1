"""Multi-process bootstrap (port of the JAX package's
``parallel/distributed.py``), and a spawner of local worlds.

Gang PostBind (the scheduler's gang plugin) writes three env vars through
each member's EnvFrom ConfigMap:

  TPU_WORKER_HOSTNAMES  comma-separated pod-reachable addresses, worker order
  TPU_WORKER_ID         this member's index in that list
  TPU_WORKER_COUNT      gang size

``distributed_init_from_env`` turns them into a ``torch.distributed``
rendezvous: worker 0's address is the store. The backend is always the
caller's explicit choice ("nccl" across cards, "gloo" on the host): there
is no "nccl if available" guess.

``spawn`` starts a world of N local processes that meet through a
``file://`` rendezvous, so concurrent worlds (parallel test workers)
never compete for a port, and kills the whole world when one rank fails
or the world outlives its timeout.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Mapping, Optional, Sequence

COORDINATOR_PORT = 8476


def worker_addresses(env: Optional[Mapping[str, str]] = None) -> list:
    src = os.environ if env is None else env
    return [h for h in src.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]


def self_worker_id(
    addresses: list, env: Optional[Mapping[str, str]] = None
) -> Optional[int]:
    """This worker's index in the gang address list, derived from its OWN
    identity: the entry whose first DNS label equals this pod's hostname
    ($HOSTNAME == pod name inside the container).

    This is the authoritative id for gangs whose members share one EnvFrom
    ConfigMap: each member's PostBind writes its scalar TPU_WORKER_ID into
    the SAME map, so the last write wins and every worker would read an
    identical id — a guaranteed rendezvous deadlock. The address list is
    identical across members by construction, so matching ourselves
    against it is race-free. Returns None when no entry matches (plain-pod
    gangs injected with node addresses)."""
    src = os.environ if env is None else env
    hostname = src.get("HOSTNAME", "")
    if not hostname:
        return None
    for i, addr in enumerate(addresses):
        if addr == hostname or addr.split(".", 1)[0] == hostname:
            return i
    return None


def distributed_init_from_env(
    env: Optional[Mapping[str, str]] = None, *, backend: str,
    coordinator_port: Optional[int] = None, local_rank: int = 0,
    local_size: int = 1, **init_kwargs,
) -> bool:
    """Initialize the default ``torch.distributed`` process group of
    ``backend`` from the gang env. Returns True iff a multi-rank
    rendezvous was performed (a single-worker pod of one rank returns
    False and stays single-process). Extra kwargs pass through to
    ``init_process_group`` (``timeout``, ``device_id``).

    Each worker runs ``local_size`` ranks (one a card, where JAX ran one
    process over every local chip); this one is its ``local_rank``, so
    the world is workers × ``local_size`` ranks and this rank's global
    rank ``worker id × local_size + local_rank``. The store is worker 0's
    address (``localhost`` for a worker alone) at ``coordinator_port``
    (default ``COORDINATOR_PORT``).

    Worker id preference: self-derived from $HOSTNAME vs the address list
    (shared-ConfigMap-safe — see self_worker_id), then the injected
    TPU_WORKER_ID scalar (per-pod-ConfigMap gangs, hostNetwork gangs)."""
    src = os.environ if env is None else env
    addresses = worker_addresses(src)
    if len(addresses) <= 1 and local_size == 1:
        return False
    worker_id = self_worker_id(addresses, src) if addresses else 0
    if worker_id is None:
        worker_id = int(src.get("TPU_WORKER_ID", "0") or 0)
    count = int(src.get("TPU_WORKER_COUNT", "") or max(1, len(addresses)))
    host = addresses[0] if addresses else "localhost"
    port = COORDINATOR_PORT if coordinator_port is None else coordinator_port
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=f"tcp://{host}:{port}",
        world_size=count * local_size,
        rank=worker_id * local_size + local_rank, **init_kwargs)
    return True


class WorldError(RuntimeError):
    """A spawned world failed: ``failures`` maps each failed rank to its
    traceback (or to how its process ended)."""

    def __init__(self, failures: dict):
        self.failures = dict(failures)
        text = "\n".join(f"--- rank {r} ---\n{tb}"
                         for r, tb in sorted(self.failures.items()))
        super().__init__(f"rank(s) {sorted(self.failures)} failed:\n{text}")


def _rank_main(fn, rank: int, world: int, backend: str, path: str,
               args: tuple, results, group_timeout: float) -> None:
    import torch.distributed as dist

    ok, out = False, None
    try:
        if backend is not None:
            dist.init_process_group(
                backend, init_method=f"file://{path}", rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=group_timeout))
        out = fn(rank, world, *args)
        ok = True
    except BaseException:  # noqa: BLE001 — reported to the parent, re-raised as WorldError
        out = traceback.format_exc()
    results.put((rank, ok, out))
    results.close()
    results.join_thread()
    if ok and dist.is_initialized():
        dist.destroy_process_group()
    else:
        # A failed rank leaves at once: its closed connections make the
        # peers' pending collectives raise instead of waiting.
        os._exit(1)


def spawn(fn: Callable, world_size: int, backend: Optional[str],
          args: Sequence = (), rendezvous: Optional[str] = None,
          timeout: float = 300.0, group_timeout: float = 120.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes (``spawn`` start method), each a rank of a ``backend``
    process group that meets through the file ``rendezvous`` (a path that
    must not exist yet; default: one in a new temporary directory);
    with ``backend`` None the ranks start with no group and ``fn`` joins
    one itself.
    ``fn`` and ``args`` are pickled, so ``fn`` is a module-level function
    of a module every rank can import. Returns the ranks' return values
    in rank order.

    Raises ``WorldError`` with every failed rank's traceback when a rank
    raises or dies (the other ranks are killed once they have had
    ``group_timeout`` seconds to fail on their own), and kills every rank
    and raises ``TimeoutError`` when the world is not done after
    ``timeout`` seconds."""
    import multiprocessing as mp

    if rendezvous is None:
        rendezvous = os.path.join(tempfile.mkdtemp(prefix="world-"), "rdv")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, rendezvous,
                               tuple(args), results, group_timeout))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    failures: dict = {}

    def record(item):
        rank, ok, val = item
        (out if ok else failures)[rank] = val

    deadline = time.monotonic() + timeout
    fail_deadline = None
    finished = False
    try:
        while len(out) + len(failures) < world_size:
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(
                    f"world of {world_size} not done after {timeout} s "
                    f"(ranks done: {sorted(out)}, failed: "
                    f"{sorted(failures)})")
            if fail_deadline is not None and now > fail_deadline:
                for r in range(world_size):
                    if r not in out and r not in failures:
                        failures[r] = "killed: a peer rank had failed"
                break
            try:
                record(results.get(timeout=0.2))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and r not in failures
                        and p.exitcode is not None]
                if dead:
                    # A rank flushes its report before it exits: read
                    # what is in the pipe before calling it lost.
                    try:
                        while True:
                            record(results.get(timeout=0.5))
                    except queue_mod.Empty:
                        pass
                    for r in dead:
                        if r not in out and r not in failures:
                            failures[r] = (f"exited with code "
                                           f"{procs[r].exitcode}")
            if failures and fail_deadline is None:
                fail_deadline = time.monotonic() + group_timeout
        finished = not failures
    finally:
        for p in procs:
            # A world that finished has ranks leaving on their own; any
            # other is killed at once.
            p.join(timeout=5.0 if finished else 0.5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
    if failures:
        raise WorldError(failures)
    return [out[r] for r in range(world_size)]
