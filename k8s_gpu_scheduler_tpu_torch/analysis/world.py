"""The multi-rank graftcheck entries on one spawned world of two ranks.

The tp traffic rows, the sharding audit, the tp steady states and the
pipeline's op audit each need a process group, and so may a hook's
multi-rank entry (a ``GspmdEntry``, or an ``OpEntry``/``TrafficEntry``
with ``world=2``): one ``parallel.spawn`` of two gloo ranks runs them
all, in one order on both ranks (their collectives pair up), on the CPU
or on card 0 (both ranks share it, as chip_smoke's tp phases do). A job
is ``(pass, name, src)``: ``src`` is "" for a registry entry, else the
hook module's path, which each rank imports. Each rank returns its
findings and stats per job; ``run_world`` merges the ranks' findings (one
finding for a message both ranks give) and sums each pass's seconds from
rank 0.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

from .findings import Finding

WORLD = 2
HOOKS = {"ops": "GRAFTCHECK_TORCH_OP_AUDIT",
         "traffic": "GRAFTCHECK_TORCH_TRAFFIC_AUDIT",
         "gspmd": "GRAFTCHECK_TORCH_GSPMD_AUDIT"}


def check_world(world: int) -> None:
    """An entry runs on one process (1) or on the world of two."""
    if world not in (1, WORLD):
        raise ValueError(f"world={world}: an entry runs on 1 process or on "
                         f"the spawned world of {WORLD}")


def world_jobs() -> List[Tuple[str, str, str]]:
    """(pass, name, "") of every registry entry that runs on the world."""
    from . import entrypoints as eps

    return ([("ops", n, "") for n, e in eps.op_entrypoints() if e.world > 1]
            + [("traffic", n, "") for n, e in eps.traffic_entrypoints()
               if e.world > 1]
            + [("gspmd", n, "") for n, _ in eps.gspmd_entrypoints()]
            + [("steady", n, "") for n, _ in eps.tp_steady_scenarios()])


def _entry(kind: str, name: str, src: str):
    """The entry a job names: the registry's, or the hook module's at
    ``src`` (imported here, in the rank)."""
    from . import _discover_hooks
    from . import entrypoints as eps

    if src:
        for _, _, entries in _discover_hooks([src], (HOOKS[kind],)):
            if isinstance(entries, Exception):
                raise entries
            return dict(entries)[name]
        raise LookupError(f"{src} no longer defines {HOOKS[kind]}")
    if kind == "traffic":
        import dataclasses

        # "entry@row": the entry audited under another row's contract.
        entry_name, _, row = name.partition("@")
        entry = dict(eps.traffic_entrypoints())[entry_name]
        return dataclasses.replace(
            entry, contract=eps.traffic_contracts()[row]) if row else entry
    return dict({"ops": eps.op_entrypoints, "gspmd": eps.gspmd_entrypoints,
                 "steady": eps.tp_steady_scenarios}[kind]())[name]


def _run_job(kind: str, name: str, src: str, dev, rank: int, world: int):
    entry = _entry(kind, name, src)
    if kind == "ops":
        from .opaudit import audit_entry

        found, recs = audit_entry(entry, name, dev)
        return found, {"ops": [len(r.ops) for r in recs],
                       "launched": recs[0].launched() if recs else {},
                       "uploads": [(t.via, t.nbytes, t.site)
                                   for t in recs[0].uploads()] if recs
                       else []}
    if kind == "traffic":
        from .traffic import run_traffic_entry

        return run_traffic_entry(entry, name, dev, rank, world)
    if kind == "gspmd":
        from .gspmd import run_gspmd_entry

        return run_gspmd_entry(entry, name, dev, rank, world)
    from .steady import run_steady

    found, st = run_steady(entry, name, dev)
    return found, {k: st[k] for k in ("tracked", "launches", "allocated")}


def rank_main(rank: int, world: int, device_type: str, jobs: list) -> list:
    """One rank: every job in order → [(pass, name, findings, stats,
    seconds)]."""
    import torch

    if device_type == "cuda":
        from ..ops import _build

        torch.cuda.set_device(0)
        _build.load_library()
        dev = torch.device("cuda", 0)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    out = []
    for kind, name, src in jobs:
        t0 = time.perf_counter()
        try:
            found, stats = _run_job(kind, name, src, dev, rank, world)
        except Exception as e:  # noqa: BLE001 — report, keep auditing
            found, stats = [Finding(
                f"{kind}-world-error", f"<{kind}:{name}>", 0,
                f"{name} failed on rank {rank}: {type(e).__name__}: "
                f"{str(e)[:300]}")], {}
        out.append((kind, name, found, stats, time.perf_counter() - t0))
    return out


def _merge(per_rank: List[list]) -> Dict[Tuple[str, str], tuple]:
    merged: Dict[Tuple[str, str], tuple] = {}
    for rank, results in enumerate(per_rank):
        for kind, name, found, stats, secs in results:
            got = merged.setdefault((kind, name), ([], {}, 0.0))
            for f in found:
                msg = f.message if "(rank " in f.message \
                    else f"rank {rank}: {f.message}"
                twin = next((g for g in got[0] if g.rule == f.rule
                             and g.message.split(": ", 1)[-1]
                             == f.message), None)
                if twin is None:
                    got[0].append(Finding(f.rule, f.path, f.line, msg,
                                          f.severity))
            got[1][rank] = stats
            if rank == 0:
                merged[(kind, name)] = (got[0], got[1], secs)
    return merged


def run_world(device_type: str, jobs=None, timeout: float = 900.0):
    """Run ``jobs`` (default ``world_jobs()``) on a spawned gloo world of
    two: ({(pass, name): (findings, {rank: stats}, rank 0's seconds)},
    the world's wall seconds)."""
    from ..parallel.distributed import spawn

    jobs = world_jobs() if jobs is None else list(jobs)
    t0 = time.perf_counter()
    per_rank = spawn(rank_main, WORLD, "gloo",
                     args=(device_type, jobs), timeout=timeout,
                     group_timeout=120.0)
    return _merge(per_rank), time.perf_counter() - t0
