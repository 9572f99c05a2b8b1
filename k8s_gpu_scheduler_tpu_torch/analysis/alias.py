"""Shared-page write audit — the prefix cache's copy-on-write rule with
teeth.

The radix prefix cache (models/prefix_cache.py) lets one physical KV
page back the block tables of many slots at once; correctness rests on a
single invariant: **a shared page is never written**. The engine upholds
it by construction (decode writes at ``lens``, which always points past
the mounted prefix; the tail-prefill scatter receives only the slot's
OWN page ids), but "by construction" is one refactor away from silent KV
cross-contamination — request B's system prompt suddenly holding request
A's decode rows, with no crash.

The JAX package's audit compares the pool a jitted dispatch returns with
the one it was given. The port's dispatches write the pool IN PLACE and
return none, so a scenario names the pool tensors and the shared pages;
the audit snapshots those pages, runs the real dispatch once, and
byte-compares the same tensors. Any difference is a ``shared-page-write``
finding (error severity).

Scenario contract (``build(device, size)`` return value, also the
``GRAFTCHECK_TORCH_ALIAS_AUDIT`` hook protocol — a list of ``(name,
build)`` pairs):

    (fn, pools, shared_pages)

``fn()`` dispatches once; ``pools`` are the tensors it writes in place,
indexed by page on AXIS 1 (the ``[L, n_pages, page_size, ...]`` serving
layout); ``shared_pages`` must be non-empty — a vacuous audit would read
as a clean copy-on-write bill of health while checking nothing
(``alias-guard``).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

from .findings import Finding


def _same_bytes(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def check_shared_pages(fn: Callable[[], object], pools: Sequence,
                       shared: Sequence[int],
                       name: str = "fn") -> List[Finding]:
    """Run ``fn()`` once and verify every declared shared page of every
    pool tensor is byte-identical afterwards."""
    anchor = f"<alias:{name}>"
    shared = sorted(int(p) for p in shared)
    if not shared:
        return [Finding(
            "alias-guard", anchor, 0,
            f"{name}: no shared pages declared — the audit verified "
            f"nothing")]
    pools = [p for p in pools if p is not None]
    if not pools:
        return [Finding("alias-guard", anchor, 0,
                        f"{name}: no pool tensors declared")]
    before = [p[:, shared].clone() for p in pools]
    fn()
    findings: List[Finding] = []
    for i, (pool, snap) in enumerate(zip(pools, before)):
        after = pool[:, shared]
        changed = [p for j, p in enumerate(shared)
                   if not _same_bytes(snap[:, j], after[:, j])]
        if changed:
            findings.append(Finding(
                "shared-page-write", anchor, 0,
                f"{name}: pool tensor {i} {tuple(pool.shape)} WROTE shared "
                f"page(s) {changed} — aliased prefix pages are read-only "
                f"by the copy-on-write contract; a write corrupts every "
                f"slot sharing them"))
    return findings


def audit_shared_pages(build: Callable, name: str, device,
                       size=None) -> List[Finding]:
    """Run one alias scenario from ``build`` (see the module docstring).
    Exceptions become findings so a broken scenario cannot mask the
    others."""
    anchor = f"<alias:{name}>"
    try:
        fn, pools, shared = (build(device) if size is None
                             else build(device, size))
        return check_shared_pages(fn, pools, shared, name=name)
    except Exception as e:  # noqa: BLE001 — report, keep auditing
        return [Finding("alias-guard", anchor, 0,
                        f"scenario {name} failed to run: "
                        f"{type(e).__name__}: {str(e)[:300]}")]
