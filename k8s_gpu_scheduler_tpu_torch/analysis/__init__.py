"""graftcheck for the port — static and dynamic analysis of
``k8s_gpu_scheduler_tpu_torch``, the counterpart of the JAX package's
``analysis/`` (``python -m k8s_gpu_scheduler_tpu_torch.analysis``).

Fast passes (AST only, no card; ``run_fast_passes``, the tier-1 clean
gate tests/test_torch_graftcheck_clean.py):

1. **AST lint** (``astlint``): the dispatch-body rules
   (``host-sync-in-dispatch``, ``host-time-in-dispatch``,
   ``numpy-in-dispatch``) over the registered dispatch bodies
   (``entrypoints.DISPATCH_BODIES``), the repo-wide ``host-sync``, and the
   JAX package's ``bare-except`` and ``lock-guard``.
2. **Retry-lint** (``retrylint``, inside the AST pass):
   ``unbounded-retry`` and ``blocking-io-under-lock``, copied.
3. **Trace-lint** (``tracelint``, inside the AST pass):
   ``trace-in-dispatch``.
4. **Lock-order & in-place-buffer audit** (``lockorder``): ``lock-cycle``
   and ``torn-snapshot`` copied; ``read-of-inplace-buffer`` in place of
   ``use-after-donate``. The suppression-policy lint ``bare-suppression``
   (``findings``) rides the AST pass.
5. **Determinism lint** (``determinism``): ``unseeded-rng``,
   ``builtin-hash``, ``unordered-iteration``, ``wall-clock-decision``
   over ``DETERMINISM_SCOPE``, copied.
6. **Shared-memory budgeter** (``smem``): ``smem-budget`` and
   ``kernel-shape-unsupported`` for every kernel instantiation a preset
   reaches (the counterpart of the VMEM budgeter).

Dynamic passes (``run_dynamic_passes``; the device is explicit):

7. **Shared-page audit** (``alias``): the copy-on-write rule over the
   dispatches that run with shared prefix pages mounted.
8. **Steady-state audit** (``steady``): storage kept, no rebuild, no
   repeated first-use configuration, no allocation growth over steady
   dispatches (the recompile guard's and donation audit's counterpart).
9. **Wire-format audit** (``wirecompat``): the port's snapshot, replica
   summary and journal against the JAX package's goldens.
10. **Op audit** (``opaudit``, over the op recorder ``oprecord``): the
    jaxpr audit's counterpart — ``f32-upcast``, ``host-transfer``,
    ``dead-output``, and ``per-call-upload`` for ``captured-const``.
11. **Traffic audit** (``traffic``): each serving dispatch's allocations,
    costed symbolically in the pool geometry, against its contract —
    ``traffic-contract``, ``dense-materialization``, ``peak-residency``.
12. **Sharding audit** (``gspmd``): each rank's real tensors against
    ``parallel/sharding.py`` — ``cache-spec-mismatch``/``-missing``,
    ``island-pool-spec``, ``island-missing``, ``island-weight-spec``,
    ``oversized-replicated``, ``unknown-mesh-axis``.

The multi-rank entries (the sharding audit, the tp traffic rows and
steady states, the pipeline's op audit, and a hook's sharding entries
and ``world=2`` op and traffic entries) run on one spawned world of two
gloo ranks (``world``).

Hooks: a module under the analysed paths that assigns
``GRAFTCHECK_TORCH_SMEM_AUDIT``, ``GRAFTCHECK_TORCH_ALIAS_AUDIT``,
``GRAFTCHECK_TORCH_STEADY_AUDIT``, ``GRAFTCHECK_TORCH_OP_AUDIT``,
``GRAFTCHECK_TORCH_TRAFFIC_AUDIT`` or ``GRAFTCHECK_TORCH_GSPMD_AUDIT`` at
top level is imported and its entries audited (the seeded fixtures in
tests/data/graftcheck_torch/).
A module that imports ``jax`` or the JAX
package is never executed: its hook is a ``hook-error`` finding.

Suppression: ``# graftcheck: ignore[rule]`` on the offending line, with a
rationale in the same comment or the comment-only line above (policy in
README, "graftcheck for the port"; enforced by ``bare-suppression``).
"""
from __future__ import annotations

import os
import re
import time

from .findings import (
    ALL_RULES, Finding, Report, lint_suppressions, parse_suppressions,
    suppression_catalogue,
)
from .astlint import lint_source
from .determinism import (
    DETERMINISM_SCOPE, in_determinism_scope, lint_determinism_source,
)
from .lockorder import lint_lockorder_source
from .retrylint import lint_retry
from .smem import audit_smem
from .tracelint import lint_trace_calls
from .wirecompat import (
    WIRE_ARTIFACTS, default_schema_dir, diff_schemas, extract_schemas,
    load_golden,
)

__all__ = [
    "ALL_RULES", "DETERMINISM_SCOPE", "Finding", "Report", "WIRE_ARTIFACTS",
    "audit_smem", "default_schema_dir", "diff_schemas", "extract_schemas",
    "in_determinism_scope", "lint_determinism_source",
    "lint_lockorder_source", "lint_retry", "lint_source",
    "lint_suppressions", "lint_trace_calls", "load_golden",
    "package_root", "parse_suppressions", "run_dynamic_passes",
    "run_fast_passes", "run_wirecompat_pass", "suppression_catalogue",
]

# Hook discovery never executes a module that imports jax or the JAX
# package: the JAX package's own fixtures live beside the port's, and the
# card's machine has no JAX.
_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|k8s_gpu_scheduler_tpu)(\.|\s|$)", re.M)


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _covers_package(paths) -> bool:
    """True when ``paths`` hold the port's package directory (the
    registries' scenarios run only then)."""
    root = os.path.realpath(package_root())
    return any(os.path.realpath(p) == root
               or root.startswith(os.path.realpath(p) + os.sep)
               for p in paths)


def run_fast_passes(paths=None) -> Report:
    """AST lint + lock-order + determinism lint + shared-memory budgeter —
    no tensor work, suitable for collection-time gating. ``paths`` defaults to
    the port's package directory; the budgeter's presets run when the
    package is among them, and ``GRAFTCHECK_TORCH_SMEM_AUDIT`` hooks
    under ``paths`` are checked too."""
    import ast

    from .astlint import iter_python_files
    from .smem import KernelEntry, audit_preset, check_resources, \
        entry_resources

    report = Report()
    paths = [package_root()] if paths is None else list(paths)
    t0 = time.perf_counter()
    lock_s = det_s = 0.0
    # One read and ONE ast.parse per file, shared by the three AST passes.
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            tree = None     # lint_source re-parses and reports the error
        report.extend(lint_source(path, source, tree=tree))
        if tree is not None:
            t1 = time.perf_counter()
            report.extend(lint_lockorder_source(path, source, tree=tree))
            lock_s += time.perf_counter() - t1
            t1 = time.perf_counter()
            report.extend(lint_determinism_source(path, source, tree=tree))
            det_s += time.perf_counter() - t1
    report.pass_seconds["astlint"] = time.perf_counter() - t0 - lock_s \
        - det_s
    report.pass_seconds["lockorder"] = lock_s
    report.pass_seconds["determinism"] = det_s
    t0 = time.perf_counter()
    if _covers_package(paths):
        report.extend(audit_smem())
    for src, attr, entries in _discover_hooks(
            paths, ("GRAFTCHECK_TORCH_SMEM_AUDIT",)):
        for name, item in _safe_entries(report, src, attr, entries):
            if isinstance(item, KernelEntry):
                report.extend(check_resources(
                    f"{name}: {item.label}", entry_resources(item), src))
            else:
                report.extend(audit_preset(item, anchor=src))
    report.pass_seconds["smem"] = time.perf_counter() - t0
    return report


def run_wirecompat_pass(paths=None) -> Report:
    """The port's wire artifacts against the JAX package's goldens (read
    only), when the port's package is among ``paths`` (the default)."""
    report = Report()
    paths = [package_root()] if paths is None else list(paths)
    t0 = time.perf_counter()
    if _covers_package(paths):
        for name, schema in extract_schemas(report).items():
            report.extend(diff_schemas(name, schema, load_golden(name),
                                       anchor=f"<wire:{name}>"))
    report.pass_seconds["wirecompat"] = time.perf_counter() - t0
    return report


def run_dynamic_passes(paths=None, device="cuda") -> Report:
    """Shared-page, steady-state, op, traffic, sharding and wire-format
    audits on ``device`` (explicit: ``"cuda"`` raises without a card).
    The registries' entries run when the port's package is among
    ``paths`` (the default); the ``GRAFTCHECK_TORCH_*_AUDIT`` hooks under
    ``paths`` run too. Every multi-rank entry, a hook's too, runs on one
    spawned world of two ranks (``world.py``)."""
    import torch

    from . import entrypoints as eps
    from .alias import audit_shared_pages
    from .gspmd import GspmdEntry
    from .opaudit import OpEntry, audit_entry
    from .steady import audit_steady_state
    from .traffic import TrafficEntry, run_traffic_entry
    from .world import run_world, world_jobs

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the dynamic passes run on the card (device='cuda') and no CUDA "
            "device is visible; pass device='cpu' (--device cpu) to run "
            "them on the CPU's plain versions")
    report = Report()
    paths = [package_root()] if paths is None else list(paths)
    ours = _covers_package(paths)
    hooks = list(_discover_hooks(paths, _DYNAMIC_HOOKS))

    def hook_entries(attr, kind):
        for src, hook, entries in hooks:
            if hook != attr:
                continue
            for name, item in _safe_entries(report, src, hook, entries):
                if kind is not None and not isinstance(item, kind):
                    report.extend([Finding(
                        "hook-error", src, 0,
                        f"{attr}[{name!r}]: expected a {kind.__name__}, got "
                        f"{type(item).__name__}")])
                    continue
                yield src, name, item

    for attr, registry, audit, key in (
            ("GRAFTCHECK_TORCH_ALIAS_AUDIT", eps.alias_scenarios,
             audit_shared_pages, "alias"),
            ("GRAFTCHECK_TORCH_STEADY_AUDIT", eps.steady_scenarios,
             audit_steady_state, "steady")):
        t0 = time.perf_counter()
        for name, build in registry() if ours else ():
            report.extend(audit(build, name, dev))
        for _, name, build in hook_entries(attr, None):
            report.extend(audit(build, name, dev))
        report.pass_seconds[key] = time.perf_counter() - t0

    # The multi-rank entries, the registry's and the hooks', go to the
    # world (world.py); the rest run here.
    jobs = world_jobs() if ours else []
    t0 = time.perf_counter()
    ops = [("", n, e) for n, e in eps.op_entrypoints()] if ours else []
    for src, name, entry in ops + list(hook_entries(
            "GRAFTCHECK_TORCH_OP_AUDIT", OpEntry)):
        if entry.world == 1:
            report.extend(audit_entry(entry, name, dev)[0])
        elif src:
            jobs.append(("ops", name, src))
    report.pass_seconds["opaudit"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = [("", n, e) for n, e in eps.traffic_entrypoints()] if ours else []
    for src, name, entry in rows + list(hook_entries(
            "GRAFTCHECK_TORCH_TRAFFIC_AUDIT", TrafficEntry)):
        if entry.world > 1:
            if src:
                jobs.append(("traffic", name, src))
            continue
        found, stats = run_traffic_entry(entry, name, dev)
        report.extend(found)
        if "refused" in stats:
            report.notes.append(f"{name}: refused by the port — "
                                f"{stats['refused'][:120]}")
    report.pass_seconds["traffic"] = time.perf_counter() - t0

    report.pass_seconds["gspmd"] = 0.0
    jobs += [("gspmd", name, src) for src, name, _ in hook_entries(
        "GRAFTCHECK_TORCH_GSPMD_AUDIT", GspmdEntry)]
    if jobs:
        results, wall = run_world(dev.type, jobs)
        keys = {"ops": "opaudit", "traffic": "traffic", "gspmd": "gspmd",
                "steady": "steady"}
        for (kind, name), (found, stats, secs) in results.items():
            report.extend(found)
            report.pass_seconds[keys[kind]] += secs
            report.stats[f"{kind}:{name}"] = stats
            if "refused" in stats.get(0, {}):
                report.notes.append(f"{name}: refused by the port — "
                                    f"{stats[0]['refused'][:120]}")
        report.pass_seconds["world"] = wall
    wire = run_wirecompat_pass(paths)
    report.findings.extend(wire.findings)
    report.pass_seconds.update(wire.pass_seconds)
    return report


_DYNAMIC_HOOKS = ("GRAFTCHECK_TORCH_ALIAS_AUDIT",
                  "GRAFTCHECK_TORCH_STEADY_AUDIT", "GRAFTCHECK_TORCH_OP_AUDIT",
                  "GRAFTCHECK_TORCH_TRAFFIC_AUDIT",
                  "GRAFTCHECK_TORCH_GSPMD_AUDIT")


def _safe_entries(report: Report, src: str, attr: str, entries):
    """Yield well-formed ``(name, item)`` hook entries; malformed ones
    (not a pair) and import failures become findings instead of crashing
    the run — a broken hook must surface, not take the lint down with
    it."""
    if isinstance(entries, Exception):
        report.extend([Finding("hook-error", src, 0,
                               f"{attr}: {type(entries).__name__}: "
                               f"{entries}")])
        return
    for i, entry in enumerate(entries):
        if not isinstance(entry, (tuple, list)) or len(entry) != 2:
            report.extend([Finding(
                "hook-error", src, 0,
                f"{attr}[{i}]: expected a (name, item) pair, got "
                f"{type(entry).__name__}")])
            continue
        yield entry


def _discover_hooks(paths, attrs: tuple):
    """Find modules under ``paths`` whose top level assigns any of the
    hook ``attrs``, import each such module ONCE, and yield ``(path, attr,
    entries)`` per attr it defines — ``entries`` is the registered list,
    or the Exception if the import failed or was refused (a module that
    imports jax or the JAX package is never executed)."""
    import ast
    import importlib.util
    import zlib

    from .astlint import iter_python_files

    for path in iter_python_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                src = fh.read()
            present = [a for a in attrs if a in src]
            if not present:
                continue
            tree = ast.parse(src)
            assigned = [a for a in present if any(
                getattr(t, "id", None) == a for n in tree.body
                for t in (n.targets if isinstance(n, ast.Assign) else
                          [n.target] if isinstance(n, ast.AnnAssign)
                          else []))]
            if not assigned:
                continue
            if _JAX_IMPORT.search(src):
                raise ImportError(
                    "refused: the module imports jax or the JAX package, "
                    "which the port's discovery never executes")
            spec = importlib.util.spec_from_file_location(
                f"_graftcheck_torch_hook_{zlib.crc32(path.encode()):08x}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception as e:  # noqa: BLE001 — a broken hook is a finding
            yield path, attrs[0], e
            continue
        for attr in assigned:
            yield path, attr, list(getattr(mod, attr, []))
