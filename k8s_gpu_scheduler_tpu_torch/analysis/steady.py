"""Steady-state audit — the port's counterpart of the JAX package's
recompile guard and donation audit.

JAX proves two things about a steady serving loop: no dispatch retraces,
and every donated buffer is consumed rather than copied. Eager PyTorch
has no trace to repeat (that half becomes the CUDA-graph recapture count
once the dispatches are captured), but the other properties carry over,
and a captured graph needs every one of them. Over N steady dispatches
after one warm-up:

``storage-not-kept``
    a tracked tensor — the page pool, its scale planes, the block table;
    ``generate``'s cache; a train step's parameters and AdamW state — no
    longer lives in the storage it had after warm-up
    (``untyped_storage().data_ptr()``). The
    port's form of "the donated buffer was consumed, not copied": a
    dispatch that rebinds its pool to a copy doubles the pool's memory
    for a moment and invalidates every captured pointer.
``kernel-rebuild``
    the kernels' library was built or loaded again (``ops/_build``).
``first-use-config-repeated``
    a first-use configuration (``allow_smem`` in ``ops/csrc/common.cuh``,
    ``check_cluster_fits`` in ``cluster_merge.cuh``: a kernel's shared
    memory raise and its cluster fit check) ran after warm-up — a kernel
    instantiation the warm-up never reached, which a graph capture would
    meet mid-capture.
``allocation-growth`` (CUDA only)
    ``torch.cuda.memory_allocated()`` grew from one steady dispatch to
    the next.

Scenario contract (``build(device[, size])``, also the
``GRAFTCHECK_TORCH_STEADY_AUDIT`` hook protocol — ``(name, build)``
pairs): ``(warmup, steady_fns, tracked)`` — ``warmup()`` reaches every
kernel instantiation, each ``steady_fns[i]()`` is one steady dispatch,
``tracked()`` returns ``{name: tensor}``. ``run_steady(...,
count_syncs=True)`` also records each dispatch's host syncs, and where
they happen, under ``torch.cuda.set_sync_debug_mode("warn")`` (reported,
not gated).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .findings import Finding


def storage_ptrs(tensors: Dict[str, object]) -> Dict[str, int]:
    return {n: t.untyped_storage().data_ptr()
            for n, t in tensors.items() if t is not None}


def _sync_sites(fn: Callable[[], object]) -> List[str]:
    """``file:line`` of each host sync ``fn`` makes on the card, as the
    sync debug mode warns of them (the innermost Python frame of the
    syncing call: implicit syncs too, which no AST rule can see)."""
    import os
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return [f"{os.path.relpath(w.filename, root)}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message)]


def _launches() -> Dict[str, int]:
    """Every kernel wrapper's launch count and every plain version's call
    count (``ops/decode_attention.py``, ``ops/flash_attention.py``)."""
    from ..ops.decode_attention import counters as decode_counters
    from ..ops.flash_attention import counters as flash_counters

    return {**decode_counters(), **flash_counters()}


def run_steady(build: Callable, name: str, device, size=None,
               count_syncs: bool = False) -> Tuple[List[Finding], dict]:
    """Run one scenario; returns (findings, stats): the dispatches'
    ``allocated`` bytes (CUDA), their ``syncs`` (with ``count_syncs`` on
    CUDA) with their ``sync_sites`` (``file:line`` each), the tracked
    tensors' names, and the kernel launches and plain-version calls the
    steady dispatches made (``launches``, nonzero counts only)."""
    import torch

    from ..ops import _build

    anchor = f"<steady:{name}>"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    stats: dict = {"allocated": [], "syncs": [], "sync_sites": [],
                   "tracked": [], "launches": {}}
    try:
        warmup, steady, tracked = (build(dev) if size is None
                                   else build(dev, size))
        warmup()
        base = storage_ptrs(tracked())
        stats["tracked"] = sorted(base)
        counts = dict(_build.COUNTS)
        first_use = _build.first_use_configs()
        launched = _launches()
        findings: List[Finding] = []
        for i, fn in enumerate(steady):
            if count_syncs and cuda:
                sites = _sync_sites(fn)
                stats["syncs"].append(len(sites))
                stats["sync_sites"].extend(sites)
            else:
                fn()
            now = storage_ptrs(tracked())
            moved = sorted(n for n in base if now.get(n) != base[n])
            if moved:
                findings.append(Finding(
                    "storage-not-kept", anchor, 0,
                    f"{name}: steady dispatch {i} left {moved} in new "
                    f"storage — the dispatch copied what it should write "
                    f"in place (twice the memory for a moment, and every "
                    f"captured pointer dangles)"))
                base = now
            if cuda:
                stats["allocated"].append(torch.cuda.memory_allocated(dev))
                a = stats["allocated"]
                if len(a) > 1 and a[-1] > a[-2]:
                    findings.append(Finding(
                        "allocation-growth", anchor, 0,
                        f"{name}: memory_allocated grew {a[-2]} -> {a[-1]} "
                        f"bytes from steady dispatch {i - 1} to {i}"))
    except Exception as e:  # noqa: BLE001 — report, keep auditing
        return [Finding("steady-guard", anchor, 0,
                        f"scenario {name} failed to run: "
                        f"{type(e).__name__}: {str(e)[:300]}")], stats
    stats["launches"] = {k: n - launched[k] for k, n in _launches().items()
                         if n != launched[k]}
    if dict(_build.COUNTS) != counts:
        findings.append(Finding(
            "kernel-rebuild", anchor, 0,
            f"{name}: the kernels' library was built or loaded after "
            f"warm-up ({counts} -> {dict(_build.COUNTS)})"))
    if _build.first_use_configs() != first_use:
        findings.append(Finding(
            "first-use-config-repeated", anchor, 0,
            f"{name}: {_build.first_use_configs() - first_use} first-use "
            f"configuration(s) (shared memory raise, cluster fit check) ran "
            f"after warm-up — warm every instantiation up first"))
    return findings, stats


def audit_steady_state(build: Callable, name: str,
                       device) -> List[Finding]:
    return run_steady(build, name, device)[0]


def engine_tensors(eng) -> Dict[str, Optional[object]]:
    """The tensors an engine's dispatches write in place: the pool or
    cache, its scale planes, and the block table (paged) or validity
    bitmap (contiguous)."""
    out = {"k": eng._k, "v": eng._v, "k_scale": eng._ks,
           "v_scale": eng._vs}
    if eng.layout == "paged":
        out["table"] = eng._table
    else:
        out["bitmap"] = eng._bitmap
    return out


def train_tensors(model, opt) -> Dict[str, object]:
    """A train step's parameters and AdamW state, by name."""
    out = {f"param:{n}": p for n, p in model.named_parameters()}
    names = {id(p): n for n, p in model.named_parameters()}
    for p, st in opt.state.items():
        for k, v in st.items():
            if hasattr(v, "untyped_storage") and v.ndim:
                out[f"adamw:{names.get(id(p), '?')}:{k}"] = v
    return out

