"""Symbolic memory-traffic / residency audit — the port's counterpart of
the JAX package's ``traffic.py``.

Every serving performance claim is a memory-traffic claim: the decode
chunk is O(pos), the speculative verify window O(pos+γ), the prefix-tail
prefill O(hit_len+tail). This pass makes the class a CONTRACT: it runs
each registered serving entry once under the op recorder
(``oprecord.py``) — on the card with the kernels as they really run, on
the CPU with the kernels' plain versions as leaves — costs every
ALLOCATED output's shape SYMBOLICALLY in the pool geometry dims, and
checks the measured class against the entry's declared contract. Views
cost nothing and an in-place write (the pool's update chain) allocates
nothing, so only allocations are classed.

Symbolization (``symbolize_shape``, ``render_monomial``) and the three
rules are the JAX package's:

- ``traffic-contract``: an allocation's monomial carries a tracked scale
  symbol beyond the contract's class; on a tp contract, a rank-5 pool
  value whose kv-heads dim is not Hkv/tp, a dispatch with no collective
  at all (no island), or — on ``weight_sharded`` rows — a 2-D block
  weight the rank's dispatch reads at its FULL (d|d_ff, d|d_ff) shape
  (the port keeps each layer's weights apart, where JAX stacks them
  [L, K, N]); and, at registry level, an entry with no contract.
- ``dense-materialization``: an allocation that scales with the full
  pool (``n_pages``) and is not the update chain (some pool-scale
  operand at least as big), or with the slots×prefix-window cross
  product ``M·hit``; ``dense_ok`` (with a rationale) sanctions it.
- ``peak-residency``: the pools stay resident and are written in place,
  so the rule bounds the pool-scale bytes newly ALLOCATED and live at
  once during the dispatch (``Record.peak_live``, liveness from each
  storage's ``weakref.finalize``) to ``(residency_multiple − 1)`` × the
  pool working set (the pool-scale bytes of the ``in_place`` operands).
  On the card the call's ``torch.cuda.max_memory_allocated()`` growth is
  held to the same bound above what the recorder saw allocated, so an
  allocation no op shows (a kernel wrapper's workspace) cannot hide.

``TrafficContract`` is the JAX package's field for field, but for
``donated``, which becomes ``in_place``: the argument positions the
dispatch writes in place (the pool planes, their scales, the table).

Entries come from ``entrypoints.traffic_entrypoints()`` with contracts
from ``entrypoints.traffic_contracts()``; out-of-tree code and the seeded
``bad_traffic.py`` opt in with a module-level
``GRAFTCHECK_TORCH_TRAFFIC_AUDIT = [(name, TrafficEntry(...)), ...]`` —
``contract`` a TrafficContract, a dict of its fields, or None to assert
"this entry must be flagged as contract-less".
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from .findings import Finding
from .world import check_world

# Scale symbols the contracts police; everything else in a geometry is
# structural vocabulary for readable monomials.
TRACKED_KV = ("n_pages", "S", "hit", "tb", "W")
POOL_SYM = "n_pages"
SLOTS_SYM = "M"
HIT_SYM = "hit"
# Allocator slack of the card's check: each allocation rounds up to
# 512 bytes, and the kernel wrappers' small operands (lengths, tables)
# are not ops.
_ALLOC_SLACK = 1 << 20


@dataclass(frozen=True)
class TrafficContract:
    """Declared per-dispatch traffic class for one entry (the JAX
    package's fields; ``in_place`` for its ``donated``)."""
    kv_scale: Mapping[str, int] = field(default_factory=dict)
    dense_ok: bool = False
    rationale: str = ""
    in_place: Tuple[int, ...] = ()
    residency_multiple: Optional[float] = 1.25
    tp: int = 1
    weight_sharded: bool = False

    def __post_init__(self):
        if self.dense_ok and not self.rationale.strip():
            raise ValueError(
                "dense_ok=True requires a rationale — a sanctioned dense "
                "materialization is a reviewable exemption, not a default")
        unknown = set(self.kv_scale) - set(TRACKED_KV)
        if unknown:
            raise ValueError(
                f"kv_scale names untracked symbols {sorted(unknown)} "
                f"(tracked: {TRACKED_KV})")


@dataclass(frozen=True)
class TrafficEntry:
    """``build(device, rank, world)`` → ``(fn, args)``. ``world``: 1, or
    2 to run on each rank of the spawned world of two (``world.py``), a
    hook's entry too. ``refused``: the port refuses this configuration —
    ``build`` must raise ``ValueError`` or ``NotImplementedError`` with
    this text in its message, and the entry is
    reported as refused, not audited."""
    build: Callable
    geometry: Mapping[str, int]
    contract: object = None
    world: int = 1
    refused: str = ""

    def __post_init__(self):
        check_world(self.world)


# -- symbolic shapes ----------------------------------------------------------

def symbolize_shape(shape: Sequence[int], geometry: Mapping[str, int],
                    ) -> Tuple[Counter, int]:
    """(symbol multiset, constant factor) for a concrete shape. First
    geometry entry with a matching value wins — the registry orders
    scale symbols first and builds its audit engines with DISTINCT
    values for them, so the mapping is unambiguous where it matters."""
    syms: Counter = Counter()
    const = 1
    for d in shape:
        d = int(d)
        for name, val in geometry.items():
            if val == d and d != 1:
                syms[name] += 1
                break
        else:
            const *= d
    return syms, const


def render_monomial(syms: Counter, const: int) -> str:
    parts = [f"{s}^{p}" if p > 1 else s
             for s, p in sorted(syms.items())]
    if const != 1 or not parts:
        parts.append(str(const))
    return "·".join(parts)


def as_contract(c) -> Optional[TrafficContract]:
    if c is None or isinstance(c, TrafficContract):
        return c
    return TrafficContract(**dict(c))


# -- the audit ----------------------------------------------------------------

def _pool_scale(meta, geometry) -> bool:
    return POOL_SYM in symbolize_shape(meta.shape, geometry)[0]


def weight_keys(args) -> Dict[int, Tuple[int, ...]]:
    """Storage id → shape of every 2-D tensor an argument holds: a
    module's parameters, or a bare tensor argument (the candidates of the
    replicated-weight check)."""
    import torch

    out: Dict[int, Tuple[int, ...]] = {}
    for a in args:
        ts = (list(a.parameters()) if isinstance(a, torch.nn.Module)
              else [a] if isinstance(a, torch.Tensor) else [])
        for t in ts:
            if t.ndim == 2:
                out[id(t.untyped_storage())] = tuple(t.shape)
    return out


def working_set(args, contract: TrafficContract, geometry) -> int:
    """Pool-scale bytes of the contract's in-place operands."""
    import torch

    from .oprecord import meta

    total = 0
    for pos in contract.in_place:
        if pos < len(args) and isinstance(args[pos], torch.Tensor):
            t = args[pos]
            if _pool_scale(meta(t), geometry):
                total += t.numel() * t.element_size()
    return total


def audit_traffic_record(rec, name: str, geometry: Mapping[str, int],
                         contract: TrafficContract, pool_set: int,
                         weights: Optional[Dict[int, tuple]] = None,
                         growth: Optional[int] = None) -> List[Finding]:
    """Audit one record against its contract. ``pool_set``: the pool
    working set (``working_set``); ``weights``: ``weight_keys`` of the
    call's arguments; ``growth``: the call's ``max_memory_allocated``
    growth on the card (None elsewhere)."""
    anchor = f"<traffic:{name}>"
    findings: List[Finding] = []
    seen: set = set()

    def emit(rule: str, key: str, msg: str, severity: str = "error"):
        if (rule, key) in seen:
            return
        seen.add((rule, key))
        findings.append(Finding(rule, anchor, 0, msg, severity=severity))

    for a in rec.allocs:
        op = rec.ops[a.op]
        shape = a.meta.shape
        if len(shape) < 2:
            continue
        syms, const = symbolize_shape(shape, geometry)
        mono = render_monomial(syms, const)
        if POOL_SYM in syms:
            chain = any(_pool_scale(m, geometry) and m.nbytes >= a.meta.nbytes
                        for m in op.inputs)
            if not chain and not contract.dense_ok:
                emit("dense-materialization", mono,
                     f"{name}: {op.name} materializes a pool-scale "
                     f"{shape} [{mono}] that is not the pool update chain "
                     f"— full-pool traffic on every dispatch (the class the "
                     f"paged kernels exist to avoid)")
            continue
        if SLOTS_SYM in syms and HIT_SYM in syms and not contract.dense_ok:
            emit("dense-materialization", mono,
                 f"{name}: {op.name} materializes {shape} [{mono}] — the "
                 f"slots×prefix-window cross product (dense per-slot "
                 f"prefix K/V, the gather class); stream the prefix "
                 f"through the kernel's table instead, or sanction the "
                 f"fallback in its contract")
        for sym in TRACKED_KV:
            power, allowed = syms.get(sym, 0), contract.kv_scale.get(sym, 0)
            if power > allowed:
                emit("traffic-contract", f"{sym}:{mono}",
                     f"{name}: {op.name} allocates {shape} [{mono}], which "
                     f"scales with {sym}^{power}; the contract allows "
                     f"{sym}^{allowed} — the measured traffic class exceeds "
                     f"the declared one (allowed: "
                     f"{dict(contract.kv_scale) or 'none'})")
    if contract.tp > 1 or contract.weight_sharded:
        _check_island(rec, name, geometry, contract, weights or {}, emit)
    findings.extend(_check_residency(rec, name, geometry, contract,
                                     pool_set, growth))
    return findings


def _check_island(rec, name, geometry, contract, weights, emit) -> None:
    hkv = geometry.get("Hkv") if contract.tp > 1 else None
    if hkv:
        for op in rec.ops:
            for m in op.inputs + op.outputs:
                if len(m.shape) == 5 and _pool_scale(m, geometry) \
                        and m.shape[3] * contract.tp != hkv:
                    emit("traffic-contract", f"island:{m.shape}",
                         f"{name}: rank-5 pool value {m.shape} on a "
                         f"tp={contract.tp} rank carries kv-heads dim "
                         f"{m.shape[3]}, expected Hkv/tp = "
                         f"{hkv // contract.tp} — the rank moves full "
                         f"pool-dim traffic instead of 1/tp")
    if contract.tp > 1 and not any(op.name.startswith("c10d.")
                                   for op in rec.ops):
        emit("traffic-contract", "island-missing",
             f"{name}: contract declares tp={contract.tp} but the rank's "
             f"dispatch ran no collective — no island: pool traffic is not "
             f"sharded at all")
    if not contract.weight_sharded:
        return
    full = {geometry.get("d"), geometry.get("d_ff")} - {None}
    if not full:
        emit("traffic-contract", "weights:vacuous-geometry",
             f"{name}: contract declares weight_sharded but the geometry "
             f"lacks d/d_ff — the replicated-weight check is vacuous",
             severity="warning")
        return
    read = set()
    for op in rec.ops:
        for k in op.ext_keys:
            if k in weights and min(weights[k]) > 1:
                read.add(k)
    for k in sorted(read):
        shape = weights[k]
        if shape[0] in full and shape[1] in full:
            emit("traffic-contract", f"weights:{shape}",
                 f"{name}: the rank's dispatch reads the FULL {shape} block "
                 f"weight — a replicated weight on a weight_sharded rank: "
                 f"per-rank weight bytes do not scale 1/tp")
    if not read:
        emit("traffic-contract", "weights:none",
             f"{name}: contract declares weight_sharded but the rank's "
             f"dispatch reads no 2-D block weight at all")


def _check_residency(rec, name, geometry, contract, pool_set,
                     growth) -> List[Finding]:
    anchor = f"<traffic:{name}>"
    if contract.residency_multiple is None:
        return []
    if pool_set == 0:
        return [Finding(
            "traffic-contract", anchor, 0,
            f"{name}: no pool-scale ({POOL_SYM}-dim) in-place operand — the "
            f"residency audit is vacuous; the geometry has drifted from "
            f"the entry's real shapes", severity="warning")]
    peak, at = rec.peak_live(lambda a: _pool_scale(a.meta, geometry))
    limit = (contract.residency_multiple - 1.0) * pool_set
    out = []
    if peak > limit:
        out.append(Finding(
            "peak-residency", anchor, 0,
            f"{name}: {peak} pool-scale bytes newly allocated and live at "
            f"once (at op {at}; {peak / pool_set:.2f}× the {pool_set}-byte "
            f"pool working set) > the "
            f"{contract.residency_multiple - 1.0:.2f}× a resident, in-place "
            f"pool allows — the dispatch copies the pool"))
    if growth is not None:
        seen, _ = rec.peak_live()
        if growth > seen + limit + _ALLOC_SLACK:
            out.append(Finding(
                "peak-residency", anchor, 0,
                f"{name}: max_memory_allocated grew {growth} bytes across "
                f"the dispatch, {growth - seen} above the {seen} the "
                f"recorder saw allocated — more than the "
                f"{limit:.0f}-byte residency bound (+{_ALLOC_SLACK} slack) "
                f"that no op shows"))
    return out


def run_traffic_entry(entry: TrafficEntry, name: str, device, rank: int = 0,
                      world: int = 1) -> Tuple[List[Finding], dict]:
    """Build, record and audit one entry on ``device`` (as ``rank`` of
    ``world``): (findings, stats) with the record's peak pool-scale
    bytes, the working set, the card's ``max_memory_allocated`` growth,
    the kernels the record launched and its uploads. A refused entry
    yields no finding and ``stats["refused"]``."""
    import torch

    from .oprecord import OpRecorder

    anchor = f"<traffic:{name}>"
    contract = as_contract(entry.contract)
    stats: dict = {}
    if contract is None:
        return [Finding(
            "traffic-contract", anchor, 0,
            f"{name}: registered with no traffic contract — an unstated "
            f"complexity class cannot regress because it was never "
            f"stated; declare one")], stats
    try:
        made = entry.build(device, rank, world)
    except (ValueError, NotImplementedError) as e:
        if entry.refused and entry.refused in str(e):
            stats["refused"] = str(e)[:200]
            return [], stats
        made, err = None, e
    except Exception as e:  # noqa: BLE001 — report, keep auditing
        made, err = None, e
    if entry.refused and made is not None:
        return [Finding(
            "traffic-refusal", anchor, 0,
            f"{name}: the port refuses this configuration ({entry.refused})"
            f" but its build succeeded")], stats
    if made is None:
        return [Finding("traffic-trace-error", anchor, 0,
                        f"could not build {name}: {type(err).__name__}: "
                        f"{str(err)[:300]}")], stats
    fn, args = made
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    try:
        # The allocator's counts move when the host allocates: no sync.
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        with OpRecorder(dev) as r:
            result = fn(*args)
        growth = None
        if cuda:
            growth = torch.cuda.max_memory_allocated(dev) - base
    except Exception as e:  # noqa: BLE001 — report, keep auditing
        return [Finding("traffic-trace-error", anchor, 0,
                        f"could not run {name}: {type(e).__name__}: "
                        f"{str(e)[:300]}")], stats
    rec = r.record
    pool_set = working_set(args, contract, entry.geometry)
    findings = audit_traffic_record(rec, name, entry.geometry, contract,
                                    pool_set, weight_keys(args), growth)
    del result
    stats.update(
        ops=len(rec.ops), pool_set=pool_set,
        peak_pool=rec.peak_live(
            lambda a: _pool_scale(a.meta, entry.geometry))[0],
        peak_all=rec.peak_live()[0], growth=growth,
        launched=rec.launched(),
        uploads=[(t.via, t.nbytes, t.site) for t in rec.uploads()])
    return findings, stats
