"""Sharding audit — the port's counterpart of the JAX package's GSPMD
audit (``gspmd.py``).

JAX reads the sharding ANNOTATIONS of a traced program. The port has no
annotations: each rank of a world allocates its own blocks. So this pass
reads each rank's REAL tensors — the cache ``generate(mesh=)`` makes
(from the op record of the call), an engine's pool planes, its model's
weights — and holds their shapes to the one rules table the models take
their specs from (``parallel/sharding.py``: ``DEFAULT_RULES``,
``block_region``, ``rank_slice``, ``weight_slice_spec``):

- ``cache-spec-mismatch`` / ``cache-spec-missing``: each rank-5 cache a
  rank allocates has the shape ``block_region`` gives its whole shape
  under ``serving.CACHE_SPEC``; an entry registered with
  ``cache_spec=True`` must allocate at least one.
- ``island-pool-spec`` / ``island-missing``: an entry registered with
  ``pool_spec=True`` holds, on each rank, pool planes of its block under
  the rules table's ``KV_POOL_AXES`` (Hkv/tp on dim 3), its dispatch
  reads the pool at that shape, and a tp > 1 engine holds an ``Island``
  (``parallel/island.py``) — else the sharded engine degraded to a
  replicated one.
- ``island-weight-spec``: with ``weight_specs=True``, each of a rank's
  Megatron weights has the shape of ``rank_slice(w, weight_slice_spec(
  kind))`` (the port keeps each layer's [K, N] apart, so the stacked
  spec's layer dim is dropped), and both halves (column and row) appear.
- ``oversized-replicated``: a rank tensor above
  ``REPLICATED_BYTES_LIMIT`` that has the FULL shape of a tensor its spec
  shards — the whole buffer on every rank.
- ``unknown-mesh-axis``: a spec naming a mesh axis outside the rules
  table's values (dp/fsdp/sp/ep/tp) — a typo'd axis silently replicates.

JAX's ``unconstrained-scan-carry`` has no eager counterpart: nothing
propagates a layout, each rank allocates its own shapes. The failure it
hunts — the whole cache on every rank — is caught here by
``oversized-replicated`` and the cache rule.

Entries come from ``entrypoints.gspmd_entrypoints()``; out-of-tree code
and the seeded ``bad_gspmd.py`` opt in with a module-level
``GRAFTCHECK_TORCH_GSPMD_AUDIT = [(name, GspmdEntry(build, expect)),
...]``. Every entry, a hook's too, runs on each rank of the spawned world
of two (``world.py``), whose process group its ``build(device, rank,
world)`` may use.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Set, Tuple

from .findings import Finding

REPLICATED_BYTES_LIMIT = 1 << 20   # 1 MiB tensor whole on every rank
CACHE_RANK = 5                     # [L, B, S, Hkv, hd]


@dataclasses.dataclass
class Sharded:
    """One rank tensor and what it should be a block of."""
    label: str
    tensor: object                 # the rank's tensor
    full_shape: Tuple[int, ...]    # the whole tensor's shape
    spec: tuple                    # mesh axes per dim (None: replicated)
    role: str = "other"            # "cache" | "pool" | "weight" | "other"


@dataclasses.dataclass
class RankView:
    """What one rank holds: its mesh ``sizes``/``index``
    (``mesh_coords``), its tensors, whether it holds a tp ``island``, and
    optionally the dispatch to record (``run``) with the whole shape of
    the cache it allocates (``cache_full``)."""
    sizes: Dict[str, int]
    index: Dict[str, int]
    tensors: List[Sharded] = dataclasses.field(default_factory=list)
    island: bool = False
    run: Optional[Callable] = None
    cache_full: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class GspmdEntry:
    """``build(device, rank, world)`` → ``RankView``; ``expect`` is JAX's
    expectations dict (``cache_spec``, ``pool_spec``, ``weight_specs``)."""
    build: Callable
    expect: Mapping[str, bool] = dataclasses.field(default_factory=dict)


def known_mesh_axes() -> Set[str]:
    """The VALUES of the rules table: every axis a spec may name."""
    from ..parallel.sharding import DEFAULT_RULES

    axes: Set[str] = set()
    for v in DEFAULT_RULES.values():
        if v is None:
            continue
        axes.update(str(a) for a in (v if isinstance(v, (tuple, list))
                                     else (v,)))
    return axes


def pool_spec() -> tuple:
    """The pool planes' spec, from the rules table (Hkv on tp)."""
    from ..parallel.sharding import DEFAULT_RULES, KV_POOL_AXES, spec_for

    return spec_for(KV_POOL_AXES, DEFAULT_RULES)


def weight_spec(kind: str) -> tuple:
    """A per-layer [K, N] weight's spec: the stacked [L, K, N] spec of
    ``weight_slice_spec`` without its layer dim."""
    from ..parallel.sharding import weight_slice_spec

    return tuple(weight_slice_spec(kind)[1:])


def _axes(spec) -> Set[str]:
    out: Set[str] = set()
    for e in spec:
        if e is not None:
            out.update(str(a) for a in (e if isinstance(e, (tuple, list))
                                        else (e,)))
    return out


def block_shape(full, spec, sizes, index) -> Tuple[int, ...]:
    from ..parallel.sharding import block_region

    region = block_region(tuple(full), tuple(spec), sizes, index)
    return tuple(r.stop - r.start for r in region) + tuple(full)[len(region):]


def _shards(spec, sizes) -> bool:
    """Whether ``spec`` cuts any dim on this mesh."""
    n = 1
    for a in _axes(spec):
        n *= sizes.get(a, 1)
    return n > 1


def audit_rank(view: RankView, name: str, rank: int, cache_spec=False,
               pool_spec_=False, weight_specs=False, record=None) -> List[Finding]:
    """Audit one rank's view (and ``record``, the op record of
    ``view.run`` when given)."""
    from ..models.serving import CACHE_SPEC
    from .oprecord import meta

    anchor = f"<gspmd:{name}>"
    out: List[Finding] = []
    known = known_mesh_axes()
    sizes, index = view.sizes, view.index
    tp = sizes.get("tp", 1)
    who = f"{name} (rank {rank})"

    def check_axes(label, spec) -> bool:
        bad = _axes(spec) - known
        if bad:
            out.append(Finding(
                "unknown-mesh-axis", anchor, 0,
                f"{who}: {label}'s spec {spec} names mesh axes "
                f"{sorted(bad)} outside the rules table (dp/fsdp/sp/ep/tp) "
                f"— a typo'd axis silently replicates"))
        return not bad

    tensors = list(view.tensors)
    if record is not None and view.cache_full is not None:
        for a in record.allocs:
            op = record.ops[a.op]
            if len(a.meta.shape) == CACHE_RANK and not op.inputs:
                tensors.append(Sharded(f"cache allocated by {op.name}",
                                       a.meta, view.cache_full, CACHE_SPEC,
                                       "cache"))
    rule = {"cache": "cache-spec-mismatch", "pool": "island-pool-spec",
            "weight": "island-weight-spec"}
    kinds: Set[str] = set()
    for s in tensors:
        shape = tuple(int(d) for d in s.tensor.shape)
        m = s.tensor if not hasattr(s.tensor, "untyped_storage") \
            else meta(s.tensor)
        nbytes = m.nbytes
        if not check_axes(s.label, s.spec):
            continue
        try:
            want = block_shape(s.full_shape, s.spec, sizes, index)
        except ValueError as e:
            want, why = None, str(e)
        if s.role in rule and shape != want:
            out.append(Finding(
                rule[s.role], anchor, 0,
                f"{who}: {s.label} is {shape}, its block under spec "
                f"{s.spec} of the whole {tuple(s.full_shape)} is "
                + (f"{want}" if want is not None else f"undefined ({why})")
                + " — the rank holds another layout than the rules table's"))
        elif s.role == "weight":
            kinds.add(s.spec.index("tp") if "tp" in s.spec else -1)
        if nbytes > REPLICATED_BYTES_LIMIT and _shards(s.spec, sizes) \
                and shape == tuple(s.full_shape):
            out.append(Finding(
                "oversized-replicated", anchor, 0,
                f"{who}: {s.label} {shape} ({nbytes / 2**20:.1f} MiB) is "
                f"the WHOLE tensor, though its spec {s.spec} shards it — "
                f"the full buffer on every rank"))
    if cache_spec and not any(s.role == "cache" for s in tensors):
        out.append(Finding(
            "cache-spec-missing", anchor, 0,
            f"{who}: registered with cache_spec=True but allocates no "
            f"rank-5 cache — nothing to hold to CACHE_SPEC {CACHE_SPEC}"))
    if pool_spec_:
        check_axes("the pool", pool_spec())
        if tp > 1 and not view.island:
            out.append(Finding(
                "island-missing", anchor, 0,
                f"{who}: registered with pool_spec=True on a tp={tp} mesh "
                f"but holds no Island — the sharded engine degraded to a "
                f"replicated one"))
        pools = [s for s in tensors if s.role == "pool"]
        if not pools:
            out.append(Finding(
                "island-pool-spec", anchor, 0,
                f"{who}: registered with pool_spec=True but holds no pool "
                f"plane"))
        elif record is not None:
            full = tuple(pools[0].full_shape)
            want = block_shape(full, pool_spec(), sizes, index)
            for op in record.ops:
                for m in op.inputs:
                    if len(m.shape) == CACHE_RANK and m.shape[1] == full[1] \
                            and m.shape[:3] == full[:3] \
                            and m.shape[3] != want[3]:
                        out.append(Finding(
                            "island-pool-spec", anchor, 0,
                            f"{who}: the dispatch reads a pool value "
                            f"{m.shape} ({op.name}), not the rank's block "
                            f"{want}"))
                        break
    if weight_specs and tp > 1:
        if not any(s.role == "weight" for s in tensors):
            out.append(Finding(
                "island-weight-spec", anchor, 0,
                f"{who}: registered with weight_specs=True but holds no "
                f"Megatron weight"))
        elif not any(f.rule == "island-weight-spec" for f in out):
            from ..parallel.sharding import WEIGHT_COLUMN_DIM, WEIGHT_ROW_DIM

            need = {WEIGHT_COLUMN_DIM - 1, WEIGHT_ROW_DIM - 1}
            if not need <= kinds:
                out.append(Finding(
                    "island-weight-spec", anchor, 0,
                    f"{who}: weight_specs=True but the weights are sliced "
                    f"on dims {sorted(kinds)} only — column AND row halves "
                    f"must both appear"))
    return out


def run_gspmd_entry(entry: GspmdEntry, name: str, device, rank: int,
                    world: int) -> Tuple[List[Finding], dict]:
    """Build one rank's view, record its dispatch when it has one, and
    audit it: (findings, stats)."""
    from .oprecord import OpRecorder

    anchor = f"<gspmd:{name}>"
    try:
        view = entry.build(device, rank, world)
        record = None
        if view.run is not None:
            with OpRecorder(device) as r:
                result = view.run()
            record = r.record
            del result
    except Exception as e:  # noqa: BLE001 — report, keep auditing
        return [Finding("gspmd-trace-error", anchor, 0,
                        f"could not run {name} on rank {rank}: "
                        f"{type(e).__name__}: {str(e)[:300]}")], {}
    exp = dict(entry.expect)
    findings = audit_rank(view, name, rank,
                          cache_spec=exp.get("cache_spec", False),
                          pool_spec_=exp.get("pool_spec", False),
                          weight_specs=exp.get("weight_specs", False),
                          record=record)
    stats = {"tensors": {s.label: tuple(int(d) for d in s.tensor.shape)
                         for s in view.tensors},
             "island": view.island,
             "ops": len(record.ops) if record is not None else 0}
    return findings, stats
