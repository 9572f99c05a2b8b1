"""Op audit — the port's counterpart of the JAX package's jaxpr audit.

Each registered entry runs once under the op recorder (``oprecord.py``)
on an explicit device, and the record is checked. The thresholds are
the JAX package's (entries run at toy shapes, so only genuinely
suspicious tensors cross them). Rules:

- ``f32-upcast``: a ``_to_copy`` to float32 from bf16/f16 whose result
  exceeds ``F32_ELEMS_LIMIT`` elements (a full-size f32 intermediate in
  a bf16 path), or a ``mm``/``bmm``/``addmm``/``baddbmm`` one of whose
  operands is an f32 copy of a bf16/f16 tensor made in the same call
  (PyTorch refuses mixed-dtype matmuls, so the upcast comes first; the
  contraction then runs at f32's cost).
- ``host-transfer``: a device→host copy or ``_local_scalar_dense``
  inside the call. Eager PyTorch has no ``scan`` to mark the hot loop,
  so an entry with a loop is recorded at two loop lengths (a decode
  chunk, ``generate``'s token count): a transfer whose count grows with
  the loop is in the per-tick loop, ERROR; any other is a warning, as in
  JAX.
- ``dead-output``: an allocated output above ``DEAD_ELEMS_LIMIT``
  elements that no later op reads and that is freed before the call
  returns (neither returned nor kept) — compute that nobody consumes
  (warning, as in JAX).
- ``per-call-upload`` (JAX's ``captured-const``): eager PyTorch bakes no
  constants into a program; what costs the same on every call is a
  host→device copy above ``CONST_BYTES_LIMIT`` inside the call. Every
  smaller upload stays in the record with its bytes and site
  (``Record.uploads()``).

Entries come from ``entrypoints.op_entrypoints()``; out-of-tree code and
the seeded ``bad_ops.py`` fixture opt in with a module-level
``GRAFTCHECK_TORCH_OP_AUDIT = [(name, OpEntry(build, loop)), ...]``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, List, Optional, Tuple

from .findings import Finding
from .world import check_world

CONST_BYTES_LIMIT = 1 << 20            # 1 MiB upload per call
F32_ELEMS_LIMIT = 1 << 16              # 64k-element f32 intermediate
DEAD_ELEMS_LIMIT = 1 << 12             # dead outputs below this are noise

_MATMULS = {"aten.mm.default", "aten.bmm.default", "aten.addmm.default",
            "aten.baddbmm.default"}
_HALF = ("bfloat16", "float16")


@dataclasses.dataclass(frozen=True)
class OpEntry:
    """``build(device, loop)`` → ``(fn, args)``: a fresh call of the
    entry on ``device``. ``loop`` is None, or two lengths of the entry's
    hot loop (``build`` is called with each; the audit compares the
    transfers of the two records). ``world``: 1, or 2 to run on each rank
    of the spawned world of two (``world.py``), a hook's entry too."""
    build: Callable
    loop: Optional[Tuple[int, int]] = None
    world: int = 1

    def __post_init__(self):
        check_world(self.world)


def _upcasts(rec) -> set:
    """Indices of ``_to_copy`` ops that made an f32 copy of a half
    tensor."""
    return {op.index for op in rec.ops
            if op.name == "aten._to_copy.default" and op.inputs
            and op.inputs[0].dtype in _HALF and op.outputs
            and op.outputs[0].dtype == "float32"}


def audit_record(rec, name: str) -> List[Finding]:
    """Every rule but the loop's severity over one record."""
    anchor = f"<ops:{name}>"
    out: List[Finding] = []
    ups = _upcasts(rec)
    for op in rec.ops:
        if op.index in ups and op.outputs[0].numel > F32_ELEMS_LIMIT:
            m = op.outputs[0]
            out.append(Finding(
                "f32-upcast", anchor, 0,
                f"{name}: {m.numel}-element {m.shape} upcast to f32 from "
                f"{op.inputs[0].dtype} (op {op.index}) — a full-size f32 "
                f"intermediate in a bf16 path (2x the bytes)"))
        elif op.name in _MATMULS and ups.intersection(op.reads):
            out.append(Finding(
                "f32-upcast", anchor, 0,
                f"{name}: {op.name} (op {op.index}) contracts an f32 copy of "
                f"a half tensor made in this call — the whole product runs "
                f"at f32's cost; cast the other operand down instead"))
    for t in rec.uploads():
        if t.nbytes > CONST_BYTES_LIMIT:
            out.append(Finding(
                "per-call-upload", anchor, 0,
                f"{name}: {t.via} uploads {t.nbytes / 2**20:.1f} MiB "
                f"({t.meta.shape}, {t.meta.dtype}) at {t.site} on every "
                f"call — keep it resident and pass the device tensor"))
    for a in rec.allocs:
        if not a.read and a.died is not None \
                and a.meta.numel > DEAD_ELEMS_LIMIT:
            op = rec.ops[a.op]
            out.append(Finding(
                "dead-output", anchor, 0,
                f"{name}: {op.name} (op {op.index}) output {a.meta.shape} "
                f"{a.meta.dtype} is never read, returned or kept — dead "
                f"compute", severity="warning"))
    return out


def _transfer_counts(rec) -> Counter:
    return Counter((t.via, t.site) for t in rec.readbacks())


def audit_records(recs, name: str) -> List[Finding]:
    """``recs``: one record, or two at the entry's two loop lengths."""
    out = audit_record(recs[0], name)
    grows = set()
    if len(recs) > 1:
        a, b = _transfer_counts(recs[0]), _transfer_counts(recs[1])
        grows = {k for k in b if b[k] > a.get(k, 0)}
    seen = set()
    for t in recs[0].readbacks() + (recs[1].readbacks()
                                    if len(recs) > 1 else []):
        key = (t.via, t.site)
        if key in seen:
            continue
        seen.add(key)
        loop = key in grows
        out.append(Finding(
            "host-transfer", f"<ops:{name}>", 0,
            f"{name}: {t.via} reads {t.meta.shape} {t.meta.dtype} back to "
            f"the host at {t.site}"
            + (" — its count grows with the loop: a host round trip per "
               "tick of the hot loop" if loop else " inside the call"),
            severity="error" if loop else "warning"))
    return out


def record_entry(entry: OpEntry, device, loop: Optional[int] = None):
    """(result, Record) of one call of ``entry`` at loop length
    ``loop``."""
    from .oprecord import record_call

    fn, args = entry.build(device, loop)
    return record_call(fn, args, device)


def audit_entry(entry: OpEntry, name: str, device) -> Tuple[
        List[Finding], list]:
    """(findings, records) of one entry; a failure to build or run is a
    finding (``record-error``), so one broken entry cannot hide the
    rest."""
    try:
        loops = entry.loop or (None,)
        recs = [record_entry(entry, device, n)[1] for n in loops]
    except Exception as e:  # noqa: BLE001 — report, keep auditing
        return [Finding("record-error", f"<ops:{name}>", 0,
                        f"could not record {name}: {type(e).__name__}: "
                        f"{str(e)[:300]}")], []
    return audit_records(recs, name), recs
