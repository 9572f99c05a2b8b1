"""Wire-format schema-compatibility audit (``wirecompat``).

The port writes the JAX package's three wire artifacts — the
``ServingSnapshot`` pytree + host meta doc (shed/failover pages), the
``ReplicaSummary`` JSON (the registry heartbeat the placement contract
hashes) and the ``RequestJournal`` doc (the replay source of truth) —
and one wire format means a JAX replica's snapshot and journal load on a
port replica and back. This pass holds the port's codecs to the JAX
package's committed goldens, with the JAX pass's constructors and rules:

1. **Build** every wire artifact from ``WIRE_ARTIFACTS`` — audit
   constructors producing fully populated representative instances
   (every optional field non-empty, so no leaf or doc key can hide).
2. **Extract** the live schema: pytree leaf names + ``dtype[rank]``,
   host-doc/JSON keys + JSON types, and whether the *decoder* tolerates
   each field's absence, probed by deleting the field and running the
   real decode (``from_pytree``/``from_json``). ``"required": true``
   means "the decoder has no default".
3. **Diff** against the goldens in ``tests/data/graftcheck/schemas/``
   (the JAX package's; this pass only reads them). Rules:

   ``wire-break``
       a golden field is gone from the live schema, or its type/rank
       changed — artifacts already in flight stop loading.
   ``wire-no-default``
       a new live field whose decoder has no default — the new decoder
       rejects old artifacts (add-with-default only).
   ``wire-golden-stale``
       any other live≠golden drift (a benign add-with-default, a
       requiredness flip, a missing golden file).

The port never writes the goldens (the CLI's ``--update-schemas``
refuses): the port follows the shared wire format, it does not define
it, so a drifted port cannot move the goldens. Host-only (numpy + json,
no torch).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .findings import Finding, Report

SCHEMA_VERSION = 1


def default_schema_dir() -> str:
    """tests/data/graftcheck/schemas next to the package — the JAX
    package's committed goldens this pass diffs against (read only)."""
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, "tests", "data", "graftcheck", "schemas")


def _json_type(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float"
    if isinstance(v, str):
        return "str"
    if isinstance(v, (list, tuple)):
        return "list"
    if isinstance(v, dict):
        return "object"
    return type(v).__name__


def _decodes(fn: Callable, *args) -> bool:
    try:
        fn(*args)
        return True
    except Exception:  # noqa: BLE001 — ANY decode failure means "required"
        return False


def _doc_to_uint8(doc: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(doc).encode("utf-8"),
                         dtype=np.uint8).copy()


# -- audit constructors (the JAX pass's, over the port's classes) -------
#
# Each builds a fully populated representative artifact: every optional
# field non-empty/non-default so every leaf and doc key appears in the
# live schema (an empty tier sidecar would make tier_k invisible), then
# probes per-field decoder defaults by deletion. Imports are lazy so
# this module stays import-light for the fast CLI path.


def _snapshot_schema() -> dict:
    from ..models.snapshot import ServingSnapshot

    L, R, ps, Hkv, hd = 2, 3, 4, 2, 4
    k = np.arange(L * R * ps * Hkv * hd, dtype=np.int32)
    k = (k % 127 - 63).astype(np.int8).reshape(L, R, ps, Hkv, hd)
    scales = np.linspace(0.5, 2.0, L * R * ps * Hkv).astype(
        np.float32).reshape(L, R, ps, Hkv, 1)
    snap = ServingSnapshot(
        fingerprint={"layout": "paged", "page_size": ps, "n_pages": R,
                     "n_layers": L, "n_kv_heads": Hkv, "head_dim": hd},
        page_ids=np.array([0, 1, 2], dtype=np.int32),
        k_pages=k, v_pages=(-k).copy(),
        k_scales=scales, v_scales=(scales * 0.5).copy(),
        table=np.array([[0, 1], [2, -1]], dtype=np.int32),
        lens=np.array([6, 4], dtype=np.int32),
        last=np.array([11, 22], dtype=np.int32),
        slot_req={0: 7, 1: 8},
        slot_pages={0: [0, 1], 1: [2]},
        slot_shared={0: [0], 1: []},
        slot_prompt={0: [1, 2, 3], 1: [4, 5]},
        budgets={7: 5, 8: 3, 9: 4},
        out={7: [11, 12], 8: [22]},
        queue=[(9, [6, 7, 8])],
        next_id=10,
        eos_scanned={0: 1, 1: 0},
        tree_paths=[([1, 2, 3, 4], [0]), ([5, 6, 7, 8], [-1])],
        arrival={7: 1.0, 8: 1.5},
        first_tok={7: 2.0},
        drained_mono=3.0,
        drained_wall=100.0,
        skipped_tokens=3,
        flight=[{"step": 0, "t": 3.5, "what": "decode"}],
        partial=False,
        tier_keys=[0],
        tier_k=k[:, :1].copy(), tier_v=(-k[:, :1]).copy(),
        tier_ks=scales[:, :1].copy(), tier_vs=(scales[:, :1] * 0.5).copy(),
    )
    snap.validate()
    tree = snap.to_pytree()
    doc = snap._meta_doc()

    def decode(t):
        ServingSnapshot.from_pytree(t)

    pytree: Dict[str, dict] = {}
    for name in sorted(tree):
        arr = np.asarray(tree[name])
        t2 = {kk: vv for kk, vv in tree.items() if kk != name}
        pytree[name] = {"type": f"{arr.dtype}[{arr.ndim}]",
                        "required": not _decodes(decode, t2)}
    doc_group: Dict[str, dict] = {}
    for key in sorted(doc):
        d2 = {kk: vv for kk, vv in doc.items() if kk != key}
        t2 = dict(tree)
        t2["meta_json"] = _doc_to_uint8(d2)
        doc_group[key] = {"type": _json_type(doc[key]),
                          "required": not _decodes(decode, t2)}
    return {"artifact": "serving_snapshot",
            "schema_version": SCHEMA_VERSION,
            "groups": {"pytree": pytree, "doc": doc_group}}


def _summary_schema() -> dict:
    from ..fleet.summary import ReplicaSummary

    summ = ReplicaSummary(
        replica="r0", fleet="blue", seq=4, published_wall=9.5,
        page_size=8, pages_total=64, pages_free=16, n_slots=4,
        active_slots=3, queued=2, decode_p50_s=0.01, prefill_p50_s=0.05,
        prefill_backlog_tokens=96, tp=2, weight_device_bytes=1 << 20,
        dram_cached_pages=5,
        digest=[([11, 22, 33], 3, 2), ([44, 55], 2, 2)],
    )
    d = json.loads(summ.to_json())

    fields: Dict[str, dict] = {}
    for key in sorted(d):
        d2 = {kk: vv for kk, vv in d.items() if kk != key}
        fields[key] = {"type": _json_type(d[key]),
                       "required": not _decodes(
                           ReplicaSummary.from_json, json.dumps(d2))}
    return {"artifact": "replica_summary",
            "schema_version": SCHEMA_VERSION,
            "groups": {"json": fields}}


def _journal_schema() -> dict:
    from ..fleet.journal import RequestJournal

    j = RequestJournal()
    a = j.open(prompt=[1, 2, 3], max_new=8, trace_id="t-a",
               replica="r0", deadline_wall=99.0, submitted_wall=1.0)
    j.deliver(a, [7, 8])
    b = j.open(prompt=[4, 5], max_new=4, trace_id="t-b",
               submitted_wall=2.0)
    j.reassign(b, "r1", failover=True)
    c = j.open(prompt=[6], max_new=2)
    j.deliver(c, [9, 10])
    j.close(c, "done")
    tree = j.to_pytree()
    doc = json.loads(bytes(tree["journal_doc"]).decode("utf-8"))

    def decode(d):
        RequestJournal.from_pytree({"journal_doc": _doc_to_uint8(d)})

    doc_group: Dict[str, dict] = {}
    for key in sorted(doc):
        d2 = {kk: vv for kk, vv in doc.items() if kk != key}
        doc_group[key] = {"type": _json_type(doc[key]),
                          "required": not _decodes(decode, d2)}
    entry_group: Dict[str, dict] = {}
    for field in sorted(doc["entries"][0]):
        d2 = dict(doc)
        d2["entries"] = [{kk: vv for kk, vv in e.items() if kk != field}
                         for e in doc["entries"]]
        entry_group[field] = {
            "type": _json_type(doc["entries"][0][field]),
            "required": not _decodes(decode, d2)}
    return {"artifact": "request_journal",
            "schema_version": SCHEMA_VERSION,
            "groups": {"pytree": {"journal_doc": {"type": "uint8[1]",
                                                  "required": True}},
                       "doc": doc_group, "entry": entry_group}}


# (name, constructor) — the registry the pass walks. A new wire artifact
# gets a row here + a committed golden, not a hand-audit.
WIRE_ARTIFACTS: List[Tuple[str, Callable[[], dict]]] = [
    ("serving_snapshot", _snapshot_schema),
    ("replica_summary", _summary_schema),
    ("request_journal", _journal_schema),
]


def extract_schemas(report: Optional[Report] = None) -> Dict[str, dict]:
    """Live schema per registered artifact; a constructor that raises
    becomes a ``wire-audit-error`` finding (a wire codec so broken its
    own audit constructor cannot round-trip must fail the run)."""
    out: Dict[str, dict] = {}
    for name, build in WIRE_ARTIFACTS:
        try:
            out[name] = build()
        except Exception as e:  # noqa: BLE001 — a broken codec is a finding
            if report is not None:
                report.extend([Finding(
                    "wire-audit-error", f"<wire:{name}>", 0,
                    f"audit constructor for {name} failed: "
                    f"{type(e).__name__}: {str(e)[:300]}")])
    return out


def load_golden(name: str) -> Optional[dict]:
    path = os.path.join(default_schema_dir(), f"{name}.json")
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def diff_schemas(name: str, live: dict, golden: Optional[dict],
                 anchor: str = "") -> List[Finding]:
    """Diff one artifact's live schema against its golden. Field-level
    breaks (``wire-break``/``wire-no-default``) are reported per field;
    ANY residual drift also raises one ``wire-golden-stale`` for the
    artifact, so a benign add-with-default still forces the golden (and
    its review) to move in the same commit."""
    anchor = anchor or f"<wire:{name}>"
    if golden is None:
        return [Finding(
            "wire-golden-stale", anchor, 0,
            f"{name}: no committed golden schema under the schema "
            f"directory — the port reads the JAX package's goldens "
            f"(tests/data/graftcheck/schemas/{name}.json)")]
    out: List[Finding] = []
    live_groups = live.get("groups", {})
    gold_groups = golden.get("groups", {})
    for group in sorted(set(live_groups) | set(gold_groups)):
        lf: Dict[str, dict] = dict(live_groups.get(group, {}))
        gf: Dict[str, dict] = dict(gold_groups.get(group, {}))
        for field in sorted(set(lf) | set(gf)):
            in_live, in_gold = field in lf, field in gf
            if in_gold and not in_live:
                out.append(Finding(
                    "wire-break", anchor, 0,
                    f"{name}.{group}.{field}: field REMOVED from the "
                    f"live wire format (golden type "
                    f"{gf[field].get('type')}) — artifacts already on "
                    f"the wire/disk stop loading; a rename reads as "
                    f"remove+add, and the port must follow the JAX "
                    f"package's format"))
                continue
            if in_live and not in_gold:
                if lf[field].get("required"):
                    out.append(Finding(
                        "wire-no-default", anchor, 0,
                        f"{name}.{group}.{field}: NEW field whose "
                        f"decoder has no default — the new decoder "
                        f"rejects every artifact written before this "
                        f"commit (a rolling upgrade bricks itself). "
                        f"Give the decoder an explicit default (the "
                        f"payload_shape / tier-sidecar idiom)"))
                continue
            if lf[field].get("type") != gf[field].get("type"):
                out.append(Finding(
                    "wire-break", anchor, 0,
                    f"{name}.{group}.{field}: wire type changed "
                    f"{gf[field].get('type')} -> {lf[field].get('type')}"
                    f" — old artifacts decode to the wrong "
                    f"dtype/shape/JSON type. Add a NEW field with a "
                    f"default instead, or bump the format version"))
    if live != golden:
        out.append(Finding(
            "wire-golden-stale", anchor, 0,
            f"{name}: the port's live wire schema drifted from the "
            f"committed golden — the port writes the JAX package's "
            f"format; a change to it belongs to both packages at once"))
    return out
