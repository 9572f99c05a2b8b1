"""Determinism lint — the replay/placement planes must stay replayable.

A copy of the JAX package's pass (fast, AST-only; rides the port's
tier-1 clean gate). The fleet's whole recovery story is deterministic
re-execution: failover re-completes a dead replica's in-flight requests
by replaying the journal byte-identically on survivors, and the
placement contract is same-summaries-⇒-same-decision. Both collapse
silently if a module on those paths consults ambient nondeterminism:

``unseeded-rng``
    ``random.Random()`` with no seed, the module-level ``random.*``
    global-state functions, the legacy ``np.random.*`` global RNG, and
    ``np.random.default_rng()`` with no seed. The fault injector and the
    health prober derive per-decision ``random.Random(seed)`` instances
    precisely so chaos runs replay; an unseeded RNG on those paths is a
    replay divergence with no log line.
``builtin-hash``
    builtin ``hash()`` — str/bytes hashing is salted per process
    (PYTHONHASHSEED), so any key, ordering, or routing decision derived
    from it differs across restarts and across replicas. Use
    ``zlib.crc32``/``hashlib`` (the fault injector's keys) for
    cross-process-stable keys.
``unordered-iteration``
    a ``for`` loop over a ``set``/``frozenset`` (literal, constructor,
    set comprehension, set algebra, or a name/attribute bound to one)
    whose body feeds an ordered decision — appends/extends an
    accumulator, yields, or selects-first via ``break``/``return``. Set
    iteration order is insertion-and-hash dependent; two replicas
    replaying the same events can pick different victims. Iterate
    ``sorted(s)`` (exempt by construction — ``sorted()`` returns a
    list) or keep an explicitly ordered structure.
``wall-clock-decision``
    direct ``time.time()``/``monotonic()``/``perf_counter()`` calls in
    scoped decision modules. The injectable ``Clock`` seam
    (``obs.SystemClock``/``VirtualClock``) exists exactly so schedulers
    and routers read time through a replayable source; a raw clock read
    is a decision input that can never be replayed.

Scope: determinism is a *contract of specific planes*, not the whole
tree — ``DETERMINISM_SCOPE`` below lists the modules whose
nondeterminism is an outage (fleet routing/health/replay, the fault
injector, snapshot/prefix/paging state machines, the scheduler scoring
path, scheduler plugins — kept so the scheduler's GPU side is linted
as soon as it lands in the port). Other modules (benches, demos) may use
ambient RNGs freely. A file outside the scope opts in by defining
``GRAFTCHECK_DETERMINISM_LINT`` at top level — the seeded fixture
idiom. Suppression: ``# graftcheck: ignore[rule]`` with a rationale,
per the README policy.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding, apply_suppressions, parse_suppressions

# Path suffix/prefix fragments (``/``-separated) naming the load-bearing
# modules. A trailing ``/`` means "the whole subtree".
DETERMINISM_SCOPE: Tuple[str, ...] = (
    "fleet/",
    "plugins/",
    "testing/faults.py",
    "models/snapshot.py",
    "models/prefix_cache.py",
    "models/paging.py",
    "models/proposers.py",
    "sched/scheduler.py",
    "sched/framework.py",
)

# Files outside the scope opt in by assigning this at module top level
# (how the seeded bad_determinism.py fixture gets linted).
OPT_IN_MARKER = "GRAFTCHECK_DETERMINISM_LINT"

# random-module functions that consume the hidden module-global RNG.
_GLOBAL_RANDOM_FNS = frozenset({
    "random", "randint", "randrange", "randbytes", "getrandbits",
    "choice", "choices", "sample", "shuffle", "uniform", "triangular",
    "betavariate", "expovariate", "gammavariate", "gauss",
    "lognormvariate", "normalvariate", "vonmisesvariate", "paretovariate",
    "weibullvariate", "seed",
})
# numpy.random constructors that ARE seedable — unseeded only when
# called with no arguments. Everything else under np.random.* is the
# legacy module-global RNG and is flagged unconditionally.
_SEEDABLE_NP = frozenset({
    "default_rng", "Generator", "SeedSequence", "RandomState",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
})
_WALL_CLOCK_FNS = frozenset({
    "time", "monotonic", "perf_counter",
    "time_ns", "monotonic_ns", "perf_counter_ns",
})
# Loop-body calls that feed an ordered accumulator.
_ORDERED_SINKS = frozenset({"append", "extend", "insert", "appendleft"})


def in_determinism_scope(path: str, source: str = "") -> bool:
    """True when ``path`` names a module whose determinism is load-bearing
    (DETERMINISM_SCOPE) or the source opts in via the fixture marker."""
    p = path.replace(os.sep, "/")
    for frag in DETERMINISM_SCOPE:
        if frag.endswith("/"):
            if f"/{frag}" in p or p.startswith(frag):
                return True
        elif p == frag or p.endswith(f"/{frag}"):
            return True
    return OPT_IN_MARKER in source


def _call_name(node: ast.Call) -> Optional[str]:
    """Dotted name of a call's callee (``a.b.c`` or ``name``), else None."""
    parts: List[str] = []
    cur = node.func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


class _ImportMap:
    """Aliases for the modules/functions the rules care about."""

    def __init__(self, tree: ast.AST) -> None:
        self.random_mods: Set[str] = set()      # import random [as r]
        self.np_mods: Set[str] = set()          # import numpy [as np]
        self.nprandom_mods: Set[str] = set()    # import numpy.random as npr
        self.time_mods: Set[str] = set()        # import time [as t]
        self.random_cls: Set[str] = set()       # from random import Random
        self.random_fns: Set[str] = set()       # from random import choice…
        self.np_seedable: Set[str] = set()      # numpy.random's default_rng…
        self.np_global_fns: Set[str] = set()    # numpy.random's shuffle…
        self.time_fns: Set[str] = set()         # from time import time…
        for n in ast.walk(tree):
            if isinstance(n, ast.Import):
                for a in n.names:
                    name = a.asname or a.name
                    if a.name == "random":
                        self.random_mods.add(name)
                    elif a.name == "numpy":
                        self.np_mods.add(name)
                    elif a.name == "numpy.random" and a.asname:
                        self.nprandom_mods.add(name)
                    elif a.name == "time":
                        self.time_mods.add(name)
            elif isinstance(n, ast.ImportFrom) and n.module:
                for a in n.names:
                    name = a.asname or a.name
                    if n.module == "random":
                        if a.name == "Random":
                            self.random_cls.add(name)
                        elif a.name in _GLOBAL_RANDOM_FNS:
                            self.random_fns.add(name)
                    elif n.module == "numpy.random":
                        if a.name in _SEEDABLE_NP:
                            self.np_seedable.add(name)
                        else:
                            self.np_global_fns.add(name)
                    elif n.module == "time":
                        if a.name in _WALL_CLOCK_FNS:
                            self.time_fns.add(name)


def _rng_finding(node: ast.Call, path: str,
                 imports: _ImportMap) -> Optional[Finding]:
    dotted = _call_name(node)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    seeded = bool(node.args) or bool(node.keywords)
    # random.Random() / Random() — unseeded instance.
    if (dotted in {f"{m}.Random" for m in imports.random_mods}
            or (not rest and head in imports.random_cls)):
        if not seeded:
            return Finding(
                "unseeded-rng", path, node.lineno,
                "random.Random() with no seed draws from OS entropy — "
                "replay on a survivor diverges. Derive the seed from "
                "stable inputs (the testing/faults.py idiom: "
                "crc32(kind:key) ^ run_seed)")
        return None
    # random.<global fn>() / bare imported global fn — shared hidden state.
    if ((head in imports.random_mods and rest in _GLOBAL_RANDOM_FNS)
            or (not rest and head in imports.random_fns)):
        return Finding(
            "unseeded-rng", path, node.lineno,
            f"module-global random.{rest or head}() shares one hidden "
            f"RNG across every caller and thread — even seeded once, "
            f"interleaving reorders draws. Use a per-component "
            f"random.Random(seed)")
    # numpy.random.* — seedable constructors vs the legacy global RNG.
    np_prefixes = ({f"{m}.random" for m in imports.np_mods}
                   | imports.nprandom_mods)
    np_head, _, np_fn = dotted.rpartition(".")
    if np_head in np_prefixes:
        if np_fn in _SEEDABLE_NP:
            if not seeded:
                return Finding(
                    "unseeded-rng", path, node.lineno,
                    f"np.random.{np_fn}() with no seed pulls OS entropy — "
                    f"pass an explicit seed so the stream replays")
            return None
        return Finding(
            "unseeded-rng", path, node.lineno,
            f"legacy np.random.{np_fn}() uses the module-global "
            f"RandomState — use np.random.default_rng(seed) so the "
            f"stream is per-component and replayable")
    if not rest and head in imports.np_seedable and not seeded:
        return Finding(
            "unseeded-rng", path, node.lineno,
            f"{head}() with no seed pulls OS entropy — pass an explicit "
            f"seed so the stream replays")
    if not rest and head in imports.np_global_fns:
        return Finding(
            "unseeded-rng", path, node.lineno,
            f"legacy numpy.random.{head}() uses the module-global "
            f"RandomState — use np.random.default_rng(seed)")
    return None


def _clock_finding(node: ast.Call, path: str,
                   imports: _ImportMap) -> Optional[Finding]:
    dotted = _call_name(node)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    if ((head in imports.time_mods and rest in _WALL_CLOCK_FNS)
            or (not rest and head in imports.time_fns)):
        fn = rest or head
        return Finding(
            "wall-clock-decision", path, node.lineno,
            f"time.{fn}() read directly in a decision module — inject "
            f"the obs Clock seam (SystemClock in production, "
            f"VirtualClock in tests) so staleness/deadline/backoff "
            f"decisions replay; a raw clock read can never be replayed")
    return None


# -- unordered-iteration --------------------------------------------------


def _is_set_expr(node: ast.AST, local_sets: Set[str],
                 attr_sets: Set[str]) -> bool:
    """Conservatively: does ``node`` statically evaluate to a set?
    Literals, ``set()``/``frozenset()`` calls, set comprehensions, names
    and ``self.<attr>`` bound to one of those, and set-algebra BinOps
    over them. ``sorted(s)`` returns a list, so ordering a set at the
    loop header exempts it by construction."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in {"set", "frozenset"}:
            return True
        # s.union(t) / s.difference(t) / … on a known set.
        if (isinstance(fn, ast.Attribute)
                and fn.attr in {"union", "difference", "intersection",
                                "symmetric_difference"}
                and _is_set_expr(fn.value, local_sets, attr_sets)):
            return True
        return False
    if isinstance(node, ast.Name):
        return node.id in local_sets
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr in attr_sets
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (_is_set_expr(node.left, local_sets, attr_sets)
                or _is_set_expr(node.right, local_sets, attr_sets))
    return False


def _collect_set_bindings(tree: ast.AST) -> Tuple[Dict[ast.AST, Set[str]],
                                                  Set[str]]:
    """Per-function local names statically bound to sets, plus the
    ``self.<attr>`` names any method assigns a set to (class-wide — the
    usual ``self._members = set()`` in __init__ pattern). Flow-
    insensitive on purpose: a name EVER bound to a set is suspect."""
    attr_sets: Set[str] = set()
    fn_locals: Dict[ast.AST, Set[str]] = {}
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        fn_locals[fn] = set()
    # Two passes: attribute bindings first (visible to every method),
    # then locals (which may chain off already-known names).
    for fn in funcs:
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and _is_set_expr(
                    n.value, set(), set()):
                for t in n.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        attr_sets.add(t.attr)
    for fn in funcs:
        local = fn_locals[fn]
        for _ in range(2):   # one re-pass resolves a = set(); b = a | c
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign) and _is_set_expr(
                        n.value, local, attr_sets):
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            local.add(t.id)
    return fn_locals, attr_sets


def _ordered_sink(body: List[ast.stmt]) -> Optional[Tuple[int, str]]:
    """(lineno, what) of the first ordered-decision sink in a loop body:
    an ordered-accumulator call (append/extend/insert/appendleft), a
    ``yield``, or first-match selection via ``break``/``return value``."""
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call) and isinstance(
                    n.func, ast.Attribute) and n.func.attr in _ORDERED_SINKS:
                return n.lineno, f".{n.func.attr}() into an accumulator"
            if isinstance(n, (ast.Yield, ast.YieldFrom)):
                return n.lineno, "a yield (caller sees set order)"
            if isinstance(n, ast.Break):
                return n.lineno, "first-match selection via break"
            if isinstance(n, ast.Return) and n.value is not None:
                return n.lineno, "first-match selection via return"
    return None


def _iter_findings(tree: ast.AST, path: str) -> List[Finding]:
    out: List[Finding] = []
    fn_locals, attr_sets = _collect_set_bindings(tree)
    for scope, local_sets in fn_locals.items():
        for n in ast.walk(scope):
            if not isinstance(n, (ast.For, ast.AsyncFor)):
                continue
            if not _is_set_expr(n.iter, local_sets, attr_sets):
                continue
            sink = _ordered_sink(n.body)
            if sink is None:
                continue
            _lineno, what = sink
            out.append(Finding(
                "unordered-iteration", path, n.lineno,
                f"for-loop over a set feeds an ordered decision ({what}) "
                f"— set order is hash/insertion dependent, so two "
                f"replicas replaying the same events diverge. Iterate "
                f"sorted(...) or keep an ordered structure"))
    return out


def lint_determinism_source(path: str, source: str,
                            tree: Optional[ast.AST] = None,
                            force: bool = False) -> List[Finding]:
    """Run the determinism rules over one file. Scope-gated: outside
    DETERMINISM_SCOPE (and without the opt-in marker) this returns []
    unless ``force`` — decision-plane determinism is a contract of
    specific modules, not a tree-wide style rule."""
    if not force and not in_determinism_scope(path, source):
        return []
    if tree is None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            return []   # the AST lint reports the syntax error
    imports = _ImportMap(tree)
    findings: List[Finding] = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        f = _rng_finding(n, path, imports) or _clock_finding(
            n, path, imports)
        if f is not None:
            findings.append(f)
        elif (isinstance(n.func, ast.Name) and n.func.id == "hash"
              and (n.args or n.keywords)):
            findings.append(Finding(
                "builtin-hash", path, n.lineno,
                "builtin hash() is salted per process (PYTHONHASHSEED) — "
                "any key/ordering/routing derived from it differs across "
                "restarts and replicas. Use zlib.crc32 (the fault "
                "injector's keys) or hashlib for stable keys"))
    findings.extend(_iter_findings(tree, path))
    findings = apply_suppressions(findings, parse_suppressions(source))
    return findings

