"""Lock-order & in-place-buffer concurrency audit.

The AST lock-lint (astlint.py ``lock-guard``) answers "is this attribute
touched without its lock"; this pass answers the three questions that
rule cannot see:

- ``lock-cycle`` (the JAX package's rule, copied): extend the lock→attr
  map into a lock-ACQUISITION-ORDER graph — one node per lock
  (``Class.attr`` or a module-level lock), one edge A→B whenever code
  acquires B while holding A (a directly nested ``with``, or a call to a
  same-scope function/method that acquires B). A cycle is a potential
  deadlock. A SELF-edge on a non-reentrant ``threading.Lock`` /
  ``Condition`` is the degenerate cycle; ``RLock`` self-edges are
  exempt by construction.

- ``read-of-inplace-buffer`` (the port's form of JAX's
  ``use-after-donate``): host reads of engine attributes that a
  registered dispatch body WRITES IN PLACE, outside the step path. JAX
  derives its donated set from ``jit(..., donate_argnums=)``; eager
  PyTorch donates nothing but writes its pools in place, so the set is
  derived from the dispatch bodies themselves (``entrypoints.
  DISPATCH_BODIES``, or a fixture's ``GRAFTCHECK_DISPATCH_BODIES``): a
  parameter a body writes through a subscript store, an augmented
  assignment or an in-place method (``copy_``, ``zero_``, ...) is
  in-place, and every ``self.X`` passed at that parameter from a method
  of the class joins the set. A read of such an attribute is safe only
  where the step cannot run beside it: ``__init__``, methods that
  themselves dispatch or rebind the attr, and reads under a lock that
  every dispatch call site holds. Anywhere else — a metrics scrape on
  another thread — the read races the step's queued in-place writes (a
  torn pool, and a readback that waits behind the step). Identity
  checks (``is None``) and metadata reads (``.shape``/``.dtype``/
  ``.device``/``.numel()``...) never touch device memory and are exempt.

- ``torn-snapshot`` (copied): a method that acquires the SAME lock more
  than once and touches that lock's guarded attributes under two or more
  of the acquisitions — each ``with`` block is individually "held" (so
  ``lock-guard`` stays quiet) but the values come from different
  instants. Multi-gauge drains must be ONE lock snapshot.

Pure AST (no torch import) — runs inside the fast passes and the port's
tier-1 clean gate. Suppression: the standard ``# graftcheck:
ignore[rule]`` with a rationale (e.g. ``drain()``'s pool reads, which
happen at a step boundary with admission stopped).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import Finding, apply_suppressions, parse_suppressions
from .astlint import (
    _LOCK_TYPES, _self_attr, _terminal_name, _walk_shallow, _MUTATORS,
)

# Reads of these attributes touch only a tensor's metadata, never device
# memory — safe while a dispatch writes the buffer.
_METADATA_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "size",
                   "numel", "nbytes", "element_size", "layout", "stride",
                   "is_contiguous", "data_ptr", "untyped_storage"}


def _parents(tree: ast.AST) -> Dict[int, ast.AST]:
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


# -- lock-acquisition-order graph ---------------------------------------------

class _LockGraph:
    """Acquisition-order edges between the locks of one scope (a class,
    or a module's top level). Node = lock attr name; edge (a, b, lineno)
    = b acquired while a held."""

    def __init__(self, owner: str, path: str) -> None:
        self.owner = owner
        self.path = path
        self.edges: Dict[str, Dict[str, int]] = {}   # a -> {b: lineno}
        self.rlocks: Set[str] = set()

    def add(self, a: str, b: str, lineno: int) -> None:
        self.edges.setdefault(a, {}).setdefault(b, lineno)

    def cycles(self) -> List[Tuple[List[str], int]]:
        """Every elementary cycle reachable in the (small) graph, as
        (node path, anchor lineno). Self-edges on non-reentrant locks
        are length-1 cycles; RLock self-edges are dropped."""
        out: List[Tuple[List[str], int]] = []
        seen: Set[frozenset] = set()
        for a, nbrs in sorted(self.edges.items()):
            if a in nbrs and a not in self.rlocks:
                out.append(([a, a], nbrs[a]))
        # DFS for multi-node cycles (graphs here have a handful of nodes).
        def dfs(start: str, node: str, trail: List[str]) -> None:
            for b, ln in sorted(self.edges.get(node, {}).items()):
                if b == start and len(trail) > 1:
                    key = frozenset(trail)
                    if key not in seen:
                        seen.add(key)
                        out.append((trail + [start], ln))
                elif b not in trail and b != start:
                    dfs(start, b, trail + [b])

        for a in sorted(self.edges):
            dfs(a, a, [a])
        return out


def _lock_attrs_of_class(cls: ast.ClassDef) -> Tuple[Set[str], Set[str]]:
    """(lock attrs, RLock attrs) assigned as ``self.X = threading.Lock()``
    anywhere in the class body."""
    locks: Set[str] = set()
    rlocks: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            tname = _terminal_name(node.value.func)
            if tname not in _LOCK_TYPES:
                continue
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is not None:
                    locks.add(attr)
                    if tname == "RLock":
                        rlocks.add(attr)
    return locks, rlocks


def _module_locks(tree: ast.Module) -> Set[str]:
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if _terminal_name(node.value.func) in _LOCK_TYPES:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
    return out


def _acquired_lock(item: ast.withitem, locks: Set[str],
                   self_based: bool) -> Optional[str]:
    expr = item.context_expr
    # `with self._mu:` / `with self._cv:` (also `.acquire()`-less
    # Condition use; `with lock:` at module level when self_based=False).
    if self_based:
        attr = _self_attr(expr)
        return attr if attr in locks else None
    if isinstance(expr, ast.Name) and expr.id in locks:
        return expr.id
    return None


def _direct_acquisitions(fn: ast.AST, locks: Set[str],
                         self_based: bool) -> Set[str]:
    out: Set[str] = set()
    for node in _walk_shallow(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                lk = _acquired_lock(item, locks, self_based)
                if lk:
                    out.add(lk)
    return out


def _scan_order_edges(fn: ast.AST, locks: Set[str], self_based: bool,
                      acquires: Dict[str, Set[str]],
                      graph: _LockGraph) -> None:
    """Walk one function body tracking the held-lock set; record an edge
    held→B for every nested acquisition of B (directly, or through a
    call to a same-scope function whose transitive acquisition set is
    known). Nested defs/lambdas run later (often on another thread):
    held set resets to empty inside them."""

    def callee_name(call: ast.Call) -> Optional[str]:
        if self_based:
            # self.method(...) — same-class resolution only.
            if isinstance(call.func, ast.Attribute) \
                    and isinstance(call.func.value, ast.Name) \
                    and call.func.value.id == "self":
                return call.func.attr
            return None
        if isinstance(call.func, ast.Name):
            return call.func.id
        return None

    def walk(nodes: Iterable[ast.AST], held: Tuple[str, ...]) -> None:
        for node in nodes:
            if isinstance(node, ast.With):
                now = list(held)
                for item in node.items:
                    lk = _acquired_lock(item, locks, self_based)
                    if lk:
                        # Edges from EVERYTHING currently held — including
                        # locks acquired earlier in this same multi-item
                        # statement (`with self._a, self._b:` orders a
                        # before b exactly like nesting does).
                        for h in now:
                            graph.add(h, lk, node.lineno)
                        now.append(lk)
                walk(ast.iter_child_nodes(node), tuple(now))
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                walk(ast.iter_child_nodes(node), ())
                continue
            if isinstance(node, ast.Call) and held:
                name = callee_name(node)
                if name is not None:
                    for b in acquires.get(name, ()):
                        for h in held:
                            graph.add(h, b, node.lineno)
            walk(ast.iter_child_nodes(node), held)

    body = fn.body if isinstance(fn, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) else [fn]
    walk(iter(body), ())


def _transitive_acquires(fns: Dict[str, ast.AST], locks: Set[str],
                         self_based: bool) -> Dict[str, Set[str]]:
    """fn name -> locks it may acquire, directly or via same-scope calls
    (fixpoint over the one-scope call graph)."""
    acq = {name: _direct_acquisitions(fn, locks, self_based)
           for name, fn in fns.items()}
    calls: Dict[str, Set[str]] = {}
    for name, fn in fns.items():
        out: Set[str] = set()
        for node in _walk_shallow(fn):
            if not isinstance(node, ast.Call):
                continue
            if self_based:
                if isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self" \
                        and node.func.attr in fns:
                    out.add(node.func.attr)
            elif isinstance(node.func, ast.Name) and node.func.id in fns:
                out.add(node.func.id)
        calls[name] = out
    changed = True
    while changed:
        changed = False
        for name in fns:
            before = len(acq[name])
            for callee in calls[name]:
                acq[name] |= acq[callee]
            if len(acq[name]) != before:
                changed = True
    return acq


def _check_lock_order(path: str, tree: ast.Module) -> List[Finding]:
    findings: List[Finding] = []
    graphs: List[_LockGraph] = []

    # Module-level locks + top-level functions.
    mlocks = _module_locks(tree)
    if mlocks:
        fns = {n.name: n for n in tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        graph = _LockGraph("<module>", path)
        acq = _transitive_acquires(fns, mlocks, self_based=False)
        for fn in fns.values():
            _scan_order_edges(fn, mlocks, False, acq, graph)
        graphs.append(graph)

    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        locks, rlocks = _lock_attrs_of_class(node)
        if not locks:
            continue
        methods = {m.name: m for m in node.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        graph = _LockGraph(node.name, path)
        graph.rlocks = rlocks
        acq = _transitive_acquires(methods, locks, self_based=True)
        for m in methods.values():
            _scan_order_edges(m, locks, True, acq, graph)
        graphs.append(graph)

    for graph in graphs:
        for trail, lineno in graph.cycles():
            pretty = " -> ".join(f"{graph.owner}.{n}" for n in trail)
            if len(trail) == 2 and trail[0] == trail[1]:
                msg = (f"{graph.owner}.{trail[0]} re-acquired while "
                       f"already held (non-reentrant Lock/Condition): "
                       f"the thread deadlocks on itself; use one "
                       f"acquisition or an RLock with a rationale")
            else:
                msg = (f"lock-order cycle {pretty}: two threads entering "
                       f"from different edges deadlock; pick ONE global "
                       f"acquisition order and restructure the inner "
                       f"acquisition")
            findings.append(Finding("lock-cycle", path, lineno, msg))
    return findings


# -- read-of-inplace-buffer ---------------------------------------------------

def _write_base(node: ast.AST) -> Optional[str]:
    """The parameter name at the root of a subscript chain (``k[l][p, o]``
    -> ``k``), else None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def inplace_params(fn: ast.AST) -> Set[str]:
    """Parameters a dispatch body writes in place: a subscript store or
    delete (``k[layer][pg, off] = ...``, ``bitmap[:, row] |= m``), an
    augmented assignment to the bare name (``x += 1`` on a tensor), or an
    in-place method (``x.copy_(...)``, ``x[0].zero_()``)."""
    args = fn.args
    params = {a.arg for a in args.posonlyargs + args.args
              + args.kwonlyargs}
    # A parameter rebound before its first write (``lens = lens.clone()``)
    # writes a copy, not the caller's tensor.
    rebound = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            rebound[node.id] = min(node.lineno,
                                   rebound.get(node.id, node.lineno))
    out: Set[str] = set()
    for node in ast.walk(fn):
        name = None
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            name = _write_base(node)
        elif isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Name):
            name = node.target.id
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr.endswith("_") \
                and not node.func.attr.startswith("_"):
            name = _write_base(node.func.value)
        if name in params and rebound.get(name, node.lineno + 1) \
                > node.lineno:
            out.add(name)
    return out


def _dispatch_defs(path: str, tree: ast.Module) -> Dict[str, ast.AST]:
    from .astlint import registered_bodies

    names = registered_bodies(path, tree)
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name in names}


def _inplace_attrs(cls: ast.ClassDef,
                   defs: Dict[str, ast.AST]) -> Dict[str, Set[str]]:
    """{self attr: dispatch names} for every attr a method of ``cls``
    passes at a parameter that dispatch writes in place."""
    written = {name: inplace_params(fn) for name, fn in defs.items()}
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in defs):
            continue
        fn = defs[node.func.id]
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        bound = list(zip(params, node.args))
        bound += [(k.arg, k.value) for k in node.keywords if k.arg]
        for param, value in bound:
            attr = _self_attr(value)
            if attr is not None and param in written[node.func.id]:
                out.setdefault(attr, set()).add(node.func.id)
    return out


def _nodes_with_locks(fn: ast.AST, locks: Set[str]):
    """(node, self-locks held there) for every node of ``fn``'s body;
    nested defs run later, with no lock held."""
    out = []

    def walk(nodes: Iterable[ast.AST], held: Set[str]) -> None:
        for node in nodes:
            now = held
            if isinstance(node, ast.With):
                now = held | {a for item in node.items
                              for a in [_self_attr(item.context_expr)]
                              if a in locks}
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                now = set()
            out.append((node, held))
            walk(ast.iter_child_nodes(node), now)

    walk(iter(fn.body), set())
    return out


def _check_inplace_reads(path: str, tree: ast.Module) -> List[Finding]:
    defs = _dispatch_defs(path, tree)
    if not defs:
        return []
    findings: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        inplace = _inplace_attrs(cls, defs)
        if not inplace:
            continue
        locks, _ = _lock_attrs_of_class(cls)
        walked = {m.name: _nodes_with_locks(m, locks) for m in cls.body
                  if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}

        def dispatches(n):
            return isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in defs

        # Locks held at EVERY dispatch call site: a read under one of them
        # cannot overlap a dispatch.
        at_calls = [held for nodes in walked.values() for n, held in nodes
                    if dispatches(n)]
        ordered = set.intersection(*at_calls) if at_calls else set()
        parents = _parents(cls)
        for name, nodes in walked.items():
            # Step-path / lifecycle exemption: a method that dispatches, or
            # rebinds the attr itself, owns the buffer's lifetime.
            if name == "__init__" or any(dispatches(n) for n, _ in nodes):
                continue
            rebinds = {a for n, _ in nodes for a in [_self_attr(n)]
                       if a in inplace and isinstance(n.ctx, ast.Store)}
            for n, held in nodes:
                attr = _self_attr(n)
                if attr not in inplace or attr in rebinds \
                        or not isinstance(n.ctx, ast.Load) or held & ordered:
                    continue
                parent = parents.get(id(n))
                if isinstance(parent, ast.Attribute) \
                        and parent.attr in _METADATA_ATTRS:
                    continue      # .shape/.dtype — metadata, no device read
                if isinstance(parent, ast.Compare) and all(
                        isinstance(op, (ast.Is, ast.IsNot))
                        for op in parent.ops):
                    continue      # `self._ks is not None` — identity only
                if isinstance(parent, ast.Call) and parent.func is n:
                    continue      # calling it — not a tensor read
                findings.append(Finding(
                    "read-of-inplace-buffer", path, n.lineno,
                    f"{cls.name}.{name} reads self.{attr}, which "
                    f"{'/'.join(sorted(inplace[attr]))} writes IN PLACE on "
                    f"every dispatch: off the step path the read races "
                    f"the step's queued writes (a torn pool) and its "
                    f"readback waits behind them; read a host mirror or "
                    f"build-time constant, hold the lock every dispatch "
                    f"holds, or suppress with the step-boundary rationale"))
    return findings


# -- torn-snapshot ------------------------------------------------------------

def _guarded_attrs(cls: ast.ClassDef, locks: Set[str]) -> Dict[str, Set[str]]:
    """lock attr -> self attrs WRITTEN under it (the astlint pass-1
    signal, recomputed here so the two passes cannot drift apart on
    import order)."""
    guarded: Dict[str, Set[str]] = {lk: set() for lk in locks}

    def written_attr(node: ast.AST) -> Optional[str]:
        attr = _self_attr(node)
        if attr is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
            return attr
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            return _self_attr(node.value)
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            return _self_attr(node.func.value)
        return None

    for node in ast.walk(cls):
        if not isinstance(node, ast.With):
            continue
        held = {_self_attr(item.context_expr) for item in node.items}
        held &= locks
        if not held:
            continue
        for inner in _walk_shallow(node):
            attr = written_attr(inner)
            if attr and attr not in locks:
                for lk in held:
                    guarded[lk].add(attr)
    return guarded


def _check_torn_snapshot(path: str, tree: ast.Module) -> List[Finding]:
    findings: List[Finding] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks, _ = _lock_attrs_of_class(cls)
        if not locks:
            continue
        guarded = _guarded_attrs(cls, locks)
        for m in cls.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if m.name == "__init__" or m.name.endswith("_locked"):
                continue
            # with-blocks per lock, NOT descending into nested defs.
            per_lock: Dict[str, List[ast.With]] = {}
            for node in _walk_shallow(m):
                if not isinstance(node, ast.With):
                    continue
                for item in node.items:
                    lk = _self_attr(item.context_expr)
                    if lk in locks:
                        per_lock.setdefault(lk, []).append(node)
            for lk, blocks in per_lock.items():
                if len(blocks) < 2:
                    continue
                touching = []
                for blk in sorted(blocks, key=lambda b: b.lineno):
                    # Reads only — and a Load that is merely the receiver
                    # of a mutating call (`self._x.discard(k)`) is the
                    # write-back half of check-then-act, not a snapshot
                    # read.
                    mut_receivers = {
                        id(n.func.value) for n in _walk_shallow(blk)
                        if isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr in _MUTATORS}
                    attrs = {a for n in _walk_shallow(blk)
                             for a in [_self_attr(n)]
                             if a and isinstance(n.ctx, ast.Load)
                             and id(n) not in mut_receivers
                             } & guarded.get(lk, set())
                    if attrs:
                        touching.append((blk, attrs))
                distinct = set().union(*(a for _, a in touching)) \
                    if touching else set()
                # The torn-SNAPSHOT class is a multi-gauge read split
                # across acquisitions. One attr across two blocks is the
                # idiomatic check-then-act / fill-cache shape (compute
                # outside the lock, write back) — a different, sound
                # pattern.
                if len(touching) >= 2 and len(distinct) >= 2:
                    blk, attrs = touching[1]
                    first = touching[0][0].lineno
                    findings.append(Finding(
                        "torn-snapshot", path, blk.lineno,
                        f"{cls.name}.{m.name} drains/reads "
                        f"{sorted(attrs)} under a SECOND acquisition of "
                        f"self.{lk} (first at line {first}): the two "
                        f"blocks observe different instants — a scrape "
                        f"between them pairs this step's gauges with "
                        f"last step's; take ONE lock snapshot (the "
                        f"exporter torn-read class)"))
    return findings


# -- entry points -------------------------------------------------------------

def lint_lockorder_source(path: str, source: str,
                          tree: Optional[ast.Module] = None,
                          ) -> List[Finding]:
    """``tree`` lets run_fast_passes share ONE ast.parse per file across
    the AST and lock-order passes."""
    if tree is None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            return []      # astlint already reports the syntax error
    findings = (_check_lock_order(path, tree)
                + _check_inplace_reads(path, tree)
                + _check_torn_snapshot(path, tree))
    return apply_suppressions(findings, parse_suppressions(source))

