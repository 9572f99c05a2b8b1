"""AST lint — dispatch-body and lock-discipline rules, pure AST.

Two families of purely syntactic rules over the port's source:

**Dispatch-body rules.** A dispatch body is a function whose work the
card runs: the engine's five dispatches in ``models/serving.py`` and the
seven kernel wrappers in ``ops/`` (``entrypoints.DISPATCH_BODIES``). The
JAX package finds its traced bodies through the jax wrappers they are
passed to; eager PyTorch has no such wrapper, so the port lists its
bodies in a registry (a fixture lists its own in a top-level
``GRAFTCHECK_DISPATCH_BODIES`` tuple of names, read from the AST and
never executed). Nested defs of a body, and same-module functions a body
calls (to a fixpoint), are bodies too. Inside them:

- ``host-sync-in-dispatch``: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.to("cpu")``, ``.synchronize()`` (``torch.cuda.synchronize`` and
  the stream/event form), and ``int()``/``float()``/``bool()`` on a
  non-literal — each makes the host wait for the card, and none can be
  captured into a CUDA graph.
- ``host-time-in-dispatch``: ``time.time()`` and friends — a captured
  graph replays the capture's constant.
- ``numpy-in-dispatch``: ``np.*()`` calls — host math inside the
  dispatch, run once at capture and frozen thereafter.
- ``trace-in-dispatch`` (tracelint.py): span/tracer/flight calls.

**Repo-wide rules.**

- ``host-sync``: ``.synchronize()``, ``.item()``, ``.cpu()``,
  ``.to("cpu")`` and ``.tolist()`` anywhere in the package outside a
  dispatch body (those get the stronger finding above). Every sanctioned
  sync carries a ``# graftcheck: ignore[host-sync]`` with its rationale,
  so a NEW sync cannot enter a hot loop unreviewed. ``.numpy()`` of a
  CUDA tensor raises, so it needs no rule.
- ``bare-except`` and ``lock-guard``: the JAX package's rules, copied
  with their conventions: ``__init__`` is exempt (construction
  happens-before publication), methods named ``*_locked`` are exempt,
  thread-safe primitives are never considered guarded, and nested
  functions are treated as lock-NOT-held.
- ``unbounded-retry`` / ``blocking-io-under-lock``: retrylint.py.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import Finding, apply_suppressions, parse_suppressions

_LOCK_TYPES = {"Lock", "RLock", "Condition"}
# NOTE: threading.Thread is deliberately NOT here — the Thread object is
# thread-safe but rebinding a self._thread REFERENCE under a worker
# spawn/exit protocol is exactly the state a lock guards.
_THREADSAFE_TYPES = {
    "Event", "ThreadPoolExecutor", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue", "local",
}
# Receiver methods that mutate the receiver — a call under the lock marks
# the receiver attribute as lock-owned state.
_MUTATORS = {
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "add", "discard", "remove", "setdefault", "appendleft", "popleft",
    "heappush", "heappop",
}
_HOST_TIME_ATTRS = {"time", "perf_counter", "monotonic", "process_time",
                    "time_ns", "perf_counter_ns", "monotonic_ns"}
# Methods that read a tensor's values back to the host, or wait for the
# card.
_READBACK_ATTRS = {"item", "tolist", "cpu", "synchronize"}
# Top-level tuple of function names a file registers as dispatch bodies
# (the fixtures' opt-in).
DISPATCH_MARKER = "GRAFTCHECK_DISPATCH_BODIES"


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _walk_shallow(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested function/lambda
    bodies (those are linted as their own units)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


class _Scopes:
    """Name -> FunctionDef resolution through lexically enclosing scopes.
    Class bodies are not scope boundaries here: methods register in the
    enclosing module/function table (harmless for this lint's purposes)."""

    def __init__(self, tree: ast.Module) -> None:
        self.tables: Dict[int, Dict[str, ast.AST]] = {}
        self.parents: Dict[int, Optional[ast.AST]] = {}
        self._build(tree, None)

    def _build(self, scope: ast.AST, parent: Optional[ast.AST]) -> None:
        table: Dict[str, ast.AST] = {}
        self.tables[id(scope)] = table
        self.parents[id(scope)] = parent
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                table[n.name] = n
                self._build(n, scope)
            elif isinstance(n, ast.Lambda):
                self._build(n, scope)
            else:
                stack.extend(ast.iter_child_nodes(n))

    def resolve(self, scope: ast.AST, name: str) -> Optional[ast.AST]:
        cur: Optional[ast.AST] = scope
        while cur is not None:
            table = self.tables.get(id(cur), {})
            if name in table:
                return table[name]
            cur = self.parents.get(id(cur))
        return None


def _numpy_aliases(tree: ast.Module) -> Set[str]:
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    aliases.add(a.asname or "numpy")
    return aliases


def registered_bodies(path: str, tree: ast.Module) -> Set[str]:
    """Names of the module-level functions ``path`` registers as dispatch
    bodies: its ``entrypoints.DISPATCH_BODIES`` row (matched on the
    package-qualified path suffix) plus a fixture's top-level
    ``GRAFTCHECK_DISPATCH_BODIES`` tuple of string literals."""
    from .entrypoints import DISPATCH_BODIES

    p = path.replace(os.sep, "/")
    names: Set[str] = set()
    for rel, fns in DISPATCH_BODIES.items():
        if p.endswith("/" + rel) or p == rel:
            names.update(fns)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == DISPATCH_MARKER
                for t in node.targets) and isinstance(
                    node.value, (ast.Tuple, ast.List)):
            names.update(e.value for e in node.value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str))
    return names


def collect_dispatch_bodies(path: str, tree: ast.Module,
                            scopes: Optional[_Scopes] = None) -> Set[int]:
    """ids of FunctionDef/Lambda nodes that run inside a dispatch: the
    registered module-level functions, their nested defs, and the
    same-module functions they call (fixpoint)."""
    scopes = scopes or _Scopes(tree)
    enclosing: Dict[int, ast.AST] = {}

    def assign_scopes(node: ast.AST, scope: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            enclosing[id(child)] = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                assign_scopes(child, child)
            else:
                assign_scopes(child, scope)

    assign_scopes(tree, tree)
    bodies: Set[int] = set()
    queue: List[ast.AST] = []

    def mark(node: ast.AST) -> None:
        if id(node) not in bodies:
            bodies.add(id(node))
            queue.append(node)

    names = registered_bodies(path, tree)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in names:
            mark(node)
    i = 0
    while i < len(queue):
        fn = queue[i]
        i += 1
        for sub in _walk_shallow(fn):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                mark(sub)
            elif isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                target = scopes.resolve(
                    enclosing.get(id(sub), tree), sub.func.id)
                if target is not None:
                    mark(target)
    return bodies


def host_sync_label(node: ast.Call) -> Optional[str]:
    """A label when ``node`` reads device values back to the host (the
    ``host-sync`` set), else None."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _READBACK_ATTRS:
        return f".{func.attr}()"
    if func.attr == "to":
        cpu = [a for a in node.args if isinstance(a, ast.Constant)
               and a.value == "cpu"]
        cpu += [k for k in node.keywords if k.arg == "device"
                and isinstance(k.value, ast.Constant)
                and k.value.value == "cpu"]
        if cpu:
            return '.to("cpu")'
    return None


def _lint_dispatch_body(path: str, fn: ast.AST, np_aliases: Set[str],
                        fn_label: str) -> List[Finding]:
    out: List[Finding] = []
    for node in _walk_shallow(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _terminal_name(node.func)
        if isinstance(node.func, ast.Name) and name in ("int", "float",
                                                        "bool"):
            if node.args and not isinstance(node.args[0], ast.Constant):
                out.append(Finding(
                    "host-sync-in-dispatch", path, node.lineno,
                    f"{name}() on a non-literal inside dispatch body "
                    f"{fn_label}: on a device tensor the host waits for "
                    f"the card, and a captured graph freezes the value"))
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        base = node.func.value
        sync = host_sync_label(node)
        if isinstance(base, ast.Name) and base.id == "time" \
                and name in _HOST_TIME_ATTRS:
            out.append(Finding(
                "host-time-in-dispatch", path, node.lineno,
                f"time.{name}() inside dispatch body {fn_label}: a captured "
                f"graph replays the capture's timestamp; time the dispatch "
                f"on the host, around it"))
        elif isinstance(base, ast.Name) and base.id in np_aliases:
            out.append(Finding(
                "numpy-in-dispatch", path, node.lineno,
                f"{base.id}.{name}() inside dispatch body {fn_label}: host "
                f"numpy runs once at capture and is frozen thereafter; use "
                f"torch on the device"))
        elif sync:
            out.append(Finding(
                "host-sync-in-dispatch", path, node.lineno,
                f"{sync} inside dispatch body {fn_label}: the host waits "
                f"for the card mid-dispatch, and no CUDA graph can "
                f"capture it"))
    return out


def _lint_module_wide(path: str, tree: ast.Module,
                      bodies: Set[int]) -> List[Finding]:
    out: List[Finding] = []
    # Host-sync sites OUTSIDE dispatch bodies (those already got the
    # stronger host-sync-in-dispatch finding).
    ranges: List[Tuple[int, int]] = []
    for node in ast.walk(tree):
        if id(node) in bodies and hasattr(node, "lineno"):
            ranges.append(
                (node.lineno, getattr(node, "end_lineno", node.lineno)))

    def in_body(lineno: int) -> bool:
        return any(a <= lineno <= b for a, b in ranges)

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            out.append(Finding(
                "bare-except", path, node.lineno,
                "bare 'except:' swallows KeyboardInterrupt/SystemExit; "
                "catch Exception (or narrower)"))
        elif isinstance(node, ast.Call):
            label = host_sync_label(node)
            if label and not in_body(node.lineno):
                out.append(Finding(
                    "host-sync", path, node.lineno,
                    f"{label} is a host<->device sync point; sanctioned "
                    f"syncs carry '# graftcheck: ignore[host-sync]' with a "
                    f"rationale"))
    return out


# -- lock lint (the JAX package's rule, copied) -------------------------------

def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _lint_class_locks(path: str, cls: ast.ClassDef) -> List[Finding]:
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    locks: Set[str] = set()
    threadsafe: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            tname = _terminal_name(node.value.func)
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if tname in _LOCK_TYPES:
                    locks.add(attr)
                elif tname in _THREADSAFE_TYPES:
                    threadsafe.add(attr)
    if not locks:
        return []

    def lock_of_with(item: ast.withitem) -> Optional[str]:
        attr = _self_attr(item.context_expr)
        return attr if attr in locks else None

    # Pass 1: guarded set — self attrs WRITTEN inside `with self.<lock>`
    # (assignment, subscript store/del, or a known mutating method call).
    guarded: Dict[str, Set[str]] = {}          # attr -> {locks guarding it}

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

    def scan_with_blocks(node: ast.AST) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.With):
                continue
            held = {lk for item in sub.items
                    for lk in [lock_of_with(item)] if lk}
            if not held:
                continue
            # Shallow: a write inside a nested def/lambda under the
            # with-block runs LATER (usually on a worker thread).
            for inner in _walk_shallow(sub):
                attr = written_attr(inner)
                if attr and attr not in locks and attr not in threadsafe \
                        and attr not in methods:
                    guarded.setdefault(attr, set()).update(held)

    for m in methods.values():
        scan_with_blocks(m)
    if not guarded:
        return []

    # Pass 2: accesses of guarded attrs outside their lock.
    out: List[Finding] = []

    def check_body(nodes: Iterable[ast.AST], held: Set[str],
                   method_name: str) -> None:
        for node in nodes:
            if isinstance(node, ast.With):
                now = set(held)
                for item in node.items:
                    lk = lock_of_with(item)
                    if lk:
                        now.add(lk)
                check_body(ast.iter_child_nodes(node), now, method_name)
                continue
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # Closures run later, often on another thread: lock NOT held.
                check_body(ast.iter_child_nodes(node), set(), method_name)
                continue
            attr = _self_attr(node)
            if attr in guarded and not (guarded[attr] & held):
                out.append(Finding(
                    "lock-guard", path, node.lineno,
                    f"{cls.name}.{method_name} touches self.{attr} without "
                    f"holding {'/'.join(sorted(guarded[attr]))} (guards it "
                    f"elsewhere); hold the lock, rename the helper "
                    f"*_locked, or suppress with a rationale"))
            check_body(ast.iter_child_nodes(node), held, method_name)

    for name, m in methods.items():
        if name == "__init__" or name.endswith("_locked"):
            continue
        check_body(iter(m.body), set(), name)
    return out


# -- entry points -------------------------------------------------------------

def lint_source(path: str, source: str,
                tree: Optional[ast.Module] = None) -> List[Finding]:
    """``tree`` lets run_fast_passes share ONE ast.parse per file across
    the AST, lock-order and determinism passes."""
    if tree is None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return [Finding("syntax-error", path, e.lineno or 0,
                            str(e.msg))]
    from .findings import lint_suppressions
    from .retrylint import lint_retry
    from .tracelint import lint_trace_calls

    scopes = _Scopes(tree)
    bodies = collect_dispatch_bodies(path, tree, scopes)
    np_aliases = _numpy_aliases(tree)

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if id(node) in bodies and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            label = getattr(node, "name", "<lambda>")
            findings.extend(
                _lint_dispatch_body(path, node, np_aliases, label))
            findings.extend(
                lint_trace_calls(path, node, label, _walk_shallow))
        elif isinstance(node, ast.ClassDef):
            findings.extend(_lint_class_locks(path, node))
    findings.extend(_lint_module_wide(path, tree, bodies))
    findings.extend(lint_retry(path, tree))
    out = apply_suppressions(findings, parse_suppressions(source))
    # After the suppression filter: a bare marker must not vouch for
    # itself (suppression-policy lint, findings.py).
    out.extend(lint_suppressions(path, source))
    return out


def iter_python_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git", ".venv"))
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return out

