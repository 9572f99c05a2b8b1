"""Retry-lint — unbounded retry loops and blocking I/O under locks.

A copy of the JAX package's pass, rule for rule. The dynamic half
(utils/retry.py's ``RetryPolicy``, the chaos harness in
testing/faults.py) makes failure handling *testable*; this pass makes the
two failure-handling anti-patterns *unwritable*:

- ``unbounded-retry``: a ``while True:`` loop containing an exception
  handler that SWALLOWS (no ``raise``/``return``/``break`` anywhere in
  the handler) — the shape that turns a dead control-plane dependency
  (registry restarting, recommender rolling) into a silently hung
  thread. A bounded loop always has a failure-path exit: a handler that
  re-raises once ``RetryPolicy.give_up`` says so, or returns a
  degraded answer. Only loop exits on the FAILURE path count — a
  ``return`` on the success path bounds nothing when the dependency
  stays dead.
- ``blocking-io-under-lock``: ``time.sleep`` or a blocking socket call
  (``connect``/``recv``/``accept``/``sendall``/``create_connection``)
  lexically inside a ``with self.<lock>:`` block. One thread's backoff
  nap (or un-timed-out dial) stalls every other thread's call for its
  whole duration — the registry client releases its lock across backoff
  sleeps for exactly this reason. ``Condition.wait`` is exempt (it
  releases the lock); ``*_locked`` helper bodies are the caller's
  responsibility, like the lock-guard rule.

Both rules are purely syntactic, import-light, and run in the fast
passes (the port's tier-1 clean gate,
tests/test_torch_graftcheck_clean.py). Its parity with the JAX pass is
held over the JAX package's seeded fixture
tests/data/graftcheck/bad_retry.py.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from .findings import Finding

_LOCK_TYPES = {"Lock", "RLock", "Condition"}
_BLOCKING_SOCKET_ATTRS = {
    "connect", "connect_ex", "recv", "recv_into", "recvfrom", "accept",
    "sendall", "create_connection",
}


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _is_while_true(node: ast.While) -> bool:
    test = node.test
    return isinstance(test, ast.Constant) and bool(test.value)


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    """True when no failure-path exit exists anywhere in the handler:
    no raise, no return, no break. (A conditional ``raise`` under a
    give_up/deadline check still counts as an exit — precision beats
    recall here; the rule exists to catch loops with NO bound at all.)"""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Return, ast.Break)):
            return False
    return True


def _lint_unbounded_retry(path: str, tree: ast.Module) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.While) and _is_while_true(node)):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Try):
                continue
            for handler in sub.handlers:
                if _handler_swallows(handler):
                    out.append(Finding(
                        "unbounded-retry", path, handler.lineno,
                        "'while True' retry loop swallows this exception "
                        "with no attempt bound or deadline on the failure "
                        "path — a dead dependency hangs the thread "
                        "forever; bound it with utils.retry.RetryPolicy "
                        "(attempts + backoff + deadline) and re-raise "
                        "when give_up() says so"))
    return out


def _walk_class(cls: ast.ClassDef) -> Iterable[ast.AST]:
    """Walk a class's own subtree (methods included) but stop at nested
    ClassDef boundaries: a nested class has its own ``self``, its own
    locks, and its own scan — pooling the two would cross-contaminate
    lock attrs and report its findings twice (once per enclosing
    class)."""
    stack = list(ast.iter_child_nodes(cls))
    while stack:
        n = stack.pop()
        if isinstance(n, ast.ClassDef):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _collect_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    locks: Set[str] = set()
    for node in _walk_class(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if _terminal_name(node.value.func) in _LOCK_TYPES:
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr is not None:
                        locks.add(attr)
    return locks


def _blocking_call(node: ast.Call) -> Optional[str]:
    """A human-readable label when ``node`` is a blocking call, else
    None. ``<cond>.wait`` is NOT here: Condition.wait releases the lock
    while it blocks — it is the correct way to wait under one."""
    func = node.func
    if isinstance(func, ast.Attribute):
        base = func.value
        if isinstance(base, ast.Name) and base.id == "time" \
                and func.attr == "sleep":
            return "time.sleep"
        if func.attr in _BLOCKING_SOCKET_ATTRS:
            return f".{func.attr}()"
    return None


def _walk_shallow(node: ast.AST) -> Iterable[ast.AST]:
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _lint_blocking_under_lock(path: str, cls: ast.ClassDef) -> List[Finding]:
    locks = _collect_lock_attrs(cls)
    if not locks:
        return []
    out: List[Finding] = []
    for node in _walk_class(cls):
        if not isinstance(node, ast.With):
            continue
        held = [a for item in node.items
                for a in [_self_attr(item.context_expr)] if a in locks]
        if not held:
            continue
        # Shallow: a sleep inside a nested def under the with-block runs
        # later, usually on another thread, without the lock.
        for inner in _walk_shallow(node):
            if isinstance(inner, ast.Call):
                label = _blocking_call(inner)
                if label:
                    out.append(Finding(
                        "blocking-io-under-lock", path, inner.lineno,
                        f"{label} while holding "
                        f"{'/'.join(sorted(held))}: every other thread's "
                        f"call stalls for the whole blocking window — "
                        f"release the lock across sleeps/dials (see "
                        f"registry/client.py's backoff), or use "
                        f"Condition.wait"))
    return out


def lint_retry(path: str, tree: ast.Module) -> List[Finding]:
    """Both retry-lint rules over one parsed module (suppressions are
    applied by the caller, astlint.lint_source)."""
    findings = _lint_unbounded_retry(path, tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_lint_blocking_under_lock(path, node))
    return findings
