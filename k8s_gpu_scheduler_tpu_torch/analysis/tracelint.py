"""Trace-lint — the ``trace-in-dispatch`` rule.

The JAX package's ``trace-in-jit`` in the port's terms. The obs/ span
API is host-side by contract: a ``tracer.span(...)`` /
``tracer.record(...)`` / ``flight.record(...)`` call inside a dispatch
body reads the host clock between kernel launches, and a CUDA graph that
captures the dispatch would replay the capture's timestamps forever.
The right shape is the one the serving engine uses: time the *dispatch*
on the host, around it.

Detection is syntactic and runs inside the fast AST pass over the
dispatch bodies (astlint's registry and fixpoint). It flags

- attribute calls whose receiver name mentions a tracing object
  (``tracer``/``_tracer``/``trace``/``flight``/``obs``) and whose method
  is part of the span-API surface (``span``/``record``/``event``), and
- direct calls to functions named like span constructors
  (``span``, ``trace_span``, ``start_span``).

Receiver-name matching keeps the rule import-light (no type inference);
the names are the obs/ API's own. The seeded failing fixture is
tests/data/graftcheck_torch/bad_dispatch.py.
"""
from __future__ import annotations

import ast
from typing import List

from .findings import Finding

# Method names of the obs tracing surface (Tracer.span/record/event,
# FlightRecorder.record).
_SPAN_METHODS = {"span", "record", "event"}
# Receiver-name fragments that identify a tracing object.
_TRACE_RECEIVERS = ("tracer", "trace", "flight", "obs")
# Bare function names that construct spans.
_SPAN_FUNCS = {"span", "trace_span", "start_span"}


def _receiver_label(node: ast.AST) -> str:
    """Dotted-ish label of a call receiver: ``self._tracer`` ->
    ``self._tracer``, ``tr`` -> ``tr``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_trace_receiver(node: ast.AST) -> bool:
    leaf = _receiver_label(node).lower().rsplit(".", 1)[-1]
    return any(frag in leaf for frag in _TRACE_RECEIVERS)


def lint_trace_calls(path: str, fn: ast.AST, fn_label: str,
                     walk_shallow) -> List[Finding]:
    """Scan one dispatch body (shallow — nested defs are their own units,
    like the sibling dispatch-body rules) for span API calls.
    ``walk_shallow`` is astlint's traversal, passed in to keep one
    definition of 'the body'."""
    out: List[Finding] = []
    for node in walk_shallow(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _SPAN_METHODS \
                    and _is_trace_receiver(node.func.value):
                out.append(Finding(
                    "trace-in-dispatch", path, node.lineno,
                    f"{_receiver_label(node.func)}() inside dispatch body "
                    f"{fn_label}: a span read between kernel launches is "
                    f"frozen by graph capture and times the enqueue, not "
                    f"the card; time the dispatch on the host, around it"))
        elif isinstance(node.func, ast.Name) \
                and node.func.id in _SPAN_FUNCS:
            out.append(Finding(
                "trace-in-dispatch", path, node.lineno,
                f"{node.func.id}() inside dispatch body {fn_label}: trace "
                f"the host-side dispatch instead"))
    return out
