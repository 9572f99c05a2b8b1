"""Kernel wrappers as single ops of an op record.

A recording ``TorchDispatchMode`` (``analysis/oprecord.py``) sees every
aten op a dispatch runs, but not a kernel launched through ``ctypes``;
and on the CPU, where a wrapper calls its plain version, it would see
the plain version's ops (a dense page gather the kernel never makes).
``leaf_op`` makes each wrapper one op of the record on both devices: while
a recorder is installed (``set_hook``), the wrapper's call goes through
the hook, which runs it unrecorded and records its name, operands and
output. With no recorder the wrapper is called as it is.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

_HOOK: Optional[Callable] = None


def set_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install ``hook(name, fn, args, kwargs)`` (or None); returns the one
    it replaces."""
    global _HOOK
    old, _HOOK = _HOOK, hook
    return old


def leaf_op(fn: Callable) -> Callable:
    """Record ``fn`` as one leaf op under an installed hook."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        hook = _HOOK
        if hook is None:
            return fn(*args, **kwargs)
        return hook(fn.__name__, fn, args, kwargs)

    return wrapper
