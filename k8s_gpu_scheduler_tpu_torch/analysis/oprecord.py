"""The op recorder: every aten op, allocation and host transfer of one call.

The port's counterpart of what ``jax.make_jaxpr`` gives the JAX package's
audits. Eager PyTorch has no traced program, so the recorder runs the
call once under a ``TorchDispatchMode`` and keeps, for every aten op:

- its name, and its tensor inputs' and outputs' shapes, dtypes, devices;
- for each output, whether it ALLOCATED new storage, or is a view or an
  in-place target of an input (``copy_``, ``index_put_``, the pool's
  update chain);
- which earlier ops' outputs it read (``reads``), and whether autograd's
  backward ran it (``backward``: the train step's backward ops are the
  step's);
- each allocated output's liveness: the op it was made by and the op
  count at which its storage was freed (a ``weakref.finalize`` on the
  storage), or None when it outlives the call.

Kernel wrappers (K1–K4 and ``flash_forward``/``flash_backward``, which run
K5 and K6 + K7) are leaves: one op each, named after the wrapper, with no
recording inside (``ops/_leaf.py``), so a record made on the card (the
kernels) and one made on the CPU (their plain versions) agree op for op.
A leaf notes the kernel launches and plain-version calls it made
(``launched``).

Host transfers are kept apart from the ops (``transfers``), with their
bytes and the ``file:line`` that made them, in the same form on both
devices:

- an *upload* is ``torch.as_tensor``/``tensor``/``asarray`` of host data
  (numpy, Python values) with an explicit ``device=`` that is the
  record's device, or a copy into a tensor of the record's device from a
  host tensor (``torch.from_numpy``, or any CPU tensor on the card);
- a *readback* is ``.tolist()``, ``.numpy()``, ``.cpu()``/``.to("cpu")``
  (of a tensor on the record's device), a device→host copy, or
  ``_local_scalar_dense`` (``.item()``, ``int(t)``...).

The ops inside such a call (``lift_fresh``, the copy itself) are not
recorded as ops: on the CPU an upload is often no op at all, and the
records of the two devices would part.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..ops import _leaf

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_TORCH_DIR = os.path.dirname(torch.__file__)
_SKIP = (_TORCH_DIR, os.path.abspath(__file__))

_COPIES = {"aten._to_copy.default", "aten.copy_.default"}
_SCALAR_READ = "aten._local_scalar_dense.default"
# A tensor made from Python data inside torch (``t[i] = 3`` makes one on
# the host): host data on both devices.
_LIFT = "aten.lift_fresh.default"
_HOST_DATA = {"as_tensor", "tensor", "asarray"}
_FACTORIES = {"empty", "zeros", "ones", "full", "arange", "rand", "randn",
              "randint", "randperm", "linspace", "eye"}
_READBACKS = {"tolist", "numpy", "cpu", "to"}


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    shape: Tuple[int, ...]
    dtype: str
    device: str

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * _itemsize(self.dtype)

    def key(self) -> Tuple[Tuple[int, ...], str]:
        """What two devices' records compare: shape and dtype."""
        return self.shape, self.dtype


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(tuple(int(d) for d in t.shape),
                      str(t.dtype).replace("torch.", ""), t.device.type)


@dataclasses.dataclass
class Op:
    index: int
    name: str
    leaf: bool
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    allocated: Tuple[bool, ...]          # per output: new storage
    reads: Tuple[int, ...]               # ops whose outputs it took
    backward: bool = False
    launched: Dict[str, int] = dataclasses.field(default_factory=dict)
    ext_keys: Tuple[int, ...] = ()       # storage ids of inputs made
                                         # outside the call

    def signature(self) -> tuple:
        return (self.name, tuple(m.key() for m in self.inputs),
                tuple(m.key() for m in self.outputs))


@dataclasses.dataclass
class Transfer:
    kind: str                   # "upload" or "readback"
    via: str                    # the call or op that made it
    meta: TensorMeta
    site: str                   # file:line in the repo

    @property
    def nbytes(self) -> int:
        return self.meta.nbytes


@dataclasses.dataclass
class Alloc:
    op: int                     # the op whose output it is
    meta: TensorMeta
    nbytes: int                 # the storage's bytes
    died: Optional[int] = None  # op count when freed; None: outlived it
    read: bool = False          # a later op took it


@dataclasses.dataclass
class Record:
    device: str
    ops: List[Op] = dataclasses.field(default_factory=list)
    transfers: List[Transfer] = dataclasses.field(default_factory=list)
    allocs: List[Alloc] = dataclasses.field(default_factory=list)

    def signature(self) -> List[tuple]:
        return [op.signature() for op in self.ops]

    def uploads(self) -> List[Transfer]:
        return [t for t in self.transfers if t.kind == "upload"]

    def readbacks(self) -> List[Transfer]:
        return [t for t in self.transfers if t.kind == "readback"]

    def leaves(self) -> List[Op]:
        return [op for op in self.ops if op.leaf]

    def launched(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.leaves():
            for k, n in op.launched.items():
                out[k] = out.get(k, 0) + n
        return out

    def peak_live(self, select: Callable[[Alloc], bool] = lambda a: True
                  ) -> Tuple[int, int]:
        """(peak bytes of the selected allocations live at once, the op
        index it was reached at)."""
        n = len(self.ops)
        events: Dict[int, int] = {}
        for a in self.allocs:
            if select(a):
                events[a.op] = events.get(a.op, 0) + a.nbytes
                end = n if a.died is None else a.died
                events[end] = events.get(end, 0) - a.nbytes
        live = peak = 0
        at = -1
        for t in sorted(events):
            live += events[t]
            if live > peak:
                peak, at = live, t
        return peak, at


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _site() -> str:
    """``file:line`` of the innermost frame outside torch and this
    module."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if not path.startswith(_SKIP) and "<" not in path:
            return f"{os.path.relpath(path, _ROOT)}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _from_torch() -> bool:
    """Whether the torch function being handled was called from torch's
    own code (an optimizer's host bookkeeping), not the repo's."""
    f = sys._getframe(2)
    return os.path.abspath(f.f_code.co_filename).startswith(_TORCH_DIR)


def _launch_counts() -> Dict[str, int]:
    from ..ops.decode_attention import counters as decode_counters
    from ..ops.flash_attention import counters as flash_counters

    return {**decode_counters(), **flash_counters()}


class _Dispatch(TorchDispatchMode):
    def __init__(self, rec: "OpRecorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.rec._on_op(func, args, kwargs, out)
        return out


class _Function(TorchFunctionMode):
    def __init__(self, rec: "OpRecorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        rec = self.rec
        if name in _HOST_DATA and args and not isinstance(
                args[0], torch.Tensor):
            with rec._quiet():
                out = func(*args, **kwargs)
            dev = kwargs.get("device")
            if dev is not None and torch.device(dev).type == rec.device \
                    and not _from_torch():
                rec._transfer("upload", name, out)
            else:
                rec._mark_host(out)
            return out
        if name in _FACTORIES and kwargs.get("device") is None:
            out = func(*args, **kwargs)          # no device=: host data
            rec._mark_host(out)
            return out
        if name == "from_numpy":
            with rec._quiet():
                out = func(*args, **kwargs)
            rec._mark_host(out)
            return out
        if name in _READBACKS and args and isinstance(args[0], torch.Tensor):
            t = args[0]
            if name == "cpu":
                dst = "cpu"
            elif name == "to":
                dst = next((torch.device(a).type for a in
                            list(args[1:]) + [kwargs.get("device")]
                            if isinstance(a, (str, torch.device))), None)
            else:                            # tolist, numpy: never up
                dst = "host"
            host = rec._is_host(t)
            kind = ("upload" if host and dst == rec.device else
                    "readback" if not host and dst in ("cpu", "host")
                    and t.device.type == rec.device else None)
            if kind is not None:
                with rec._quiet():
                    out = func(*args, **kwargs)
                if kind == "upload":
                    rec._transfer(kind, name, out)
                else:
                    rec._transfer(kind, name, t)
                return out
        return func(*args, **kwargs)


class _Quiet:
    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        self.rec._quiet_depth += 1

    def __exit__(self, *exc):
        self.rec._quiet_depth -= 1


class OpRecorder:
    """``with OpRecorder(device) as rec: fn(...)``; then ``rec.record``.
    ``device`` is the record's device type ("cpu" or "cuda"): uploads go
    to it, readbacks leave it."""

    def __init__(self, device):
        self.device = torch.device(device).type
        self.record = Record(self.device)
        self._live: Dict[int, Alloc] = {}     # storage id -> allocation
        self._fin: List[weakref.finalize] = []
        self._host: set = set()               # storage ids of live host
                                              # data
        self._leaf_depth = 0
        self._quiet_depth = 0
        self._closed = False
        self._modes = (_Function(self), _Dispatch(self))
        self._old_hook = None

    # -- context ------------------------------------------------------------
    def __enter__(self) -> "OpRecorder":
        self._old_hook = _leaf.set_hook(self._leaf)
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        for m in reversed(self._modes):
            m.__exit__(*exc)
        _leaf.set_hook(self._old_hook)
        self._closed = True
        for f in self._fin:
            f.detach()
        self._fin.clear()
        self._live.clear()

    def _quiet(self) -> _Quiet:
        return _Quiet(self)

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return id(t.untyped_storage())

    # -- what the modes report ------------------------------------------------
    def _transfer(self, kind: str, via: str, t: torch.Tensor) -> None:
        self.record.transfers.append(Transfer(kind, via, meta(t), _site()))

    def _freed(self, key: int, alloc: Alloc) -> None:
        if self._closed:
            return
        alloc.died = len(self.record.ops)
        if self._live.get(key) is alloc:
            del self._live[key]

    def _on_op(self, func, args, kwargs, out) -> None:
        if self._quiet_depth:
            return
        name = str(func)
        if name == _SCALAR_READ:
            if not self._is_host(args[0]):
                self._transfer("readback", "_local_scalar_dense", args[0])
            return
        ins = _tensors((args, kwargs))
        if name == _LIFT or ins and all(self._is_host(t) for t in ins):
            for t in _tensors(out):          # host work on host data
                self._mark_host(t)
            return
        if name == "aten.copy_.default" and self._is_host(args[1]):
            self._transfer("upload", "copy_", args[0])
            return
        if name in _COPIES:
            src = args[1] if name == "aten.copy_.default" else args[0]
            dst = args[0] if name == "aten.copy_.default" else out
            if dst.device.type == "cpu" and src.device.type != "cpu":
                self._transfer("readback", name.split(".")[1], src)
                return
        if self._leaf_depth:
            return
        self._add(name, False, ins, _tensors(out))

    def _mark_host(self, t: torch.Tensor) -> None:
        """Note ``t``'s storage as host data until it is freed: a storage
        made later may get the freed one's id."""
        st = t.untyped_storage()
        k = id(st)
        if k not in self._host:
            self._host.add(k)
            self._fin.append(weakref.finalize(st, self._host.discard, k))

    def _is_host(self, t: torch.Tensor) -> bool:
        """Host data: on the card any CPU tensor; on the CPU a tensor made
        from host data (``from_numpy``, ``as_tensor`` with no device) or
        from such tensors only."""
        if self.device != "cpu":
            return t.device.type == "cpu"
        return self._key(t) in self._host

    def _add(self, name: str, leaf: bool, ins: List[torch.Tensor],
             outs: List[torch.Tensor], launched=None) -> None:
        rec = self.record
        index = len(rec.ops)
        in_keys = [self._key(t) for t in ins]
        reads, ext_keys = [], []
        for k in in_keys:
            a = self._live.get(k)
            if a is not None:
                a.read = True
                if a.op not in reads:
                    reads.append(a.op)
            else:
                ext_keys.append(k)
        allocated = []
        fresh = []
        for t in outs:
            k = self._key(t)
            new = k not in in_keys and k not in self._live
            allocated.append(new)
            if new:
                st = t.untyped_storage()
                fresh.append((k, st, Alloc(index, meta(t), int(st.nbytes()))))
        rec.ops.append(Op(
            index, name, leaf, tuple(meta(t) for t in ins),
            tuple(meta(t) for t in outs), tuple(allocated), tuple(reads),
            torch._C._current_autograd_node() is not None,
            dict(launched or {}), tuple(ext_keys)))
        for k, st, a in fresh:
            rec.allocs.append(a)
            self._live[k] = a
            self._fin.append(weakref.finalize(st, self._freed, k, a))

    def _leaf(self, name: str, fn, args, kwargs):
        if self._leaf_depth:
            return fn(*args, **kwargs)
        before = _launch_counts()
        self._leaf_depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._leaf_depth -= 1
        after = _launch_counts()
        self._add(name, True, _tensors((args, kwargs)), _tensors(out),
                  {k: n - before[k] for k, n in after.items()
                   if n != before[k]})
        return out


def record_call(fn: Callable, args=(), device="cpu", kwargs=None):
    """``(fn(*args, **kwargs), its Record)``. The result is returned so
    the caller holds it: an output it keeps is no dead output."""
    with OpRecorder(device) as rec:
        out = fn(*args, **(kwargs or {}))
    return out, rec.record


def first_difference(a: Record, b: Record) -> Optional[str]:
    """None when two records agree op for op in name, shape and dtype
    (uploads and readbacks aside); else where and how they part."""
    sa, sb = a.signature(), b.signature()
    for i, (x, y) in enumerate(zip(sa, sb)):
        if x != y:
            return f"op {i}: {x} != {y}"
    if len(sa) != len(sb):
        return (f"{len(sa)} ops against {len(sb)}; the longer goes on with "
                f"{(sa if len(sa) > len(sb) else sb)[min(len(sa), len(sb))]}")
    return None
