"""Training checkpoint and resume (port of the JAX package's
``utils/checkpoint.py``).

    ckpt = TrainCheckpointer(dir, max_to_keep=3)
    step, (model, opt) = ckpt.restore_or(lambda: (model, opt))
    ...
    ckpt.maybe_save(step, (model, opt), every=100)

The JAX checkpointer is orbax's asynchronous manager; this one is
synchronous: ``save`` returns once ``torch.save`` of
``{"model": model.state_dict(), "opt": optimizer.state_dict()}`` has
landed in ``<dir>/<step>/state.pt``. The file is written under a
temporary name and moved into place with ``os.replace``, so a reader (or
a process killed mid-save) never sees half a checkpoint. The newest
``max_to_keep`` step directories are kept, as orbax keeps them.

A state is a ``(model, optimizer)`` pair, or a mapping of names to
objects with ``state_dict``/``load_state_dict``. ``restore`` loads the
saved dicts into the objects of ``like`` (tensors mapped onto the device
of ``like``'s first parameter) and returns ``like``; without ``like`` it
returns the saved dicts on the CPU.
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Callable, Dict, Optional, Tuple

import torch

log = logging.getLogger(__name__)

_FILE = "state.pt"
_PAIR = ("model", "opt")


def _named(state: Any) -> Dict[str, Any]:
    """The state's objects by name: a ``(model, optimizer)`` pair becomes
    ``{"model": ..., "opt": ...}``; a mapping is taken as it is."""
    if isinstance(state, dict):
        return dict(state)
    if isinstance(state, (tuple, list)) and len(state) == len(_PAIR):
        return dict(zip(_PAIR, state))
    raise TypeError(f"a checkpoint state is a (model, optimizer) pair or a "
                    f"mapping of names to objects, got {type(state)}")


def _device_of(objs: Dict[str, Any]) -> torch.device:
    for obj in objs.values():
        if isinstance(obj, torch.nn.Module):
            for p in obj.parameters():
                return p.device
    return torch.device("cpu")


class TrainCheckpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self._dir = str(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self._dir, exist_ok=True)

    # -- save --------------------------------------------------------------
    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Synchronous save of ``state`` as step ``step``; returns whether a
        save was made (a step already on disk is kept unless ``force``)."""
        step = int(step)
        step_dir = os.path.join(self._dir, str(step))
        if os.path.isfile(os.path.join(step_dir, _FILE)) and not force:
            return False
        doc = {name: obj.state_dict() for name, obj in _named(state).items()}
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, _FILE + ".tmp")
        with open(tmp, "wb") as fh:
            torch.save(doc, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(step_dir, _FILE))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)),
                          ignore_errors=True)
        return True

    def maybe_save(self, step: int, state: Any, every: int = 100) -> bool:
        if every <= 0 or step % every:
            return False
        return self.save(step, state)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> list:
        """The saved steps, ascending."""
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(d) for d in os.listdir(self._dir)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self._dir, d, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """The state saved at ``step`` (default: latest), loaded into the
        objects of ``like`` when given (and returned), else the saved
        state dicts by name, on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        objs = None if like is None else _named(like)
        doc = torch.load(os.path.join(self._dir, str(int(step)), _FILE),
                         map_location=(torch.device("cpu") if objs is None
                                       else _device_of(objs)),
                         weights_only=True)
        if objs is None:
            return doc
        if set(doc) != set(objs):
            raise ValueError(f"checkpoint holds {sorted(doc)}, the state "
                             f"to restore into has {sorted(objs)}")
        for name, obj in objs.items():
            obj.load_state_dict(doc[name])
        return like

    def restore_or(self, init_fn: Callable[[], Any]) -> Tuple[int, Any]:
        """(step, state): the latest checkpoint loaded into ``init_fn()``'s
        objects if one exists, else ``(0, init_fn())`` — the
        elastic-restart entry point."""
        step = self.latest_step()
        init = init_fn()
        if step is None:
            return 0, init
        log.info("resuming from checkpoint step %d under %s", step, self._dir)
        return step, self.restore(step, like=init)

    def wait(self) -> None:
        """Nothing to wait for: every save has landed when it returns."""

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
