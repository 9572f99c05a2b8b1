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

Sharded (``mesh=``, a mesh of more than one rank; every rank calls
``save`` and ``restore`` in step): each rank writes its own blocks to
``<dir>/<step>/rank-<r>.pt`` with the mesh's axis sizes and its
coordinates, all ranks meet at a barrier, and rank 0 commits the step by
writing ``<dir>/<step>/commit.json`` (the mesh's shape); only committed
steps count. A step restores onto the mesh that saved it, each rank
reading its own file, bit for bit (orbax restores onto the shardings of
its template the same way); another mesh is refused.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Callable, Dict, Optional, Tuple

import torch

log = logging.getLogger(__name__)

_FILE = "state.pt"
_COMMIT = "commit.json"
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


def _write(path: str, write) -> None:
    """``write(fh)`` into ``path`` under a temporary name, synced and
    moved into place."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        write(fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class TrainCheckpointer:
    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self._dir = str(directory)
        self.max_to_keep = int(max_to_keep)
        self._mesh = None
        if mesh is not None:
            from ..parallel.mesh import MeshAxes

            ax = MeshAxes.of(mesh)
            self._mesh = ax if ax.size() > 1 else None
        os.makedirs(self._dir, exist_ok=True)

    def _rank_file(self, step: int) -> str:
        import torch.distributed as dist

        return os.path.join(self._dir, str(step),
                            f"rank-{dist.get_rank()}.pt")

    def _marker(self) -> str:
        return _FILE if self._mesh is None else _COMMIT

    # -- save --------------------------------------------------------------
    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Synchronous save of ``state`` as step ``step``; returns whether a
        save was made (a step already on disk is kept unless ``force``).
        Sharded: every rank returns once rank 0 has committed the step."""
        step = int(step)
        step_dir = os.path.join(self._dir, str(step))
        if os.path.isfile(os.path.join(step_dir, self._marker())) \
                and not force:
            return False
        doc = {name: obj.state_dict() for name, obj in _named(state).items()}
        os.makedirs(step_dir, exist_ok=True)
        if self._mesh is None:
            _write(os.path.join(step_dir, _FILE),
                   lambda fh: torch.save(doc, fh))
        else:
            import torch.distributed as dist

            doc["mesh"] = {"sizes": self._mesh.sizes,
                           "index": self._mesh.index}
            _write(self._rank_file(step), lambda fh: torch.save(doc, fh))
            dist.barrier()
            if dist.get_rank() == 0:
                _write(os.path.join(step_dir, _COMMIT), lambda fh: fh.write(
                    json.dumps({"mesh": self._mesh.sizes,
                                "ranks": dist.get_world_size()}).encode()))
                self._prune()
            dist.barrier()
            return True
        self._prune()
        return True

    def _prune(self) -> None:
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)),
                          ignore_errors=True)

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
                          os.path.join(self._dir, d, self._marker())))

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
        path = os.path.join(self._dir, str(int(step)), _FILE)
        if self._mesh is not None:
            with open(os.path.join(self._dir, str(int(step)), _COMMIT)) as fh:
                saved = json.load(fh)["mesh"]
            if saved != self._mesh.sizes:
                raise NotImplementedError(
                    f"step {step} was saved on a mesh of {saved}, this one "
                    f"is {self._mesh.sizes}: restoring onto another mesh "
                    f"comes with the multi-device slice of restore across "
                    f"meshes (ROADMAP queue 1, 'Multi-device', remainder "
                    f"item 4)")
            path = self._rank_file(int(step))
        doc = torch.load(path,
                         map_location=(torch.device("cpu") if objs is None
                                       else _device_of(objs)),
                         weights_only=True)
        if self._mesh is not None and doc.pop("mesh")["index"] != \
                self._mesh.index:
            raise ValueError(f"{path} holds another rank's blocks")
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
