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
its template the same way).

Onto another mesh or layout (another shape, a ``pp`` axis's stages, or
no mesh; and a one-card step onto a mesh), a Llama ``(model, optimizer)``
pair is restored block by block: the coordinates in each saved file say
which block of each leaf that rank held (``models.llama.rank_layout``),
and the new rank copies, from the files whose blocks overlap its own,
the parts of every parameter and of its AdamW moments that it holds,
keyed by the parameter's name in the whole model (a stage's optimizer
lists fewer parameters than a whole model's). The copies are exact, so
the restored state is the saved one bit for bit. The optimizer must list
the model's parameters in their order, as ``make_optimizer`` does.
"""
from __future__ import annotations

import json
import logging
import math
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

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

    def _committed(self, step: int) -> bool:
        """A one-card state file or a sharded step's commit is there."""
        d = os.path.join(self._dir, str(step))
        return any(os.path.isfile(os.path.join(d, m))
                   for m in (_FILE, _COMMIT))

    # -- save --------------------------------------------------------------
    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Synchronous save of ``state`` as step ``step``; returns whether a
        save was made (a step already on disk is kept unless ``force``).
        Sharded: every rank returns once rank 0 has committed the step."""
        step = int(step)
        step_dir = os.path.join(self._dir, str(step))
        if self._committed(step) and not force:
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
                      if d.isdigit() and self._committed(int(d)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """The state saved at ``step`` (default: latest), loaded into the
        objects of ``like`` when given (and returned), else the saved
        state dicts by name, on the CPU. A step saved on another mesh or
        layout is restored into ``like``'s Llama ``(model, optimizer)``
        block by block (see the module's docstring); a leaf this mesh
        cannot tile raises ``ValueError`` naming it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        step = int(step)
        objs = None if like is None else _named(like)
        saved = self._saved_mesh(step)
        here = None if self._mesh is None else self._mesh.sizes
        if saved != here:
            if objs is None:
                raise ValueError(
                    f"step {step} was saved on a mesh of {saved}, this one "
                    f"is {here}: restoring it onto another mesh needs "
                    f"like=(model, optimizer)")
            _restore_across(self._files(step), objs, self._mesh)
            return like
        path = (os.path.join(self._dir, str(step), _FILE)
                if self._mesh is None else self._rank_file(step))
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

    def _saved_mesh(self, step: int) -> Optional[Dict[str, int]]:
        """The axis sizes of the mesh that saved ``step``; None for one
        card."""
        commit = os.path.join(self._dir, str(step), _COMMIT)
        if not os.path.isfile(commit):
            return None
        with open(commit) as fh:
            return json.load(fh)["mesh"]

    def _files(self, step: int) -> List[str]:
        d = os.path.join(self._dir, str(step))
        commit = os.path.join(d, _COMMIT)
        if not os.path.isfile(commit):
            return [os.path.join(d, _FILE)]
        with open(commit) as fh:
            ranks = json.load(fh)["ranks"]
        return [os.path.join(d, f"rank-{r}.pt") for r in range(ranks)]

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


def _restore_across(paths: List[str], objs: Dict[str, Any], mesh) -> None:
    """Restore the step whose files are ``paths`` into ``objs``' Llama
    model and optimizer on ``mesh`` (a ``MeshAxes``, or None for one
    card): each parameter and its AdamW moments assembled from the saved
    blocks that overlap this rank's block of the leaf."""
    from ..models.llama import rank_layout

    if set(objs) != set(_PAIR):
        raise ValueError(f"restoring onto another mesh takes a (model, "
                         f"optimizer) pair, got {sorted(objs)}")
    model, opt = objs["model"], objs["opt"]
    params = list(model.parameters())
    if len(opt.param_groups) != 1 or len(opt.param_groups[0]["params"]) \
            != len(params) or any(a is not b for a, b in zip(
                opt.param_groups[0]["params"], params)):
        raise ValueError("the optimizer must hold one group of the model's "
                         "parameters in their order (make_optimizer)")
    sizes, index = (mesh.sizes, mesh.index) if mesh is not None else ({}, {})
    mine = rank_layout(model.cfg, sizes, index)
    held = []                      # (doc, whole name -> (name, region, i))
    for path in paths:
        doc = torch.load(path, map_location="cpu", mmap=True,
                         weights_only=True)
        meta = doc.get("mesh", {"sizes": {}, "index": {}})
        order = {name: i for i, name in enumerate(doc["model"])}
        held.append((doc, {whole: (name, region, order[name])
                           for name, (whole, region) in rank_layout(
                               model.cfg, meta["sizes"],
                               meta["index"]).items()}))

    def assemble(whole, region, get):
        """The ``region`` of leaf ``whole``, from every saved block that
        overlaps it (each distinct block once: replicas are equal)."""
        out, seen, covered = None, set(), 0
        for doc, table in held:
            if whole not in table:
                continue
            name, theirs, i = table[whole]
            key = tuple((r.start, r.stop) for r in theirs)
            cut = [(max(a.start, b.start), min(a.stop, b.stop))
                   for a, b in zip(region, theirs)]
            if key in seen or any(lo >= hi for lo, hi in cut):
                continue
            seen.add(key)
            src = get(doc, name, i)
            if src is None:
                return None
            if out is None:
                out = torch.empty([r.stop - r.start for r in region],
                                  dtype=src.dtype)
            out[tuple(slice(lo - a.start, hi - a.start)
                      for (lo, hi), a in zip(cut, region))] = src[tuple(
                          slice(lo - b.start, hi - b.start)
                          for (lo, hi), b in zip(cut, theirs))]
            covered += math.prod(hi - lo for lo, hi in cut)
        if out is None or covered != out.numel():
            raise ValueError(f"leaf {whole}: the saved blocks cover "
                             f"{covered} of this rank's elements")
        return out

    def moment(key):
        def get(doc, name, i):
            st = doc["opt"]["state"].get(i)
            return None if st is None else st[key]
        return get

    def step_of(whole):
        """The step count of the first saved rank holding ``whole``."""
        doc, (_, _, i) = next((d, t[whole]) for d, t in held if whole in t)
        return doc["opt"]["state"][i]["step"].clone()

    weights, state = {}, {}
    order = {name: j for j, (name, _) in enumerate(model.named_parameters())}
    for name, (whole, region) in mine.items():
        j = order[name]
        weights[name] = assemble(whole, region,
                                 lambda doc, n, i: doc["model"][n])
        avg = assemble(whole, region, moment("exp_avg"))
        if avg is not None:
            state[j] = {"step": step_of(whole),
                        "exp_avg": avg,
                        "exp_avg_sq": assemble(whole, region,
                                               moment("exp_avg_sq"))}
    template = opt.state_dict()
    saved_group = held[0][0]["opt"]["param_groups"][0]
    template["param_groups"][0].update(
        {k: v for k, v in saved_group.items() if k != "params"})
    template["state"] = state
    with torch.no_grad():
        model.load_state_dict(weights)
    opt.load_state_dict(template)
