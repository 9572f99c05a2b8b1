"""A cell and everything its name leads to: its entry in ``BENCHMARK.json``,
``workloads/<cell>.json`` (the step's settings, the traced steps, the
limits of the comparison), ``configs/<config>.json`` (the model as run) and
``traffic/<mix>.json``, the loop ``loops/<kind>.py`` that the mix's
``kind`` names, and the metric readers ``metrics/<metric>.py`` that
``BENCHMARK.json`` assigns to it."""
from __future__ import annotations

import importlib
import importlib.util
import json
from types import ModuleType
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: Dict                    # configs/<config>.json
    mix: Dict                       # traffic/<mix>.json
    workload: Dict                  # workloads/<cell>.json
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    chips: int = 1


def _read(path: Path) -> Dict:
    return json.loads(path.read_text())


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = Path("."), base: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files under
    ``base`` (this folder); raises KeyError or FileNotFoundError when a
    piece is missing."""
    bench = _read(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name,
        config=_read(root / cfgs[entry["config"]]["file"]),
        mix=_read(base / "traffic" / f"{entry['traffic']}.json"),
        workload=_read(base / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        chips=int(entry["chips"]))


def reader(metric: str, base: Path = HERE) -> Callable:
    """``metrics/<metric>.py``'s ``read(ctx)``: the metric's value, or
    None where the run holds nothing for it to read."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop(kind: str) -> ModuleType:
    """``loops/<kind>.py``: the set-up, window and comparison of every
    cell whose traffic is of this kind."""
    return importlib.import_module(f"{__package__}.loops.{kind}")
