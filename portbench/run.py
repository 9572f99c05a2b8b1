"""One run of one cell of the port's benchmark.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Hands the cell to the loop of its traffic's kind (``loops/<kind>.py``),
which loads the kernels' library (the first run in a checkout builds it
into ``build/kernels/``), draws the weights on the card from ``--seed``,
warms up the cell's shapes, measures for ``--seconds`` and runs the
comparison that decides ``correct``; then prints one JSON line last on
standard output. ``--trace 1`` is a separate run that reports the cell's
per-layer metrics instead of its end-to-end ones, read from
``torch.profiler`` over a steady part of the window and from the loop's
host spans. Without a CUDA card, or with JAX loaded, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from . import cell as cells  # noqa: E402
from .reference.model import precise  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "k8s_gpu_scheduler_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def pin_caches(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ["USE_FLAX"] = "0"


def _read_metrics(wanted: List[Dict], ctx) -> Dict[str, Dict]:
    out = {}
    for m in wanted:
        v = cells.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: torch.device) -> Dict:
    """The run's result line (a dict) for ``cell`` on ``device``, by
    the loop of its mix's kind (``loops/<kind>.py``)."""
    precise()
    run = cells.loop(cell.mix["kind"]).run(cell, seed, seconds, trace,
                                           device)
    ctx = run["ctx"]
    ctx.setup_s = ctx.w0 - T_PROCESS
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = _read_metrics(wanted, ctx)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run["peak"]}
    out = {"correct": bool(run["correct"]), "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        labels = [(s.name, s.t0, s.t1) for s in ctx.spans] + list(ctx.host)
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                            "idle_gaps": ctx.trace.idle_gaps(labels, 10)}
    # readings the comparison takes but holds to no limit, then the
    # compared ones, last
    out["readings"] = run["readings"]
    out["checks"] = run["checks"]
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    pin_caches(root)
    cell = cells.load(args.workload, root)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    for name, v in out["readings"].items():
        print(f"reading {name}: {v!r} (no limit)", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
