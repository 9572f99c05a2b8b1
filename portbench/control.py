"""The readings that the limits of ``correct`` are set from, on the chip at
a cell's own size: the control (the reference in float8, put in the
program's place) and the faults a cell can have, beside the program's own
readings, for several seeds in one process (``control`` of the cell's
loop, ``loops/<kind>.py``).

    python -m portbench.control --workload <cell> --seeds 1,2,3

One JSON line a seed."""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from . import cell as cells
from .reference.model import precise
from .run import pin_caches


def main() -> None:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    pin_caches(Path.cwd())
    cell = cells.load(args.workload)
    loop = cells.loop(cell.mix["kind"])
    dev = torch.device("cuda", 0)
    precise()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(loop.control(cell, seed, dev)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
