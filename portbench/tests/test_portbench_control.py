"""The control (the reference in float8, put in the program's place) and
the planted faults fail the comparison that a sound run passes: at a tiny
size on the CPU here, and with ``-m gpu`` through the card's kernels and
the traced run."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench.loops import train
from portbench.run import run_cell
from portbench.tests.tiny import train_cell

SEED = 2 ** 31 + 77
WORKLOADS = Path(__file__).resolve().parents[1] / "workloads"


def test_training_control_and_half_batch_fail(cpu):
    cell = train_cell()
    r = train.control(cell, SEED, cpu, seconds=1.0)
    lim = cell.workload["limits"]
    assert r["correct"]
    for fault in ("control_fp8", "half_batch"):
        assert any(r[fault][k] > lim[k] for k in lim), (fault, r[fault])


@pytest.mark.gpu
def test_traced_run_on_the_card(cuda_device):
    # bf16 at head size 64, the flash kernels' shapes, held to the
    # benchmark cell's own limits
    limits = json.loads((WORKLOADS / "mistral-7b.train.json").read_text()
                        )["limits"]
    cell = train_cell(limits, {"kind": "train", "batch": 2, "seq": 256},
                      torch_dtype="bfloat16", hidden_size=256,
                      intermediate_size=512)
    names = ("device_idle.train", "flash_roofline.train", "mfu.train")
    cell.per_layer = [{"name": n, "unit": "%"} for n in names]
    out = run_cell(cell, SEED, 2.0, True, cuda_device)
    assert out["correct"], out["checks"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert set(out["metrics"]) == set(names)
    assert 0 < out["metrics"]["flash_roofline.train"]["value"] <= 100
    assert out["breakdown"]["device_ops"]
