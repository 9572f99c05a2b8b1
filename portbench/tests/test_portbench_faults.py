"""A run of a tiny cell on the CPU, through the harness's own path, comes
out correct; with the timed path broken underneath it comes out not
correct, once for each fault the cell can have."""
from __future__ import annotations

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.tiny import train_cell

SEED = 2 ** 31 + 4099


def test_sound_training_run_is_correct(cpu):
    out = run_cell(train_cell(), SEED, 1.0, False, cpu)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_tok_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_step_that_leaves_the_state_unchanged(cpu, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    out = run_cell(train_cell(), SEED, 1.0, False, cpu)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(cpu, monkeypatch):
    from k8s_gpu_scheduler_tpu_torch.models import llama

    orig = llama.loss_fn

    def half(model, batch, mesh=None):
        n = batch["tokens"].shape[0] // 2
        return orig(model, {k: v[:n] for k, v in batch.items()}, mesh)

    monkeypatch.setattr(llama, "loss_fn", half)
    out = run_cell(train_cell(), SEED, 1.0, False, cpu)
    assert not out["correct"]
