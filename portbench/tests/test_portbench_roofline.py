"""The yardstick's arithmetic against hand counts."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import roofline as rf
from portbench.weights import leaves

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name, **over):
    c = json.loads((CONFIGS / f"{name}.json").read_text())
    c.update(over)
    return c


def _count(cfg):
    n = 0
    for _, shape, _ in leaves(cfg):
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def test_parameter_counts():
    # Mistral-7B whole: 32 x 218,112,000 + 2 x 131,072,000 + 4,096
    assert _count(_cfg("mistral-7b-16l",
                       num_hidden_layers=32)) == 7_241_732_096
    assert _count(_cfg("mistral-7b-16l")) == 3_751_940_096


def test_active_parameters_by_hand():
    d, f, v = 4096, 14336, 32000
    attn = d * d + 2 * d * 1024 + d * d
    dense = _cfg("mistral-7b-16l")
    assert rf.active_matmul_params(dense) == 16 * (attn + 3 * d * f) + d * v


def test_train_token_flops():
    c = _cfg("mistral-7b-16l")
    p = rf.active_matmul_params(c)
    assert rf.train_token_flops(c, 2048) == 6 * p + 6 * 16 * 4096 * 2048
    # 22.5 GFLOP of model work a training token
    assert rf.train_token_flops(c, 2048) == pytest.approx(22.53e9, rel=1e-3)


def test_flash_costs_match_the_kernel_smoke_test():
    # chip_smoke phase 1, case train-8b (B 8, T 2048, H 32, Hkv 8, hd 128)
    c = rf.flash_costs(8, 2048, 32, 8, 128)
    assert c["flash_forward"] == {"bytes": 337641472, "flops": 275012124672}
    assert c["flash_backward_dq"] == {"bytes": 608174080,
                                      "flops": 412518187008}
    assert c["flash_backward_dkv"] == {"bytes": 406847488,
                                       "flops": 550024249344}
    one = rf.flash_step_bound_s(8, 2048, 32, 8, 128, 1)
    assert one == pytest.approx(2 * 275012124672 / 989e12
                                + (412518187008 + 550024249344) / 989e12)


def test_bound_takes_the_longer():
    assert rf.bound_s(3.35e12, 0) == 1.0
    assert rf.bound_s(0, 989e12) == 1.0
    assert rf.bound_s(3.35e12, 2 * 989e12) == 2.0
