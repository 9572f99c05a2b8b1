"""The metric readers against hand counts on a made-up run."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import readings as rd
from portbench import roofline as rf
from portbench.devtrace import DeviceTrace, Kernel

CFG = {"vocab_size": 1000, "hidden_size": 256, "intermediate_size": 512,
       "num_hidden_layers": 2, "num_attention_heads": 4,
       "num_key_value_heads": 2}


def test_union_busy_and_labelled_gaps():
    t = DeviceTrace(0.0, 5.0, [Kernel("a", 0.0, 1.0), Kernel("b", 0.5, 2.0),
                               Kernel("a", 3.0, 4.0), Kernel("c", 6.0, 7.0)])
    assert t.busy_s == pytest.approx(3.0)
    assert t.top_ops(2) == [["a", 2.0], ["b", 1.5]]
    gaps = t.idle_gaps([("step", 1.5, 3.5), ("tick", 2.2, 2.8),
                        ("wait", 4.0, 5.0)])
    assert dict((k, round(v, 6)) for k, v in gaps) == {"tick": 1.0,
                                                       "wait": 1.0}
    ctx = SimpleNamespace(trace=t)
    assert rd.device_idle(ctx) == pytest.approx(40.0)


def test_train_rate_and_mfu():
    ctx = SimpleNamespace(cfg=CFG, batch=2, seq=8,
                          steps=[(0.0, 1.0), (1.5, 2.5)])
    assert rd.train_tok_s(ctx) == pytest.approx(32 / 2.5)
    assert rd.train_mfu(ctx) == pytest.approx(
        100 * rf.train_token_flops(CFG, 8) * 32 / (2.0 * 989e12))


def test_flash_roofline_by_hand():
    kernels = [Kernel("void flash_fwd_mma_kernel<bf16, 64>", 0.0, 3e-6),
               Kernel("void flash_bwd_dq_mma_kernel<bf16>", 0.1, 0.1 + 2e-6),
               Kernel("void flash_bwd_dkv_mma_kernel<bf16>", 0.2, 0.2 + 5e-6),
               Kernel("nvjet_tst_gemm", 0.3, 0.4)]
    ctx = SimpleNamespace(cfg=CFG, batch=2, seq=64, traced_steps=3,
                          trace=DeviceTrace(0.0, 1.0, kernels))
    c = {k: rf.bound_s(v["bytes"], v["flops"])
         for k, v in rf.flash_costs(2, 64, 4, 2, 64).items()}
    one = 2 * (2 * c["flash_forward"] + c["flash_backward_dq"]
               + c["flash_backward_dkv"])
    assert rd.flash_roofline(ctx) == pytest.approx(100 * 3 * one / 1e-5)


def test_readers_find_nothing_without_their_run():
    ctx = SimpleNamespace(trace=None, steps=[], spans=[])
    assert rd.device_idle(ctx) is None
    assert rd.flash_roofline(ctx) is None
    assert rd.train_mfu(ctx) is None
    assert rd.train_tok_s(ctx) is None
    empty = SimpleNamespace(trace=DeviceTrace(0.0, 1.0), cfg=CFG, batch=2,
                            seq=64, traced_steps=1)
    assert rd.device_idle(empty) is None
    assert rd.flash_roofline(empty) is None
