"""The plain float32 reference against the port at tiny float32 sizes on
the CPU: three training steps, a part of the batch, and the float8
control."""
from __future__ import annotations

import torch

from portbench.check import train_gaps
from portbench.reference.train import follow, loss_and_grads
from portbench.tests.tiny import TRAIN, tiny_config
from portbench.traffic import train_batch
from portbench.weights import draw, draw_leaf, leaves, port_config, port_model


def test_three_training_steps_match_the_port(cpu):
    from k8s_gpu_scheduler_tpu_torch.models.llama import (
        make_optimizer, make_train_step)

    cfg, seed = tiny_config(), 5
    pcfg = port_config(cfg, attn_impl="flash", remat=True)
    model = port_model(pcfg, draw(cfg, seed, cpu))
    opt = make_optimizer(model, 3e-4)
    step = make_train_step(pcfg, None, opt)
    batches = [train_batch(TRAIN, seed, k, cfg["vocab_size"], cpu)
               for k in range(3)]
    losses = []
    for k, b in enumerate(batches):
        losses.append(float(step(model, b)))
        if k == 0:
            grad1 = {n: float(opt.state[p]["exp_avg"].norm()) / 0.1
                     for n, p in model.named_parameters()}
    change = {n: float((p.detach() - draw_leaf(cfg, seed, n, cpu)).norm())
              for n, p in model.named_parameters()}
    names = [n for n, _ in model.named_parameters()]
    want = follow(lambda n: draw_leaf(cfg, seed, n, cpu), names, cfg,
                  batches)
    gaps = train_gaps({"losses": losses, "grad1": grad1, "change": change},
                      want)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-4


def _params(cfg, seed, cpu):
    return {n: draw_leaf(cfg, seed, n, cpu).float().requires_grad_()
            for n, _, _ in leaves(cfg)}


def test_rows_take_the_mean_over_that_part(cpu):
    cfg = tiny_config()
    batch = train_batch(TRAIN, 3, 0, cfg["vocab_size"], cpu)
    a = _params(cfg, 2, cpu)
    half = loss_and_grads(a, cfg, batch, rows=slice(0, 2))
    b = _params(cfg, 2, cpu)
    alone = loss_and_grads(b, cfg, {k: v[:2] for k, v in batch.items()})
    assert half == alone
    assert torch.equal(a["lm_head"].grad, b["lm_head"].grad)
    whole = loss_and_grads(_params(cfg, 2, cpu), cfg, batch)
    assert abs(whole - half) > 1e-6


def test_fp8_control_departs(cpu):
    cfg = tiny_config()
    batch = train_batch(TRAIN, 4, 0, cfg["vocab_size"], cpu)
    exact = _params(cfg, 4, cpu)
    loss = loss_and_grads(exact, cfg, batch)
    low = _params(cfg, 4, cpu)
    loss8 = loss_and_grads(low, cfg, batch, lowp="fp8")
    assert 1e-6 < abs(loss8 - loss) / loss < 0.1
    g, g8 = exact["blocks.0.wq"].grad, low["blocks.0.wq"].grad
    rel = float((g8 - g).norm() / g.norm())
    assert 1e-3 < rel < 0.5
