"""The port's ResNet against the JAX package on the CPU, and its pod entry
point.

Weights come from the JAX ``init_params`` (NHWC/HWIO) through
``bridge.resnet_params_from_numpy`` (OIHW); images and labels from numpy
with a seed; f32, the tiny config (two stages of one bottleneck). Image
sizes: 32x32, where "SAME" pads the stride-2 stem, max pool and stage
conv asymmetrically (one more row and column at the end), 33x33, where
every pad is symmetric, and 30x37. Logits and losses agree to 1e-5
(largest seen 6.0e-8); after three ``optax.sgd(0.1, momentum=0.9)``
steps against ``torch.optim.SGD(lr=0.1, momentum=0.9)`` the losses agree
to 1e-5 relative and every weight to 1e-5 absolute (batch-statistics
gradients summed in another order, times lr 0.1 and the momentum's
running sum).

``main()`` runs at the tiny config in f32 (``ResNetConfig.resnet50``
patched; the full width runs on the card, ``chip_smoke.py`` phase 16)
until its third line."""
import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import resnet as jresnet
from k8s_gpu_scheduler_tpu_torch.bridge import resnet_params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models import resnet
from k8s_gpu_scheduler_tpu_torch.models.resnet import (
    ResNetConfig, forward, init_params, loss_fn, make_optimizer,
    make_train_step)
from test_torch_bert import run_main

LINE = re.compile(r"^resnet50 img/s=([\d.]+) loss=([\d.-]+) slo=([\d.]+) "
                  r"chips=(\S+)$")
SIZES = [(32, 32), (33, 33), (30, 37)]


def both(seed=0, B=4, size=(32, 32)):
    jcfg = dataclasses.replace(jresnet.ResNetConfig.tiny(), dtype=jnp.float32)
    cfg = dataclasses.replace(ResNetConfig.tiny(), dtype=torch.float32)
    params = jresnet.init_params(jcfg, jax.random.PRNGKey(seed))
    model = resnet_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                     "cpu")
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, *size, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, B)
    return ((params, jcfg, {"images": jnp.asarray(images),
                            "labels": jnp.asarray(labels)}),
            (model, cfg, {"images": torch.from_numpy(images),
                          "labels": torch.from_numpy(labels)}))


def test_config_matches_jax():
    for name in ("resnet50", "tiny"):
        j, t = getattr(jresnet.ResNetConfig, name)(), \
            getattr(ResNetConfig, name)()
        assert (t.stage_sizes, t.width, t.n_classes) == \
            (j.stage_sizes, j.width, j.n_classes)


def test_same_padding_is_xlas():
    for size in range(5, 40):
        for k, s in ((7, 2), (3, 2), (3, 1), (1, 2), (1, 1)):
            want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
            assert resnet._same_pad(size, k, s) == tuple(want), (size, k, s)


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_forward_and_loss_match_jax(size):
    (params, jcfg, jb), (model, _, tb) = both(size=size)
    want = np.asarray(jresnet.forward(params, jb["images"], jcfg))
    got = forward(model, tb["images"])
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    assert float(loss_fn(model, tb)) == pytest.approx(
        float(jresnet.loss_fn(params, jb, jcfg)), rel=1e-5)


def test_sgd_momentum_steps_match_optax():
    (params, jcfg, jb), (model, cfg, tb) = both(seed=1)
    jopt = optax.sgd(0.1, momentum=0.9)
    jstate = jopt.init(params)
    jstep = jresnet.make_train_step(jcfg, jopt)
    step = make_train_step(cfg, make_optimizer(model))
    for _ in range(3):
        params, jstate, jloss = jstep(params, jstate, jb)
        loss = step(model, tb)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    ref = resnet_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                   "cpu")
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_bf16_forward_tracks_f32():
    """The bf16 model (JAX's default dtype) on the same weights: finite
    logits near the f32 ones (random weights, two stages: within 0.1 of
    logits of magnitude about 1)."""
    (_, _, _), (model, cfg, tb) = both(seed=2, size=(33, 33))
    f32 = forward(model, tb["images"]).detach()
    bf = init_params(dataclasses.replace(cfg, dtype=torch.bfloat16),
                     torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for p, q in zip(bf.parameters(), model.parameters()):
            p.copy_(q.to(torch.bfloat16))
    got = forward(bf, tb["images"]).detach()
    assert torch.isfinite(got).all()
    assert (got - f32).abs().max() < 0.1


def test_init_params_from_generator_only():
    cfg = ResNetConfig.tiny()
    a, b = (init_params(cfg, torch.Generator().manual_seed(5), "cpu")
            for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q) and p.requires_grad, name
    w = a.stages[1][0].c2.float()
    assert float(w.std()) == pytest.approx(math.sqrt(2 / w[0].numel()),
                                           rel=0.2)
    assert a.stages[0][0].proj is not None
    assert a.stem.is_contiguous(memory_format=torch.channels_last)


def test_main_prints_the_jax_line_each_step(monkeypatch):
    tiny = dataclasses.replace(ResNetConfig.tiny(), dtype=torch.float32)
    monkeypatch.setattr(ResNetConfig, "resnet50", staticmethod(lambda: tiny))
    monkeypatch.setenv("SLO", "2")
    lines, published = run_main(resnet.main, monkeypatch)
    assert len(lines) == 3
    for line in lines:
        m = LINE.match(line)
        assert m and float(m.group(1)) > 0 and math.isfinite(
            float(m.group(2)))
        assert m.group(3) == "2.0" and m.group(4) == "?"
    # Published about once a second: the first step always.
    assert 1 <= len(published) <= 2 and published[0] > 0


def test_main_needs_a_card_unless_told_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.main()
