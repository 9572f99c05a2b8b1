"""The port's BERT-base encoder against the JAX package on the CPU, and
its pod entry point.

Weights come from the JAX ``init_params`` through
``bridge.bert_params_from_numpy``; tokens from numpy with a seed.
``encode`` and ``classify`` at f32 agree to 1e-5 absolute (largest seen
7.2e-7). In bf16 the two frameworks round the same operations but
sum matmul products in another order, so a value may move by a bf16 unit
at a LayerNorm's input and carry it on. That input (the residual sum)
reaches about 4, where a bf16 unit is 2^-5, and the LayerNorm divides by
a standard deviation near 1: hidden states agree to 2^-4 of max(|value|,
1), two such units (largest seen 0.0176 over seeds 2-4), the f32 logits
to 2^-6 of their largest magnitude (largest seen 0.0066).

``main()`` is driven at the tiny config (``BertConfig.base`` patched;
the full width runs on the card, ``chip_smoke.py`` phase 15) until its
third line."""
import dataclasses
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import bert as jbert
from k8s_gpu_scheduler_tpu_torch.bridge import bert_params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models import bert
from k8s_gpu_scheduler_tpu_torch.models.bert import (
    BertConfig, classify, encode, init_params, layer_norm)
from k8s_gpu_scheduler_tpu_torch.recommender import collector

LINE = re.compile(r"^bert-base qps=([\d.]+) slo=([\d.]+) chips=(\S+)$")


def both(dtype, seed=0, B=3, T=24):
    jcfg = dataclasses.replace(jbert.BertConfig.tiny(), dtype=dtype[0])
    cfg = dataclasses.replace(BertConfig.tiny(), dtype=dtype[1])
    params = jbert.init_params(jcfg, jax.random.PRNGKey(seed))
    model = bert_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                   "cpu")
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (B, T))
    return (params, jcfg, jnp.asarray(tokens)), (model,
                                                  torch.from_numpy(tokens))


F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


def as_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_config_matches_jax():
    for name in ("base", "tiny"):
        j, t = getattr(jbert.BertConfig, name)(), getattr(BertConfig, name)()
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name)
        assert t.head_dim == j.head_dim
    assert BertConfig().dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x, s, b = (rng.standard_normal(shape).astype(np.float32) * k
               for shape, k in (((4, 7, 32), 3.0), ((32,), 1.0), ((32,), 0.5)))
    want = jbert.layer_norm(*(jnp.asarray(a).astype(dtype[0])
                              for a in (x, s, b)))
    got = layer_norm(*(torch.from_numpy(a).to(dtype[1]) for a in (x, s, b)))
    assert got.dtype == dtype[1]
    if dtype is BF16:   # the same rounding points: bit for bit
        np.testing.assert_array_equal(got.float().numpy(), as_np(want))
    else:
        np.testing.assert_allclose(got.numpy(), as_np(want), atol=1e-5)


def test_encode_and_classify_match_jax_f32():
    (params, jcfg, jt), (model, tt) = both(F32)
    np.testing.assert_allclose(encode(model, tt).numpy(),
                               as_np(jbert.encode(params, jt, jcfg)),
                               atol=1e-5, rtol=0)
    logits = classify(model, tt)
    assert logits.dtype == torch.float32 and logits.shape == (3, 2)
    np.testing.assert_allclose(logits.numpy(),
                               as_np(jbert.classify(params, jt, jcfg)),
                               atol=1e-5, rtol=0)


def test_encode_and_classify_match_jax_bf16():
    (params, jcfg, jt), (model, tt) = both(BF16, seed=2)
    hidden = encode(model, tt)
    assert hidden.dtype == torch.bfloat16
    want = as_np(jbert.encode(params, jt, jcfg))
    err = np.abs(hidden.float().numpy() - want) / np.maximum(
        np.abs(want), 1.0)
    assert err.max() <= 2 ** -4, err.max()
    want = as_np(jbert.classify(params, jt, jcfg))
    np.testing.assert_allclose(classify(model, tt).numpy(), want,
                               atol=2 ** -6 * np.abs(want).max(), rtol=0)


def test_attention_is_bidirectional():
    """Changing the last token moves the first position's hidden state
    (a causal mask would not), on both sides alike."""
    (params, jcfg, jt), (model, tt) = both(F32, seed=3)
    moved = tt.clone()
    moved[:, -1] = (moved[:, -1] + 1) % model.cfg.vocab
    a, b = encode(model, tt)[:, 0], encode(model, moved)[:, 0]
    assert (a - b).abs().max() > 1e-4
    np.testing.assert_allclose(
        b.numpy(), as_np(jbert.encode(params, jnp.asarray(moved.numpy()),
                                      jcfg))[:, 0], atol=1e-5, rtol=0)


def test_init_params_from_generator_only():
    cfg = BertConfig.tiny()
    a, b = (init_params(cfg, torch.Generator().manual_seed(5), "cpu")
            for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert not p.requires_grad and p.dtype == torch.bfloat16
    assert torch.equal(a.blocks[0].ln1_s, torch.ones(cfg.d_model,
                                                     dtype=torch.bfloat16))
    assert float(a.cls.float().std()) == pytest.approx(0.02, rel=0.3)


class StopAfter:
    """Stands in for ``sys.stdout``: keeps the lines written and raises
    ``Stop`` once ``n`` have been."""

    class Stop(Exception):
        pass

    def __init__(self, n):
        self.n, self.text = n, ""

    def write(self, s):
        self.text += s
        if self.text.count("\n") >= self.n:
            raise self.Stop
        return len(s)

    def flush(self):
        pass


def run_main(main, monkeypatch, n=3, **kw):
    """``main(device="cpu", **kw)`` until its ``n``-th line: (lines,
    values published)."""
    published = []
    monkeypatch.setattr(collector, "make_workload_publisher",
                        lambda *a, **k: published.append)
    out = StopAfter(n)
    monkeypatch.setattr(sys, "stdout", out)
    with pytest.raises(StopAfter.Stop):
        main(device="cpu", **kw)
    monkeypatch.undo()
    return out.text.splitlines(), published


def test_main_prints_the_jax_line_each_second(monkeypatch):
    """The pod loop: a synchronised ``classify`` a step, its qps on the
    JAX line, published, then ``sleep(1)``."""
    tiny = dataclasses.replace(BertConfig.tiny(), max_seq=128)
    monkeypatch.setattr(BertConfig, "base", staticmethod(lambda: tiny))
    slept = []
    monkeypatch.setattr("time.sleep", slept.append)
    monkeypatch.setenv("SLO", "0.25")
    monkeypatch.setenv("TPU_VISIBLE_CHIPS", "0")
    lines, published = run_main(bert.main, monkeypatch)
    assert len(lines) == 3
    for line, qps in zip(lines, published):
        m = LINE.match(line)
        assert m and float(m.group(1)) > 0
        assert m.group(2) == "0.25" and m.group(3) == "0"
        assert float(m.group(1)) == pytest.approx(qps, abs=0.05)
    assert len(published) == 2 and slept == [1, 1]   # stopped at line 3


def test_main_needs_a_card_unless_told_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert.main()
