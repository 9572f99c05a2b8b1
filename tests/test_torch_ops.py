"""The port's ops and Llama forward against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks as
numpy arrays; weights cross through ``bridge.params_from_numpy``.
Tolerances: 1e-5 for the f32 ops (one rounding-order class apart), 1e-4
for whole-model logits (a few layers of accumulated reordering)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu.models.serving import _kv_quant as j_kv_quant
from k8s_gpu_scheduler_tpu.ops import attention as jattn
from k8s_gpu_scheduler_tpu.ops import layers as jlayers
from k8s_gpu_scheduler_tpu.ops import quant as jquant
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models.llama import (
    LlamaConfig, forward, init_params)
from k8s_gpu_scheduler_tpu_torch.models.serving import _kv_quant
from k8s_gpu_scheduler_tpu_torch.ops import attention, layers, quant

TOL = dict(atol=1e-5, rtol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    close(layers.rms_norm(t(x), t(w)), jlayers.rms_norm(x, w))


@pytest.mark.parametrize("hd,theta", [(16, 10000.0), (64, 500000.0)])
def test_rope(hd, theta):
    rng = np.random.default_rng(1)
    ang = layers.rope_freqs(hd, 32, theta)
    close(ang, jlayers.rope_freqs(hd, 32, theta))
    x = rng.normal(size=(2, 32, 4, hd)).astype(np.float32)
    close(layers.apply_rope(t(x), ang),
          jlayers.apply_rope(x, jlayers.rope_freqs(hd, 32, theta)))


def test_swiglu():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.normal(size=(48, 32)).astype(np.float32) * 0.1
    close(layers.swiglu(t(x), t(wg), t(wu), t(wd)),
          jlayers.swiglu(x, wg, wu, wd))


def test_quantize_weight_and_qdot():
    """int8 codes are equal (both round half to even); scales and the
    int8 product agree at f32 tolerance."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(2, 32, 24)).astype(np.float32)
    w[0, :, 5] = 0.0                               # all-zero channel
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    port, ref = quant.quantize_weight(t(w)), jquant.quantize_weight(w)
    np.testing.assert_array_equal(port["q"].numpy(), np.asarray(ref["q"]))
    close(port["s"], ref["s"])
    close(quant.qdot(t(x), port), jquant.qdot(x, ref))
    close(quant.qdot(t(x), t(w)), jquant.qdot(x, w))
    close(quant.dequantize_weight(port, torch.float32),
          jquant.dequantize_weight(ref, jnp.float32))


def test_kv_quant():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 2, 16)).astype(np.float32)
    x[1, 2, 0] = 0.0                               # scale floor
    q, s = _kv_quant(t(x))
    jq, js = j_kv_quant(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    close(s, js)


@pytest.mark.parametrize("n_kv", [4, 2])
def test_dense_attention(n_kv):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, n_kv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, n_kv, 16)).astype(np.float32)
    close(attention.dense_attention(t(q), t(k), t(v)),
          jattn.dense_attention(q, k, v))


def _configs(n_kv):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32,
                               n_kv_heads=n_kv)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return jcfg, LlamaConfig(**fields, dtype=torch.float32)


@pytest.mark.parametrize("n_kv", [8, 2], ids=["mha", "gqa4"])
def test_forward_logits(n_kv):
    """The port's forward == JAX forward on LlamaConfig.tiny() (and a GQA
    variant), weights carried by the bridge."""
    jcfg, cfg = _configs(n_kv)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 24))
    ref = jllama.forward(params, jnp.asarray(tokens), jcfg)
    got = forward(model, torch.from_numpy(tokens))
    close(got, ref, atol=1e-4, rtol=1e-4)


def test_bridge_int8_and_bf16_leaves():
    """int8 {"q","s"} leaves become Int8Weight modules bit for bit, and
    bf16 leaves cross bit for bit."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny())     # bf16
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = LlamaConfig(**fields, dtype=torch.bfloat16)
    params = jquant.quantize_llama_params(
        jllama.init_params(jcfg, jax.random.PRNGKey(1)))
    tree = jax.tree.map(np.asarray, params)
    model = params_from_numpy(tree, cfg, "cpu")
    wq = model.blocks[1].wq
    assert isinstance(wq, quant.Int8Weight)
    np.testing.assert_array_equal(wq.q.numpy(), tree["blocks"]["wq"]["q"][1])
    np.testing.assert_array_equal(wq.s.numpy(), tree["blocks"]["wq"]["s"][1])
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.embed.view(torch.int16).numpy(),
        tree["embed"].view(np.int16))


def test_quantize_llama_params_matches_jax():
    jcfg, cfg = _configs(8)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    qm = quant.quantize_llama_params(model)
    ref = jax.tree.map(np.asarray, jquant.quantize_llama_params(params))
    np.testing.assert_array_equal(qm.blocks[0].w_down.q.numpy(),
                                  ref["blocks"]["w_down"]["q"][0])
    np.testing.assert_array_equal(qm.lm_head.q.numpy(), ref["lm_head"]["q"])
    assert isinstance(model.blocks[0].w_down, torch.nn.Parameter)


def test_moe_config_raises():
    """An MoE config constructs and its blocks run; what still raises is
    an expert product spec ``qeinsum`` does not serve."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), n_experts=4,
                              dtype=torch.float32)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert model.blocks[0].router.dtype == torch.float32
    logits = forward(model, torch.zeros((1, 8), dtype=torch.long))
    assert logits.shape == (1, 8, cfg.vocab) and torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="unsupported spec"):
        quant.qeinsum("btd,edf->bte", torch.zeros(1, 2, 3),
                      torch.zeros(4, 3, 5))
