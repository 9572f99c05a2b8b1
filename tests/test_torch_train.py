"""The port's training path against the JAX package on the CPU.

Weights are built by the JAX ``init_params`` and carried across with
``bridge.params_from_numpy``; updated weights come back through
``bridge.params_to_numpy``. Both sides train ``LlamaConfig.tiny()`` (and a
GQA variant) at f32 with ``attn_impl`` "dense" or "flash" (JAX's flash
runs its Pallas kernels in interpret mode, the port's its plain versions)
under ``optax.adamw(3e-4)`` / ``make_optimizer(model, 3e-4)``.

Tolerances: losses to 1e-5 relative (largest seen 2.6e-7); updated
weights to 1e-5 absolute, a thirtieth of one step. An AdamW step moves
each weight by about lr = 3e-4 whatever its gradient's size, so where a
gradient is near zero, m/(sqrt(v) + eps) turns a last-bit difference
between the frameworks into a visible one: three or four weights of
about 10^5 differ by more than 3e-7, the largest by 2.0e-6. Remat on and
off give bitwise-equal losses and gradients (the recompute runs the same
ops on the same inputs)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu_torch.bridge import (
    params_from_numpy, params_to_numpy)
from k8s_gpu_scheduler_tpu_torch.models.llama import (
    LlamaConfig, forward, init_params, loss_fn, make_optimizer,
    make_train_step)
from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
    counters, reset_counters)

CELLS = [("dense", 8), ("flash", 8), ("flash", 2)]
IDS = ["dense-mha", "flash-mha", "flash-gqa4"]


def configs(attn_impl="dense", n_kv=8, remat=False, **kw):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(attn_impl),
                               dtype=jnp.float32, n_kv_heads=n_kv,
                               remat=remat, **kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return jcfg, LlamaConfig(**fields, dtype=torch.float32)


def batches(vocab, B=2, T=32, seed=0):
    tokens = np.random.default_rng(seed).integers(0, vocab, (B, T))
    targets = np.roll(tokens, -1, axis=1)
    return ({"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)},
            {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets)})


def both_models(jcfg, cfg, seed=0):
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_numpy(tree, cfg, "cpu", trainable=True)


@pytest.mark.parametrize("attn_impl,n_kv", CELLS, ids=IDS)
def test_loss_fn_matches_jax(attn_impl, n_kv):
    jcfg, cfg = configs(attn_impl, n_kv)
    params, model = both_models(jcfg, cfg)
    jb, tb = batches(cfg.vocab)
    ref = float(jllama.loss_fn(params, jb, jcfg))
    got = float(loss_fn(model, tb).detach())
    assert got == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("attn_impl,n_kv", CELLS, ids=IDS)
def test_three_adamw_steps_match_jax(attn_impl, n_kv):
    """Three steps of make_train_step on both sides: each loss, and every
    weight after the last step (block leaves stacked [L, ...])."""
    jcfg, cfg = configs(attn_impl, n_kv, remat=True)
    params, model = both_models(jcfg, cfg, seed=1)
    start = jax.tree.map(np.asarray, params)
    jb, tb = batches(cfg.vocab, seed=1)
    opt = optax.adamw(3e-4)
    state = opt.init(params)
    jstep = jllama.make_train_step(jcfg, None, opt)
    step = make_train_step(cfg, None, make_optimizer(model, 3e-4))
    reset_counters()
    for _ in range(3):
        params, state, jloss = jstep(params, state, jb)
        loss = step(model, tb)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = jax.tree.map(np.asarray, params)
    got = params_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w, w0 in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                        jax.tree.leaves(start)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        assert np.abs(w - w0).max() > 5e-4          # the weights moved
    c = counters()
    if attn_impl == "flash":
        # Remat: the forward and the recompute each run the plain K5, the
        # backward the plain K6+K7, per layer and step.
        assert c["flash_forward_reference"] == 2 * cfg.n_layers * 3
        assert c["flash_backward_reference"] == cfg.n_layers * 3
    assert not (c["flash_forward"] or c["flash_backward_dq"]
                or c["flash_backward_dkv"]), c


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_remat_on_equals_off(attn_impl):
    """Checkpointed blocks give the same loss and gradients as stored
    activations, bit for bit."""
    grads, losses = [], []
    for remat in (False, True):
        _, cfg = configs(attn_impl, 2, remat=remat)
        model = init_params(cfg, torch.Generator().manual_seed(3),
                            "cpu").requires_grad_(True)
        _, tb = batches(cfg.vocab, seed=3)
        loss = loss_fn(model, tb)
        loss.backward()
        losses.append(loss.detach())
        grads.append([p.grad for p in model.parameters()])
    assert torch.equal(losses[0], losses[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_loss_drops():
    """The JAX package's convergence contract (tests/test_models.py):
    eight adamw(3e-3) steps on one toy batch drop the loss by > 0.5 —
    here with flash attention and remat."""
    _, cfg = configs("flash", 8, remat=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, tb = batches(cfg.vocab, B=4, T=32)
    step = make_train_step(cfg, None, make_optimizer(model, 3e-3))
    losses = [float(step(model, tb)) for _ in range(8)]
    assert losses[-1] < losses[0] - 0.5, losses


def test_serving_params_stay_frozen():
    """Parameters are created frozen unless training asks; a forward
    records no autograd graph."""
    _, cfg = configs()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits = forward(model, torch.zeros((1, 8), dtype=torch.long))
    assert logits.grad_fn is None
    make_optimizer(model)
    assert all(p.requires_grad for p in model.parameters())


class FakeMesh:
    """What ``parallel.sharding.mesh_coords`` reads of a ``DeviceMesh``:
    enough for the refusals, which come before any collective."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = sizes

    def size(self, i):
        return self._sizes[self.mesh_dim_names[i]]

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return name            # never used: no step runs on a fake mesh


def test_not_ported_options_raise():
    """A pipeline axis is refused by the plain step, naming the
    pipeline's (``models.pipeline.make_pp_train_step``); a
    mixture-of-experts model on a mesh (the ep axis) now builds a step,
    as on one rank. Ring and Ulysses attention with the sequence whole
    are dense attention, as in JAX."""
    _, cfg = configs()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = make_optimizer(model)
    with pytest.raises(ValueError, match="make_pp_train_step"):
        make_train_step(cfg, FakeMesh(pp=2, tp=2), opt)
    moe = dataclasses.replace(cfg, n_experts=4)
    moe_opt = make_optimizer(init_params(
        moe, torch.Generator().manual_seed(0), "cpu"))
    for mesh in (FakeMesh(dp=2, ep=2), FakeMesh(dp=1)):
        assert callable(make_train_step(moe, mesh, moe_opt))
    _, tb = batches(cfg.vocab)
    dense = loss_fn(model, tb)
    for impl in ("ring", "ulysses"):
        m = init_params(dataclasses.replace(cfg, attn_impl=impl),
                        torch.Generator().manual_seed(0), "cpu")
        assert torch.equal(loss_fn(m, tb), dense)
    with pytest.raises(ValueError, match="attn_impl"):
        loss_fn(init_params(dataclasses.replace(cfg, attn_impl="sparse"),
                            torch.Generator().manual_seed(0), "cpu"), tb)


def test_a_sharded_step_refuses_a_whole_model():
    """On a mesh of more than one rank the step takes the rank's blocks;
    a whole model is refused before any collective."""
    _, cfg = configs()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, FakeMesh(tp=2), make_optimizer(model))
    _, tb = batches(cfg.vocab)
    with pytest.raises(ValueError, match="this rank's block"):
        step(model, tb)


def test_flops_per_token_matches_jax():
    for name in ("llama3_8b", "tiny"):
        jcfg = getattr(jllama.LlamaConfig, name)()
        cfg = getattr(LlamaConfig, name)()
        for T in (0, 2048):
            assert cfg.flops_per_token(T) == jcfg.flops_per_token(T)


def test_forward_logits_at_graft_entry_shape():
    """Logits at the ``__graft_entry__.entry()`` shape (d_model 512, 4
    layers, 8 heads, d_ff 1536, vocab 32000, B 2, T 256) in f32, the
    entry's own weights (PRNGKey 0) and tokens (PRNGKey 1)."""
    jcfg = jllama.LlamaConfig(
        vocab=32000, d_model=512, n_layers=4, n_heads=8, n_kv_heads=8,
        d_ff=1536, max_seq=512, remat=False, dtype=jnp.float32)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = LlamaConfig(**fields, dtype=torch.float32)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 256), 0,
                                jcfg.vocab)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    ref = np.asarray(jllama.forward(params, tokens, jcfg))
    got = forward(model, torch.from_numpy(np.array(tokens))).numpy()
    assert got.shape == (2, 256, 32000)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
