"""The port's mixture-of-experts path against the JAX package on the CPU.

Ops (``ops/moe.py``, ``ops/quant.qeinsum``): inputs from numpy with a
seed; ``moe_ffn`` (out and aux, at a capacity that drops and at one that
does not), ``moe_ffn_dropless`` (plain and int8 expert stacks),
``load_balancing_loss`` and the gradients of ``moe_ffn``. Ties among the
routing probabilities (identical experts) go to the lower index on both
sides.

Model (``models/llama.py`` with ``n_experts=4``): weights from the JAX
``init_params`` through the bridge; ``loss_fn`` and three AdamW steps,
remat on and off, dense and flash attention (JAX's Pallas kernels in
interpret mode, the port's plain versions); the paged engine's greedy
streams against the JAX engine's. Inside the port: prefix cache on == off,
chunked == unchunked, speculative == plain, dropless == capacity where
nothing drops, int8 == its dequantized float model.

Tolerances (f32): op outputs, aux and gradients 1e-5 absolute (largest
seen 1.5e-7 on outputs, 7.2e-7 on gradients); losses 1e-5 relative;
weights after three AdamW steps 1e-5 absolute (the training file's
reason: AdamW turns last-bit gradient differences of near-zero gradients
into lr-sized ones); int8 against its dequantized float model 1e-4 on
the logits (the JAX test's bound).
bf16 dropless against JAX: 2 bf16 units (2^-7 relative) of the output's
largest magnitude, the products summing in another order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import llama as jllama
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu.ops import moe as jmoe
from k8s_gpu_scheduler_tpu.ops import quant as jquant
from k8s_gpu_scheduler_tpu_torch import ops
from k8s_gpu_scheduler_tpu_torch.bridge import (
    params_from_numpy, params_to_numpy)
from k8s_gpu_scheduler_tpu_torch.models.llama import (
    LlamaConfig, forward, forward_with_aux, init_params, loss_fn,
    make_optimizer, make_train_step, mlp_sublayer)
from k8s_gpu_scheduler_tpu_torch.models.serving import (
    ContinuousBatcher, forward_with_cache, init_cache)
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from k8s_gpu_scheduler_tpu_torch.ops import moe, quant
from test_torch_serving import configs, step_all, traffic

ATOL = 1e-5
MOE = dict(n_experts=4, moe_top_k=2)
B, T, D, F, E = 2, 16, 32, 64, 4


def arrays(seed=0, scale=0.1):
    """x [B, T, D], router [D, E], w_gate/w_up [E, D, F], w_down
    [E, F, D] as f32 numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = [(B, T, D), (D, E), (E, D, F), (E, D, F), (E, F, D)]
    out = [rng.standard_normal(s).astype(np.float32) * scale for s in shapes]
    out[0] /= scale                                    # unit activations
    return out


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, dtype=np.float32),
                               atol=atol, rtol=0)


def test_expert_capacity_matches_jax():
    for args in [(16, 4, 2, 1.25), (16, 4, 2, 0.5), (3, 8, 1, 1.0),
                 (2048, 8, 2, 1.25)]:
        assert moe.expert_capacity(*args) == jmoe.expert_capacity(*args)


@pytest.mark.parametrize("top_k,cf", [(2, 8.0), (2, 1.0), (2, 0.5), (1, 0.5)],
                         ids=["k2-no-drop", "k2-cf1", "k2-cf0.5", "k1-cf0.5"])
def test_moe_ffn_matches_jax(top_k, cf):
    """Out and aux, f32; at cf < k·E/E the queues overflow and choices
    are dropped, a token's second choice while its first is kept among
    them, so the keep mask is JAX's."""
    (jx, *jw), (tx, *tw) = zip(*map(both, arrays()))
    jout, jaux = jmoe.moe_ffn(jx, *jw, top_k=top_k, capacity_factor=cf)
    out, aux = moe.moe_ffn(tx, *tw, top_k=top_k, capacity_factor=cf)
    close(out, jout)
    close(aux, jaux)
    dropless = moe.moe_ffn_dropless(tx, *tw, top_k=top_k)
    dropped = (out - dropless).abs().amax(-1) > 1e-6
    assert bool(dropped.any()) == (cf < 8.0)


def test_identical_experts_tie_break_as_jax():
    """Identical router columns tie every probability: both sides pick
    the lower expert indices, so at a capacity that drops the outputs and
    the kept choices are JAX's; with identical experts and ample capacity
    the output is the dense SwiGLU."""
    x, router, wg, wu, wd = arrays(1)
    router = np.repeat(router[:, :1], E, axis=1)
    wg, wu, wd = (np.broadcast_to(w[:1], w.shape).copy() for w in (wg, wu, wd))
    (jx, *jw), (tx, *tw) = zip(*map(both, (x, router, wg, wu, wd)))
    probs = torch.softmax(tx @ tw[0], -1)
    vals, idx = moe._top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx == torch.tensor([0, 1])).all()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    for cf in (0.5, 8.0):
        jout, jaux = jmoe.moe_ffn(jx, *jw, top_k=2, capacity_factor=cf)
        out, aux = moe.moe_ffn(tx, *tw, top_k=2, capacity_factor=cf)
        close(out, jout)
        close(aux, jaux)
    dense = ops.swiglu(tx, tw[1][0], tw[2][0], tw[3][0])
    close(out, dense.numpy(), atol=1e-4)


@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
def test_moe_ffn_dropless_matches_jax(int8):
    (jx, jr, *jw), (tx, tr, *tw) = zip(*map(both, arrays(2)))
    if int8:
        jw = [jquant.quantize_weight(w) for w in jw]
        tw = [quant.quantize_weight(w) for w in tw]
        for j, t in zip(jw, tw):
            np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
        assert tw[0]["s"].shape == (E, 1, F)
    close(moe.moe_ffn_dropless(tx, tr, *tw),
          jmoe.moe_ffn_dropless(jx, jr, *jw))


def test_dropless_bf16_matches_jax():
    (jx, jr, *jw), (tx, tr, *tw) = zip(*map(both, arrays(3)))
    jw = [w.astype(jnp.bfloat16) for w in jw]
    tw = [w.to(torch.bfloat16) for w in tw]
    want = np.asarray(jmoe.moe_ffn_dropless(
        jx.astype(jnp.bfloat16), jr, *jw).astype(jnp.float32))
    got = moe.moe_ffn_dropless(tx.to(torch.bfloat16), tr, *tw)
    assert got.dtype == torch.bfloat16
    close(got, want, atol=2 * 2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("spec,shape_x,shape_w", [
    ("btd,edf->betf", (B, T, D), (E, D, F)),
    ("betf,efd->betd", (B, E, T, F), (E, F, D))], ids=["up", "down"])
@pytest.mark.parametrize("int8", [False, True], ids=["plain", "int8"])
def test_qeinsum_matches_jax(spec, shape_x, shape_w, int8):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape_x).astype(np.float32)
    w = rng.standard_normal(shape_w).astype(np.float32)
    (jx, tx), (jw, tw) = both(x), both(w)
    if int8:
        jw, tw = jquant.quantize_weight(jw), quant.Int8Weight(
            **quant.quantize_weight(tw))
    close(quant.qeinsum(spec, tx, tw), jquant.qeinsum(spec, jx, jw),
          atol=1e-4)


def test_load_balancing_loss_matches_jax():
    x, router, *_ = arrays(5)
    for k in (1, 2):
        close(moe.load_balancing_loss(torch.from_numpy(x),
                                      torch.from_numpy(router), top_k=k),
              jmoe.load_balancing_loss(jnp.asarray(x), jnp.asarray(router),
                                       top_k=k))
    uniform = moe.load_balancing_loss(torch.from_numpy(x),
                                      torch.zeros(D, E), top_k=1)
    assert float(uniform) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("cf", [0.5, 8.0], ids=["drops", "no-drop"])
def test_moe_ffn_grads_match_jax(cf):
    """Gradients of sum(out · r) + aux with respect to x, the router and
    the three expert stacks, f32."""
    arrs = arrays(6)
    r = np.random.default_rng(7).standard_normal((B, T, D)).astype(
        np.float32)

    def jloss(*a):
        out, aux = jmoe.moe_ffn(*a, top_k=2, capacity_factor=cf)
        return (out * r).sum() + aux

    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out, aux = moe.moe_ffn(*ts, top_k=2, capacity_factor=cf)
    ((out * torch.from_numpy(r)).sum() + aux).backward()
    for t, g in zip(ts, jgrads):
        close(t.grad, g)


# -- the model ------------------------------------------------------------

def moe_configs(attn_impl="dense", remat=False, **kw):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(attn_impl),
                               dtype=jnp.float32, remat=remat, **MOE, **kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return jcfg, LlamaConfig(**fields, dtype=torch.float32)


def test_moe_block_and_bridge_round_trip():
    jcfg, cfg = moe_configs()
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.PRNGKey(0)))
    model = params_from_numpy(tree, cfg, "cpu")
    blk = model.blocks[0]
    assert blk.router.dtype == torch.float32
    assert tuple(blk.w_gate.shape) == (4, cfg.d_model, cfg.d_ff)
    assert tuple(blk.w_down.shape) == (4, cfg.d_ff, cfg.d_model)
    back = params_to_numpy(model)
    for name, v in tree["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][name], v)
    q = quant.quantize_llama_params(model)
    assert q.blocks[0].router.dtype == torch.float32
    assert torch.equal(q.blocks[0].router, model.blocks[0].router)
    jq = jax.tree.map(np.asarray, jquant.quantize_llama_params(
        jllama.init_params(jcfg, jax.random.PRNGKey(0))))
    assert not isinstance(jq["blocks"]["router"], dict)
    np.testing.assert_array_equal(q.blocks[1].w_up.q.numpy(),
                                  jq["blocks"]["w_up"]["q"][1])
    np.testing.assert_array_equal(q.blocks[1].w_up.s.numpy(),
                                  jq["blocks"]["w_up"]["s"][1])
    qm = params_from_numpy(jq, cfg, "cpu")
    assert isinstance(qm.blocks[0].w_gate, quant.Int8Weight)
    assert qm.blocks[0].w_gate.s.shape == (4, 1, cfg.d_ff)


def batch_of(vocab, seed=0, Bt=2, Tt=32):
    tokens = np.random.default_rng(seed).integers(0, vocab, (Bt, Tt))
    targets = np.roll(tokens, -1, axis=1)
    return ({"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)},
            {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets)})


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_moe_loss_and_adamw_steps_match_jax(attn_impl, remat):
    """loss_fn (cross entropy + 0.01 · mean aux) and three AdamW(3e-4)
    steps at a capacity factor that drops (1.25 of T·k/E)."""
    jcfg, cfg = moe_configs(attn_impl, remat)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu",
                              trainable=True)
    jb, tb = batch_of(cfg.vocab)
    jl, jaux = jllama.forward_with_aux(params, jb["tokens"], jcfg)
    logits, aux = forward_with_aux(model, tb["tokens"])
    close(logits, jl)
    close(aux, jaux)
    assert float(aux.detach()) > 0
    want = float(jllama.loss_fn(params, jb, jcfg))
    assert float(loss_fn(model, tb).detach()) == pytest.approx(want, rel=1e-5)
    jstep = jllama.make_train_step(jcfg, None, optax.adamw(3e-4))
    opt_state = optax.adamw(3e-4).init(params)
    step = make_train_step(cfg, None, make_optimizer(model, 3e-4))
    for _ in range(3):
        params, opt_state, jloss = jstep(params, opt_state, jb)
        loss = step(model, tb)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = params_to_numpy(model)
    for (path, v), w in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(w, np.asarray(v), atol=1e-5, rtol=0,
                                   err_msg=str(path))


def test_remat_carries_the_aux():
    """Remat on and off give bitwise-equal losses, aux and gradients."""
    _, cfg = moe_configs()
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = init_params(c, torch.Generator().manual_seed(0), "cpu")
        model.requires_grad_(True)
        _, tb = batch_of(c.vocab, seed=2)
        loss = loss_fn(model, tb)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone()
                                    for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("eng_kw,int8_weights", [
    ({}, False), ({"kv_dtype": "int8"}, False), ({}, True)],
    ids=["f32", "int8kv", "int8w"])
def test_moe_paged_engine_streams_match_jax(eng_kw, int8_weights):
    """The paged, prefix-cached engines of both packages, MoE tiny f32:
    equal greedy streams and prefill_tokens_skipped; the port runs the
    plain versions of K1 and K2 on the CPU."""
    jcfg, cfg = configs(**MOE)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if int8_weights:
        params = jquant.quantize_llama_params(params)
    engine = dict(kv_layout="paged", prefix_cache=True, page_size=8,
                  n_slots=2, max_len=64, chunk=2, prefill_bucket=8)
    ref = traffic(JEngine(params, jcfg, **engine, **eng_kw))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    da.reset_counters()
    got = traffic(ContinuousBatcher(model, cfg, device="cpu", **engine,
                                    **eng_kw))
    assert got == ref
    assert got[1] > 0
    c = da.counters()
    assert c["paged_decode_reference"] > 0 and c["dense_prefill_reference"] > 0


def _engine(model, cfg, **kw):
    return ContinuousBatcher(model, cfg, device="cpu", **{
        **dict(kv_layout="paged", page_size=8, n_slots=2, max_len=96,
               chunk=4, prefill_bucket=16), **kw})


def _moe_model(**kw):
    _, cfg = configs(**MOE, **kw)
    return init_params(cfg, torch.Generator().manual_seed(3), "cpu"), cfg


def _waves(eng, seed=0):
    rng = np.random.default_rng(seed)
    system = list(rng.integers(0, 256, 16))
    phrase = list(rng.integers(0, 256, 5))
    prompts = [system + list(rng.integers(0, 256, 7)) for _ in range(3)]
    prompts += [phrase * 6, list(rng.integers(0, 256, 33))]
    streams = []
    for p in prompts:
        eng.submit(p, max_new=10)
        streams += list(step_all(eng).values())
    return streams


@pytest.mark.parametrize("variant", ["prefix_cache", "chunked",
                                     "speculative"])
def test_port_identities_hold_for_moe(variant):
    """Inside the port, MoE tiny f32: prefix cache on == off, chunked
    prefill == unchunked, speculative greedy == plain greedy."""
    model, cfg = _moe_model()
    base = _waves(_engine(model, cfg))
    kw = {"prefix_cache": dict(prefix_cache=True),
          "chunked": dict(prefill_chunk_tokens=16),
          "speculative": dict(speculative=True, gamma=3)}[variant]
    eng = _engine(model, cfg, **kw)
    assert _waves(eng) == base
    m = eng.pool_metrics()
    if variant == "prefix_cache":
        assert m["prefill_tokens_skipped"] > 0
    elif variant == "chunked":
        assert m["prefill_chunks_total"] > 0
    else:
        assert m["spec_accept_rate"] > 0


def test_dropless_serving_equals_capacity_training_forward():
    """At capacity_factor = n_experts an expert's queue holds every token
    of a row, so the capacity path drops nothing and the cached (dropless)
    forward reproduces the training forward."""
    model, cfg = _moe_model(moe_capacity_factor=4.0)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, (2, 12)))
    want = forward(model, tokens)
    got, _ = forward_with_cache(model, tokens, cfg,
                                init_cache(cfg, 2, 32, device="cpu"))
    close(got, want.numpy())
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    blk = model.blocks[0]
    assert torch.allclose(mlp_sublayer(cfg, x, blk)[0],
                          mlp_sublayer(cfg, x, blk, dropless=True)[0],
                          atol=ATOL, rtol=0)


def test_moe_quantized_matches_dequantized_float_path():
    """Expert stacks quantize per (expert, channel) and the router stays
    f32; the int8 model's cached forward equals its dequantized float
    model's (the JAX test's shape)."""
    model, cfg = _moe_model()
    qm = quant.quantize_llama_params(model)
    assert qm.blocks[0].w_gate.s.shape == (4, 1, cfg.d_ff)
    assert isinstance(qm.blocks[0].router, torch.nn.Parameter)
    deq = quant.quantize_llama_params(model)
    for blk in deq.blocks:
        for name in quant.BLOCK_WEIGHTS:
            w = getattr(blk, name)
            delattr(blk, name)
            setattr(blk, name, torch.nn.Parameter(
                quant.dequantize_weight(w, torch.float32),
                requires_grad=False))
    lm = deq.lm_head
    del deq.lm_head
    deq.lm_head = torch.nn.Parameter(quant.dequantize_weight(
        lm, torch.float32), requires_grad=False)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 8)))
    ql, _ = forward_with_cache(qm, tokens, cfg,
                               init_cache(cfg, 2, 32, device="cpu"))
    dl, _ = forward_with_cache(deq, tokens, cfg,
                               init_cache(cfg, 2, 32, device="cpu"))
    close(ql, dl.numpy(), atol=1e-4)
