"""The port's paged, prefix-cached ContinuousBatcher against the JAX one.

Both engines get the same f32 tiny weights (JAX ``init_params``, carried
by the bridge) and the same traffic: a two-turn conversation (the second
turn mounts the first turn's whole transcript) and a batch sharing a
page-aligned system prompt. Greedy streams must match token for token and
``prefill_tokens_skipped`` must be equal — with f32 KV, an int8 KV pool,
int8 weights, and GQA. The JAX engine runs its Pallas kernels in
interpret mode; the port runs its plain versions (CPU tensors)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models.llama import LlamaConfig as JConfig
from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu.ops.quant import quantize_llama_params as j_quant
from k8s_gpu_scheduler_tpu_torch import resolve_device
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models.llama import (
    LlamaConfig, forward, init_params)
from k8s_gpu_scheduler_tpu_torch.models.serving import (
    ContinuousBatcher, forward_with_cache, init_cache)
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

ENGINE = dict(kv_layout="paged", prefix_cache=True, page_size=8, n_slots=2,
              max_len=64, chunk=2, prefill_bucket=8)


def configs(**kw):
    jcfg = dataclasses.replace(JConfig.tiny(), decode_attn="fused",
                               dtype=jnp.float32, **kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return jcfg, LlamaConfig(**fields, dtype=torch.float32)


def step_all(eng):
    done = {}
    while eng.pending:
        done.update(eng.step())
    return done


def traffic(eng, seed=3):
    """Two turns of one conversation, then a shared-prefix batch (one
    request first so the rest hit its donated pages; a max_new == 1 entry
    finishes at admission). Returns (streams, prefill_tokens_skipped)."""
    rng = np.random.default_rng(seed)
    vocab = 256
    p1 = list(rng.integers(0, vocab, 16))
    eng.submit(p1, max_new=12)
    (t1,) = step_all(eng).values()
    eng.submit(p1 + t1 + list(rng.integers(0, vocab, 4)), max_new=4)
    (t2,) = step_all(eng).values()
    streams = [t1, t2]
    system = list(rng.integers(0, vocab, 16))
    eng.submit(system + list(rng.integers(0, vocab, 5)), max_new=6)
    streams += list(step_all(eng).values())
    for max_new in (6, 1, 6):
        eng.submit(system + list(rng.integers(0, vocab, 5)), max_new=max_new)
    done = step_all(eng)
    streams += [done[k] for k in sorted(done)]
    eng._alloc.assert_consistent()
    return streams, eng.pool_metrics()["prefill_tokens_skipped"]


VARIANTS = [
    pytest.param({}, {}, False, id="f32"),
    pytest.param({"n_kv_heads": 2}, {}, False, id="gqa4"),
    pytest.param({}, {"kv_dtype": "int8"}, False, id="int8kv"),
    pytest.param({}, {}, True, id="int8w"),
]


@pytest.mark.parametrize("cfg_kw,eng_kw,int8_weights", VARIANTS)
def test_greedy_streams_match_jax_engine(cfg_kw, eng_kw, int8_weights):
    jcfg, cfg = configs(**cfg_kw)
    params = j_init(jcfg, jax.random.PRNGKey(0))
    if int8_weights:
        params = j_quant(params)
    ref = traffic(JEngine(params, jcfg, **ENGINE, **eng_kw))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    da.reset_counters()
    got = traffic(ContinuousBatcher(model, cfg, device="cpu", **ENGINE,
                                    **eng_kw))
    assert got == ref
    assert got[1] > 0                      # the hb > 0 rung really ran
    counts = da.counters()
    assert counts["paged_decode_reference"] > 0
    assert counts["dense_prefill_reference"] > 0
    assert counts["paged_decode_attention"] == 0
    assert counts["paged_prefill_attention"] == 0


def _port_engine(seed=0, **kw):
    _, cfg = configs()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return ContinuousBatcher(model, cfg, device="cpu", seed=seed,
                             **{**ENGINE, **kw})


def test_sampled_streams_replay_with_the_seed():
    """temperature > 0: the same engine seed replays the same streams; a
    different seed draws different ones."""
    runs = [traffic(_port_engine(seed=s, temperature=0.9, top_k=20))[0]
            for s in (5, 5, 6)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_eos_truncates_and_frees_early():
    """An eos stops the request at its first eos (inclusive); the stream
    is the greedy stream's prefix and the pool stays consistent."""
    eng = _port_engine()
    prompt = list(range(3, 20))
    eng.submit(prompt, max_new=12)
    (full,) = step_all(eng).values()
    eos = full[5]
    eng = _port_engine(eos_id=eos)
    eng.submit(prompt, max_new=12)
    (cut,) = step_all(eng).values()
    assert cut == full[:full.index(eos) + 1]
    eng._alloc.assert_consistent()
    assert eng._alloc.in_use == eng._alloc.cached_pages


def test_run_matches_step():
    """run() (reads deferred to the end) gives the step() streams."""
    prompts = [list(range(i, i + 11)) for i in (1, 40, 90)]
    a = _port_engine()
    ids = [a.submit(p, max_new=5) for p in prompts]
    by_run = a.run()
    b = _port_engine()
    for p in prompts:
        b.submit(p, max_new=5)
    by_step = step_all(b)
    assert [by_run[i] for i in ids] == [by_step[i] for i in ids]
    assert set(a.pop_request_metrics()) == set(ids)


@pytest.mark.parametrize("kw", [
    dict(mesh=object()), dict(role="prefill")],
    ids=lambda kw: next(iter(kw)))
def test_later_slice_options_raise(kw):
    with pytest.raises(NotImplementedError, match="slice"):
        _port_engine(**kw)


@pytest.mark.parametrize("kw", [
    dict(kv_tiering=True),
    dict(fault_injector=("serve.step", "page_pressure"))],
    ids=lambda kw: next(iter(kw)))
def test_lifecycle_options_build_engines_as_jax_does(kw):
    """The lifecycle slice's options build a serving engine, as they do
    in JAX: a tiered engine reports JAX's tier gauges, and an injector's
    ``serve.step`` hook fires once a step (here holding pages hostage)."""
    from k8s_gpu_scheduler_tpu.testing.faults import FaultInjector as JInj
    from k8s_gpu_scheduler_tpu.testing.faults import FaultRule as JRule
    from k8s_gpu_scheduler_tpu_torch.testing.faults import (
        FaultInjector, FaultRule)

    jcfg, cfg = configs()
    params = j_init(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    if "fault_injector" in kw:
        site, kind = kw["fault_injector"]
        jkw = dict(fault_injector=JInj(rules=[JRule(site, kind, every=1,
                                                    pages=3)]))
        kw = dict(fault_injector=FaultInjector(rules=[FaultRule(
            site, kind, every=1, pages=3)]))
    else:
        jkw = kw
    engines = (JEngine(params, jcfg, **ENGINE, **jkw),
               ContinuousBatcher(model, cfg, device="cpu", **ENGINE, **kw))
    got = []
    for eng in engines:
        eng.submit(list(range(3, 20)), max_new=4)
        eng.step()
        got.append(eng.pool_metrics())
    assert set(got[1]) == set(got[0]) - {
        "tp", "tp_combine", "weight_sliced_device_bytes"}
    for key in ("pages_in_use", "pages_free", "tier_dram_capacity"):
        assert got[1].get(key) == got[0].get(key)
    if "fault_injector" in kw:
        assert kw["fault_injector"].log == [("serve.step", 1,
                                             "page_pressure")]
        assert len(engines[1]._chaos_pages) == 3
    else:
        assert got[1]["tier_dram_capacity"] == 1 + 2 * 8


def test_drain_of_idle_engine_and_dense_decode_refused():
    """drain() of an engine with nothing in flight gives JAX's zero-page
    snapshot; the drained engine refuses work. decode_attn='dense' is
    still refused: the port serves through the attention kernels."""
    jcfg, cfg = configs()
    params = j_init(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    jsnap = JEngine(params, jcfg, **ENGINE).drain()
    eng = ContinuousBatcher(model, cfg, device="cpu", **ENGINE)
    snap = eng.drain()
    assert snap.fingerprint == jsnap.fingerprint
    assert snap.page_ids == jsnap.page_ids == []
    assert snap.k_pages.shape == jsnap.k_pages.shape
    assert snap.n_requests_in_flight == 0
    with pytest.raises(RuntimeError, match="drained"):
        eng.submit([1, 2, 3], max_new=2)
    with pytest.raises(RuntimeError, match="drained"):
        eng.step()
    with pytest.raises(NotImplementedError, match="decode_attn"):
        ContinuousBatcher(model, dataclasses.replace(cfg, decode_attn="dense"),
                          device="cpu")


def test_device_is_explicit():
    """No card here: the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    _, cfg = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))
    assert resolve_device("cpu") == torch.device("cpu")


def test_init_params_from_generator_only():
    _, cfg = configs()
    a = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    c = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(a.blocks[1].w_up, b.blocks[1].w_up)
    assert not torch.equal(a.blocks[1].w_up, c.blocks[1].w_up)


def test_forward_with_cache_prefill_is_the_causal_forward():
    """Prefill from an empty cache == the dense causal forward."""
    _, cfg = configs(n_kv_heads=4)
    model = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(2))
    logits, cache = forward_with_cache(model, tokens, cfg,
                                       init_cache(cfg, 2, 32, "cpu"))
    assert cache["len"] == 16
    torch.testing.assert_close(logits, forward(model, tokens),
                               atol=1e-5, rtol=1e-5)
