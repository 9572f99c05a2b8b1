"""Chunked prefill (``prefill_chunk_tokens``) in the port's paged batcher.

Against the JAX engine (f32 tiny, fused, the same weights through the
bridge): chunked streams, ``prefill_chunks_total`` and
``prefill_tokens_skipped`` match, with and without speculation. Inside
the port: chunked equals unchunked, the budget must be a page multiple,
the backlog gauge drains, and eos in the first emitted chunk or a step
with nothing fully prefilled keep the pool whole."""
import jax
import numpy as np
import pytest

from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from test_torch_serving import configs

PAGE = 8
ENGINE = dict(kv_layout="paged", n_slots=3, max_len=128, chunk=4,
              prefill_bucket=8, page_size=PAGE)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = configs()
    params = j_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


def workload(vocab=256, seed=0):
    """Long + short + repetitive + shared-prefix prompts: several chunk
    rungs, budget contention, and (spec, prefix cells) accepts and hits."""
    rng = np.random.default_rng(seed)
    ints = lambda n: [int(t) for t in rng.integers(0, vocab, n)]  # noqa: E731
    phrase, sysp = ints(3), ints(2 * PAGE)
    return [ints(40), ints(5), phrase * 9, sysp + ints(5),
            sysp + phrase * 4, ints(22)]


def drive(eng, prompts, max_new=6):
    ids = [eng.submit(p, max_new=max_new) for p in prompts]
    done = {}
    while eng.pending:
        done.update(eng.step())
    return [done[i] for i in ids]


def port(model, cfg, chunked, **kw):
    return ContinuousBatcher(model, cfg, device="cpu",
                             prefill_chunk_tokens=chunked, **ENGINE, **kw)


@pytest.mark.parametrize("kw", [
    dict(prefix_cache=True),
    dict(kv_dtype="int8", prefix_cache=True),
    dict(speculative=True, gamma=2, prefix_cache=True),
], ids=["prefix", "int8kv-prefix", "spec-prefix"])
def test_chunked_matches_jax_engine(setup, kw):
    jcfg, cfg, params, model = setup
    prompts = workload()
    jeng = JEngine(params, jcfg, prefill_chunk_tokens=PAGE, **ENGINE, **kw)
    ref = drive(jeng, prompts)
    jm = jeng.pool_metrics()
    da.reset_counters()
    eng = port(model, cfg, PAGE, **kw)
    got = drive(eng, prompts)
    m = eng.pool_metrics()
    assert got == ref
    for key in ("prefill_chunks_total", "prefill_tokens_skipped"):
        assert m[key] == jm[key], key
    assert m["prefill_chunks_total"] > len(prompts)
    assert da.counters()["dense_prefill_reference"] > 0   # hb > 0 chunks
    if kw.get("speculative"):
        assert m["spec_accept_rate"] == jm["spec_accept_rate"]
    eng._alloc.assert_consistent()


@pytest.mark.parametrize("budget,kw", [
    (PAGE, {}), (2 * PAGE, dict(kv_dtype="int8")),
    (PAGE, dict(prefix_cache=True, speculative=True, gamma=3)),
    (1024, {})], ids=["page", "2pages-int8kv", "page-prefix-spec",
                      "whole-prompts"])
def test_chunked_equals_unchunked(setup, budget, kw):
    _, cfg, _, model = setup
    prompts = workload(seed=1)
    ref = drive(port(model, cfg, None, **kw), prompts)
    eng = port(model, cfg, budget, **kw)
    assert drive(eng, prompts) == ref
    eng._alloc.assert_consistent()


@pytest.mark.parametrize("bad", [PAGE - 1, PAGE + 1, 0])
def test_budget_must_be_a_page_multiple(setup, bad):
    _, cfg, _, model = setup
    with pytest.raises(ValueError, match="multiple"):
        port(model, cfg, bad)


def test_backlog_and_chunk_gauges(setup):
    """The backlog counts admitted, not yet prefilled prompt tokens and
    drains to zero; a pure-prefill step dispatches no decode."""
    _, cfg, _, model = setup
    eng = port(model, cfg, PAGE)
    rid = eng.submit(list(range(1, 41)), max_new=3)
    eng.step()                                 # admit + first chunk
    m = eng.pool_metrics()
    assert m["prefill_backlog_tokens"] == 40 - PAGE
    assert m["prefill_chunks_total"] == 1
    assert eng._out[rid] == []                 # no token before the last chunk
    done = {}
    while eng.pending:
        done.update(eng.step())
    m = eng.pool_metrics()
    assert m["prefill_backlog_tokens"] == 0
    assert m["prefill_chunks_total"] == 5
    assert len(done[rid]) == 3


def test_eos_in_first_emitted_chunk_retires_everything(setup):
    _, cfg, _, model = setup
    prompt = list(range(5, 30))
    (full,) = drive(port(model, cfg, PAGE), [prompt], 8)
    eng = port(model, cfg, PAGE, eos_id=full[0], prefix_cache=True)
    (cut,) = drive(eng, [prompt], 8)
    assert cut == full[:1]
    eng._alloc.assert_consistent()
    assert eng._alloc.in_use == eng._alloc.cached_pages


def test_max_new_one_finishes_at_its_final_chunk(setup):
    _, cfg, _, model = setup
    prompts = workload(seed=2)[:3]
    ref = drive(port(model, cfg, None), prompts, 1)
    eng = port(model, cfg, PAGE)
    assert drive(eng, prompts, 1) == ref
    assert eng._alloc.in_use == 0
