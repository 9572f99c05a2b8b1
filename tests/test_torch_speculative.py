"""Speculative decoding in the port's paged batcher, against the JAX one.

Greedy (f32 tiny, fused): the port's speculative engine and the JAX one
get the same weights (JAX ``init_params`` through the bridge) and the same
traffic; streams must match token for token and the ``spec_*`` gauges must
be equal, for the bigram default, GQA, an int8 KV pool, the prefix cache,
the ``ngram:3`` proposer and adaptive gamma. The JAX engine runs its
Pallas kernels in interpret mode; the port runs its plain versions.

Inside the port: speculative greedy equals plain greedy; sampled
speculation with ``top_k=1`` equals greedy with every proposal rejected;
a draft equal to the target accepts everything; sampled runs replay from
the seed; the first two sampled tokens follow the target law (TV distance
against enumerated marginals); a failing proposer fails only its request.
"""
import jax
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models.llama import forward
from k8s_gpu_scheduler_tpu_torch.models.proposers import (
    BigramProposer, DraftModelProposer)
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from test_torch_serving import configs

ENGINE = dict(kv_layout="paged", n_slots=2, max_len=64, chunk=4,
              prefill_bucket=8, page_size=8)
GAUGES = ("spec_accept_rate", "spec_tokens_per_dispatch",
          "spec_rewound_tokens_total", "spec_proposer", "spec_gamma_agg")


def workload(seed=0, vocab=256):
    """A cycling prompt (accepts once the stream loops), a random one
    (mostly rejected), a short phrase copy, and a longer copy of the
    first prompt's page (a prefix-cache hit when the cache is on)."""
    rng = np.random.default_rng(seed)
    phrase = [int(t) for t in rng.integers(0, vocab, 4)]
    return [phrase * 2, [int(t) for t in rng.integers(0, vocab, 7)],
            phrase + phrase[:1], phrase * 3]


def run(eng, prompts, max_new=12):
    ids = [eng.submit(p, max_new=max_new) for p in prompts]
    done = eng.run()
    return [done[i] for i in ids]


def bridged(cfg_kw=None, seed=0):
    """(jax cfg, port cfg, jax params, port model on the CPU)."""
    jcfg, cfg = configs(**(cfg_kw or {}))
    params = j_init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


def port(model, cfg, **kw):
    return ContinuousBatcher(model, cfg, device="cpu",
                             **{**ENGINE, **kw})


VARIANTS = [
    pytest.param({}, {}, id="bigram"),
    pytest.param({"n_kv_heads": 2}, {}, id="gqa4"),
    pytest.param({}, {"kv_dtype": "int8"}, id="int8kv"),
    pytest.param({}, {"prefix_cache": True}, id="prefix"),
    pytest.param({}, {"proposer": "ngram:3"}, id="ngram3"),
    pytest.param({}, {"spec_adaptive": True}, id="adaptive"),
]


@pytest.mark.parametrize("cfg_kw,eng_kw", VARIANTS)
def test_greedy_spec_matches_jax_engine(cfg_kw, eng_kw):
    jcfg, cfg, params, model = bridged(cfg_kw)
    prompts = workload()
    jeng = JEngine(params, jcfg, speculative=True, gamma=3, **ENGINE,
                   **eng_kw)
    ref = run(jeng, prompts)
    jm = jeng.pool_metrics()
    da.reset_counters()
    eng = port(model, cfg, speculative=True, gamma=3, **eng_kw)
    got = run(eng, prompts)
    m = eng.pool_metrics()
    assert got == ref
    assert {k: m[k] for k in GAUGES} == {k: jm[k] for k in GAUGES}
    assert m["spec_accept_rate"] > 0
    if eng_kw.get("prefix_cache"):
        assert m["prefill_tokens_skipped"] == jm["prefill_tokens_skipped"] > 0
    counts = da.counters()
    assert counts["paged_verify_reference"] > 0
    assert counts["paged_verify_attention"] == 0
    eng._alloc.assert_consistent()
    assert eng._alloc.in_use == eng._alloc.cached_pages


@pytest.mark.parametrize("eng_kw", [{}, dict(kv_dtype="int8",
                                             prefix_cache=True)],
                         ids=["f32", "int8kv-prefix"])
def test_spec_equals_plain_greedy(eng_kw):
    _, cfg, _, model = bridged()
    prompts = workload(1)
    spec = run(port(model, cfg, speculative=True, gamma=3, **eng_kw),
               prompts, 20)
    assert spec == run(port(model, cfg, **eng_kw), prompts, 20)


def test_topk1_sampled_equals_greedy_with_zero_accepts():
    """top_k=1 makes the target law a point mass: the sampled engine
    emits the greedy stream, and on a prompt with no bigram repeat every
    proposal rejects (accept prob p[prop] is 0 or 1): gamma rows rewound
    per verify."""
    _, cfg, _, model = bridged()
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(0, cfg.vocab, 5))]
    eng = port(model, cfg, speculative=True, gamma=3, temperature=0.7,
               top_k=1)
    assert run(eng, prompts, 5) == run(port(model, cfg), prompts, 5)
    m = eng.pool_metrics()
    assert m["spec_accept_rate"] == 0.0
    assert m["spec_tokens_per_dispatch"] == 1.0
    assert m["spec_rewound_tokens_total"] == 3 * 4      # gamma x verifies
    eng._alloc.assert_consistent()


def test_draft_equal_to_target_accepts_everything():
    """A draft sharing the target's weights and sampler gives q == p:
    every proposal accepts and each verify commits gamma + 1 tokens."""
    _, cfg, _, model = bridged()
    draft = DraftModelProposer(cfg, model, temperature=0.7, ctx=32)
    eng = port(model, cfg, speculative=True, gamma=3, proposer=draft,
               temperature=0.7)
    rng = np.random.default_rng(1)
    # 9 = the prefill token + 2 full-accept verifies x (gamma + 1).
    (out,) = run(eng, [list(rng.integers(0, cfg.vocab, 6))], 9)
    m = eng.pool_metrics()
    assert m["spec_accept_rate"] == 1.0
    assert m["spec_tokens_per_dispatch"] == 4.0
    assert m["spec_proposer"] == "draft"
    assert len(out) == 9
    eng._alloc.assert_consistent()


def test_sampled_spec_replays_from_the_seed():
    _, cfg, _, model = bridged()
    prompts = workload(3)
    runs = [run(port(model, cfg, speculative=True, gamma=3, seed=s,
                     temperature=0.9, top_k=20), prompts)
            for s in (5, 5, 6)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_sampled_tokens_follow_the_target_law():
    """400 requests of one prompt through one engine (vocab 16, gamma 2,
    temperature 1): the first token (prefill) and the second (the
    rejection-sampling verify) must follow the exact marginals —
    softmax of the last logits, and the one-step chain marginal. TV
    distance stays at the multinomial noise floor (~0.08 for 16 symbols x
    400 draws); a rule that always committed proposals lands near 0.9."""
    _, cfg, _, model = bridged(dict(vocab=16), seed=3)
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(0, 16, 3)] * 3
    eng = ContinuousBatcher(model, cfg, device="cpu", kv_layout="paged",
                            n_slots=16, max_len=32, chunk=4,
                            prefill_bucket=16,
                            page_size=8, speculative=True, gamma=2,
                            temperature=1.0, seed=11)
    draws = np.asarray(run(eng, [prompt] * 400, 2))
    with torch.no_grad():
        base = torch.tensor([prompt])
        p1 = torch.softmax(forward(model, base)[0, -1], -1).numpy()
        p2 = np.zeros(16)
        for t1 in range(16):
            ext = torch.cat([base, torch.tensor([[t1]])], dim=1)
            p2 += p1[t1] * torch.softmax(forward(model, ext)[0, -1],
                                         -1).numpy()
    tv1 = 0.5 * np.abs(np.bincount(draws[:, 0], minlength=16) / 400
                       - p1).sum()
    tv2 = 0.5 * np.abs(np.bincount(draws[:, 1], minlength=16) / 400
                       - p2).sum()
    assert tv1 < 0.2, f"first-token TV {tv1:.3f} off the target law"
    assert tv2 < 0.2, f"second-token TV {tv2:.3f} off the target law"


class _Poison(BigramProposer):
    """Raises for one request id, proposes by bigram for the rest."""

    def __init__(self, bad_rid):
        super().__init__()
        self.bad_rid = bad_rid

    def propose(self, view, gamma):
        if view.rid == self.bad_rid:
            raise RuntimeError("poisoned proposal")
        return super().propose(view, gamma)


def test_failing_proposer_fails_only_its_request():
    _, cfg, _, model = bridged()
    prompts = workload(4)
    clean = run(port(model, cfg, speculative=True, gamma=3), prompts)
    eng = port(model, cfg, speculative=True, gamma=3, proposer=_Poison(1))
    ids = [eng.submit(p, max_new=12) for p in prompts]
    done = eng.run()
    assert set(done) == set(ids) - {1}
    assert [done[i] for i in ids if i != 1] == \
        [s for i, s in zip(ids, clean) if i != 1]
    assert "poisoned proposal" in eng.errors[1]
    assert eng.pool_metrics()["request_errors_total"] == 1.0
    eng._alloc.assert_consistent()
    assert eng._alloc.in_use == 0


def test_eos_and_page_exhaustion_keep_the_pool_consistent():
    """A pool that backs two of three slots (page-denied admissions), eos
    reaps mid-speculation and reject-heavy streams: the allocator stays
    partitioned after every step and is whole at the end."""
    _, cfg, _, model = bridged()
    rng = np.random.default_rng(3)
    eng = ContinuousBatcher(model, cfg, device="cpu", kv_layout="paged",
                            n_slots=3, max_len=64, chunk=4, prefill_bucket=8,
                            page_size=8,
                            n_pages=7, speculative=True, gamma=3, eos_id=7)
    for plen, mn in ((5, 9), (11, 5), (3, 13), (7, 3)):
        eng.submit(rng.integers(0, cfg.vocab, plen), max_new=mn)
    denied = False
    while eng.pending:
        eng.step()
        eng._alloc.assert_consistent()
        denied = denied or eng.pool_metrics()["page_denied"] > 0
    m = eng.pool_metrics()
    assert m["pages_in_use"] == 0 and m["pages_free"] == m["pages_total"]
    assert denied, "pool was never exhausted; shrink n_pages"


def test_shared_prefix_pages_survive_overshoot():
    """The bytes of a mounted shared page (and its int8 scales) are the
    same before and after verifies that write and rewind above it."""
    _, cfg, _, model = bridged()
    rng = np.random.default_rng(4)
    sysp = list(rng.integers(0, cfg.vocab, 8))
    eng = port(model, cfg, kv_dtype="int8", prefix_cache=True,
               speculative=True, gamma=3)
    eng.submit(sysp + list(rng.integers(0, cfg.vocab, 3)), max_new=2)
    eng.run()                              # the reap donates the page
    eng.submit(sysp + list(rng.integers(0, cfg.vocab, 4)), max_new=9)
    eng.step()                             # mounts it
    shared = sorted({p for pages in eng._slot_shared.values()
                     for p in pages})
    assert shared
    before = eng._k[:, shared].clone(), eng._ks[:, shared].clone()
    while eng.pending:
        eng.step()
    assert torch.equal(eng._k[:, shared], before[0])
    assert torch.equal(eng._ks[:, shared], before[1])
    eng._alloc.assert_consistent()


def test_overshoot_is_reserved_in_admission_math():
    _, cfg, _, model = bridged()
    eng = ContinuousBatcher(model, cfg, device="cpu", kv_layout="paged",
                            max_len=32, page_size=8, n_slots=2,
                            speculative=True,
                            gamma=4)
    eng.submit(list(range(8)), max_new=21)          # 8 + 20 + 4 == 32
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(list(range(8)), max_new=22)      # ... == 33 > 32


def test_bad_speculative_configs_raise():
    _, cfg, _, model = bridged()
    with pytest.raises(ValueError, match="gamma"):
        port(model, cfg, speculative=True, gamma=0)
    with pytest.raises(ValueError, match="proposer"):
        port(model, cfg, speculative=True, proposer="markov-chain")
    with pytest.raises(ValueError, match="protocol"):
        port(model, cfg, speculative=True, proposer=object())
