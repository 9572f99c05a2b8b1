"""The port's contiguous serving path against the JAX one: ``cached_attention``
with its fused routes, ``generate``, ``generate_speculative`` (B = 1) and
the shared-cursor ``ContinuousBatcher(kv_layout="contiguous")``.

Both sides get the same f32 tiny weights (JAX ``init_params``, carried by
the bridge) and the same inputs from numpy seeds. Greedy streams must
match token for token. The JAX side runs its Pallas kernels in interpret
mode; the port runs its plain versions (CPU tensors: K4's
``flash_decode_reference``, K3's ``paged_verify_reference``). The engine's
traffic uses a small cache (S = 32) so that a strict-FCFS stop and an
epoch roll both fire, with a burst of ``max_new == 1`` requests inside.
Sampled streams cannot equal JAX's (other generators): they are held to
replay identity, ``top_k=1`` == greedy and the target law (TV distance)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models import serving as jserving
from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.ops.quant import quantize_llama_params as j_quant
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models.llama import forward
from k8s_gpu_scheduler_tpu_torch.models.serving import (
    ContinuousBatcher, cached_attention, generate, generate_speculative,
    make_server_step, make_speculative_server_step)
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from k8s_gpu_scheduler_tpu_torch.parallel.mesh import MeshAxes
from test_torch_serving import configs, step_all

ENGINE = dict(kv_layout="contiguous", n_slots=2, max_len=32, chunk=4,
              prefill_bucket=8)


def bridged(seed=0, int8_weights=False, decode_attn="fused", **cfg_kw):
    """(jax cfg, port cfg, jax params, port model on the CPU)."""
    jcfg, cfg = (dataclasses.replace(c, decode_attn=decode_attn)
                 for c in configs(**cfg_kw))
    params = j_init(jcfg, jax.random.PRNGKey(seed))
    if int8_weights:
        params = j_quant(params)
    return jcfg, cfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


# -- cached_attention -----------------------------------------------------------

def _attn_inputs(t, seed=0, B=2, H=8, Hkv=2, hd=32, S=64):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, t, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("t,verify,kernel", [
    (1, False, "flash_decode_reference"), (5, True, "paged_verify_reference"),
    (4, False, None)], ids=["decode-K4", "verify-K3", "prefill-dense"])
def test_cached_attention_fused_matches_dense_and_jax(t, verify, kernel):
    """t == 1 goes through K4, a verify window through K3 over the cache
    viewed as pages, a prefill stays dense; each equals the port's dense
    path and the JAX function (f32, 2e-5)."""
    q, k, v = _attn_inputs(t)
    pos = 21
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    dense = cached_attention(tq, tk, tv, pos)
    da.reset_counters()
    fused = cached_attention(tq, tk, tv, pos, impl="fused", verify=verify)
    calls = {n: c for n, c in da.counters().items() if c}
    assert calls == ({kernel: 1} if kernel else {})
    torch.testing.assert_close(fused, dense, atol=2e-5, rtol=2e-5)
    ref = jserving.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
        impl="fused", interpret=True, verify=verify)
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_verify_route_refuses_an_unblockable_cache():
    """JAX falls back to the dense path when no power-of-two block divides
    S; the port raises, naming S (the t == 1 route takes any S)."""
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(5, S=100))
    with pytest.raises(ValueError, match="S=100"):
        cached_attention(q, k, v, 21, impl="fused", verify=True)
    one = cached_attention(q[:, :1], k, v, 21, impl="fused")
    torch.testing.assert_close(one, cached_attention(q[:, :1], k, v, 21),
                               atol=2e-5, rtol=2e-5)


# -- generate -------------------------------------------------------------------

@pytest.mark.parametrize("impl,cfg_kw", [("dense", {}),
                                         ("fused", {"n_kv_heads": 2})],
                         ids=["dense-mha", "fused-gqa4"])
def test_generate_matches_jax(impl, cfg_kw):
    jcfg, cfg, params, model = bridged(decode_attn=impl, **cfg_kw)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (2, 5),
                                               dtype=np.int32)
    ref = jserving.generate(params, jnp.asarray(prompt), jcfg, max_new=6,
                            max_len=32)
    da.reset_counters()
    got = generate(model, torch.from_numpy(prompt), cfg, max_new=6,
                   max_len=32)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    c = da.counters()
    # One K4 call per layer per token after the prefill's.
    assert c["flash_decode_reference"] == (
        cfg.n_layers * 5 if impl == "fused" else 0)
    assert c["flash_decode_attention"] == 0
    step = make_server_step(cfg, None, 6, max_len=32)
    assert torch.equal(step(model, torch.from_numpy(prompt)), got)


def test_generate_errors():
    _, cfg, _, model = bridged()
    prompt = torch.zeros((1, 30), dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds cache/rope capacity"):
        generate(model, prompt, cfg, max_new=3, max_len=32)
    # A mesh is a DeviceMesh (gang serving: tests/test_torch_gang_serve.py);
    # a pp axis is refused, as JAX has no pipelined serving either, and a
    # rank must hold its training blocks.
    with pytest.raises(TypeError, match="DeviceMesh"):
        generate(model, prompt, cfg, max_new=1, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_server_step(cfg, object(), 4)
    pp = MeshAxes(_NamedMesh(pp=2))
    with pytest.raises(ValueError, match="'pp' mesh axis"):
        generate(model, prompt[:, :8], cfg, max_new=1, mesh=pp)
    with pytest.raises(ValueError, match="'pp' mesh axis"):
        make_server_step(cfg, pp, 4)
    with pytest.raises(ValueError, match="this rank's block of it"):
        generate(model, prompt[:, :8], cfg, max_new=1,
                 mesh=MeshAxes(_NamedMesh(tp=2)))


class _NamedMesh:
    """A named mesh as ``mesh_coords`` reads one, at coordinate 0 on every
    axis (no process group: these calls raise before any collective)."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, i):
        return self._sizes[i]

    def get_local_rank(self, name):
        return 0


# -- generate_speculative -------------------------------------------------------

def _phrase_prompt(seed, vocab, phrase_len=4, reps=3):
    rng = np.random.default_rng(seed)
    return np.tile(rng.integers(0, vocab, phrase_len, dtype=np.int32),
                   reps)[None]


@pytest.mark.parametrize("impl,cfg_kw", [("dense", {}),
                                         ("fused", {"n_kv_heads": 2})],
                         ids=["dense-mha", "fused-gqa4"])
def test_generate_speculative_matches_jax_and_generate(impl, cfg_kw):
    """Greedy: token for token equal to the JAX function and to the
    port's ``generate``; the fused config verifies through K3 (its plain
    version here) and accepts proposals on a repeating prompt."""
    jcfg, cfg, params, model = bridged(decode_attn=impl, **cfg_kw)
    prompt = _phrase_prompt(2, cfg.vocab)
    ref = jserving.generate_speculative(params, jnp.asarray(prompt), jcfg,
                                        max_new=14, gamma=3, max_len=64)
    da.reset_counters()
    got = generate_speculative(model, torch.from_numpy(prompt), cfg,
                               max_new=14, gamma=3, max_len=64)
    c = da.counters()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got, generate(model, torch.from_numpy(prompt), cfg,
                                     max_new=14, max_len=64))
    verifies = c["paged_verify_reference"] // cfg.n_layers
    if impl == "fused":
        assert 0 < verifies < 13               # some window accepted
        assert c["paged_verify_reference"] % cfg.n_layers == 0
    else:
        assert not any(c.values())
    step = make_speculative_server_step(cfg, 14, gamma=3, max_len=64)
    assert torch.equal(step(model, torch.from_numpy(prompt)), got)


def test_generate_speculative_errors():
    _, cfg, _, model = bridged()
    with pytest.raises(ValueError, match="single-request"):
        generate_speculative(model, torch.zeros((2, 4), dtype=torch.int64),
                             cfg, max_new=4)
    prompt = torch.zeros((1, 8), dtype=torch.int64)
    generate_speculative(model, prompt, cfg, max_new=20, gamma=4, max_len=32)
    with pytest.raises(ValueError, match=r"gamma \(4\)"):   # 8 + 21 + 4 > 32
        generate_speculative(model, prompt, cfg, max_new=21, gamma=4,
                             max_len=32)
    with pytest.raises(ValueError, match="S=100"):
        generate_speculative(model, prompt, cfg, max_new=4, max_len=100)


def test_generate_speculative_sampled_replays_and_topk1_is_greedy():
    _, cfg, _, model = bridged()
    prompt = torch.from_numpy(_phrase_prompt(3, cfg.vocab))
    kw = dict(max_new=12, gamma=3, max_len=64)
    runs = [generate_speculative(model, prompt, cfg, temperature=0.9,
                                 top_k=20, seed=s, **kw) for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    greedy = generate(model, prompt, cfg, max_new=12, max_len=64)
    assert torch.equal(generate_speculative(
        model, prompt, cfg, temperature=0.7, top_k=1, seed=3, **kw), greedy)


def test_generate_speculative_samples_the_target_law():
    """300 seeds of one prompt (vocab 16, gamma 2, temperature 1): the
    first token (prefill) and the second (the rejection-sampling verify)
    follow the exact marginals. TV distance stays at the multinomial noise
    floor (~0.09 for 16 symbols x 300 draws); a rule that always committed
    its proposals lands near 0.9."""
    _, cfg, _, model = bridged(seed=3, vocab=16)
    prompt = torch.from_numpy(_phrase_prompt(5, 16, phrase_len=3))
    draws = np.concatenate([
        generate_speculative(model, prompt, cfg, max_new=2, gamma=2,
                             max_len=32, temperature=1.0, seed=s).numpy()
        for s in range(300)])
    with torch.no_grad():
        p1 = torch.softmax(forward(model, prompt.long())[0, -1], -1).numpy()
        p2 = np.zeros(16)
        for t1 in range(16):
            ext = torch.cat([prompt.long(), torch.tensor([[t1]])], dim=1)
            p2 += p1[t1] * torch.softmax(forward(model, ext)[0, -1],
                                         -1).numpy()
    for col, p in ((0, p1), (1, p2)):
        tv = 0.5 * np.abs(np.bincount(draws[:, col], minlength=16) / 300
                          - p).sum()
        assert tv < 0.2, f"token {col} TV {tv:.3f} off the target law"


# -- the contiguous engine ------------------------------------------------------

# (prompt length, max_new): the 21-token budget keeps one slot busy while
# short requests push the shared cursor past row 20; the 20- and 18-token
# prompts take the S rung, which fits only with cursor <= prompt length, so
# each blocks the queue (an FCFS stop) until the occupied slots drain and
# the epoch rolls; three max_new == 1 requests in a row hand their slot
# straight back within one step.
REQUESTS = [(3, 5), (5, 21), (4, 5), (4, 5), (4, 5), (20, 4), (7, 1), (2, 1),
            (6, 1), (6, 6), (18, 3), (5, 5)]


def traffic(eng, seed=3, requests=REQUESTS):
    rng = np.random.default_rng(seed)
    ids = [eng.submit(list(rng.integers(0, 256, n)), max_new=m)
           for n, m in requests]
    done = step_all(eng)
    return [done[i] for i in ids]


VARIANTS = [
    pytest.param({}, {}, False, id="f32"),
    pytest.param({"n_kv_heads": 2}, {}, False, id="gqa4"),
    pytest.param({}, {"kv_dtype": "int8"}, False, id="int8kv"),
    pytest.param({}, {}, True, id="int8w"),
]


@pytest.mark.parametrize("cfg_kw,eng_kw,int8_weights", VARIANTS)
def test_greedy_streams_match_jax_engine(cfg_kw, eng_kw, int8_weights):
    jcfg, cfg, params, model = bridged(int8_weights=int8_weights, **cfg_kw)
    ref = traffic(jserving.ContinuousBatcher(params, jcfg, **ENGINE,
                                             **eng_kw))
    da.reset_counters()
    eng = ContinuousBatcher(model, cfg, device="cpu", **ENGINE, **eng_kw)
    got = traffic(eng)
    assert got == ref
    assert [len(s) for s in got] == [m for _, m in REQUESTS]
    assert eng.fcfs_stops >= 1 and eng.epoch_rolls >= 2
    c = da.counters()
    assert c["flash_decode_reference"] > 0
    assert c["flash_decode_attention"] == 0
    assert not (c["paged_decode_reference"] or c["dense_prefill_reference"])
    assert eng.pool_metrics() == {}


def test_eos_matches_jax_engine():
    """An eos id taken from a greedy stream: both engines stop that
    request at its first eos (inclusive) and hand the slot on."""
    jcfg, cfg, params, model = bridged()
    full = traffic(ContinuousBatcher(model, cfg, device="cpu", **ENGINE))
    eos = full[1][3]
    ref = traffic(jserving.ContinuousBatcher(params, jcfg, eos_id=eos,
                                             **ENGINE))
    got = traffic(ContinuousBatcher(model, cfg, device="cpu", eos_id=eos,
                                    **ENGINE))
    assert got == ref
    assert got[1] == full[1][:4]
    assert all(s == f[:len(s)] for s, f in zip(got, full))


@pytest.mark.parametrize("eng_kw", [{}, {"kv_dtype": "int8"}],
                         ids=["f32", "int8kv"])
def test_contiguous_equals_paged_in_the_port(eng_kw):
    _, cfg, _, model = bridged(n_kv_heads=2)
    paged = dict(ENGINE, kv_layout="paged", page_size=8)
    assert traffic(ContinuousBatcher(model, cfg, device="cpu", **ENGINE,
                                     **eng_kw)) == \
        traffic(ContinuousBatcher(model, cfg, device="cpu", **paged,
                                  **eng_kw))


def test_run_matches_step_and_sampled_replay():
    """run() (reads deferred to the end) gives the step() streams; a
    sampled engine replays from its seed."""
    _, cfg, _, model = bridged()

    def by_run(**kw):
        eng = ContinuousBatcher(model, cfg, device="cpu", **ENGINE, **kw)
        rng = np.random.default_rng(3)
        ids = [eng.submit(list(rng.integers(0, 256, n)), max_new=m)
               for n, m in REQUESTS]
        done = eng.run()
        assert set(eng.pop_request_metrics()) == set(ids)
        return [done[i] for i in ids]

    assert by_run() == traffic(
        ContinuousBatcher(model, cfg, device="cpu", **ENGINE))
    runs = [by_run(temperature=0.9, top_k=20, seed=s) for s in (5, 5, 6)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


def test_max_new_one_burst_is_capped_per_step():
    """Six max_new == 1 requests on two slots: each step admits at most
    n_slots of them (the slot comes straight back), none occupies a slot,
    and no decode chunk runs."""
    jcfg, cfg, params, model = bridged()
    burst = [(4, 1)] * 6
    eng = ContinuousBatcher(model, cfg, device="cpu", **ENGINE)
    rng = np.random.default_rng(0)
    for n, m in burst:
        eng.submit(list(rng.integers(0, 256, n)), max_new=m)
    da.reset_counters()
    steps = []
    while eng.pending:
        steps.append(len(eng.step()))
    assert steps == [2, 2, 2]
    assert not any(da.counters().values())
    assert traffic(ContinuousBatcher(model, cfg, device="cpu", **ENGINE),
                   requests=burst) == \
        traffic(jserving.ContinuousBatcher(params, jcfg, **ENGINE),
                requests=burst)


def test_submit_and_option_errors():
    jcfg, cfg, params, model = bridged()

    def build(**kw):
        return ContinuousBatcher(model, cfg, device="cpu",
                                 **{**ENGINE, **kw})

    eng = build()
    eng.submit(list(range(8)), max_new=21)           # 8 + 24 chunk rows
    for prompt, max_new in ((list(range(8)), 26), ([], 4),
                            (list(range(4)), 0)):
        with pytest.raises(ValueError):
            eng.submit(prompt, max_new=max_new)
    for kw, match in ((dict(speculative=True), "speculative=True requires"),
                      (dict(prefix_cache=True), "prefix_cache=True requires"),
                      (dict(prefill_chunk_tokens=16),
                       "prefill_chunk_tokens requires"),
                      (dict(prefill_attn="kernel"), "prefill_attn requires"),
                      (dict(prefill_attn="gather"), "prefill_attn requires"),
                      (dict(kv_layout="ring"), "kv_layout must be"),
                      (dict(prefill_attn="einsum"), "prefill_attn must be"),
                      (dict(kv_tiering=True),
                       "kv_tiering=True requires kv_layout='paged'"),
                      (dict(role="prefill"),
                       "role='prefill' requires kv_layout='paged'")):
        with pytest.raises(ValueError, match=match):
            build(**kw)
    for kw, match in ((dict(mesh=object()), "standing rule"),
                      (dict(kv_layout="paged", page_size=8,
                            prefill_attn="gather"), "kernel only")):
        with pytest.raises(NotImplementedError, match=match):
            build(**kw)
    # The contiguous layout cannot drain, restore or absorb, in JAX too:
    # the snapshot format is pool pages and block tables.
    from k8s_gpu_scheduler_tpu.models.snapshot import (
        SnapshotError as JSnapshotError)
    from k8s_gpu_scheduler_tpu_torch.models.snapshot import SnapshotError
    jeng = jserving.ContinuousBatcher(params, jcfg, **ENGINE)
    for name in ("drain", "restore", "absorb"):
        with pytest.raises(JSnapshotError, match="kv_layout='paged'") as j:
            getattr(jeng, name)(None)
        with pytest.raises(SnapshotError, match="kv_layout='paged'") as e:
            getattr(eng, name)(None)
        assert str(e.value) == str(j.value)
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        jserving.ContinuousBatcher(params, jcfg, **ENGINE, kv_tiering=True)
    with pytest.raises(NotImplementedError, match="decode_attn"):
        ContinuousBatcher(model, dataclasses.replace(cfg,
                                                     decode_attn="dense"),
                          device="cpu", **ENGINE)
    # The contiguous layout needs no page-divisible capacity.
    build(max_len=30, page_size=64)


def test_prefill_window_breach_raises():
    """The in-place prefill writes refuse a window the host must never
    ask for (JAX's dynamic_update_slice would clamp it silently)."""
    _, cfg, _, model = bridged()
    eng = ContinuousBatcher(model, cfg, device="cpu", **ENGINE)
    args = (model, cfg, eng._k, eng._v, None, None, eng._bitmap,
            eng._rope_pos, eng._last)
    tokens = np.zeros((1, 8), np.int32)
    from k8s_gpu_scheduler_tpu_torch.models.serving import (
        _decode_chunk_fn, _prefill_multi_fn)
    for cursor, real_len in ((3, 5), (30, 4)):       # below 0; past S
        with pytest.raises(ValueError, match="leaves the cache"):
            _prefill_multi_fn(*args, slots=[0], cursors=[cursor],
                              tokens=tokens, real_lens=[real_len],
                              seed=(0, 1, 1))
    with pytest.raises(ValueError, match="leave the cache"):
        _decode_chunk_fn(model, cfg, 4, eng._k, eng._v, None, None,
                         eng._bitmap, 30, eng._rope_pos, eng._last,
                         torch.ones(2, dtype=torch.bool), eng._angles,
                         (0, 0, 1))
    assert not eng._bitmap.any()
