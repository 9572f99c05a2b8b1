"""The port's ContinuousBatcher holds the JAX engine's contract: its
options and their defaults, the decoded-suffix donation switch, and the
gauges ``pool_metrics()`` reports on the paged layout.

Both engines get the same f32 tiny weights (JAX ``init_params``, carried
by the bridge) and the same traffic from a numpy seed; the JAX engine runs
its Pallas kernels in interpret mode, the port its plain versions (CPU
tensors). The options the port refuses for good are listed by name; the
tier's knobs and the lifecycle gauges are held to JAX's."""
import inspect
import time

import jax
import numpy as np
import pytest

from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
from test_torch_serving import ENGINE, configs, step_all

# JAX options of the multi-device slice, each with a non-default value:
# without a mesh they build an engine, as in JAX, and change nothing.
DEFERRED = [
    pytest.param("weight_sharding", False, "none", id="weight_sharding"),
    pytest.param("tp_combine", "psum", "none", id="tp_combine"),
]
# JAX options the port refuses for good, by its standing rule: it serves
# through the attention kernels, so no later slice brings the dense decode,
# the gather prefix prefill or the mesh-constrained contiguous cache (JAX's
# dense "mesh_contiguous" path). (config overrides, JAX engine kwargs,
# port engine kwargs, the option's name in the message); a "mesh" entry is
# a tp = 2 mesh of the package's kind — the port refuses it before reading
# it, so it gets a placeholder.
REFUSED = [
    pytest.param({"decode_attn": "dense"}, {}, {}, "decode_attn='dense'",
                 id="decode_attn=dense"),
    pytest.param({}, {"prefill_attn": "gather"}, {"prefill_attn": "gather"},
                 "prefill_attn='gather'", id="prefill_attn=gather"),
    pytest.param({}, {"kv_layout": "contiguous", "prefix_cache": False,
                      "mesh": "tp2"},
                 {"kv_layout": "contiguous", "prefix_cache": False,
                  "mesh": object()},
                 "mesh= with kv_layout='contiguous'",
                 id="contiguous_on_mesh"),
]


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = configs()
    params = j_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


def engines(weights, **kw):
    jcfg, cfg, params, model = weights
    return (JEngine(params, jcfg, **ENGINE, **kw),
            ContinuousBatcher(model, cfg, device="cpu", **ENGINE, **kw))


@pytest.mark.parametrize("name,value,combine", DEFERRED)
def test_deferred_options_raise_naming_their_slice(weights, name, value,
                                                   combine):
    """The multi-device slice's options are accepted: off a mesh they
    build the paged engine as in JAX, report tp 1 and JAX's combine label,
    and serve JAX's streams."""
    jeng, eng = engines(weights, **{name: value})
    assert shared_prefix_traffic(eng) == shared_prefix_traffic(jeng)
    got, want = eng.pool_metrics(), jeng.pool_metrics()
    for key in ("tp", "tp_combine", "weight_sliced_device_bytes"):
        assert got[key] == want[key]
    assert got["tp"] == 1.0 and got["tp_combine"] == combine
    assert eng.replica_stats()["tp"] == jeng.replica_stats()["tp"] == 1


@pytest.mark.parametrize("cfg_kw,jax_kw,port_kw,what", REFUSED)
def test_refused_options_name_the_standing_rule(weights, cfg_kw, jax_kw,
                                                port_kw, what):
    """The options the JAX engine accepts and the port refuses raise
    ``NotImplementedError`` saying it is the port's standing rule, not a
    later slice, while the JAX engine builds with them."""
    import dataclasses
    import warnings

    from jax.sharding import Mesh

    jcfg, cfg, params, model = weights
    if jax_kw.get("mesh") == "tp2":
        jax_kw = {**jax_kw, "mesh": Mesh(np.array(jax.devices()[:2]),
                                         ("tp",))}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # JAX's downgrade
        JEngine(params, dataclasses.replace(jcfg, **cfg_kw),
                **{**ENGINE, **jax_kw})
    with pytest.raises(NotImplementedError) as e:
        ContinuousBatcher(model, dataclasses.replace(cfg, **cfg_kw),
                          device="cpu", **{**ENGINE, **port_kw})
    msg = str(e.value)
    assert what in msg and "standing rule" in msg
    assert "no later slice" in msg


@pytest.mark.parametrize("role", ["mixed", "prefill", "decode"])
def test_role_is_accepted_as_in_jax(weights, role):
    """``role`` is no longer deferred: each of JAX's three values builds a
    paged engine that reports it, and an unknown one raises JAX's
    ``ValueError``."""
    jcfg, cfg, params, model = weights
    eng = ContinuousBatcher(model, cfg, device="cpu", **ENGINE, role=role)
    assert eng.role == JEngine(params, jcfg, **ENGINE, role=role).role == role
    assert eng.replica_stats()["role"] == role
    with pytest.raises(ValueError, match="role must be"):
        ContinuousBatcher(model, cfg, device="cpu", **ENGINE, role="both")


@pytest.mark.parametrize("name,value", [("dram_pages", 64),
                                        ("kv_tier_disk", "tier")],
                         ids=["dram_pages", "kv_tier_disk"])
def test_tier_knobs_need_tiering_as_in_jax(weights, name, value):
    """The tier's knobs raise JAX's error without ``kv_tiering=True`` and
    build a tiered engine with it (``dram_pages`` its DRAM capacity)."""
    jcfg, cfg, params, model = weights
    errors = []
    for build, w, c in ((JEngine, params, jcfg),
                        (ContinuousBatcher, model, cfg)):
        kw = {} if build is JEngine else dict(device="cpu")
        with pytest.raises(ValueError) as e:
            build(w, c, **ENGINE, **kw, **{name: value})
        errors.append(str(e.value))
        eng = build(w, c, **ENGINE, **kw, kv_tiering=True, **{name: value})
        errors.append(eng.pool_metrics()["tier_dram_capacity"])
    assert errors[0] == errors[2] == \
        "dram_pages/kv_tier_disk require kv_tiering=True"
    assert errors[1] == errors[3] == (64.0 if name == "dram_pages" else 17.0)


def test_jax_defaults_are_the_ports_and_accepted(weights):
    """The six options added to the port default to the JAX engine's
    values, as do ``kv_layout`` and the observability options (``tracer``,
    ``flight_capacity``); passing those defaults explicitly does not
    raise."""
    names = ("dram_pages", "kv_tier_disk", "donate_decoded",
             "weight_sharding", "tp_combine", "clock", "kv_layout",
             "tracer", "flight_capacity")
    jax_sig = inspect.signature(JEngine.__init__).parameters
    port_sig = inspect.signature(ContinuousBatcher.__init__).parameters
    defaults = {n: jax_sig[n].default for n in names}
    assert {n: port_sig[n].default for n in names} == defaults
    _, cfg, _, model = weights
    eng = ContinuousBatcher(model, cfg, device="cpu", **defaults)
    assert eng.layout == "contiguous"


def test_default_layout_is_contiguous(weights):
    """``ContinuousBatcher(model, cfg)`` builds the contiguous engine, as
    ``ContinuousBatcher(params, cfg)`` does in JAX: no pool, no gauges."""
    jcfg, cfg, params, model = weights
    jeng = JEngine(params, jcfg)
    eng = ContinuousBatcher(model, cfg, device="cpu")
    assert eng.layout == jeng.layout == "contiguous"
    assert eng.pool_metrics() == jeng.pool_metrics() == {}


def two_turns(eng, seed=3):
    """A two-turn conversation whose second prompt is the first turn's
    transcript plus 4 new tokens; (streams, prefill_tokens_skipped after
    the second turn's admission)."""
    rng = np.random.default_rng(seed)
    p1 = list(rng.integers(0, 256, 16))
    eng.submit(p1, max_new=12)
    (t1,) = step_all(eng).values()
    eng.submit(p1 + t1 + list(rng.integers(0, 256, 4)), max_new=4)
    (t2,) = step_all(eng).values()
    eng._alloc.assert_consistent()
    return [t1, t2], eng.pool_metrics()["prefill_tokens_skipped"]


@pytest.mark.parametrize("donate", [True, False], ids=["donate", "keep"])
def test_donate_decoded_matches_jax(weights, donate):
    """With ``donate_decoded=False`` the second turn mounts only the first
    prompt's two full pages (16 tokens); with the default it mounts the
    decoded suffix too. Streams and the skip count equal the JAX
    engine's either way."""
    jeng, eng = engines(weights, donate_decoded=donate)
    ref = two_turns(jeng)
    got = two_turns(eng)
    assert got == ref
    assert (got[1] > 16) if donate else (got[1] == 16)


def shared_prefix_traffic(eng, seed=5):
    """A miss, then three requests sharing its page-aligned 16-token
    system prompt (hits of 16), one of them finishing at admission."""
    rng = np.random.default_rng(seed)
    system = list(rng.integers(0, 256, 16))
    eng.submit(system + list(rng.integers(0, 256, 5)), max_new=6)
    streams = list(step_all(eng).values())
    for max_new in (6, 1, 6):
        eng.submit(system + list(rng.integers(0, 256, 5)), max_new=max_new)
    done = step_all(eng)
    return streams + [done[k] for k in sorted(done)]


def test_pool_metrics_keys_and_gauges_match_jax(weights):
    """The paged engine reports the JAX engine's pool_metrics() keys; the
    pool's and the weights' device bytes (all of them and the sliceable
    subset) are equal, and an idle engine's step age is 0.0."""
    jeng, eng = engines(weights)
    assert shared_prefix_traffic(eng) == shared_prefix_traffic(jeng)
    want, got = jeng.pool_metrics(), eng.pool_metrics()
    assert set(got) == set(want)
    for key in ("kv_pool_device_bytes", "weight_device_bytes",
                "weight_sliced_device_bytes"):
        assert got[key] == want[key] > 0
    assert got["tp"] == want["tp"] == 1.0
    assert got["tp_combine"] == want["tp_combine"] == "none"
    for key in ("drain_duration_seconds", "restore_duration_seconds",
                "requests_resumed_total", "requests_shed_total"):
        assert got[key] == want[key] == 0.0
    assert got["last_step_age_seconds"] == want["last_step_age_seconds"] \
        == 0.0


def test_prefix_hit_batch_matches_jax_and_drains_once(weights):
    """``prefix_hit_token_batch`` holds one hit length per admission (a
    miss is 0), the JAX engine's, and a second call has none."""
    jeng, eng = engines(weights)
    shared_prefix_traffic(jeng)
    shared_prefix_traffic(eng)
    want = jeng.pool_metrics()["prefix_hit_token_batch"]
    got = eng.pool_metrics()["prefix_hit_token_batch"]
    assert got == want == (0, 16, 16, 16)
    assert "prefix_hit_token_batch" not in eng.pool_metrics()
    assert "prefix_hit_token_batch" not in jeng.pool_metrics()


def test_last_step_age_grows_while_work_is_pending(weights):
    """The liveness gauge: the age of the last step's start while a
    request is queued or in flight, 0.0 once the engine is idle."""
    _, eng = engines(weights)
    eng.submit(list(range(3, 20)), max_new=8)
    eng.step()
    time.sleep(0.01)
    assert eng.pending and eng.pool_metrics()["last_step_age_seconds"] > 0
    step_all(eng)
    assert eng.pool_metrics()["last_step_age_seconds"] == 0.0
