"""The port's KV tiering against the JAX engine's: demotion into the host
tier instead of forgetting, promotion ahead of the slot's first prefill,
the disk third tier, and the tier across drain/restore/absorb.

Both engines get the same f32 tiny weights (JAX ``init_params``, carried
by the bridge) and the same traffic: three distinct 28-token prompts run
one at a time through a pool too small to keep their pages (10 pages,
about 5 a request), then the first two again. With tiering on, the
re-submitted prompts promote their demoted pages back; greedy streams
must equal tiering off and the JAX engine's, token for token, and the
counters the JAX engine's. The JAX engine runs its Pallas kernels in
interpret mode; the port runs its plain versions (CPU tensors)."""
import os

import jax
import numpy as np
import pytest

from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.models.paging import HostTierStore as JTier
from k8s_gpu_scheduler_tpu.models.paging import PageAllocator as JAlloc
from k8s_gpu_scheduler_tpu.models.prefix_cache import PrefixCache as JCache
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models.paging import (
    HostTierStore, PageAllocator)
from k8s_gpu_scheduler_tpu_torch.models.prefix_cache import PrefixCache
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
from k8s_gpu_scheduler_tpu_torch.models.snapshot import ServingSnapshot
from test_torch_serving import configs

PAGE = 8
ENGINE = dict(n_slots=2, max_len=64, chunk=2, prefill_bucket=8,
              kv_layout="paged", page_size=PAGE, n_pages=10,
              kv_dtype="int8", prefix_cache=True)
ROUND_TRIP = [0, 1, 2, 0, 1]
TIER_GAUGES = ("tier_dram_pages", "tier_dram_capacity", "tier_disk_pages",
               "tier_pending_demotions", "page_demotions_total",
               "tier_spills_total", "tier_forgotten_total",
               "tier_cancelled_demotions", "prefix_demoted_pages",
               "page_promotions_total", "prefill_tokens_skipped")


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = configs()
    params = j_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


def engine(weights, side="port", **kw):
    jcfg, cfg, params, model = weights
    if side == "jax":
        return JEngine(params, jcfg, **{**ENGINE, **kw})
    return ContinuousBatcher(model, cfg, device="cpu", **{**ENGINE, **kw})


def prompts(n=3, seed=5):
    """Distinct 28-token prompts (3 full pages and a tail each): a
    re-submitted prompt can hit only its own, by then demoted, path."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, 256, 28)) for _ in range(n)]


def drive(eng, trace, ps, max_new=8):
    """Run ``ps[i] for i in trace`` one at a time (each reaps, and with
    tiering demotes, before the next admits): the streams in order."""
    out = []
    for i in trace:
        rid = eng.submit(ps[i], max_new=max_new)
        done = {}
        while eng.pending:
            done.update(eng.step())
        out.append(done[rid])
        eng._alloc.assert_consistent()
    return out


def gauges(eng):
    m = eng.pool_metrics()
    return {k: m.get(k) for k in TIER_GAUGES}


@pytest.mark.parametrize("kvd,spec", [(None, False), ("int8", False),
                                      (None, True), ("int8", True)],
                         ids=["f32", "int8kv", "spec", "int8kv-spec"])
def test_tiering_on_equals_off_and_jax(weights, kvd, spec):
    """Demote → promote round trips change no stream: tiering on == off
    in the port, == the JAX tiered engine, with the JAX engine's tier
    counters; the trace really cycles the tier."""
    kw = dict(kv_dtype=kvd, speculative=spec)
    ps = prompts()
    on_eng = engine(weights, kv_tiering=True, dram_pages=32, **kw)
    on = drive(on_eng, ROUND_TRIP, ps)
    off = drive(engine(weights, **kw), ROUND_TRIP, ps)
    j_eng = engine(weights, "jax", kv_tiering=True, dram_pages=32, **kw)
    assert on == off == drive(j_eng, ROUND_TRIP, ps)
    got = gauges(on_eng)
    assert got == gauges(j_eng)
    assert got["page_demotions_total"] > 0
    assert got["page_promotions_total"] > 0
    assert got["tier_dram_pages"] > 0


def test_promotion_skips_prefill_as_in_jax(weights):
    """The re-submitted prompts' full-page prefixes come from the tier:
    skipped tokens cover the promoted pages, and the promoted-hit batch
    equals the JAX engine's and drains once."""
    ps = prompts()
    engines = [engine(weights, side, kv_tiering=True, dram_pages=32)
               for side in ("port", "jax")]
    for eng in engines:
        drive(eng, ROUND_TRIP, ps)
    got, want = (eng.pool_metrics() for eng in engines)
    assert got["prefill_tokens_skipped"] == want["prefill_tokens_skipped"] \
        >= got["page_promotions_total"] * PAGE > 0
    assert got["promoted_hit_token_batch"] \
        == want["promoted_hit_token_batch"]
    assert all(t > 0 for t in got["promoted_hit_token_batch"])
    assert got["prefix_hit_token_batch"] == want["prefix_hit_token_batch"]
    assert "promoted_hit_token_batch" not in engines[0].pool_metrics()


def test_full_tier_degrades_to_forget(weights):
    """dram_pages=2 cannot hold the evictions: the overflow is forgotten,
    admission keeps flowing, streams equal tiering off, and the counters
    equal the JAX engine's."""
    ps = prompts(n=4)
    trace = [0, 1, 2, 3, 0]
    on_eng = engine(weights, kv_tiering=True, dram_pages=2)
    j_eng = engine(weights, "jax", kv_tiering=True, dram_pages=2)
    assert drive(on_eng, trace, ps) == drive(engine(weights), trace, ps) \
        == drive(j_eng, trace, ps)
    got = gauges(on_eng)
    assert got == gauges(j_eng)
    assert got["tier_forgotten_total"] > 0 and got["tier_dram_pages"] <= 2


def test_disk_spills_only_when_dram_is_full(weights, tmp_path):
    """The disk tier stays empty under a roomy DRAM budget; under a tiny
    one the coldest pages spill there and a re-submitted prompt promotes
    straight from disk, streams unchanged."""
    ps = prompts()
    roomy, tiny = tmp_path / "roomy", tmp_path / "tiny"
    eng = engine(weights, kv_tiering=True, dram_pages=32,
                 kv_tier_disk=str(roomy))
    on = drive(eng, ROUND_TRIP, ps)
    m = eng.pool_metrics()
    assert m["tier_spills_total"] == 0 and m["tier_disk_pages"] == 0
    assert not roomy.exists() or not any(os.scandir(roomy))
    eng2 = engine(weights, kv_tiering=True, dram_pages=2,
                  kv_tier_disk=str(tiny))
    assert drive(eng2, ROUND_TRIP, ps) == on == drive(engine(weights),
                                                      ROUND_TRIP, ps)
    m2 = eng2.pool_metrics()
    assert m2["tier_spills_total"] > 0
    assert m2["page_promotions_total"] > 0


@pytest.mark.parametrize("side", ["port", "jax"])
def test_pending_match_cancels_demotion(side):
    """A match that crosses a pending demotion (bytes not yet copied off
    the pool) takes the page back in place: nothing is copied, nothing
    counts as a demotion. Both packages' host structures agree."""
    alloc_cls, tier_cls, cache_cls = (
        (PageAllocator, HostTierStore, PrefixCache) if side == "port"
        else (JAlloc, JTier, JCache))
    alloc = alloc_cls(8)
    tier = tier_cls(16)
    cache = cache_cls(alloc, 4, tier=tier)
    pages = alloc.alloc(2)
    toks = list(range(8))
    cache.insert(toks, pages)
    assert cache.evict(2) == 2
    assert tier.metrics()["tier_pending_demotions"] == 2
    assert cache.demoted_count == 2
    alloc.assert_consistent()
    path, demoted = cache.match_tiered(toks + [99])
    assert demoted == [] and path == pages
    m = tier.metrics()
    assert m["tier_cancelled_demotions"] == 2
    assert m["tier_pending_demotions"] == 0
    assert m["page_demotions_total"] == 0
    assert len(cache) == 2 and cache.demoted_count == 0
    assert cache.dump_paths() == [(toks, pages)]
    alloc.assert_consistent()


def _warm_tiered(weights, ps, **kw):
    """An engine whose tier is populated by [0, 1, 2], with prompts 0
    and 1 queued again and one step taken."""
    eng = engine(weights, kv_tiering=True, dram_pages=32, **kw)
    out = drive(eng, [0, 1, 2], ps)
    rids = [eng.submit(ps[i], max_new=8) for i in (0, 1)]
    done = dict(eng.step())
    return eng, rids, done, out


@pytest.mark.parametrize("restore_kw", [
    dict(kv_tiering=True, dram_pages=32),
    dict(kv_tiering=True, dram_pages=4),
    dict()], ids=["same-tier", "smaller-tier", "untiered"])
def test_restore_with_a_populated_tier(weights, restore_kw):
    """A snapshot with a populated tier resumes as the undrained tiered
    run: into the same budget (the restored tier still promotes), into a
    smaller one (the hottest tail kept) and untiered (the sidecar
    dropped, the tree paths cut at it). The JAX engine restores the same
    snapshot to the same streams."""
    ps = prompts()
    ref = drive(engine(weights, kv_tiering=True, dram_pages=32),
                ROUND_TRIP, ps)
    eng, rids, done, out = _warm_tiered(weights, ps)
    snap = eng.drain()
    assert snap.tier_keys and snap.tier_k is not None
    tree = snap.to_pytree()
    for side in ("port", "jax"):
        fresh = engine(weights, side, **restore_kw)
        if side == "jax":
            from k8s_gpu_scheduler_tpu.models.snapshot import (
                ServingSnapshot as JSnapshot)
            fresh.restore(JSnapshot.from_pytree(tree))
        else:
            fresh.restore(ServingSnapshot.from_pytree(tree))
        got = dict(done)
        while fresh.pending:
            got.update(fresh.step())
        assert out + [got[r] for r in rids] == ref
        fresh._alloc.assert_consistent()
        m = fresh.pool_metrics()
        if not restore_kw:
            assert "tier_dram_pages" not in m
        elif restore_kw["dram_pages"] == 4:
            assert m["tier_dram_pages"] <= 4
        elif side == "port":
            extra = drive(fresh, [2], ps)
            assert extra == [ref[2]]
            assert fresh.pool_metrics()["page_promotions_total"] > 0


def test_absorb_onto_demoted_pages(weights):
    """A slot shed (partial drain) from an untiered engine is absorbed by
    a tiered one whose copy of the same prefix is demoted: the stream
    finishes as without the hop, and its reap donates resident pages over
    the demoted nodes (the tier copies dropped, no promotion run), as the
    JAX engine does."""
    ps = prompts()
    ref = drive(engine(weights), ROUND_TRIP, ps)
    results = []
    for side in ("port", "jax"):
        dst = engine(weights, side, kv_tiering=True, dram_pages=32)
        drive(dst, [0, 1, 2], ps)
        _, demoted = dst._prefix.match_tiered(ps[0] + [0], count=False)
        assert demoted
        promos = dst.pool_metrics()["page_promotions_total"]
        src = engine(weights, side)
        rid = src.submit(ps[0], max_new=8)
        src.step()
        part = src.drain(slots=sorted(src._slot_req))
        tree = part.to_pytree()
        if side == "jax":
            from k8s_gpu_scheduler_tpu.models.snapshot import (
                ServingSnapshot as JSnapshot)
            part = JSnapshot.from_pytree(tree)
        else:
            part = ServingSnapshot.from_pytree(tree)
        mapping = dst.absorb(part)
        src._alloc.assert_consistent()
        dst._alloc.assert_consistent()
        done = {}
        while dst.pending:
            done.update(dst.step())
        dst._alloc.assert_consistent()
        path, demoted = dst._prefix.match_tiered(ps[0] + [0], count=False)
        results.append((done[mapping[rid]], len(path), demoted,
                        dst.pool_metrics()["page_promotions_total"] - promos,
                        gauges(dst)))
    assert results[0] == results[1]
    stream, n_path, demoted, promoted, _ = results[0]
    assert stream == ref[0]
    assert n_path == 3 and demoted == [] and promoted == 0


@pytest.mark.parametrize("kw,match", [
    (dict(kv_layout="contiguous", prefix_cache=False, kv_tiering=True),
     "kv_layout='paged'"),
    (dict(prefix_cache=False, kv_tiering=True), "prefix_cache=True"),
    (dict(dram_pages=8), "kv_tiering=True"),
    (dict(kv_tier_disk="tier"), "kv_tiering=True")],
    ids=["contiguous", "no-prefix-cache", "dram_pages", "kv_tier_disk"])
def test_tier_options_validated_as_in_jax(weights, kw, match):
    """The tier's options are refused where JAX refuses them, with its
    messages."""
    errors = []
    for side in ("port", "jax"):
        with pytest.raises(ValueError, match=match) as e:
            engine(weights, side, **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
