"""The port's fleet tier against the JAX package's: the same replicas, the
same traffic, the same clock, and the two ``Router``s must agree.

Both fleets get engines with the same f32 tiny weights (JAX
``init_params``, carried by the bridge) and each package's own
``VirtualClock``, shared by its router and its engines and advanced by
hand, so every heartbeat, deadline and latency reading is exact. Traffic
comes from a numpy seed. The JAX engines run their Pallas kernels in
interpret mode, the port's engines their plain versions (CPU tensors).
What must be equal, exactly: each request's placement, the streams,
``stats()``, the published ``ReplicaSummary`` JSON, the journal's
``to_pytree()`` bytes, the router's trace events and the Prometheus
exposition (less ``tpu_serve_decode_fallback_total``, a count of the whole
process's engine builds, which differs between the two packages' by what
else the process built). Streams are also held to a single-engine run of
the port."""
import dataclasses
import json
import pathlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from k8s_gpu_scheduler_tpu import fleet as jfleet
from k8s_gpu_scheduler_tpu import obs as jobs
from k8s_gpu_scheduler_tpu.metrics import exporter as jexporter
from k8s_gpu_scheduler_tpu.models import lifecycle as jlifecycle
from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu.testing import faults as jfaults
from k8s_gpu_scheduler_tpu.utils import retry as jretry
from k8s_gpu_scheduler_tpu_torch import fleet, obs
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.metrics import exporter
from k8s_gpu_scheduler_tpu_torch.models import lifecycle
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
from k8s_gpu_scheduler_tpu_torch.testing import faults
from k8s_gpu_scheduler_tpu_torch.utils import retry
from test_torch_serving import configs

PAGE = 8
BASE = dict(n_slots=4, max_len=64, chunk=4, prefill_bucket=8,
            kv_layout="paged", page_size=PAGE, prefix_cache=True)
SCHEMAS = pathlib.Path(__file__).parent / "data" / "graftcheck" / "schemas"
# Exposition families whose values are process-wide, not the fleet's.
NOT_EXPORTED = {"tpu_serve_decode_fallback_total"}
FAST_QUARANTINE = dict(attempts=8, base_s=0.05, multiplier=1.0, max_s=0.1,
                       jitter=0.5)


@pytest.fixture(scope="module")
def sides():
    """The two packages behind one interface: ``engine(**kw)`` builds a
    replica on the shared tiny weights."""
    jcfg, cfg = configs()
    params = j_init(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    jax_side = SimpleNamespace(
        name="jax", fleet=jfleet, obs=jobs, exporter=jexporter,
        faults=jfaults, lifecycle=jlifecycle, retry=jretry, vocab=jcfg.vocab,
        engine=lambda **kw: JEngine(params, jcfg, **{**BASE, **kw}))
    port_side = SimpleNamespace(
        name="port", fleet=fleet, obs=obs, exporter=exporter, faults=faults,
        lifecycle=lifecycle, retry=retry, vocab=cfg.vocab,
        engine=lambda **kw: ContinuousBatcher(model, cfg, device="cpu",
                                              **{**BASE, **kw}))
    return jax_side, port_side


def workload(vocab, n=10, n_classes=2, seed=0):
    """``n`` prompts over ``n_classes`` shared two-page system prompts."""
    rng = np.random.default_rng(seed)
    hot = [list(rng.integers(0, vocab, 2 * PAGE)) for _ in range(n_classes)]
    return [hot[i % n_classes] + list(rng.integers(0, vocab, 2 + i % 5))
            for i in range(n)]


def single_engine(side, prompts, max_new=8, **kw):
    """One engine's streams: greedy decode does not depend on placement."""
    eng = side.engine(**kw)
    ids = [eng.submit(p, max_new=max_new) for p in prompts]
    done = {}
    while eng.pending:
        done.update(eng.step())
    return [done[i] for i in ids]


def exposition(reg) -> list:
    """The exposition lines, less the families the port does not export."""
    return [ln for ln in reg.expose().splitlines()
            if not any(f in ln for f in NOT_EXPORTED)]


def events(tracer) -> list:
    return [(s.name, s.lane, s.rid, s.t0, s.t1, s.attrs)
            for s in tracer.spans()]


def journal_doc(rtr) -> dict:
    return json.loads(rtr.journal.to_pytree()["journal_doc"].tobytes())


def router(side, engines, clk, **kw):
    """A router over ``engines`` (id -> engine) with a metrics registry
    and a tracer on ``clk``."""
    reg = side.exporter.Registry()
    tr = side.obs.Tracer(clock=clk)
    rtr = side.fleet.Router(list(engines.items()), clock=clk, metrics=reg,
                            tracer=tr, **kw)
    return rtr, reg, tr


def observe(rtr, reg, tr, done, frids) -> dict:
    return dict(streams=[done.get(f) for f in frids], errors=rtr.errors,
                stats=rtr.stats(), journal=journal_doc(rtr),
                summaries={r: s.to_json()
                           for r, s in rtr.summaries().items()},
                exposition=exposition(reg), events=events(tr))


def drive(rtr, clk, dt=0.0) -> dict:
    """Step until nothing is pending, advancing the clock ``dt`` a step."""
    done = {}
    while rtr.pending:
        done.update(rtr.step())
        clk.advance(dt)
    return done


# -- the scenarios, each run on both packages ------------------------------
def routed_with_shed(side, policy):
    """Three replicas; half the traffic, one step, a forced shed of one
    active slot off the busiest replica onto the idlest, then the rest of
    the traffic. Returns placements, mid-run journal and summaries, and
    the end state."""
    clk = side.obs.VirtualClock()
    engines = {f"r{i}": side.engine(clock=clk) for i in range(3)}
    rtr, reg, tr = router(side, engines, clk, policy=policy)
    prompts = workload(side.vocab)
    frids = [rtr.submit(p, max_new=8, trace_id=f"t{i}")
             for i, p in enumerate(prompts[:5])]
    placed = [rtr.locate(f)[0] for f in frids]
    done = rtr.step()
    clk.advance(0.01)
    mid = dict(journal=journal_doc(rtr),
               summaries={r: s.to_json() for r, s in rtr.summaries().items()})
    busy = sorted(engines, key=lambda r: (-len(engines[r].active_slot_ids()),
                                          r))
    src, dst = busy[0], busy[-1]
    moved = rtr.shed(src, dst, slots=engines[src].active_slot_ids()[:1])
    for i, p in enumerate(prompts[5:], start=5):
        frids.append(rtr.submit(p, max_new=8, trace_id=f"t{i}"))
        placed.append(rtr.locate(frids[-1])[0])
    done.update(drive(rtr, clk, 0.01))
    for eng in engines.values():
        eng._alloc.assert_consistent()
    return dict(placed=placed, moved=moved, mid=mid,
                **observe(rtr, reg, tr, done, frids))


def deadlines(side):
    """Two replicas of one slot each: of four requests one runs free, two
    carry a deadline that expires (one mid-decode, one in the queue) and
    one a deadline that holds."""
    clk = side.obs.VirtualClock()
    engines = {f"r{i}": side.engine(clock=clk, n_slots=1) for i in range(2)}
    rtr, reg, tr = router(side, engines, clk, policy="round_robin")
    prompts = workload(side.vocab, n=4, seed=1)
    frids = [rtr.submit(prompts[0], max_new=8),
             rtr.submit(prompts[1], max_new=24, deadline_s=0.15),
             rtr.submit(prompts[2], max_new=8, deadline_s=0.05),
             rtr.submit(prompts[3], max_new=4, deadline_s=5.0)]
    done = drive(rtr, clk, 0.04)
    return observe(rtr, reg, tr, done, frids)


def crash_replay(side, at=4):
    """Three replicas; the ``at``-th ``replica.crash`` call kills one
    mid-stream; its journaled requests replay onto the survivors."""
    clk = side.obs.VirtualClock()
    inj = side.faults.FaultInjector(rules=[side.faults.FaultRule(
        "replica.crash", "crash", at=[at])])
    engines = {f"r{i}": side.engine(clock=clk) for i in range(3)}
    rtr, reg, tr = router(side, engines, clk, faults=inj)
    frids = [rtr.submit(p, max_new=10) for p in workload(side.vocab)]
    done = drive(rtr, clk, 0.01)
    return dict(log=inj.log, health=list(rtr.health.events),
                **observe(rtr, reg, tr, done, frids))


@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_routing_and_shed_match_jax(sides, policy):
    """Placements, the mid-run journal and summaries, the shed, the
    streams, ``stats()``, the trace events and the exposition are equal;
    the streams equal one engine's, and affinity puts each hot class on
    the replica that cached it."""
    got = [routed_with_shed(s, policy) for s in sides]
    for key in got[0]:
        assert got[1][key] == got[0][key], key
    assert got[1]["moved"] == 1
    assert got[1]["streams"] == single_engine(sides[1], workload(256))
    assert not got[1]["errors"]
    if policy == "affinity":
        assert got[1]["stats"]["aggregate_prefix_hit_rate"] > 0
        assert got[1]["placed"][2] == got[1]["placed"][0]


def test_affinity_beats_round_robin_on_prefix_hits(sides):
    """The cache-aware policy's aggregate prefix-hit rate is above
    round-robin's on the same traffic, in both packages alike."""
    rates = {}
    for side in sides:
        for policy in ("affinity", "round_robin"):
            rates[side.name, policy] = routed_with_shed(
                side, policy)["stats"]["aggregate_prefix_hit_rate"]
    assert rates["port", "affinity"] == rates["jax", "affinity"]
    assert rates["port", "round_robin"] == rates["jax", "round_robin"]
    assert rates["port", "affinity"] > rates["port", "round_robin"]


def test_deadline_expiry_matches_jax(sides):
    """Expired requests are cancelled on their engines, recorded in
    ``errors`` with JAX's text and closed ``expired`` in the journal."""
    got = [deadlines(s) for s in sides]
    assert got[1] == got[0]
    assert got[1]["stats"]["deadline_expired"] == 2
    assert sorted(got[1]["errors"]) == [1, 2]
    assert got[1]["streams"][0] is not None and \
        got[1]["streams"][3] is not None
    assert got[1]["journal"]["closed"]["expired"] == 2


def test_crash_replay_matches_jax(sides):
    """A hard crash: the same replica dies at the same step, the journal
    replays its requests with the same verify windows, no request is
    lost, and every stream equals one engine's."""
    got = [crash_replay(s) for s in sides]
    for key in got[0]:
        if key == "health":          # (t, replica, old, new, reason)
            assert [e[1:] for e in got[1][key]] == \
                [e[1:] for e in got[0][key]]
        assert got[1][key] == got[0][key], key
    st = got[1]["stats"]
    assert st["failovers"] == 1 and st["requests_lost"] == 0
    assert 0 < st["replayed_tokens"] <= st["journal_delivered_tokens"]
    assert got[1]["streams"] == single_engine(sides[1], workload(256),
                                              max_new=10)


def test_summary_and_score_match_jax(sides):
    """``summarize`` of a warmed engine, its JSON and the router's score
    for a prompt of each class are equal, and ``prefix_match_parts``
    agrees on tiered three-element digests."""
    got = []
    for side in sides:
        eng = side.engine()
        for p in workload(side.vocab, n=4):
            eng.submit(p, max_new=4)
        while eng.pending:
            eng.step()
        s = side.fleet.summarize(eng, "r0", seq=3, now_wall=12.5)
        rtr = side.fleet.Router([("r0", side.engine())])
        digest = [(list(range(100, 124)), 24, 8), (list(range(100, 108)), 8)]
        got.append((s.to_json(), rtr.score(s, workload(side.vocab)[0]),
                    side.fleet.prefix_match_parts(
                        list(range(100, 124)) + [1], digest, PAGE),
                    eng.cache_digest(2, 12)))
    assert got[1] == got[0]
    assert got[1][2] == (24, 8)


@pytest.mark.parametrize("name", ["summary", "journal"])
def test_wire_formats_decode_against_the_schemas(sides, name):
    """The port's ``ReplicaSummary`` JSON and journal doc carry exactly
    the fields and types of the committed wire schemas, and decode in the
    JAX package (and back)."""
    jax_side, port_side = sides
    types = {"int": int, "float": float, "str": str, "list": list,
             "object": dict}
    if name == "summary":
        schema = json.loads((SCHEMAS / "replica_summary.json").read_text())
        eng = port_side.engine()
        eng.submit(workload(256)[0], max_new=4)
        eng.step()
        doc = json.loads(fleet.summarize(eng, "r0", now_wall=1.0).to_json())
        groups = {"json": doc}
        back = jfleet.ReplicaSummary.from_json(json.dumps(doc))
        assert fleet.ReplicaSummary.from_json(
            back.to_json()).to_json() == json.dumps(doc, sort_keys=True)
    else:
        schema = json.loads((SCHEMAS / "request_journal.json").read_text())
        j = fleet.RequestJournal()
        frid = j.open([1, 2, 3], 8, trace_id="t", replica="r0",
                      deadline_wall=9.5, submitted_wall=1.5)
        j.deliver(frid, [4, 5])
        tree = j.to_pytree()
        doc = json.loads(tree["journal_doc"].tobytes())
        groups = {"doc": doc, "entry": doc["entries"][0]}
        assert tree["journal_doc"].dtype == np.uint8
        back = jfleet.RequestJournal.from_pytree(tree)
        assert back.stream(frid) == [4, 5]
        assert fleet.RequestJournal.from_pytree(back.to_pytree()).stream(
            frid) == [4, 5]
    for group, fields in groups.items():
        want = schema["groups"][group]
        assert set(fields) == set(want), group
        for key, value in fields.items():
            if value is not None:
                assert isinstance(value, types[want[key]["type"]]), key
        for key, spec in want.items():
            if spec["required"]:
                assert key in fields


def test_fleet_metric_names_are_jax_letter_for_letter():
    """Every ``FLEET_*`` name and help text of the port is JAX's."""
    names = [n for n in dir(jexporter) if n.startswith("FLEET_")]
    assert names == [n for n in dir(exporter) if n.startswith("FLEET_")]
    assert len(names) == 16
    for n in names:
        assert getattr(exporter, n) == getattr(jexporter, n), n


def test_router_reads_only_methods_the_port_engine_has(sides):
    """A ``FaultProxy`` wraps engines by method name and misses what is
    not called: route a crash-free fleet over proxied port engines and
    every engine method the router calls must have fired on the
    injector, each a method of the port's engine."""
    _, side = sides
    clk = obs.VirtualClock()
    inj = faults.FaultInjector(rules=[faults.FaultRule(
        "engine", "drop", at=[10 ** 9])])
    engines = {"p0": side.engine(clock=clk, role="prefill",
                                 prefill_chunk_tokens=PAGE),
               "d0": side.engine(clock=clk, role="decode")}
    proxied = {r: faults.FaultProxy(e, inj, "engine")
               for r, e in engines.items()}
    rtr = fleet.Router(list(proxied.items()), clock=clk,
                       pools={"prefill": ["p0"], "decode": ["d0"]})
    frids = [rtr.submit(p, max_new=6) for p in workload(256, n=4)]
    done = rtr.run()
    assert sorted(done) == frids
    assert rtr.stats()["handoffs"] == 4
    called = {site.split(".", 1)[1] for site in inj._counts}
    used = {"replica_stats", "fingerprint", "pool_metrics", "submit",
            "step", "pop_request_metrics", "emitted", "cache_digest",
            "drain", "absorb", "pages_referenced", "handoff_ready_slots",
            "active_slot_ids"}
    assert used <= called
    for name in called | {"cancel", "label_request"}:
        assert callable(getattr(ContinuousBatcher, name)), name
