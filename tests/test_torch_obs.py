"""The port's observability plane against the JAX package's: the span
API, the flight recorder, the Perfetto export, the Prometheus exporter,
and the engine hooks on every serving path.

Both engines get the same f32 tiny weights (JAX ``init_params``, carried
by the bridge) and the same traffic from a numpy seed. Each gets a
``TickingClock``: a ``VirtualClock`` that steps 1 ms after every
monotonic read, so every span's endpoints, every flight record's
``t_mono`` and ``wall_ms``, and every queue wait and TTFT are exact, and
equal between the engines only if each engine reads its clock at the same
points in the same order. The span lists ``(name, lane, rid, t0, t1,
attrs)``, the flight records, the request timelines, the drained
``phase_durations`` and the Prometheus exposition must then be equal. The
JAX engine runs its Pallas kernels in interpret mode; the port runs its
plain versions (CPU tensors)."""
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu import metrics as jmetrics
from k8s_gpu_scheduler_tpu import obs as jobs
from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu.models.snapshot import (
    ServingSnapshot as JSnapshot)
from k8s_gpu_scheduler_tpu.obs import flight as jflight
from k8s_gpu_scheduler_tpu.testing import faults as jfaults
from k8s_gpu_scheduler_tpu_torch import metrics, obs
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models import lifecycle
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
from k8s_gpu_scheduler_tpu_torch.models.snapshot import ServingSnapshot
from k8s_gpu_scheduler_tpu_torch.obs import flight
from k8s_gpu_scheduler_tpu_torch.testing import faults
from test_torch_contract import NOT_PORTED_KEYS
from test_torch_serving import configs

PAGE = 8
BASE = dict(kv_layout="paged", page_size=PAGE, n_slots=2, max_len=64,
            chunk=2, prefill_bucket=8)
# The exposition lines of the keys the port does not report yet.
NOT_PORTED_METRICS = {"tpu_serve_" + k for k in NOT_PORTED_KEYS}


def ticking(base):
    """A ``base`` VirtualClock (either package's) that steps 1 ms after
    every monotonic read."""
    class TickingClock(base):
        def monotonic(self):
            t = super().monotonic()
            self.advance(0.001)
            return t
    return TickingClock()


# -- units: tracer, flight recorder, Perfetto --------------------------------

def span_rows(spans):
    return [(s.name, s.lane, s.rid, s.t0, s.t1, s.attrs) for s in spans]


def tracer_calls(pkg):
    """The same calls on ``pkg``'s Tracer: record, event, span (with an
    attr set inside), overflow past capacity, filters, clear."""
    clk = pkg.VirtualClock()
    tr = pkg.Tracer(capacity=5, clock=clk)
    tr.record("queue", 1.0, 2.5, lane="sched", rid="pod-a", prompt_len=3)
    clk.advance(0.25)
    tr.event("page_shortage", lane="engine", rid="pod-b", need=4, free=1)
    with tr.span("decode_chunk", lane="engine", active=2) as attrs:
        clk.advance(0.5)
        attrs["tokens"] = 7
    for i in range(4):
        tr.record("reap", 3.0 + i, 3.0 + i, lane=f"slot{i}", rid="pod-a")
    out = dict(all=span_rows(tr.spans()), dropped=tr.dropped, n=len(tr),
               pod_a=span_rows(tr.spans(rid="pod-a")),
               reap=span_rows(tr.spans(name="reap")))
    off = pkg.Tracer(enabled=False, clock=clk)
    with off.span("verify") as a:
        out["off"] = (a, len(off))
    tr.clear()
    out["cleared"] = (len(tr), tr.dropped)
    return out


def test_tracer_matches_jax():
    got, want = tracer_calls(obs), tracer_calls(jobs)
    assert got == want
    assert got["n"] == 5 and got["dropped"] == 2
    assert got["off"] == (None, 0) and got["cleared"] == (0, 0)


def flight_calls(mod, vclock):
    """The same calls on ``mod``'s FlightRecorder: records past capacity,
    a payload, and seeds that trim to capacity and continue ``seq``."""
    clk = vclock()
    rec = mod.FlightRecorder(capacity=4, clock=clk)
    for i in range(6):
        clk.advance(0.5)
        rec.record("decode", active=i, faults=[])
    out = dict(payload=rec.to_payload(), dropped=rec.dropped, n=len(rec),
               decode=rec.records("decode"), none=rec.records("verify"))
    other = mod.FlightRecorder(capacity=3, clock=clk)
    other.record("admit_only", active=0)
    other.seed(out["payload"])
    other.record("restore", resumed=2)
    out["seeded"] = other.to_payload()
    with pytest.raises(ValueError):
        mod.FlightRecorder(capacity=0)
    out["default"] = mod.DEFAULT_CAPACITY
    return out


def test_flight_recorder_matches_jax():
    got = flight_calls(flight, obs.VirtualClock)
    assert got == flight_calls(jflight, jobs.VirtualClock)
    # The newest records are kept and seq continues past them.
    assert [r["seq"] for r in got["seeded"]] == [4, 5, 6]
    assert got["seeded"][-1]["kind"] == "restore"
    assert got["default"] == 256 and got["dropped"] == 2


SPANS = [("decode_chunk", 1000.5, 1000.75, "engine", None,
          {"active": 2, "chunk": 4}),
         ("decode_chunk", 1000.5, 1000.75, "slot1", "pod-a", {"tokens": 4}),
         ("queue", 1000.0, 1000.5, "engine", "pod-a", {"prompt_len": 9}),
         ("sched_bind", 1000.25, 1000.25, "sched", "pod-a", {}),
         ("reap", 1000.75, 1000.75, "slot0", "req-3", {"eos": True})]


def perfetto_calls(pkg, tmp_path):
    spans = [pkg.Span(n, t0, t1, lane, rid, 7, dict(a))
             for n, t0, t1, lane, rid, a in SPANS]
    doc = pkg.to_perfetto(spans)
    path = tmp_path / f"{pkg.__name__}.json"
    written = pkg.write_perfetto(spans, str(path))
    bad = [None, {"traceEvents": []},
           {"traceEvents": [{"name": "a", "ph": "X", "ts": -1.0,
                             "dur": -2.0, "pid": 1, "tid": "x"}]},
           {"traceEvents": [{"ph": "Q", "pid": 1, "tid": 1}]}]
    return dict(doc=doc, problems=pkg.validate_perfetto(doc),
                file=json.loads(path.read_text()), written=written,
                bad=[pkg.validate_perfetto(b) for b in bad],
                empty=pkg.to_perfetto([]), phases=pkg.PHASES)


def test_perfetto_export_matches_jax(tmp_path):
    got = perfetto_calls(obs, tmp_path)
    assert got == perfetto_calls(jobs, tmp_path)
    assert got["problems"] == [] and got["file"] == got["doc"]
    assert all(got["bad"])
    lanes = {e["args"]["name"]: e["pid"] for e in got["doc"]["traceEvents"]
             if e["name"] == "thread_name"}
    assert lanes == {"engine": 1, "slot0": 1, "slot1": 1, "sched": 2}


def test_fault_injector_fires_as_jax():
    """The ``fault`` flight record lists what ``fire`` logged: the port's
    injector logs and returns what the JAX one does, call for call,
    raising on the same calls."""
    def calls(mod):
        inj = mod.FaultInjector(seed=7, rules=[
            mod.FaultRule("serve.step", "page_pressure", every=2, pages=3),
            mod.FaultRule("serve.step", "drop", p=0.5, after=2),
            mod.FaultRule("serve", "preempt", at=[5]),
            mod.FaultRule("serve.propose", "delay", every=3)])
        out = []
        for site in ["serve.step", "serve.propose"] * 6:
            try:
                out.append([(r.kind, r.pages) for r in inj.fire(site)])
            except mod.InjectedFault as e:
                out.append(type(e).__name__)
        return out, inj.log, inj.count("serve.step")

    got, want = calls(faults), calls(jfaults)
    assert got == want
    assert "Preempted" in got[0] and "InjectedFault" in got[0]


# -- the engines, traced, against the JAX engine's ----------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = configs()
    params = j_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


class Side:
    """One package's engine factory, clock, tracer (or None) and fault
    module."""

    def __init__(self, name, weights, obs_pkg, fault_mod, traced=True):
        jcfg, cfg, params, model = weights
        self.name, self.faults = name, fault_mod
        self.clock = ticking(obs_pkg.VirtualClock)
        self.tracer = obs_pkg.Tracer(clock=self.clock) if traced else None
        if name == "jax":
            self._make = lambda **kw: JEngine(params, jcfg, **kw)
        else:
            self._make = lambda **kw: ContinuousBatcher(
                model, cfg, device="cpu", **kw)
        self.engines = []

    def engine(self, **kw):
        eng = self._make(clock=self.clock, tracer=self.tracer, **kw)
        self.engines.append(eng)
        return eng


def step_all(eng, done=None):
    done = {} if done is None else done
    while eng.pending:
        done.update(eng.step())
    return done


def mixed(side, kw, seed=3):
    """A shared-prefix batch (a miss, then hits, one max_new == 1) with
    trace ids, a queue wait of 0.5 s, a repeated phrase, and a two-turn
    conversation through ``run()``. Returns the streams."""
    eng = side.engine(**kw)
    rng = np.random.default_rng(seed)
    system = list(rng.integers(0, 256, 2 * PAGE))
    ids = [eng.submit(system + list(rng.integers(0, 256, 5)), max_new=6,
                      trace_id="pod-a")]
    side.clock.advance(0.5)
    done = step_all(eng)
    for max_new, tid in ((6, None), (1, "pod-b"), (7, "pod-c")):
        ids.append(eng.submit(system + list(rng.integers(0, 256, 5)),
                              max_new=max_new, trace_id=tid))
    step_all(eng, done)
    phrase = list(rng.integers(0, 256, 4))
    ids.append(eng.submit(phrase * 5, max_new=9, trace_id="phrase"))
    p1 = list(rng.integers(0, 256, 11))
    ids.append(eng.submit(p1, max_new=8))
    done.update(eng.run())
    ids.append(eng.submit(p1 + done[ids[-1]] + [3, 4, 5], max_new=5))
    done.update(eng.run())
    return [done[i] for i in ids]


def eos_traffic(side, kw):
    """Greedy requests, the first of whose streams holds token 221 at its
    third place (the f32 tiny weights): step() reaps it there."""
    eng = side.engine(eos_id=221, **kw)
    rng = np.random.default_rng(11)
    ids = [eng.submit(list(rng.integers(0, 256, n)), max_new=12,
                      trace_id=f"eos-{n}") for n in (9, 14, 6)]
    done = step_all(eng)
    return [done[i] for i in ids]


def tier_traffic(side, kw):
    """Three distinct 28-token prompts one at a time through 10 pages,
    then the first two again (demote, then promote)."""
    eng = side.engine(**kw)
    rng = np.random.default_rng(5)
    ps = [list(rng.integers(0, 256, 28)) for _ in range(3)]
    out = []
    for i in (0, 1, 2, 0, 1):
        rid = eng.submit(ps[i], max_new=8, trace_id=f"tier-{i}")
        out.append(step_all(eng)[rid])
    return out


def chaos_lifecycle(side, kw):
    """Eight pages held hostage every step (the second request waits for
    pages) and a preemption at step 3: the preempted engine drains, a
    fresh one restores, sheds its active slot to a peer that absorbs and
    relabels it, and both finish."""
    f = side.faults
    inj = f.FaultInjector(seed=1, rules=[
        f.FaultRule("serve.step", "page_pressure", every=1, pages=8),
        f.FaultRule("serve.step", "preempt", at=[3])])
    a = side.engine(fault_injector=inj, **kw)
    rng = np.random.default_rng(0)
    system = list(rng.integers(0, 256, 2 * PAGE))
    prompts = [system + list(rng.integers(0, 256, n)) for n in (3, 10, 4)]
    prompts += [list(rng.integers(0, 256, n)) for n in (17, 5)]
    ids = [a.submit(p, max_new=13, trace_id=f"chaos-{i}")
           for i, p in enumerate(prompts)]
    done = {}
    with pytest.raises(side.faults.Preempted):
        while a.pending:
            done.update(a.step())
    side.clock.advance(2.0)                   # the downtime
    b = side.engine(**kw)
    b.restore(a.drain())
    slot = min(b._slot_req)
    moved = b._slot_req[slot]
    part = b.drain(slots=[slot])
    c = side.engine(**kw)
    new = c.absorb(part)[moved]
    c.label_request(new, "moved")
    step_all(b, done)
    rest = step_all(c)
    done[moved] = rest.pop(new)
    return [done[i] for i in ids]


VARIANTS = {
    "paged": (mixed, dict(prefix_cache=False)),
    "prefix": (mixed, dict(prefix_cache=True)),
    "chunked": (mixed, dict(prefix_cache=True, prefill_chunk_tokens=PAGE)),
    "speculative": (mixed, dict(prefix_cache=True, speculative=True,
                                gamma=3)),
    "eos": (eos_traffic, dict(prefix_cache=True)),
    "tiered": (tier_traffic, dict(prefix_cache=True, kv_tiering=True,
                                  n_pages=10, kv_dtype="int8")),
    "contiguous": (mixed, dict(kv_layout="contiguous")),
    "lifecycle": (chaos_lifecycle, dict(prefix_cache=True, chunk=4)),
}
# Span names each variant must show (beyond queue, admit, decode_chunk).
EXPECTED = {
    "paged": {"prefill", "reap"},
    "prefix": {"prefill", "reap"},
    "chunked": {"prefill_chunk"},
    "speculative": {"verify", "rewind", "reap"},
    "eos": {"reap"},
    "tiered": {"demote", "promote", "reap"},
    "contiguous": {"prefill", "reap"},
    "lifecycle": {"drain", "restore", "shed", "absorb", "page_shortage"},
}


def observe(side, variant):
    traffic, kw = VARIANTS[variant]
    streams = traffic(side, {**BASE, **kw})
    engs = side.engines
    out = dict(streams=streams, flight=[e._flight.records() for e in engs],
               spans=span_rows(side.tracer.spans()) if side.tracer else [],
               metrics=[e.pop_request_metrics() for e in engs],
               timelines=[], by_label=[])
    for e in engs:
        rids = sorted(e._timelines)
        out["timelines"].append({r: e.request_timeline(r) for r in rids})
        labels = sorted(set(e._rid_label.values()))
        out["by_label"].append({lb: e.request_timeline(lb) for lb in labels})
    reg_mod = jmetrics if side.name == "jax" else metrics
    out["pools"], out["expose"] = [], []
    for e in engs:
        pool = e.pool_metrics()
        reg = reg_mod.Registry()
        reg_mod.export_serving_pool(reg, pool)
        out["pools"].append(pool)
        out["expose"].append(reg.expose().splitlines())
    return out


_RUNS = {}


@pytest.fixture(params=list(VARIANTS))
def runs(request, weights):
    """(the JAX engines' observations, the port's) for one variant."""
    v = request.param
    if v not in _RUNS:
        _RUNS[v] = (observe(Side("jax", weights, jobs, jfaults), v),
                    observe(Side("port", weights, obs, faults), v))
    return v, _RUNS[v]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_untraced_engine_reads_its_clock_as_jax(weights, variant):
    """Without a tracer the engine reads its clock where the JAX engine
    does too: equal flight records and request metrics, no spans, no
    timelines, and the streams of the traced run."""
    want, got = (observe(Side(name, weights, pkg, mod, traced=False),
                         variant)
                 for name, pkg, mod in (("jax", jobs, jfaults),
                                        ("port", obs, faults)))
    assert got["flight"] == want["flight"]
    assert got["metrics"] == want["metrics"]
    assert got["streams"] == want["streams"]
    assert not any(got["timelines"]) and got["spans"] == []
    for pool in got["pools"]:
        assert "phase_durations" not in pool


def test_spans_match_jax(runs):
    v, (want, got) = runs
    assert got["streams"] == want["streams"]
    assert got["spans"] == want["spans"]
    names = {s[0] for s in got["spans"]}
    assert {"queue", "admit"} | EXPECTED[v] <= names
    assert "decode_chunk" in names or v == "speculative"
    lanes = {s[1] for s in got["spans"]}
    assert "engine" in lanes and any(lane.startswith("slot")
                                     for lane in lanes)


def test_flight_records_match_jax(runs):
    v, (want, got) = runs
    assert got["flight"] == want["flight"]
    kinds = {r["kind"] for recs in got["flight"] for r in recs}
    step_kind = {"speculative": "verify", "chunked": "prefill_chunk",
                 "lifecycle": "fault"}.get(v, "decode")
    assert step_kind in kinds
    if v == "lifecycle":
        a, b, c = got["flight"]
        kinds = [r["kind"] for r in a]
        assert kinds[-2:] == ["fault", "drain"]
        assert a[-2]["injected"] == ["page_pressure", "preempt"]
        assert a[0]["faults"] == ["page_pressure"]
        # The restored ring carries the preempted engine's records, its
        # drain marker, then its own, seq continued.
        assert [r["kind"] for r in b[:len(a) + 1]] == kinds + ["restore"]
        assert [r["seq"] for r in b] == list(range(len(b)))
        assert "shed" in {r["kind"] for r in b}
        assert c[0]["kind"] == "absorb"


def test_timelines_match_jax(runs):
    v, (want, got) = runs
    assert got["timelines"] == want["timelines"]
    assert got["by_label"] == want["by_label"]
    assert any(got["timelines"])
    for tls, by_label in zip(got["timelines"], got["by_label"]):
        for label, tl in by_label.items():
            if tl is not None:
                assert tl == tls[tl["request"]]
                assert tl["trace_id"] == label


def metric_name(line):
    """The metric a line of a Prometheus exposition belongs to."""
    words = line.split()
    if not words:
        return None
    return (words[2] if words[0] == "#" else words[0]).split("{")[0]


def test_phase_durations_and_exposition_match_jax(runs):
    """The drained phase batch equals JAX's, and the exposition of one
    pool_metrics() snapshot is JAX's line for line, less the lines of the
    keys the port does not report yet."""
    v, (want, got) = runs
    for g, w in zip(got["pools"], want["pools"]):
        assert g.get("phase_durations") == w.get("phase_durations")
    for g, w in zip(got["expose"], want["expose"]):
        kept = [ln for ln in w if metric_name(ln) not in NOT_PORTED_METRICS]
        assert g == kept
    if v != "contiguous":
        assert any("tpu_serve_phase_duration_seconds_count" in ln
                   for ln in got["expose"][0])


def test_request_metrics_match_jax(runs):
    """Queue wait and TTFT are read on the engine's clock: exact, and
    the JAX engine's."""
    v, (want, got) = runs
    assert got["metrics"] == want["metrics"]
    assert any(got["metrics"])


def test_queue_wait_and_ttft_on_a_virtual_clock(weights):
    """A request that waits 3 s on a virtual clock shows a queue span of
    exactly 3 s and a TTFT of exactly 3 s, as in the JAX engine; with
    tracing on the streams are those of tracing off."""
    _, cfg, _, model = weights
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, 256, 4 + i)) for i in range(5)]

    def drive(tracer, clk, flight_capacity=256):
        eng = ContinuousBatcher(model, cfg, device="cpu", tracer=tracer,
                                clock=clk, flight_capacity=flight_capacity,
                                prefix_cache=True, **BASE)
        ids = [eng.submit(p, max_new=6) for p in prompts]
        if clk is not None:
            clk.advance(3.0)
        done = eng.run()
        return [done[i] for i in ids], eng.pop_request_metrics()

    clk = obs.VirtualClock()
    tr = obs.Tracer(clock=clk)
    on, on_metrics = drive(tr, clk)
    off, _ = drive(None, None, flight_capacity=0)
    assert on == off
    queue = tr.spans(name="queue", rid="req-0")
    assert [q.duration for q in queue] == [3.0]
    assert on_metrics[0]["ttft_s"] == 3.0


def test_flight_ring_rides_drain_and_restore_across_packages(weights):
    """A JAX engine's ring, drained, restores into the port, whose drain
    restores into the JAX engine again: the JAX records survive both hops
    and seq stays one ordered count."""
    jcfg, cfg, params, model = weights
    kw = dict(BASE, prefix_cache=True, chunk=4)
    jeng = JEngine(params, jcfg, **kw)
    rng = np.random.default_rng(0)
    ids = [jeng.submit(list(rng.integers(0, 256, n)), max_new=13)
           for n in (19, 10, 21)]
    done = {}
    for _ in range(2):
        done.update(jeng.step())
    jsnap = jeng.drain()
    jax_records = list(jsnap.flight)
    assert [r["kind"] for r in jax_records][-1] == "drain"
    port = ContinuousBatcher(model, cfg, device="cpu", **kw)
    port.restore(ServingSnapshot.from_pytree(jsnap.to_pytree()))
    done.update(port.step())
    psnap = port.drain()
    assert psnap.flight[:len(jax_records)] == jax_records
    assert [r["kind"] for r in psnap.flight[len(jax_records):]] == \
        ["restore", "decode", "drain"]
    back = JEngine(params, jcfg, **kw)
    back.restore(JSnapshot.from_pytree(psnap.to_pytree()))
    ring = back._flight.records()
    assert ring[:len(psnap.flight)] == psnap.flight
    assert [r["seq"] for r in ring] == list(range(len(ring)))
    while back.pending:
        done.update(back.step())
    assert set(done) == set(ids)


def test_flight_ring_rides_the_persisted_checkpoint(weights, tmp_path):
    """``drain_to_checkpoint`` → ``resume_or_fresh`` keeps the ring, and
    the resumed engine's next drain ships both engines' records."""
    _, cfg, _, model = weights

    def make():
        return ContinuousBatcher(model, cfg, device="cpu", prefix_cache=True,
                                 **BASE)

    eng = make()
    for n in (12, 20):
        eng.submit(list(range(1, n)), max_new=9)
    eng.step()
    snap = lifecycle.drain_to_checkpoint(eng, str(tmp_path))
    eng2, resumed = lifecycle.resume_or_fresh(make, str(tmp_path))
    assert resumed == 2
    assert eng2._flight.records()[:len(snap.flight)] == snap.flight
    eng2.step()
    again = lifecycle.drain_to_checkpoint(eng2, str(tmp_path))
    assert again.flight[:len(snap.flight)] == snap.flight
    assert [r["kind"] for r in again.flight[len(snap.flight):]] == \
        ["restore", "decode", "drain"]


def test_no_recorder_at_capacity_zero(weights):
    """flight_capacity=0 builds no recorder, as in JAX, and its drain
    ships an empty ring; a partial drain never ships one."""
    _, cfg, _, model = weights
    eng = ContinuousBatcher(model, cfg, device="cpu", flight_capacity=0,
                            prefix_cache=True, **BASE)
    eng.submit(list(range(1, 12)), max_new=9)
    eng.step()
    assert eng._flight is None and eng.drain().flight == []
    eng = ContinuousBatcher(model, cfg, device="cpu", prefix_cache=True,
                            **BASE)
    eng.submit(list(range(1, 12)), max_new=9)
    eng.step()
    assert eng.drain(slots=list(eng._slot_req)).flight == []
    assert eng._flight.records()[-1]["kind"] == "shed"


def test_tracing_adds_no_read_back(weights, monkeypatch):
    """A traced engine with the recorder reads the device exactly as
    often as an untraced one without it (the deferred token reads and the
    verify read-back), on the plain and the speculative path."""
    _, cfg, _, model = weights
    calls = {"n": 0}
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls["n"] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    for kw in (dict(prefix_cache=True), dict(speculative=True, gamma=3),
               dict(prefill_chunk_tokens=PAGE)):
        counts = []
        for traced in (False, True):
            calls["n"] = 0
            clk = obs.VirtualClock()
            eng = ContinuousBatcher(
                model, cfg, device="cpu", **BASE, **kw,
                tracer=obs.Tracer(clock=clk) if traced else None,
                clock=clk, flight_capacity=256 if traced else 0)
            for n in (9, 21, 13):
                eng.submit(list(range(2, 2 + n)), max_new=7)
            while eng.pending:
                eng.step()
            counts.append(calls["n"])
        assert counts[0] == counts[1] > 0, kw


def test_tracer_ring_and_timelines_stay_bounded(weights):
    """A tracer of capacity 8 keeps the newest 8 spans; timelines past
    the cap evict the oldest request's, and its trace label with it."""
    _, cfg, _, model = weights
    tr = obs.Tracer(capacity=8)
    eng = ContinuousBatcher(model, cfg, device="cpu", tracer=tr, **BASE)
    eng._TIMELINE_MAX = 2
    for i in range(4):
        eng.submit(list(range(1, 6)), max_new=6, trace_id=f"t{i}")
    eng.run()
    assert len(tr) == 8 and tr.dropped > 0
    assert list(eng._timelines) == [2, 3]
    assert sorted(eng._rid_label) == [2, 3]
    assert eng.request_timeline("t0") is None
    assert eng.request_timeline("t3")["request"] == 3


def test_scrape_threads_drain_every_phase_once(weights):
    """pool_metrics() from more scrape threads than cores while the loop
    steps, the interpreter switching threads every 10 µs: the phase
    durations drained across every scrape are each folded span once,
    none lost, none twice."""
    _, cfg, _, model = weights
    tr = obs.Tracer()
    eng = ContinuousBatcher(model, cfg, device="cpu", tracer=tr,
                            prefix_cache=True, **BASE)
    rng = np.random.default_rng(4)
    for _ in range(6):
        eng.submit(list(rng.integers(0, 256, 12)), max_new=9)
    drained, stop = [], threading.Event()

    def scrape():
        while not stop.wait(0.001):
            got = eng.pool_metrics().get("phase_durations", ())
            drained.extend(got)           # list.extend: one atomic call

    threads = [threading.Thread(target=scrape)
               for _ in range((os.cpu_count() or 1) + 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        while eng.pending:
            eng.step()
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    drained.extend(eng.pool_metrics().get("phase_durations", ()))
    folded = [(s.name, s.t1 - s.t0) for s in tr.spans()
              if s.lane == "engine" and s.name != "page_shortage"]
    assert sorted(drained) == sorted(folded)


def test_metrics_server_serves_the_exposition():
    """MetricsServer serves a Registry's exposition over loopback at
    /metrics (404 elsewhere), the same text the JAX exporter writes for
    the same gauges and phase batch."""
    pool = {"pages_total": 16.0, "pages_free": 9.0, "tp": 1.0,
            "phase_durations": (("decode_chunk", 0.004), ("admit", 2e-5)),
            "prefix_hit_token_batch": (0, 16), "spec_accept_batch": (0.5,),
            "spec_proposer": "bigram",
            "spec_gamma_agg": {"min": 3.0, "mean": 3.0, "max": 3.0}}
    texts = []
    for mod in (metrics, jmetrics):
        reg = mod.Registry()
        mod.export_serving_pool(reg, pool, labels={"replica": "r0"})
        texts.append(reg.expose())
    assert texts[0] == texts[1]
    reg = metrics.Registry()
    metrics.export_serving_pool(reg, pool)
    srv = metrics.MetricsServer(reg).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
            body = resp.read().decode()
            ctype = resp.headers["Content-Type"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/other", timeout=10)
    finally:
        srv.stop()
    assert body == reg.expose() and ctype.startswith("text/plain")
    assert e.value.code == 404
    assert 'tpu_serve_phase_duration_seconds_count{phase="admit"} 1' in body
