"""The port's crash tolerance against the JAX package's: the fault
harness (``crash`` rules, ``ReplicaCrashed``, ``FaultProxy``), the bounded
retry policy, the health state machine, and whole fleet runs under
seeded chaos — replica kills with failover by journal replay, rejoin
through an engine factory, a flapping summary store, and a router that
dies and is rebuilt from its persisted journal.

Each scenario runs on both packages (``test_torch_fleet.sides``: the same
f32 tiny weights, each package's own ``VirtualClock``); the injection
logs, health transitions, streams, ``stats()`` and journals must be
equal, exactly, and the streams equal a single engine's. No request may
be lost (``tpu_fleet_requests_lost_total`` stays 0)."""
import json
import random

import pytest

from test_torch_fleet import (
    FAST_QUARANTINE, drive, exposition, journal_doc, router, sides,  # noqa: F401
    single_engine, workload)


@pytest.mark.parametrize("rule", [dict(kind="crash", at=[2]),
                                  dict(kind="drop", every=2),
                                  dict(kind="preempt", at=[1, 3])],
                         ids=["crash", "drop", "preempt"])
def test_injector_schedule_matches_jax(sides, rule):
    """The same rule fires at the same calls with the same exception
    type name and log in both packages."""
    got = []
    for side in sides:
        inj = side.faults.FaultInjector(seed=5, rules=[
            side.faults.FaultRule("replica.crash", **rule)])
        raised = []
        for _ in range(4):
            try:
                inj.fire("replica.crash")
                raised.append(None)
            except side.faults.InjectedFault as e:
                raised.append(type(e).__name__)
        got.append((raised, inj.log))
    assert got[1] == got[0]
    if rule["kind"] == "crash":
        assert got[1][0] == [None, "ReplicaCrashed", None, None]


def test_fault_proxy_fires_per_method_and_passes_attributes(sides):
    """Every public call through the proxy fires ``<site>.<method>``;
    attribute reads and private names pass through untouched."""
    got = []
    for side in sides:
        store = side.fleet.MemoryStore()
        inj = side.faults.FaultInjector(rules=[side.faults.FaultRule(
            "store.set", "drop", at=[2])])
        px = side.faults.FaultProxy(store, inj, "store",
                                    drop_exc=ConnectionError)
        px.set("a", "1")
        with pytest.raises(ConnectionError):
            px.set("b", "2")
        got.append((px.get("a"), px.get_keys("*"), px._kv, inj.log,
                    inj.count("store.get")))
    assert got[1] == got[0]
    assert got[1][0] == "1" and got[1][3] == [("store.set", 2, "drop")]


def test_retry_policy_matches_jax(sides):
    """Seeded backoff draws, the give-up rule and ``retry_call``'s
    attempts and sleeps are equal."""
    got = []
    for side in sides:
        pol = side.retry.RetryPolicy(attempts=5, base_s=0.01, max_s=0.05,
                                     jitter=0.5, deadline_s=1.0)
        rng = random.Random(7)
        draws = [pol.backoff_s(a, rng=rng) for a in range(1, 6)]
        calls, sleeps = [], []

        def flaky():
            calls.append(len(calls))
            if len(calls) < 3:
                raise ConnectionError("down")
            return "up"

        out = side.retry.retry_call(flaky, pol, rng=random.Random(1),
                                    clock=lambda: 0.0, sleep=sleeps.append)
        got.append((draws, out, calls, sleeps,
                    pol.give_up(5, 0.0, 1.0), pol.give_up(2, 0.9, 1.0, 0.2)))
    assert got[1] == got[0]


def test_health_monitor_matches_jax(sides):
    """One sequence of step errors, heartbeats, a watchdog age, deaths and
    rejoins moves both monitors through the same transitions and the same
    seeded quarantine holds."""
    got = []
    for side in sides:
        pol = side.fleet.HealthPolicy(
            quarantine=side.retry.RetryPolicy(**FAST_QUARANTINE))
        hm = side.fleet.HealthMonitor(pol, seed=3)
        for r in ("a", "b", "c"):
            hm.add(r, now=0.0)
        out = [hm.note_error("a", RuntimeError("x"), 1.0),
               hm.note_ok("a", 2.0),
               hm.observe("b", 3.0, heartbeat_age_s=6.0),
               hm.observe("b", 4.0, heartbeat_age_s=1.0),
               hm.observe("c", 5.0, last_step_age_s=31.0),
               hm.quarantine("c", 5.0),
               hm.due_for_rejoin("c", 5.01), hm.due_for_rejoin("c", 6.0),
               hm.start_rejoin("c", 6.0), hm.rejoined("c", 6.0)]
        for _ in range(3):
            out.append(hm.note_error("a", RuntimeError("y"), 7.0))
        out += [hm.quarantine("a", 7.0), hm.get("a").quarantined_until,
                hm.counts(), hm.transition_count, list(hm.events)]
        got.append(out)
    assert got[1] == got[0]


def chaos_fleet(side, seed):
    """Three replicas with an engine factory: seeded kills at
    ``replica.crash``, one dropped router step, and a summary store that
    drops every fifth write; stepped on virtual time until done, then
    until every replica has rejoined."""
    clk = side.obs.VirtualClock()
    inj = side.faults.FaultInjector(seed=seed, rules=[
        side.faults.FaultRule("replica.crash", "crash", p=0.05, until=40),
        side.faults.FaultRule("fleet.step", "drop", at=[4]),
        side.faults.FaultRule("store.set", "drop", every=5)])
    store = side.faults.FaultProxy(side.fleet.MemoryStore(), inj, "store",
                                   drop_exc=ConnectionError)

    def factory(rid):
        return side.engine(clock=clk)

    engines = {f"r{i}": factory(f"r{i}") for i in range(3)}
    rtr, reg, tr = router(
        side, engines, clk, store=store, engine_factory=factory, faults=inj,
        health=side.fleet.HealthPolicy(
            quarantine=side.retry.RetryPolicy(**FAST_QUARANTINE)),
        health_seed=seed)
    prompts = workload(side.vocab, n=10, seed=1)
    frids = [rtr.submit(p, max_new=10) for p in prompts]
    done = drive(rtr, clk, 0.02)
    for _ in range(50):
        if rtr.health.counts()["live"] == 3:
            break
        rtr.step()
        clk.advance(0.02)
    return dict(streams=[done.get(f) for f in frids], log=inj.log,
                stats=rtr.stats(), errors=rtr.errors,
                health=[e[1:] for e in rtr.health.events],
                journal=journal_doc(rtr), exposition=exposition(reg))


def test_chaos_fleet_matches_jax_and_loses_nothing(sides):
    """Kills, a dropped step and a flapping store: the same faults fire,
    the same replicas die, quarantine and rejoin, and every stream equals
    a single engine's, with nothing lost and no more tokens re-decoded
    than were delivered."""
    got = [chaos_fleet(s, seed=11) for s in sides]
    for key in got[0]:
        assert got[1][key] == got[0][key], key
    st = got[1]["stats"]
    kinds = {k for _, _, k in got[1]["log"]}
    assert kinds == {"crash", "drop"}
    assert st["failovers"] >= 1 and st["requests_lost"] == 0
    assert st["replayed_tokens"] <= st["journal_delivered_tokens"]
    assert st["health_states"]["live"] == 3
    assert not got[1]["errors"]
    assert got[1]["streams"] == single_engine(
        sides[1], workload(256, n=10, seed=1), max_new=10)
    assert not [ln for ln in got[1]["exposition"]
                if ln.startswith("tpu_fleet_requests_lost_total{")]


def restarted_router(side, tmp_path):
    """Persist the journal after three steps, throw the router and its
    engines away, and boot a new router over fresh engines from the same
    journal directory: it replays every open entry."""
    clk = side.obs.VirtualClock()
    jdir = str(tmp_path / side.name)
    r1, _, _ = router(side, {f"r{i}": side.engine(clock=clk)
                             for i in range(2)}, clk, journal_dir=jdir)
    frids = [r1.submit(p, max_new=10) for p in workload(side.vocab, n=6,
                                                        seed=12)]
    for _ in range(3):
        r1.step()
        clk.advance(0.01)
    r1.checkpoint_journal()
    before = journal_doc(r1)
    r2, reg, tr = router(side, {f"r{i}": side.engine(clock=clk)
                                for i in range(2)}, clk, journal_dir=jdir)
    after_boot = journal_doc(r2)
    done = drive(r2, clk, 0.01)
    return dict(frids=frids, before=before, after_boot=after_boot,
                done=done, stats=r2.stats(), journal=journal_doc(r2),
                exposition=exposition(reg))


def test_journal_restart_matches_jax(sides, tmp_path):
    """The persisted journal (an ``.npz`` step directory in the port, an
    orbax checkpoint in JAX) holds the same doc; the new router orphans
    and replays the same entries, and each finished stream continues the
    delivery the journal held, equal to a single engine's."""
    got = [restarted_router(s, tmp_path) for s in sides]
    for key in got[0]:
        assert got[1][key] == got[0][key], key
    ref = single_engine(sides[1], workload(256, n=6, seed=12), max_new=10)
    before = {e["frid"]: e["delivered"] for e in got[1]["before"]["entries"]}
    assert before and set(got[1]["done"]) == set(before)
    for f, toks in got[1]["done"].items():
        assert toks == ref[f] and toks[:len(before[f])] == before[f]
    assert all(e["failovers"] == 1
               for e in got[1]["after_boot"]["entries"])
    assert got[1]["stats"]["requests_lost"] == 0


def test_port_journal_loads_in_jax_and_back(sides, tmp_path):
    """A journal the port persisted decodes with the JAX codec, and a JAX
    journal's pytree loads in the port."""
    jax_side, port_side = sides
    j = port_side.fleet.RequestJournal()
    frid = j.open([1, 2, 3], 6, trace_id="t", replica="r0",
                  deadline_wall=2.0, submitted_wall=1.0)
    j.deliver(frid, [7, 8])
    port_side.lifecycle.persist_journal(j, str(tmp_path / "j"))
    loaded = port_side.lifecycle.load_journal(str(tmp_path / "j"))
    jj = jax_side.fleet.RequestJournal.from_pytree(loaded.to_pytree())
    assert jj.stream(frid) == [7, 8] and jj.entry(frid).replica == "r0"
    back = port_side.fleet.RequestJournal.from_pytree(jj.to_pytree())
    assert json.loads(back.to_pytree()["journal_doc"].tobytes()) == \
        json.loads(j.to_pytree()["journal_doc"].tobytes())
    assert port_side.lifecycle.load_journal(str(tmp_path / "none")) is None
