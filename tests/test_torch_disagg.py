"""The port's disaggregated prefill/decode pools against the JAX
package's: the engine's ``role=`` option (a ``"prefill"`` engine admits and
chunks prefills but never decodes, parking ready slots for the handoff),
and ``Router(pools=...)``'s handoff at the phase boundary.

Each scenario runs on both packages (``test_torch_fleet.sides``: the same
f32 tiny weights, each package's own ``VirtualClock``). The flight
records of a prefill engine, the handoff placements, the streams,
``stats()``, the journal, the router's ``handoff`` spans and the
exposition (with the handoff counter, its duration histogram and the
one-hot role gauge) must be equal, exactly, and the streams equal one
mixed engine's."""
import dataclasses

import pytest

from test_torch_fleet import (
    FAST_QUARANTINE, PAGE, drive, events, exposition, journal_doc, router,
    sides, single_engine, workload)  # noqa: F401


def prompts(n=8, lo=10, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, 256, lo + i % 7)) for i in range(n)]


def disagg(side, clk, n_prefill=1, n_decode=2, **kw):
    engines = {f"p{i}": side.engine(clock=clk, role="prefill",
                                    prefill_chunk_tokens=PAGE)
               for i in range(n_prefill)}
    engines.update({f"d{i}": side.engine(clock=clk, role="decode")
                    for i in range(n_decode)})
    pools = {"prefill": [f"p{i}" for i in range(n_prefill)],
             "decode": [f"d{i}" for i in range(n_decode)]}
    rtr, reg, tr = router(side, engines, clk, pools=pools,
                          health=side.fleet.HealthPolicy(
                              quarantine=side.retry.RetryPolicy(
                                  **FAST_QUARANTINE)), **kw)
    return rtr, reg, tr, engines


@pytest.mark.parametrize("role", ["mixed", "prefill", "decode"])
def test_role_is_accepted_and_reported_as_in_jax(sides, role):
    """Every role builds an engine whose ``role``, ``replica_stats()`` and
    ``fingerprint()`` (role left out) equal JAX's."""
    got = [(e.role, e.replica_stats(), e.fingerprint())
           for e in (s.engine(role=role) for s in sides)]
    assert got[1] == got[0]
    assert got[1][2] == sides[1].engine().fingerprint()


def test_role_validation_matches_jax(sides):
    errors = []
    for side in sides:
        for kw in (dict(role="weird"),
                   dict(role="prefill", kv_layout="contiguous",
                        prefix_cache=False)):
            with pytest.raises(ValueError) as e:
                side.engine(**kw)
            errors.append(str(e.value))
        eng = side.engine(role="prefill")
        eng.submit(list(range(1, 20)), max_new=4)
        with pytest.raises(RuntimeError) as e:
            eng.run()
        errors.append(str(e.value))
    assert errors[3:] == errors[:3]


def test_prefill_engine_parks_ready_slots_as_jax(sides):
    """A prefill engine over 12 steps: one token emitted, the slot handoff
    ready, ``prefill_only`` flight records and no decode, equal to
    JAX's."""
    got = []
    for side in sides:
        clk = side.obs.VirtualClock()
        eng = side.engine(clock=clk, role="prefill",
                          prefill_chunk_tokens=PAGE)
        rid = eng.submit(list(range(1, 1 + 2 * PAGE)), max_new=8)
        mid_prefill = None
        for i in range(12):
            eng.step()
            if i == 0:
                mid_prefill = eng.handoff_ready_slots()
        got.append((mid_prefill, eng.emitted(rid),
                    eng.handoff_ready_slots(), eng.pending,
                    eng._flight.records()))
    assert got[1] == got[0]
    assert got[1][0] == [] and len(got[1][1]) == 1 and got[1][3] == 1
    kinds = {r["kind"] for r in got[1][4]}
    assert "prefill_only" in kinds and "decode" not in kinds


def served(side, n_prefill=1, n_decode=2):
    clk = side.obs.VirtualClock()
    rtr, reg, tr, _ = disagg(side, clk, n_prefill, n_decode)
    frids = [rtr.submit(p, max_new=8, trace_id=f"t{i}")
             for i, p in enumerate(prompts())]
    placed = [rtr.locate(f)[0] for f in frids]
    done = drive(rtr, clk, 0.01)
    return dict(placed=placed, streams=[done[f] for f in frids],
                stats=rtr.stats(), journal=journal_doc(rtr),
                plan=dataclasses.asdict(rtr.pool_plan()),
                events=events(tr), exposition=exposition(reg))


@pytest.mark.parametrize("n_prefill,n_decode", [(1, 2), (2, 2)])
def test_disaggregated_serving_matches_jax(sides, n_prefill, n_decode):
    """Every request lands on the prefill pool, hands off once, and
    streams what one mixed engine streams; placements, stats, journal,
    pool plan, spans and exposition are JAX's."""
    got = [served(s, n_prefill, n_decode) for s in sides]
    for key in got[0]:
        assert got[1][key] == got[0][key], key
    st = got[1]["stats"]
    assert st["handoffs"] == 8 and st["requests_lost"] == 0
    assert set(got[1]["placed"]) <= {f"p{i}" for i in range(n_prefill)}
    assert got[1]["streams"] == single_engine(sides[1], prompts())
    assert sum(e[0] == "handoff" for e in got[1]["events"]) == 8
    assert any(ln.startswith("tpu_fleet_handoff_duration_seconds_count")
               for ln in got[1]["exposition"])


def manual_handoff(side):
    clk = side.obs.VirtualClock()
    rtr, _, _, engines = disagg(side, clk, 1, 1)
    out = []
    with pytest.raises(side.fleet.FleetError, match="cross pools") as e:
        rtr.shed("p0", "d0")
    out.append(str(e.value))
    frid = rtr.submit(list(range(1, 1 + 4 * PAGE)), max_new=4)
    eng = engines["p0"]
    eng.step()                          # admit and the first chunk only
    with pytest.raises(side.fleet.FleetError, match="mid-prefill") as e:
        rtr.handoff(frid)
    out.append(str(e.value))
    while eng.handoff_ready_slots() == []:
        eng.step()
    out.append(rtr.handoff(frid))
    with pytest.raises(side.fleet.FleetError, match="already on") as e:
        rtr.handoff(frid)
    out.append(str(e.value))
    out.append(drive(rtr, clk))
    return out


def test_manual_handoff_matches_jax(sides):
    got = [manual_handoff(s) for s in sides]
    assert got[1] == got[0]
    assert got[1][2] == "d0" and len(got[1][4][0]) == 4


def decode_crash_after_handoff(side):
    """The decode replica holding handed-off requests dies: they replay
    through the prefill pool with their original deadlines."""
    clk = side.obs.VirtualClock()
    inj = side.faults.FaultInjector(rules=[side.faults.FaultRule(
        "replica.crash", "crash", at=[8])])
    rtr, reg, tr, _ = disagg(side, clk, 1, 2, faults=inj)
    frids = [rtr.submit(p, max_new=8, deadline_s=60.0)
             for p in prompts(n=6, seed=2)]
    done = drive(rtr, clk, 0.01)
    return dict(log=inj.log, streams=[done.get(f) for f in frids],
                stats=rtr.stats(), events=events(tr),
                exposition=exposition(reg))


def test_decode_crash_after_handoff_matches_jax(sides):
    got = [decode_crash_after_handoff(s) for s in sides]
    for key in got[0]:
        assert got[1][key] == got[0][key], key
    st = got[1]["stats"]
    assert st["failovers"] == 1 and st["requests_lost"] == 0
    assert got[1]["streams"] == single_engine(sides[1], prompts(n=6, seed=2))


def test_decode_pool_serves_when_prefill_pool_is_down(sides):
    """With the only prefill replica crashed, new requests land on the
    decode pool and complete there, as in JAX."""
    got = []
    for side in sides:
        clk = side.obs.VirtualClock()
        rtr, _, _, _ = disagg(side, clk, 1, 2)
        rtr._crash("p0", RuntimeError("chaos"))
        frids = [rtr.submit(p, max_new=8) for p in prompts(n=4)]
        placed = [rtr.locate(f)[0] for f in frids]
        done = drive(rtr, clk)
        got.append((placed, [done[f] for f in frids], rtr.stats()))
    assert got[1] == got[0]
    assert set(got[1][0]) <= {"d0", "d1"}
    assert got[1][1] == single_engine(sides[1], prompts(n=4))
