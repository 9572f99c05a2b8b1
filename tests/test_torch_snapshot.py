"""The port's serving lifecycle against the JAX engine's: snapshots,
drain/restore/absorb, the persisted checkpoint and fault injection.

Both engines get the same f32 tiny weights (JAX ``init_params``, carried
by the bridge) and the same traffic from a numpy seed: five prompts on two
slots, two of them sharing a two-page system prompt, drained when the
first two have finished and the next two decode, so the drain catches
slots mid-decode, mounted prefix pages, a tree path and a queue. A snapshot crosses between the packages through ``to_pytree`` /
``from_pytree``. Greedy streams after drain → restore must equal the JAX
engine's undrained run, token for token. The JAX engine runs its Pallas
kernels in interpret mode; the port runs its plain versions (CPU
tensors)."""
import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_gpu_scheduler_tpu.models.llama import init_params as j_init
from k8s_gpu_scheduler_tpu.models.serving import ContinuousBatcher as JEngine
from k8s_gpu_scheduler_tpu.models.snapshot import (
    ServingSnapshot as JSnapshot)
from k8s_gpu_scheduler_tpu.models.snapshot import SnapshotError as JSnapErr
from k8s_gpu_scheduler_tpu.testing import faults as jfaults
from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.models import lifecycle
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
from k8s_gpu_scheduler_tpu_torch.models.snapshot import (
    ServingSnapshot, SnapshotError)
from k8s_gpu_scheduler_tpu_torch.testing import faults
from test_torch_serving import configs

PAGE = 8
ENGINE = dict(kv_layout="paged", prefix_cache=True, page_size=PAGE,
              n_slots=2, max_len=64, chunk=4, prefill_bucket=8)
MAX_NEW = 9
WIRE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "data", "wire")


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = configs()
    params = j_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


def workload(seed=0):
    """Five prompts, the first and the third on a shared two-page system
    prompt: the first finishes and donates its pages before the third is
    admitted and mounts them."""
    rng = np.random.default_rng(seed)
    system = list(rng.integers(0, 256, 2 * PAGE))
    own = [list(rng.integers(0, 256, n)) for n in (3, 10, 4, 17, 5)]
    return [system + own[0], own[1], system + own[2], own[3], own[4]]




def jax_engine(weights, **kw):
    jcfg, _, params, _ = weights
    return JEngine(params, jcfg, **{**ENGINE, **kw})


def port_engine(weights, **kw):
    _, cfg, _, model = weights
    return ContinuousBatcher(model, cfg, device="cpu", **{**ENGINE, **kw})


def finish(eng, done):
    while eng.pending:
        done.update(eng.step())
    return done


def start(eng, prompts, steps=None):
    """Submit ``prompts`` and step ``steps`` times, or by default until the
    first two requests have finished and one step more (the next two then
    decode, one on the first's donated pages, and one waits): (ids,
    finished so far)."""
    ids = [eng.submit(p, max_new=MAX_NEW) for p in prompts]
    done = {}
    if steps is None:
        while len(done) < 2:
            done.update(eng.step())
        steps = 1
    for _ in range(steps):
        done.update(eng.step())
    return ids, done


_REF = {}


def reference(weights, **kw):
    """The JAX engine's undrained streams on the workload (cached)."""
    key = tuple(sorted(kw.items()))
    if key not in _REF:
        eng = jax_engine(weights, **kw)
        ids, done = start(eng, workload(), 0)
        finish(eng, done)
        _REF[key] = [done[i] for i in ids]
    return _REF[key]


def resume(eng, snap, ids, done):
    """Restore ``snap`` into ``eng`` and finish; the streams of ``ids``."""
    assert eng.restore(snap) == snap.n_requests_in_flight > 0
    finish(eng, done)
    eng._alloc.assert_consistent()
    return [done[i] for i in ids]


KINDS = [pytest.param({}, id="f32"),
         pytest.param(dict(kv_dtype="int8"), id="int8kv"),
         pytest.param(dict(speculative=True, gamma=3), id="spec"),
         pytest.param(dict(kv_dtype="int8", speculative=True, gamma=3),
                      id="int8kv-spec")]


@pytest.mark.parametrize("kw", KINDS)
def test_jax_snapshot_resumes_in_the_port(weights, kw):
    """(i) A JAX engine drained mid-stream restores into the port's
    engine, which finishes every stream as the undrained JAX run does."""
    src = jax_engine(weights, **kw)
    ids, done = start(src, workload())
    jsnap = src.drain()
    assert jsnap.slot_req and jsnap.queue and jsnap.tree_paths
    snap = ServingSnapshot.from_pytree(jsnap.to_pytree())
    got = resume(port_engine(weights, **kw), snap, ids, done)
    assert got == reference(weights, **kw)


@pytest.mark.parametrize("kw", KINDS[:3])
def test_port_snapshot_resumes_in_jax(weights, kw):
    """(ii) The port's snapshot restores into the JAX engine at f32."""
    src = port_engine(weights, **kw)
    ids, done = start(src, workload())
    snap = JSnapshot.from_pytree(src.drain().to_pytree())
    dst = jax_engine(weights, **kw)
    assert dst.restore(snap) == snap.n_requests_in_flight
    finish(dst, done)
    dst._alloc.assert_consistent()
    assert [done[i] for i in ids] == reference(weights, **kw)


def test_bf16_pages_cross_as_their_words(weights):
    """A bf16 JAX snapshot's pages land in the port's bf16 pool bit for
    bit (the host holds them as 16-bit words), and the port's drain gives
    back the same words under ``payload_dtype: "bfloat16"``. Streams are
    not compared: bf16 kernels differ across the packages."""
    jcfg, cfg, params, _ = weights
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    src = JEngine(jparams, jcfg, **ENGINE)
    start(src, workload())
    tree = src.drain().to_pytree()
    assert tree["k_pages"].dtype.name == "bfloat16"
    snap = ServingSnapshot.from_pytree(tree)
    words = np.asarray(tree["k_pages"]).view(np.uint16)
    assert snap.k_pages.dtype == np.uint16
    assert np.array_equal(snap.k_pages, words)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    eng = ContinuousBatcher(model, cfg, device="cpu", **ENGINE)
    eng.restore(snap)
    # The pool's words at the restored ids, in the snapshot's order.
    new = {int(o): int(n) for o, n in zip(snap.table.reshape(-1),
                                          eng._table_np.reshape(-1))}
    for i, old in enumerate(snap.page_ids):
        if old in new:
            pool = eng._k[:, new[old]].view(torch.int16).numpy()
            assert np.array_equal(pool.view(np.uint16), words[:, i])
    back = eng.drain().to_pytree()
    doc = json.loads(bytes(back["meta_json"]).decode())
    jdoc = json.loads(bytes(tree["meta_json"]).decode())
    assert doc["payload_dtype"] == jdoc["payload_dtype"] == "bfloat16"
    assert back["k_pages"].dtype == np.uint16
    assert np.array_equal(back["k_pages"], words)
    assert np.array_equal(back["v_pages"],
                          np.asarray(tree["v_pages"]).view(np.uint16))


@pytest.mark.parametrize("restore_kw", [{}, dict(n_pages=48),
                                        dict(n_pages=12), dict(n_slots=2)],
                         ids=["same-pool", "larger-pool", "smaller-pool",
                              "queued"])
def test_port_drain_restore_equals_no_drain(weights, restore_kw):
    """(iii) Inside the port, drain → restore == no drain: into the same
    pool, a larger and a smaller one (``n_pages`` is exempt from the
    fingerprint), and with requests still queued at the drain."""
    steps = 1 if restore_kw.get("n_slots") else None
    eng = port_engine(weights)
    ref_ids, ref = start(eng, workload(), 0)
    finish(eng, ref)
    src = port_engine(weights)
    ids, done = start(src, workload(), steps)
    snap = ServingSnapshot.from_pytree(src.drain().to_pytree())
    assert snap.queue
    fresh = port_engine(weights, **restore_kw)
    assert resume(fresh, snap, ids, done) == [ref[i] for i in ref_ids]
    m = fresh.pool_metrics()
    assert m["requests_resumed_total"] == snap.n_requests_in_flight
    assert m["restore_duration_seconds"] > 0
    assert src.pool_metrics()["drain_duration_seconds"] > 0


def test_mid_prefill_slots_resume_unchunked(weights):
    """A chunked engine drained while slots are mid-prefill restores into
    an unchunked engine, which finishes each remainder in one chunk; the
    streams equal the undrained run (chunking is not in the
    fingerprint)."""
    src = port_engine(weights, prefill_chunk_tokens=PAGE)
    ids, done = start(src, workload(), 1)
    snap = src.drain()
    assert any(int(snap.lens[s]) < len(snap.slot_prompt[s])
               for s in snap.slot_req)
    fresh = port_engine(weights)
    assert resume(fresh, snap, ids, done) == reference(weights)
    assert fresh.pool_metrics()["prefill_chunks_total"] > 0


@pytest.mark.parametrize("kw", [{}, dict(kv_dtype="int8"),
                                dict(speculative=True, gamma=3)],
                         ids=["f32", "int8kv", "spec"])
def test_fingerprint_equals_jax(weights, kw):
    """(iv) The port's fingerprint is the JAX engine's, key for key."""
    assert port_engine(weights, **kw).fingerprint() \
        == jax_engine(weights, **kw).fingerprint()


def _golden_tree():
    with np.load(os.path.join(WIRE, "snapshot_pre_tiering.npz")) as z:
        return {k: z[k] for k in z.files}


def test_wire_golden_loads_byte_faithfully(weights):
    """(v) The committed pre-tiering drain loads into the port's
    snapshot to the recorded fields and payload hash. Its fingerprint
    names ``decode_attn: "dense"``, which the port does not serve, so
    restore refuses it naming that key, as a JAX fused engine does."""
    with open(os.path.join(WIRE, "snapshot_pre_tiering.expect.json")) as fh:
        exp = json.load(fh)
    snap = ServingSnapshot.from_pytree(_golden_tree())
    assert snap.fingerprint == exp["fingerprint"]
    assert [int(p) for p in snap.page_ids] == exp["page_ids"]
    assert [int(x) for x in snap.lens] == exp["lens"]
    assert snap.n_requests_in_flight == exp["n_requests_in_flight"]
    assert [[r, p] for r, p in snap.queue] == exp["queue"]
    assert {str(r): ts for r, ts in snap.out.items()} == exp["out"]
    assert {str(r): b for r, b in snap.budgets.items()} == exp["budgets"]
    assert len(snap.tree_paths) == exp["n_tree_paths"]
    payload = hashlib.sha256(
        np.ascontiguousarray(snap.k_pages).tobytes()
        + np.ascontiguousarray(snap.v_pages).tobytes()).hexdigest()
    assert payload == exp["payload_sha256"]
    assert snap.tier_keys == [] and snap.tier_k is None
    assert snap.partial is False
    kw = {k: v for k, v in exp["engine_kw"].items()}
    with pytest.raises(SnapshotError, match="decode_attn"):
        port_engine(weights, **kw).restore(snap)
    with pytest.raises(JSnapErr, match="decode_attn"):
        jax_engine(weights, **kw).restore(
            JSnapshot.from_pytree(_golden_tree()))


def _drained(weights, **kw):
    eng = port_engine(weights, **kw)
    eng.submit(list(range(1, 12)), max_new=6)
    eng.step()
    return eng, eng.drain()


@pytest.mark.parametrize("case", ["drained", "not-fresh", "partial",
                                  "contiguous", "corrupt", "mismatch"])
def test_refusals(weights, case):
    """(vi) What restore and drain refuse, with JAX's errors: a drained
    engine, a busy engine, a partial snapshot, the contiguous layout, a
    snapshot missing a referenced page's payload, a fingerprint
    mismatch."""
    eng, snap = _drained(weights)
    if case == "drained":
        with pytest.raises(RuntimeError, match="already drained"):
            eng.drain()
        with pytest.raises(RuntimeError, match="drained"):
            eng.restore(snap)
    elif case == "not-fresh":
        busy = port_engine(weights)
        busy.submit([1, 2, 3], max_new=4)
        busy.step()
        with pytest.raises(SnapshotError, match="FRESH"):
            busy.restore(snap)
    elif case == "partial":
        src = port_engine(weights)
        src.submit(list(range(1, 12)), max_new=6)
        src.step()
        part = src.drain(slots=sorted(src._slot_req))
        assert part.partial and not src._slot_req
        src._alloc.assert_consistent()
        with pytest.raises(SnapshotError, match="absorb"):
            port_engine(weights).restore(part)
        with pytest.raises(SnapshotError, match="PARTIAL"):
            port_engine(weights).absorb(snap)
    elif case == "contiguous":
        cont = port_engine(weights, kv_layout="contiguous",
                           prefix_cache=False)
        with pytest.raises(SnapshotError, match="paged"):
            cont.drain()
    elif case == "corrupt":
        assert snap.nbytes() > 0
        broken = dataclasses.replace(
            snap, page_ids=snap.page_ids[:-1],
            k_pages=snap.k_pages[:, :-1], v_pages=snap.v_pages[:, :-1])
        with pytest.raises(SnapshotError):
            broken.validate()
    else:
        for bad_kw, key in ((dict(page_size=16), "page_size"),
                            (dict(chunk=8), "chunk"),
                            (dict(kv_dtype="int8"), "kv_dtype"),
                            (dict(n_slots=4), "n_slots")):
            with pytest.raises(SnapshotError, match=key):
                port_engine(weights, **bad_kw).restore(snap)


def test_clock_rebasing_charges_downtime():
    """(vi) Latency clocks survive a process boundary and charge the
    downtime: age before the drain plus the wall-clock gap."""
    snap = ServingSnapshot(
        fingerprint={}, page_ids=[], k_pages=np.zeros((1, 0, 8, 1, 4)),
        v_pages=np.zeros((1, 0, 8, 1, 4)), k_scales=None, v_scales=None,
        table=np.zeros((1, 8), np.int32), lens=np.zeros(1, np.int32),
        last=np.zeros(1, np.int32), slot_req={}, slot_pages={},
        slot_shared={}, slot_prompt={}, budgets={}, out={}, queue=[],
        next_id=0, eos_scanned={}, tree_paths=[],
        arrival={7: 100.0}, drained_mono=103.0, drained_wall=1000.0)
    rebased = snap.rebased_clock(snap.arrival, now_mono=50.0,
                                 now_wall=1010.0)
    assert rebased[7] == pytest.approx(50.0 - 13.0)


def test_lifecycle_persist_and_resume_twice(weights, tmp_path):
    """(vi) drain_to_checkpoint → resume_or_fresh through the port's own
    files, twice into the same directory (a second preemption of one
    lineage must not collide with the first); the streams equal the
    undrained run and one snapshot is kept."""
    ref = reference(weights)
    d = str(tmp_path / "serve_snapshot")
    eng = port_engine(weights)
    ids, done = start(eng, workload(), 1)
    snap = lifecycle.drain_to_checkpoint(eng, d)
    eng, resumed = lifecycle.resume_or_fresh(lambda: port_engine(weights), d)
    assert resumed == snap.n_requests_in_flight > 0
    done.update(eng.step())
    lifecycle.drain_to_checkpoint(eng, d)
    assert sorted(os.listdir(d)) == ["1"]
    eng, _ = lifecycle.resume_or_fresh(lambda: port_engine(weights), d)
    finish(eng, done)
    assert [done[i] for i in ids] == ref
    fresh, n = lifecycle.resume_or_fresh(lambda: port_engine(weights),
                                         str(tmp_path / "empty"))
    assert n == 0 and not fresh.pending


def test_preemption_fault_drains_and_resumes(weights):
    """(vii) A seeded ``Preempted`` at step 3 stops the engine before that
    step changes anything; drain → restore then finishes the streams as
    the undrained run does, and the injection log replays with the seed."""
    logs = []
    for _ in range(2):
        inj = faults.FaultInjector(seed=7, rules=[
            faults.FaultRule(site="serve.step", kind="preempt", at=[3])])
        eng = port_engine(weights, fault_injector=inj)
        ids = [eng.submit(p, max_new=MAX_NEW) for p in workload()]
        done = {}
        with pytest.raises(faults.Preempted):
            finish(eng, done)
        snap = ServingSnapshot.from_pytree(eng.drain().to_pytree())
        got = resume(port_engine(weights), snap, ids, done)
        assert got == reference(weights)
        logs.append(inj.log)
    assert logs[0] == logs[1] == [("serve.step", 3, "preempt")]


def test_page_pressure_matches_jax(weights):
    """(vii) A seeded page-pressure rule: the same streams and the same
    admissions (denials, allocations, hit lengths) as the JAX engine
    under the same rule, and every hostage released at the end."""
    def run(engine, mod):
        inj = mod.FaultInjector(seed=3, rules=[
            mod.FaultRule(site="serve.step", kind="page_pressure",
                          pages=10, p=0.5),
            mod.FaultRule(site="serve.step", kind="page_pressure",
                          pages=14, every=4, until=8)])
        eng = engine(weights, fault_injector=inj)
        ids, done = start(eng, workload(), 0)
        finish(eng, done)
        m = eng.pool_metrics()
        return ([done[i] for i in ids], inj.log, m["page_denied"],
                m["page_allocs"], m.get("prefix_hit_token_batch"),
                len(eng._chaos_pages))

    got = run(port_engine, faults)
    want = run(jax_engine, jfaults)
    assert got == want
    assert got[2] >= 1                     # pressure forced a denial
    assert got[0] == reference(weights)


def test_poison_proposal_fails_one_request(weights):
    """(vii) A ``serve.propose`` drop fails only its own request (its
    error recorded, its pages back in the pool), as in JAX; the other
    streams finish as without the fault."""
    def run(engine, mod):
        inj = mod.FaultInjector(rules=[mod.FaultRule(
            site="serve.propose", kind="drop", at=[2])])
        eng = engine(weights, speculative=True, gamma=3, fault_injector=inj)
        ids, done = start(eng, workload(), 0)
        finish(eng, done)
        eng._alloc.assert_consistent()
        return {i: done.get(i) for i in ids}, sorted(eng.errors)

    got, want = run(port_engine, faults), run(jax_engine, jfaults)
    assert got == want
    assert len(got[1]) == 1
