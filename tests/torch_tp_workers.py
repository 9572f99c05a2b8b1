"""Rank workers of the port's tensor-parallel tests
(``tests/test_torch_tp.py``). ``parallel.spawn`` pickles a worker by its
module and name, and every rank re-imports that module, so the workers
live here, in a module that imports no JAX. Each world function runs on
every rank of a gloo world on the CPU and returns its results from rank
0 (None from the others); every rank builds the same island engines in
the same order, the leader drives them and a follower replays them
(``ContinuousBatcher.follow``)."""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from k8s_gpu_scheduler_tpu_torch.bridge import params_from_numpy
from k8s_gpu_scheduler_tpu_torch.fleet import MemoryStore, Router
from k8s_gpu_scheduler_tpu_torch.fleet.summary import summarize
from k8s_gpu_scheduler_tpu_torch.models import serving
from k8s_gpu_scheduler_tpu_torch.models.llama import LlamaConfig, init_params
from k8s_gpu_scheduler_tpu_torch.models.serving import ContinuousBatcher
from k8s_gpu_scheduler_tpu_torch.models.snapshot import ServingSnapshot
from k8s_gpu_scheduler_tpu_torch.ops.quant import qdot, quantize_weight
from k8s_gpu_scheduler_tpu_torch.parallel import MeshSpec, make_mesh
from k8s_gpu_scheduler_tpu_torch.parallel.island import Island

# The JAX tp tests' engine (tests/test_sharded_serving.py build()).
BUILD = dict(n_slots=2, max_len=32, chunk=2, prefill_bucket=8, page_size=8,
             kv_layout="paged", device="cpu")


def config(**kw) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig.tiny(), decode_attn="fused",
                               dtype=torch.float32, **kw)


def mixed_prompts(vocab: int, seed: int = 0, n: int = 4) -> list:
    """The JAX tp tests' traffic (``test_sharded_serving.mixed_prompts``):
    random prompts, a prefix-sharing pair and a self-repeating prompt."""
    rng = np.random.default_rng(seed)
    phrase = list(rng.integers(0, vocab, 3))
    shared = list(rng.integers(0, vocab, 8))
    out = [list(rng.integers(0, vocab, int(ln)))
           for ln in rng.integers(4, 21, n - 2)]
    out.append(shared + list(rng.integers(0, vocab, 4)))
    out.append(phrase * 4)
    return [[int(t) for t in p] for p in out]


def drive(eng, prompts, max_new=4) -> dict:
    for p in prompts:
        eng.submit(p, max_new=max_new)
    return eng.run()


def island(make, lead):
    """Build an island engine on every rank (``make()``); the leader
    returns ``lead(engine)`` and stops its followers, a follower replays
    the leader's steps and returns None."""
    eng = make()
    if not eng.is_leader:
        eng.follow()
        return None
    try:
        return lead(eng)
    finally:
        eng.close()


def refusal(build) -> str:
    try:
        build()
    except (TypeError, ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "built"


def _cell(cell: dict):
    """(cfg, engine kwargs) of a grid cell: config keys go to the
    config, the rest to the engine."""
    cell = dict(cell)
    cfg_kw = {k: cell.pop(k) for k in ("n_kv_heads",) if k in cell}
    return config(**cfg_kw), cell


def world_two(rank, world, tree, prompts, cells, jax_snap, shed_prompts):
    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec({"tp": world}), "cpu")
    cfg = config()
    full = params_from_numpy(tree, cfg, "cpu")
    out = {}

    # Streams of every cell at tp = 2 against the port's tp = 1. The
    # first cell's ranks get their slices from the bridge, the others
    # slice the full model in the engine.
    out["grid"] = {}
    for i, (name, cell) in enumerate(cells):
        ccfg, kw = _cell(cell)
        base = full if ccfg == cfg else init_params(
            ccfg, torch.Generator().manual_seed(0), "cpu")
        model = (params_from_numpy(tree, ccfg, "cpu", mesh=mesh) if i == 0
                 else base)

        def lead(eng, kw=kw, ccfg=ccfg, base=base):
            ref = ContinuousBatcher(base, ccfg, **BUILD, **kw)
            return drive(eng, prompts), drive(ref, prompts)

        out["grid"][name] = island(
            lambda: ContinuousBatcher(model, ccfg, mesh=mesh, **BUILD, **kw),
            lead)

    # psum: streams, and the helper against the monolithic qdot.
    out["psum"] = island(
        lambda: ContinuousBatcher(full, cfg, mesh=mesh, tp_combine="psum",
                                  kv_dtype="int8", **BUILD),
        lambda eng: (drive(eng, prompts), drive(ContinuousBatcher(
            full, cfg, kv_dtype="int8", **BUILD), prompts),
            eng.pool_metrics()["tp_combine"]))
    isl = Island(mesh, torch.device("cpu"), True, "psum")
    rng = np.random.default_rng(0)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(rng.standard_normal((4, 64)), dtype=dt)
        w = torch.as_tensor(rng.standard_normal((64, 32)), dtype=dt)
        for kind, wt in (("plain", w), ("int8", quantize_weight(w))):
            if kind == "plain":
                local = w[32 * rank:32 * (rank + 1)]
            else:
                local = {"q": wt["q"][32 * rank:32 * (rank + 1)],
                         "s": wt["s"]}
            got = serving._psum_qdot(x[:, 32 * rank:32 * (rank + 1)],
                                     local, isl).float()
            want = qdot(x, wt).float()
            errs[(str(dt), kind)] = (got - want).abs().max().item(), \
                want.abs().max().item()
    out["psum_err"] = errs

    # Replicated weights: the tp = 1 streams, warned once and counted.
    serving.reset_decode_fallback_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["replicated"] = island(
            lambda: ContinuousBatcher(full, cfg, mesh=mesh,
                                      weight_sharding=False, **BUILD),
            lambda eng: (drive(eng, prompts), eng.pool_metrics()))
        island(lambda: ContinuousBatcher(full, cfg, mesh=mesh,
                                         weight_sharding=False, **BUILD),
               lambda eng: None)
    out["replicated_counts"] = serving.decode_fallback_counts()
    out["replicated_warnings"] = sum(
        "weight_sharding=False" in str(w.message) for w in caught)

    # Bytes per rank, the fingerprint and the fleet summary.
    def stats(eng):
        one = ContinuousBatcher(full, cfg, kv_dtype="int8", **BUILD)
        return (eng.pool_metrics(), one.pool_metrics(), eng.fingerprint(),
                one.fingerprint(), eng.replica_stats(),
                summarize(eng, "r0").tp)

    out["stats"] = island(
        lambda: ContinuousBatcher(full, cfg, mesh=mesh, kv_dtype="int8",
                                  **BUILD), stats)

    # Snapshots: tp = 2 → tp = 1 (here) → tp = 4 (world_four).
    def hop(eng):
        for p in prompts:
            eng.submit(p, max_new=6)
        done = dict(eng.step())
        one = ContinuousBatcher(full, cfg, kv_dtype="int8",
                                prefix_cache=True, **BUILD)
        one.restore(eng.drain())
        done.update(one.step())
        return done, one.drain().to_pytree()

    out["hop"] = island(
        lambda: ContinuousBatcher(full, cfg, mesh=mesh, kv_dtype="int8",
                                  prefix_cache=True, **BUILD), hop)
    out["hop_ref"] = drive(ContinuousBatcher(
        full, cfg, kv_dtype="int8", prefix_cache=True, **BUILD), prompts,
        max_new=6) if rank == 0 else None

    # The JAX engine's tp = 2 snapshot, restored here at tp = 2.
    def finish(eng):
        eng.restore(ServingSnapshot.from_pytree(jax_snap))
        done = {}
        while eng.pending:
            done.update(eng.step())
        return done

    out["jax_restore"] = island(
        lambda: ContinuousBatcher(full, cfg, mesh=mesh, kv_dtype="int8",
                                  **BUILD), finish)

    # Shed/absorb across tp, both ways, and a Router over both widths.
    def shed(eng):
        one = ContinuousBatcher(full, cfg, kv_dtype="int8",
                                prefix_cache=True, **BUILD)
        res = {}
        for src, dst in ((eng, one), (one, eng)):
            rids = [src.submit(p, max_new=6) for p in shed_prompts]
            done = dict(src.step())
            slot = src.active_slot_ids()[0]
            rid = src._slot_req[slot]
            mapping = dst.absorb(src.drain(slots=[slot]))
            while src.pending:
                done.update(src.step())
            moved = {}
            while dst.pending:
                moved.update(dst.step())
            done[rid] = done.get(rid, []) + moved[mapping[rid]]
            res["tp2->tp1" if src is eng else "tp1->tp2"] = [
                done[r] for r in rids]
        res["ref"] = [drive(ContinuousBatcher(
            full, cfg, kv_dtype="int8", **BUILD), [p], max_new=6).popitem()[1]
            for p in shed_prompts]
        rtr = Router([("r0", eng), ("r1", ContinuousBatcher(
            full, cfg, kv_dtype="int8", prefix_cache=True, **BUILD))],
            store=MemoryStore())
        frids = [rtr.submit(p, max_new=6) for p in prompts]
        done = dict(rtr.step())
        busy = [r for r in ("r0", "r1")
                if rtr._replica(r).engine.active_slot_ids()]
        moved = rtr.shed(busy[0], "r1" if busy[0] == "r0" else "r0",
                         max_slots=1)
        while rtr.pending:
            done.update(rtr.step())
        res["router"] = ([done[f] for f in frids], moved,
                         {r: s.tp for r, s in rtr.summaries().items()})
        return res

    out["shed"] = island(
        lambda: ContinuousBatcher(full, cfg, mesh=mesh, kv_dtype="int8",
                                  prefix_cache=True, **BUILD), shed)

    # A data-parallel mesh (``MeshSpec.for_devices``' default tp = 1):
    # every rank leads its own engine, with no island.
    eng = ContinuousBatcher(full, cfg, mesh=make_mesh(
        MeshSpec.for_devices(world), "cpu"), **BUILD)
    out["tp1_mesh"] = (eng._island is None, eng.is_leader,
                       eng.pool_metrics()["tp"], drive(eng, prompts))

    # Refusals (raised while building, before any collective).
    dp_mesh = make_mesh(MeshSpec({"dp": world}), "cpu")
    odd = config(n_heads=6, n_kv_heads=3, d_model=48)
    moe = config(n_experts=2, moe_top_k=1)
    gen = torch.Generator().manual_seed(0)
    out["refusals"] = {
        "no_tp_axis": refusal(lambda: ContinuousBatcher(
            full, cfg, mesh=dp_mesh, **BUILD)),
        "kv_heads": refusal(lambda: ContinuousBatcher(
            init_params(odd, gen, "cpu"), odd, mesh=mesh, **BUILD)),
        "moe": refusal(lambda: ContinuousBatcher(
            init_params(moe, gen, "cpu"), moe, mesh=mesh, **BUILD)),
        "contiguous": refusal(lambda: ContinuousBatcher(
            full, cfg, mesh=mesh, **{**BUILD, "kv_layout": "contiguous"})),
    }
    return out if rank == 0 else None


def world_four(rank, world, tree, prompts, snap):
    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec({"tp": world}), "cpu")
    cfg = config()
    full = params_from_numpy(tree, cfg, "cpu")
    out = {}

    def finish(eng):
        eng.restore(ServingSnapshot.from_pytree(snap))
        done = {}
        while eng.pending:
            done.update(eng.step())
        return done, eng.pool_metrics()

    out["hop"] = island(
        lambda: ContinuousBatcher(full, cfg, mesh=mesh, kv_dtype="int8",
                                  prefix_cache=True, **BUILD), finish)
    out["streams"] = island(
        lambda: ContinuousBatcher(full, cfg, mesh=mesh, kv_dtype="int8",
                                  **BUILD),
        lambda eng: (drive(eng, prompts), drive(ContinuousBatcher(
            full, cfg, kv_dtype="int8", **BUILD), prompts)))
    wide = config(d_ff=130)
    gen = torch.Generator().manual_seed(0)
    wide_model = init_params(wide, gen, "cpu")
    out["d_ff"] = refusal(lambda: ContinuousBatcher(
        wide_model, wide, mesh=mesh, **BUILD))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out["d_ff_replicated"] = island(
            lambda: ContinuousBatcher(wide_model, wide, mesh=mesh,
                                      weight_sharding=False, **BUILD),
            lambda eng: eng.pool_metrics()["tp_combine"])
    return out if rank == 0 else None


def world_follower_fails(rank, world, tree, prompts):
    """The follower's decode raises; the leader's step must raise too."""
    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec({"tp": world}), "cpu")
    cfg = config()
    eng = ContinuousBatcher(params_from_numpy(tree, cfg, "cpu"), cfg,
                            mesh=mesh, **BUILD)
    if not eng.is_leader:
        def broken(**kw):
            raise RuntimeError("follower decode failed on purpose")

        eng._op_decode = broken
        eng.follow()
        return None
    for p in prompts:
        eng.submit(p, max_new=4)
    eng.run()
    return "the leader finished"


def world_meshes(rank, world):
    """make_mesh and multislice_mesh over the world: each mesh's dim
    names, shape, this rank's coordinates and tp group size."""
    from k8s_gpu_scheduler_tpu_torch.parallel import multislice_mesh
    from k8s_gpu_scheduler_tpu_torch.parallel.sharding import mesh_coords

    out = {}
    for name, mesh in (
            ("for_devices", make_mesh(MeshSpec.for_devices(world, tp=world),
                                      "cpu")),
            ("multislice", multislice_mesh(world, device_type="cpu"))):
        out[name] = (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
                     mesh_coords(mesh)[1], mesh.get_group("tp").size())
    try:
        make_mesh(MeshSpec({"tp": world + 1}), "cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    return out


def world_sleeps(rank, world):
    import time

    time.sleep(60)


def card_world(rank, world, combine):
    """On the card (every rank on card 0): the tiny f32 config served at
    tp = world with ``combine`` against one card's engine. Returns, from
    every rank, (streams or None, the rank's launch counts, its pool
    bytes) and, from rank 0, the single-card run's."""
    from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # The kernels take head_dim 64 or 128: 4 heads of 64, 2 kv heads
    # (1 a rank at tp 2, group 2).
    cfg = config(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512)
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    prompts = mixed_prompts(cfg.vocab, seed=1, n=6)
    kw = {**BUILD, "device": dev, "prefix_cache": True, "page_size": 16,
          "max_len": 64, "prefill_bucket": 16}

    def run(eng):
        da.reset_counters()
        streams = None
        if eng.is_leader:
            streams = drive(eng, prompts)
            eng.close()
        else:
            eng.follow()
        torch.cuda.synchronize()
        return (streams, da.counters(),
                eng.pool_metrics()["kv_pool_device_bytes"])

    mesh = make_mesh(MeshSpec({"tp": world}), "cuda")
    out = {"island": run(ContinuousBatcher(model, cfg, mesh=mesh,
                                           tp_combine=combine, **kw))}
    if rank == 0:
        out["one"] = run(ContinuousBatcher(model, cfg, **kw))
    return out
