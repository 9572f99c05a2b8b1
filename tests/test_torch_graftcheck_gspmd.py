"""The port's sharding audit (the counterpart of the JAX package's GSPMD
audit) and every multi-rank graftcheck entry on the CPU, on ONE spawned
world of two gloo ranks (``world.run_world``): the seven sharding
entries, the six ``_tp2`` traffic rows, the two tp steady states and the
pipeline's op audit (plus, for the tests, the replicated-weight row
under the weight-sharded contract). The registries are JAX's, every
entry is clean on both ranks, the CLI over the tree gates on the world's
results and reports its refused row, and the seeded ``bad_gspmd.py`` is
caught per rank, on a world of its own, with exactly its rules."""
import json
import pathlib

import pytest

from k8s_gpu_scheduler_tpu.analysis import entrypoints as jeps
from k8s_gpu_scheduler_tpu_torch.analysis import __main__ as cli
from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
from k8s_gpu_scheduler_tpu_torch.analysis import gspmd, world

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "graftcheck_torch" / "bad_gspmd.py"
REPLICATED_AS_WS = ("traffic", "traffic_decode_chunk_tp2_replicated"
                    "@traffic_decode_chunk_tp2", "")
JOBS = world.world_jobs()
KEYS = [(k, n) for k, n, _ in JOBS]


@pytest.fixture(scope="module")
def world_run():
    """The world's results on the CPU: {(pass, name): (findings, {rank:
    stats}, s)}."""
    return world.run_world("cpu", JOBS + [REPLICATED_AS_WS])[0]


def test_registries_are_jaxs():
    assert list(eps.GSPMD_NAMES) == [n for n, *_ in jeps.gspmd_entrypoints()]
    assert [n for n, _ in eps.gspmd_entrypoints()] == list(eps.GSPMD_NAMES)
    tp = [n for n, _ in jeps.recompile_scenarios() if "_tp" in n]
    assert [n for n, _ in eps.tp_steady_scenarios()] == tp
    assert not {n for n, _ in eps.steady_scenarios()} & set(tp)
    assert gspmd.REPLICATED_BYTES_LIMIT == 1 << 20


def test_world_runs_every_multi_rank_entry():
    assert JOBS == [(k, n, "") for k, n in (
        [("ops", "pipeline_loss_grad")]
        + [("traffic", n) for n in jeps.traffic_entry_names() if "_tp2" in n]
        + [("gspmd", n) for n in eps.GSPMD_NAMES]
        + [("steady", n) for n, _ in eps.tp_steady_scenarios()])]


def test_cli_passes_the_tree_on_cpu(world_run, monkeypatch, capsys):
    """The CLI over the tree with the world's results above and, of the
    single-card registries (each entry is held clean in its own test),
    only the refused gather row: it exits 0 and reports both gather rows
    as refused."""
    gather = "traffic_prefill_tb16_hb4_gather"
    rows = [(n, e) for n, e in eps.traffic_entrypoints() if n == gather]
    for registry in ("op_entrypoints", "alias_scenarios",
                     "steady_scenarios"):
        monkeypatch.setattr(eps, registry, lambda: [])
    monkeypatch.setattr(eps, "traffic_entrypoints", lambda: rows)
    got = {k: v for k, v in world_run.items()
           if k != REPLICATED_AS_WS[:2]}
    monkeypatch.setattr(world, "run_world", lambda device_type, jobs: (
        got, 0.0))
    assert cli.main(["--device", "cpu", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out.splitlines()[0])
    assert doc["findings"] == []
    assert {"opaudit", "traffic", "gspmd", "world", "alias",
            "steady"} <= set(doc["pass_seconds"])
    refused = [n.split(":")[0] for n in doc["notes"]]
    assert refused == [gather, f"{gather}_tp2"]
    assert set(doc["stats"]) == {f"{k}:{n}" for k, n in KEYS}


@pytest.mark.parametrize("job", KEYS, ids=[f"{k}:{n}" for k, n in KEYS])
def test_world_entry_clean_on_both_ranks(world_run, job):
    found, stats, _ = world_run[job]
    assert found == [], [f.render() for f in found]
    assert set(stats) == {0, 1}
    kind, name = job
    if kind == "gspmd" and name != "generate_sharded":
        assert all(s["island"] for s in stats.values())
        assert all(s["ops"] for s in stats.values())
    if kind == "traffic" and "gather" not in name:
        assert stats[0]["pool_set"] * 2 == _pool_bytes(eps.TRAFFIC_SIZE)


def _pool_bytes(size):
    cfg = eps._traffic_cfg()
    n = cfg.n_layers * size.n_pages * size.page_size * cfg.n_kv_heads
    return 2 * n * cfg.head_dim + 2 * n * 4      # int8 k, v + f32 scales


def test_replicated_island_under_the_ws_contract_is_flagged(world_run):
    """JAX's pin: the legacy replicated-weight island audited under a
    weight_sharded contract trips the replicated-weight finding."""
    found, _, _ = world_run[REPLICATED_AS_WS[:2]]
    assert {f.rule for f in found} == {"traffic-contract"}
    assert any("FULL" in f.message for f in found)


def test_tp_steady_states_keep_each_ranks_storage(world_run):
    for name, _ in eps.tp_steady_scenarios():
        _, stats, _ = world_run[("steady", name)]
        for st in stats.values():
            assert {"k", "v", "table"} <= set(st["tracked"])
            assert st["launches"].get("paged_decode_reference")


def test_bad_gspmd_fixture_caught_per_rank(capsys):
    assert cli.main([str(FIXTURE), "--device", "cpu", "--json"]) == 1
    doc = json.loads(capsys.readouterr().out.splitlines()[0])
    assert set(doc["rules"]) == {"cache-spec-mismatch",
                                 "oversized-replicated", "island-weight-spec"}
    by = {}
    for f in doc["findings"]:
        by.setdefault(f["path"][len("<gspmd:"):-1], set()).add(f["rule"])
    assert by == {
        "bad_cache_layout": {"cache-spec-mismatch", "oversized-replicated"},
        "bad_whole_cache": {"cache-spec-mismatch", "oversized-replicated"},
        "bad_replicated_weight_island": {"island-weight-spec"}}
    assert {"(rank 0)", "(rank 1)"} <= {
        f["message"].split(":")[0][-8:] for f in doc["findings"]}


def test_specs_name_only_the_rules_tables_axes():
    import torch

    from k8s_gpu_scheduler_tpu_torch.models.serving import CACHE_SPEC

    view = gspmd.RankView({"tp": 2}, {"tp": 0}, [gspmd.Sharded(
        "typo", torch.zeros(4), (4,), ("tq",))])
    found = gspmd.audit_rank(view, "t", 0)
    assert {f.rule for f in found} == {"unknown-mesh-axis"}
    assert gspmd._axes(CACHE_SPEC) <= gspmd.known_mesh_axes()
    assert gspmd._axes(gspmd.pool_spec()) == {"tp"}
