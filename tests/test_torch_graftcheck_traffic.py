"""The port's traffic audit (the counterpart of the JAX package's
``analysis/traffic.py``) on the CPU: the registry and every contract are
JAX's (``donated`` read as ``in_place``), the symbolization gives JAX's
monomials, the audit geometry keeps JAX's distinct-scale-dims rule at a
head the kernels take, every single-card entry meets its contract with
the kernels' plain versions as leaves (the gather rungs reported as
refused), and the seeded ``bad_traffic.py`` is caught with exactly its
rules. The ``_tp2`` rows run in tests/test_torch_graftcheck_gspmd.py's
world; the card runs them in tests/test_torch_gpu.py and chip_smoke.py
phase 22b."""
import dataclasses
import json
import pathlib

import pytest
import torch

from k8s_gpu_scheduler_tpu.analysis import entrypoints as jeps
from k8s_gpu_scheduler_tpu.analysis import traffic as jtraffic
from k8s_gpu_scheduler_tpu_torch.analysis import __main__ as cli
from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
from k8s_gpu_scheduler_tpu_torch.analysis import traffic
from k8s_gpu_scheduler_tpu_torch.ops.decode_attention import KERNEL_HEAD_DIMS

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "graftcheck_torch" / "bad_traffic.py"
CPU = torch.device("cpu")
SINGLE = [(n, e) for n, e in eps.traffic_entrypoints() if e.world == 1]
# TestTraffic.GEO of tests/test_analysis.py.
TEST_GEO = {"n_pages": 11, "S": 13, "hit": 12, "tb": 4, "W": 5, "M": 3,
            "Hkv": 2, "hd": 7, "ps": 6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_is_jaxs():
    assert eps.traffic_entry_names() == jeps.traffic_entry_names()
    assert [n for n, _ in eps.traffic_entrypoints()] == \
        jeps.traffic_entry_names()
    assert traffic.TRACKED_KV == jtraffic.TRACKED_KV
    assert (traffic.POOL_SYM, traffic.SLOTS_SYM, traffic.HIT_SYM) == (
        jtraffic.POOL_SYM, jtraffic.SLOTS_SYM, jtraffic.HIT_SYM)


@pytest.mark.parametrize("name", jeps.traffic_entry_names())
def test_contract_is_jaxs_field_for_field(name):
    port = dataclasses.asdict(eps.traffic_contracts()[name])
    jax = dataclasses.asdict(jeps.traffic_contracts()[name])
    assert port.pop("in_place") == jax.pop("donated")
    assert port == jax


SHAPES = [(3, 13), (3, 13, 13), (11, 6, 2, 7), (2, 3, 12, 2, 7), (3, 4, 4),
          (5, 3, 4), (1, 11, 9), (2, 23, 8, 2, 128), (2, 3, 32, 2, 128),
          (3, 5, 384), (3, 16, 16), (23, 8), (56, 64), (3, 7), (112, 64)]


@pytest.mark.parametrize("geo", [TEST_GEO, jeps.TRAFFIC_GEOMETRY,
                                 eps.TRAFFIC_GEOMETRY],
                         ids=["TestTraffic.GEO", "jax", "port"])
def test_monomials_are_jaxs(geo):
    for shape in SHAPES:
        syms, const = traffic.symbolize_shape(shape, geo)
        want = jtraffic.symbolize_shape(shape, geo)
        assert (syms, const) == want
        assert traffic.render_monomial(syms, const) == \
            jtraffic.render_monomial(*want)


def test_geometry_keeps_scale_dims_distinct():
    """JAX's rule at the port's widths: every scale-bearing value differs
    from every other dim in play, the tp-sliced widths and the rope
    table's half head included; the geometry is the config's."""
    geo = eps.TRAFFIC_GEOMETRY
    assert list(geo) == list(jeps.TRAFFIC_GEOMETRY)
    assert eps.TRAFFIC_SIZE.geometry() == geo
    cfg = eps._traffic_cfg()
    scale = [geo[s] for s in traffic.TRACKED_KV + ("M",)]
    assert len(set(scale)) == len(scale)
    hd, tp = cfg.head_dim, 2
    in_play = {cfg.n_layers, cfg.vocab, cfg.d_ff, cfg.d_model, hd, hd // 2,
               cfg.max_seq, cfg.n_heads, cfg.n_kv_heads, geo["ps"],
               cfg.d_model // tp, cfg.d_ff // tp, cfg.n_heads * hd // tp,
               cfg.n_kv_heads * hd, cfg.n_kv_heads * hd // tp,
               geo["S"] // geo["ps"]}
    assert not set(scale) & in_play
    assert hd in KERNEL_HEAD_DIMS


def test_contract_validation():
    with pytest.raises(ValueError, match="rationale"):
        traffic.TrafficContract(dense_ok=True)
    with pytest.raises(ValueError, match="untracked"):
        traffic.TrafficContract(kv_scale={"bogus": 1})


@pytest.mark.parametrize("name,entry", SINGLE, ids=[n for n, _ in SINGLE])
def test_single_card_entry_meets_its_contract(name, entry):
    found, stats = traffic.run_traffic_entry(entry, name, CPU)
    assert found == [], [f.render() for f in found]
    if "gather" in name:
        assert "standing rule" in stats["refused"]
        return
    assert stats["pool_set"] > 0 and stats["peak_pool"] == 0
    kernels = {"traffic_decode_chunk": "paged_decode_reference",
               "traffic_verify_window": "paged_verify_reference",
               "traffic_verify_window_sampled": "paged_verify_reference",
               "traffic_prefill_tb16_hb4_kernel": "dense_prefill_reference"}
    if name in kernels:
        assert stats["launched"].get(kernels[name]), stats["launched"]


def test_refused_rows_are_notes_not_findings():
    entry = dict(eps.traffic_entrypoints())["traffic_prefill_tb16_hb4_gather"]
    found, stats = traffic.run_traffic_entry(entry, "g", CPU)
    assert found == [] and "refused" in stats
    served = dataclasses.replace(
        dict(eps.traffic_entrypoints())["traffic_prefill_tb16_hb4_kernel"],
        refused=eps.GATHER_REFUSAL)
    found, _ = traffic.run_traffic_entry(served, "k", CPU)
    assert {f.rule for f in found} == {"traffic-refusal"}


def test_the_plain_gather_hides_inside_the_kernel_leaf(monkeypatch):
    """The prefix rung's K2 leaf keeps the plain version's dense prefix
    gather out of the record; recorded with the leaf opened up, the same
    call is a dense materialization."""
    from k8s_gpu_scheduler_tpu_torch.analysis.oprecord import OpRecorder

    entry = dict(eps.traffic_entrypoints())["traffic_prefill_tb16_hb4_kernel"]
    assert traffic.run_traffic_entry(entry, "k", CPU)[0] == []
    monkeypatch.setattr(OpRecorder, "_leaf",
                        lambda self, name, f, a, kw: f(*a, **kw))
    fn, args = entry.build(CPU)
    with OpRecorder(CPU) as r:
        fn(*args)
    contract = traffic.as_contract(entry.contract)
    found = traffic.audit_traffic_record(
        r.record, "k", entry.geometry, contract,
        traffic.working_set(args, contract, entry.geometry))
    assert "dense-materialization" in {f.rule for f in found}


def test_pool_copy_breaks_residency_on_cpu():
    entry = dict(eps.traffic_entrypoints())["traffic_decode_chunk"]

    def build(device, rank=0, world=1):
        fn, args = entry.build(device)

        def copying(model, k, *rest):
            k = k.clone()                       # the bug
            return fn(model, k, *rest)
        return copying, args

    found, _ = traffic.run_traffic_entry(
        dataclasses.replace(entry, build=build), "copy", CPU)
    assert {f.rule for f in found} == {"peak-residency"}


def test_bad_traffic_fixture_caught(capsys):
    assert cli.main([str(FIXTURE), "--device", "cpu", "--json"]) == 1
    doc = json.loads(capsys.readouterr().out.splitlines()[0])
    assert set(doc["rules"]) == {"dense-materialization", "traffic-contract",
                                 "peak-residency"}
    by_entry = {}
    for f in doc["findings"]:
        by_entry.setdefault(f["path"][len("<traffic:"):-1], set()).add(
            f["rule"])
    assert by_entry == {
        "bad_dense_gather": {"dense-materialization", "traffic-contract"},
        "bad_pool_copied": {"peak-residency"},
        "bad_no_contract": {"traffic-contract"},
        "bad_replicated_weight": {"traffic-contract"}}
