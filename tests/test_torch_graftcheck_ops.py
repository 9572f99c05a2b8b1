"""The port's op recorder and op audit (the counterpart of the JAX
package's jaxpr audit) on the CPU: the registry is JAX's, its thresholds
are JAX's, every entry records clean at the tiny widths, every kernel
wrapper records as one leaf op with nothing of its plain version inside,
the uploads a CUDA-graph capture would freeze are listed at their sites,
and the seeded ``bad_ops.py`` is caught with exactly its four rules. The
card's records are held to these in tests/test_torch_gpu.py and
chip_smoke.py phase 22a."""
import inspect
import json
import pathlib

import pytest
import torch

from k8s_gpu_scheduler_tpu.analysis import jaxpr_audit
from k8s_gpu_scheduler_tpu_torch.analysis import __main__ as cli
from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
from k8s_gpu_scheduler_tpu_torch.analysis import opaudit
from k8s_gpu_scheduler_tpu_torch.analysis.oprecord import (
    first_difference, record_call)
from k8s_gpu_scheduler_tpu_torch.models import serving
from k8s_gpu_scheduler_tpu_torch.ops import decode_attention as da
from k8s_gpu_scheduler_tpu_torch.ops import layers
from k8s_gpu_scheduler_tpu_torch.ops.flash_attention import (
    flash_attention_diff)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "graftcheck_torch" / "bad_ops.py"
CPU = torch.device("cpu")
SINGLE = [(n, e) for n, e in eps.op_entrypoints() if e.world == 1]
N_FREED = 500     # enough frees that some later storage reuses an id


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_is_jaxs():
    from k8s_gpu_scheduler_tpu.analysis.entrypoints import jaxpr_entrypoints

    assert list(eps.OP_AUDIT_NAMES) == [n for n, *_ in jaxpr_entrypoints()]
    assert [n for n, _ in eps.op_entrypoints()] == list(eps.OP_AUDIT_NAMES)
    assert [n for n, e in eps.op_entrypoints() if e.world > 1] == [
        "pipeline_loss_grad"]


def test_thresholds_are_jaxs():
    assert opaudit.CONST_BYTES_LIMIT == jaxpr_audit.CONST_BYTES_LIMIT
    assert opaudit.F32_ELEMS_LIMIT == jaxpr_audit.F32_ELEMS_LIMIT
    assert opaudit.DEAD_ELEMS_LIMIT == jaxpr_audit.DEAD_ELEMS_LIMIT


@pytest.mark.parametrize("name,entry", SINGLE, ids=[n for n, _ in SINGLE])
def test_entry_records_clean_on_cpu(name, entry):
    found, recs = opaudit.audit_entry(entry, name, CPU)
    assert found == [], [f.render() for f in found]
    assert recs and all(r.ops for r in recs)
    assert len(recs) == (2 if entry.loop else 1)
    assert not recs[0].readbacks()


def test_records_repeat_op_for_op():
    """Two builds of one entry record the same ops: what the card's record
    is compared with is deterministic."""
    entry = dict(eps.op_entrypoints())["batcher_verify_paged_spec"]
    a = opaudit.record_entry(entry, CPU)[1]
    b = opaudit.record_entry(entry, CPU)[1]
    assert first_difference(a, b) is None
    a.ops.pop()
    assert "ops against" in first_difference(a, b)


def _rand(*shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0))


WRAPPERS = {
    "paged_decode_attention": (da.paged_decode_attention, "paged_decode_reference"),
    "paged_verify_attention": (da.paged_verify_attention, "paged_verify_reference"),
    "paged_prefill_attention": (da.paged_prefill_attention,
                                "dense_prefill_reference"),
    "flash_decode_attention": (da.flash_decode_attention,
                               "flash_decode_reference"),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_decode_wrapper_records_as_one_leaf(name):
    """K1-K4: on the CPU the wrapper calls its plain version, and the
    record holds one op — the wrapper, its operands and its output —
    with nothing of the plain version (its dense gather) inside."""
    fn, plain = WRAPPERS[name]
    build = eps._op_kernel(name)
    f, args = build(CPU, None)
    out, rec = record_call(f, args, CPU)
    assert len(rec.ops) == 1
    (op,) = rec.ops
    assert op.leaf and op.name == name and op.allocated == (True,)
    assert op.outputs[0].shape == tuple(out.shape)
    assert len(op.inputs) == sum(isinstance(a, torch.Tensor) for a in args)
    assert op.launched == {plain: 1}


def test_flash_wrappers_record_as_leaves_in_forward_and_backward():
    """K5 (``flash_forward``) and K6 + K7 (``flash_backward``, one leaf:
    their plain version is one function) through autograd: the backward
    leaf is marked as the step's backward, and no op of the plain
    versions' einsums is in the record."""
    q = _rand(2, 16, 2, 64).requires_grad_()
    k = _rand(2, 16, 1, 64).requires_grad_()
    v = _rand(2, 16, 1, 64).requires_grad_()

    def step():
        flash_attention_diff(q, k, v).sum().backward()

    _, rec = record_call(step, (), CPU)
    leaves = [(op.name, op.backward) for op in rec.leaves()]
    assert leaves == [("flash_forward", False), ("flash_backward", True)]
    assert not any(op.name == "aten.bmm.default" for op in rec.ops)
    fwd, bwd = rec.leaves()
    assert [m.shape for m in fwd.outputs] == [(2, 16, 2, 64), (4, 16)]
    assert [m.shape for m in bwd.outputs] == [q.shape, k.shape, v.shape]
    assert bwd.launched == {"flash_backward_reference": 1}
    assert any(op.backward and not op.leaf for op in rec.ops)


def _line_of(fn, text):
    src, start = inspect.getsourcelines(fn)
    return start + next(i for i, s in enumerate(src) if text in s)


def test_dispatch_uploads_are_listed_at_their_sites():
    """The small per-call uploads a CUDA-graph capture would freeze, by
    ``file:line`` and bytes: ``_op_decode``'s ``active``, ``_op_verify``'s
    proposals, active flags and windows, and ``rope_freqs``' scalar."""
    def sites(name):
        entry = dict(eps.op_entrypoints())[name]
        rec = opaudit.record_entry(entry, CPU, (entry.loop or (None,))[0])[1]
        return {(t.via, t.nbytes, t.site) for t in rec.uploads()}

    rel = "k8s_gpu_scheduler_tpu_torch/"
    dec = _line_of(serving.ContinuousBatcher._op_decode, "as_tensor(active")
    assert sites("batcher_decode_paged") == {
        ("as_tensor", 2, f"{rel}models/serving.py:{dec}")}
    ver = serving.ContinuousBatcher._op_verify
    want = {("as_tensor", 16, _line_of(ver, "as_tensor(props")),
            ("as_tensor", 2, _line_of(ver, "as_tensor(active")),
            ("as_tensor", 8, _line_of(ver, "as_tensor(eff"))}
    assert sites("batcher_verify_paged_spec") == {
        (v, n, f"{rel}models/serving.py:{line}") for v, n, line in want}
    rope = _line_of(layers.rope_freqs, "torch.tensor(theta")
    assert ("tensor", 4, f"{rel}ops/layers.py:{rope}") in sites(
        "llama_generate")


def test_freed_host_data_leaves_no_mark_on_a_later_tensor():
    """A host tensor's storage is host data only while it lives: its id
    leaves the recorder's host set when it is freed, so a tensor made
    later that gets the same id (CPython reuses a freed object's address)
    is recorded like any other."""
    import numpy as np

    from k8s_gpu_scheduler_tpu_torch.analysis.oprecord import OpRecorder

    with OpRecorder("cpu") as rec:
        host = torch.from_numpy(np.ones(4, np.float32))
        key = id(host.untyped_storage())
        assert key in rec._host
        del host
        assert key not in rec._host

    def fn():
        out = []
        for _ in range(N_FREED):
            host = torch.from_numpy(np.ones(4, np.float32))
            del host
            fresh = torch.ones(4, device="cpu")
            out.append(fresh * 2)
        return out

    _, rec = record_call(fn, device="cpu")
    names = [op.name for op in rec.ops]
    assert names.count("aten.ones.default") == N_FREED
    assert names.count("aten.mul.Tensor") == N_FREED


def test_readback_outside_the_loop_warns_inside_errors():
    def build(device, loop):
        x = torch.ones(4, device=device)

        def fn():
            total = float(x.sum())                       # once a call
            for _ in range(loop):
                total += float(x[0])                     # once a tick
            return total
        return fn, ()

    found, _ = opaudit.audit_entry(opaudit.OpEntry(build, (2, 3)), "t", CPU)
    sev = sorted((f.rule, f.severity) for f in found)
    assert sev == [("host-transfer", "error"), ("host-transfer", "warning")]


def test_bad_ops_fixture_caught(capsys):
    assert cli.main([str(FIXTURE), "--device", "cpu", "--json"]) == 1
    doc = json.loads(capsys.readouterr().out.splitlines()[0])
    assert set(doc["rules"]) == {"per-call-upload", "f32-upcast",
                                 "host-transfer", "dead-output"}
    sev = {(f["rule"], f["severity"]) for f in doc["findings"]}
    assert ("host-transfer", "error") in sev
    assert ("dead-output", "warning") in sev
    assert "opaudit" in doc["pass_seconds"]
