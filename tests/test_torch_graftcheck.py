"""The port's graftcheck (k8s_gpu_scheduler_tpu_torch/analysis/) against
the JAX package's.

- The rules both packages share give the same (rule, line) sets over the
  JAX package's seeded fixtures (parsed, never imported) and over every
  .py of both packages.
- The port's wire schemas equal the JAX package's, dict for dict, and
  match the committed goldens, which the port never writes.
- Every seeded fixture of tests/data/graftcheck_torch/ is caught with its
  rule, and the CLI exits 1 on them and 0 on the port's tree.
- The registries cover every dispatch and kernel wrapper; the budgeter's
  presets reach K1–K7 within the H100's limits. (The alias and steady
  scenarios run in tests/test_torch_graftcheck_scenarios.py.)
"""
import ast
import dataclasses
import json
import pathlib
import re

import pytest
import torch

from k8s_gpu_scheduler_tpu.analysis import astlint as jax_astlint
from k8s_gpu_scheduler_tpu.analysis import determinism as jax_det
from k8s_gpu_scheduler_tpu.analysis import findings as jax_findings
from k8s_gpu_scheduler_tpu.analysis import lockorder as jax_lock
from k8s_gpu_scheduler_tpu.analysis import retrylint as jax_retry
from k8s_gpu_scheduler_tpu.analysis import wirecompat as jax_wire
from k8s_gpu_scheduler_tpu_torch import analysis
from k8s_gpu_scheduler_tpu_torch.analysis import __main__ as cli
from k8s_gpu_scheduler_tpu_torch.analysis import astlint, determinism
from k8s_gpu_scheduler_tpu_torch.analysis import entrypoints as eps
from k8s_gpu_scheduler_tpu_torch.analysis import findings, lockorder, retrylint
from k8s_gpu_scheduler_tpu_torch.analysis import smem, wirecompat

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_FIXTURES = ROOT / "tests" / "data" / "graftcheck"
FIXTURES = ROOT / "tests" / "data" / "graftcheck_torch"
SHARED_RULES = {
    "lock-guard", "bare-except", "lock-cycle", "torn-snapshot",
    "unbounded-retry", "blocking-io-under-lock", "bare-suppression",
    "unseeded-rng", "builtin-hash", "unordered-iteration",
    "wall-clock-decision"}


def _shared_findings(lint, lock, det, path: pathlib.Path) -> set:
    source = path.read_text()
    tree = ast.parse(source)
    found = (lint.lint_source(str(path), source, tree=tree)
             + lock.lint_lockorder_source(str(path), source, tree=tree)
             + det.lint_determinism_source(str(path), source, tree=tree))
    return {(f.rule, f.line) for f in found if f.rule in SHARED_RULES}


def _both(path):
    return (_shared_findings(jax_astlint, jax_lock, jax_det, path),
            _shared_findings(astlint, lockorder, determinism, path))


JAX_PASSES = (jax_astlint, jax_lock, jax_det, jax_retry, jax_findings)
PORT_PASSES = (astlint, lockorder, determinism, retrylint, findings)
# A lock is a call named Lock, RLock or Condition (both packages'
# _LOCK_TYPES); bare-except needs "except:"; unbounded-retry a while loop.
_LOCK_CALL = re.compile(r"\b(R?Lock|Condition)\s*\(")
_BARE_EXCEPT = re.compile(r"\bexcept\s*:")


def _shared_checks(passes, path: str, source: str, tree) -> set:
    """The shared rules' (rule, line) set of one package's passes, running
    only the checks that emit them, and each only where the source holds
    what it needs (above): the trees' walk costs a third of the full
    passes'. The fixture test holds it equal to the full passes."""
    lint, lock, det, retry, fnd = passes
    raw = []
    if _LOCK_CALL.search(source):
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                raw += lint._lint_class_locks(path, node)
                raw += retry._lint_blocking_under_lock(path, node)
        raw += lock._check_lock_order(path, tree)
        raw += lock._check_torn_snapshot(path, tree)
    if _BARE_EXCEPT.search(source):
        raw += [f for f in lint._lint_module_wide(path, tree, set())
                if f.rule == "bare-except"]
    if "while" in source:
        raw += retry._lint_unbounded_retry(path, tree)
    if "graftcheck" in source:
        raw = fnd.apply_suppressions(raw, fnd.parse_suppressions(source))
        raw += fnd.lint_suppressions(path, source)
    raw += det.lint_determinism_source(path, source, tree=tree)
    return {(f.rule, f.line) for f in raw if f.rule in SHARED_RULES}


def _both_checks(path: pathlib.Path):
    source = path.read_text()
    tree = ast.parse(source)        # one parse for both packages' checks
    return (_shared_checks(JAX_PASSES, str(path), source, tree),
            _shared_checks(PORT_PASSES, str(path), source, tree))


@pytest.mark.parametrize("name", ["bad_lockorder.py", "bad_retry.py",
                                  "bad_determinism.py", "bad_astlint.py"])
def test_shared_rules_match_jax_on_its_fixtures(name):
    jax_set, port_set = _both(JAX_FIXTURES / name)
    assert jax_set, f"{name}: no shared-rule finding — vacuous comparison"
    assert port_set == jax_set
    assert _both_checks(JAX_FIXTURES / name) == (jax_set, port_set)


@pytest.mark.parametrize("package", ["k8s_gpu_scheduler_tpu",
                                     "k8s_gpu_scheduler_tpu_torch"])
def test_shared_rules_match_jax_over_both_trees(package):
    files = sorted((ROOT / package).rglob("*.py"))
    assert len(files) > 40
    diffs = {}
    for path in files:
        jax_set, port_set = _both_checks(path)
        if jax_set != port_set:
            diffs[str(path.relative_to(ROOT))] = (jax_set, port_set)
    assert not diffs


def test_wire_schemas_equal_jax_and_the_goldens(capsys):
    live = wirecompat.extract_schemas()
    assert live == jax_wire.extract_schemas()
    assert set(live) == {"serving_snapshot", "replica_summary",
                         "request_journal"}
    report = analysis.run_wirecompat_pass()
    assert not report.findings, report.render()
    goldens = sorted(pathlib.Path(wirecompat.default_schema_dir())
                     .glob("*.json"))
    before = [p.read_bytes() for p in goldens]
    assert cli.main(["--update-schemas"]) == 2
    assert "refusing" in capsys.readouterr().err
    assert [p.read_bytes() for p in goldens] == before


def test_wire_drift_is_caught():
    live = wirecompat.extract_schemas()["replica_summary"]
    golden = wirecompat.load_golden("replica_summary")
    gone = json.loads(json.dumps(live))
    del gone["groups"]["json"]["tp"]
    assert {f.rule for f in wirecompat.diff_schemas(
        "replica_summary", gone, golden)} == {"wire-break",
                                              "wire-golden-stale"}
    new = json.loads(json.dumps(live))
    new["groups"]["json"]["zone"] = {"type": "str", "required": True}
    assert {f.rule for f in wirecompat.diff_schemas(
        "replica_summary", new, golden)} == {"wire-no-default",
                                             "wire-golden-stale"}


# -- the port's seeded fixtures -----------------------------------------------

EXPECTED = {
    "bad_dispatch.py": {("host-sync-in-dispatch", 21),
                        ("host-time-in-dispatch", 25),
                        ("numpy-in-dispatch", 26),
                        ("host-sync-in-dispatch", 28),
                        ("trace-in-dispatch", 29), ("host-sync", 34)},
    "bad_inplace.py": {("read-of-inplace-buffer", 40)},
    "bad_smem.py": {("smem-budget", 0), ("kernel-shape-unsupported", 0)},
    "bad_alias.py": {("shared-page-write", 0)},
    "bad_steady.py": {("storage-not-kept", 0)},
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_cli_fails_on_each_port_fixture(name, capsys):
    """Every pass, the dynamic ones on the CPU: the CLI exits 1 with the
    fixture's rules at their lines, and nothing else."""
    path = str(FIXTURES / name)
    assert cli.main([path, "--device", "cpu", "--json"]) == 1
    out, err = capsys.readouterr()
    doc = json.loads(out.splitlines()[0])
    got = {(f["rule"], f["line"]) for f in doc["findings"]}
    assert EXPECTED[name] <= got, err
    assert set(doc["rules"]) == {r for r, _ in EXPECTED[name]}
    assert all(f["path"] in (path, f"<{f['path'][1:-1]}>")
               for f in doc["findings"])
    assert {"astlint", "smem", "alias", "steady"} <= set(doc["pass_seconds"])


def test_cli_passes_the_tree(capsys):
    assert cli.main(["--fast"]) == 0
    err = capsys.readouterr().err
    assert "clean" in err and "smem" in err


def test_cuda_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        analysis.run_dynamic_passes(device="cuda")


def test_discovery_never_executes_jax_modules(tmp_path):
    hook = tmp_path / "jax_hook.py"
    hook.write_text("import jax\nGRAFTCHECK_TORCH_SMEM_AUDIT = []\n")
    report = analysis.run_fast_passes([str(tmp_path)])
    assert [f.rule for f in report.findings] == ["hook-error"]
    assert "never executes" in report.findings[0].message
    jax_dir = analysis.run_fast_passes([str(JAX_FIXTURES)])
    assert "hook-error" not in {f.rule for f in jax_dir.findings}


def test_bare_suppression_needs_a_rationale():
    src = ("x = 1  # graftcheck: ignore[host-sync]\n"
           "# a sanctioned host read at the wave's end:\n"
           "# graftcheck: ignore[host-sync]\n"
           "y = x.cpu()\n")
    found = astlint.lint_source("m.py", src)
    assert [(f.rule, f.line) for f in found] == [("bare-suppression", 1)]


# -- registries ---------------------------------------------------------------

def _defs(rel):
    tree = ast.parse((ROOT / rel).read_text())
    return [n for n in tree.body if isinstance(n, ast.FunctionDef)]


def test_registry_names_every_dispatch_and_kernel_wrapper():
    reg = eps.DISPATCH_BODIES
    serving = "k8s_gpu_scheduler_tpu_torch/models/serving.py"
    fns = {n.name for n in _defs(serving)
           if n.name.startswith("_") and n.name.endswith("_fn")}
    assert len(fns) == 5 and fns == set(reg[serving])
    wrappers = {}
    for path in sorted((ROOT / "k8s_gpu_scheduler_tpu_torch" / "ops")
                       .glob("*.py")):
        rel = str(path.relative_to(ROOT))
        for n in _defs(rel):
            if any(isinstance(c, ast.Call) and getattr(
                    c.func, "attr", "").endswith("_launch")
                   for c in ast.walk(n)):
                wrappers.setdefault(rel, set()).add(n.name)
    assert sum(map(len, wrappers.values())) == 7
    assert {k: set(v) for k, v in reg.items() if k != serving} == wrappers


def test_inplace_params_follow_the_dispatch_bodies():
    tree = ast.parse((ROOT / "k8s_gpu_scheduler_tpu_torch/models/serving.py")
                     .read_text())
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    written = {name: lockorder.inplace_params(defs[name])
               for name in eps.DISPATCH_BODIES[
                   "k8s_gpu_scheduler_tpu_torch/models/serving.py"]}
    assert written["_decode_chunk_paged_fn"] == {"k", "v", "k_s", "v_s"}
    assert written["_verify_chunk_paged_fn"] == {"k", "v", "k_s", "v_s"}
    # lens/last are cloned before their rows are set: not the caller's.
    assert written["_prefill_multi_paged_fn"] == {"k", "v", "k_s", "v_s"}
    assert written["_decode_chunk_fn"] == {"k", "v", "k_s", "v_s", "bitmap"}
    assert written["_prefill_multi_fn"] == {"k", "v", "k_s", "v_s", "bitmap",
                                            "rope_pos", "last"}


# -- the shared-memory budgeter -----------------------------------------------

def test_presets_fit_the_budget_and_reach_every_kernel():
    assert not smem.audit_smem()
    reached = smem.reached_entries()
    assert {e.kernel for e in reached} == {f"K{i}" for i in range(1, 8)}
    by_label = {e.label: e for e in reached}
    e = by_label["decode_mma_kernel<__nv_bfloat16, 128, PagedRows, 4>"]
    assert e.dynamic_bytes == 2 * 2 * 3 * 64 * 136
    assert by_label["decode_mma_kernel<signed char, 64, ContiguousRows, 4>"
                    ].dynamic_bytes == 4 * 2 * 64 * 72 + 8 * 2 * 64 + 2 * 64
    # K3 at t = 5 over g = 4 stacks 20 rows: two 16-row tiles (KW 2).
    assert "decode_mma_kernel<__nv_bfloat16, 128, PagedRows, 2>" in by_label
    assert max(e.dynamic_bytes for e in reached) < smem.SMEM_BYTES_PER_BLOCK


def test_ptxas_records_resolve_by_template():
    e = next(e for e in smem.reached_entries()
             if e.label == "decode_mma_kernel<signed char, 128, PagedRows, 4>")
    report = [
        {"kernel": "void port_kernels::decode_mma_kernel<__nv_bfloat16, 128, "
                   "port_kernels::PagedRows, 4>(const __nv_bfloat16*)",
         "registers": 90, "smem_bytes": 0},
        {"kernel": "void port_kernels::decode_mma_kernel<signed char, 128, "
                   "port_kernels::PagedRows, 4>(const __nv_bfloat16*)",
         "registers": 128, "smem_bytes": 16, "spill_stores": 4,
         "spill_loads": 8}]
    res = smem.entry_resources(e, report)
    assert (res.registers, res.static_bytes, res.spill_bytes) == (128, 16, 12)
    assert res.blocks_per_sm()["registers"] == 4
    assert smem.check_resources("x", dataclasses.replace(
        res, registers=255), "a") == []
    too_big = smem.Resources(200_000, static_bytes=40_000)
    assert [f.rule for f in smem.check_resources("x", too_big)] == \
        ["smem-budget"]


def test_suppression_catalogue_matches_the_readme():
    readme = (ROOT / "README.md").read_text()
    start = readme.index("<!-- graftcheck-torch-suppressions:start -->")
    end = readme.index("<!-- graftcheck-torch-suppressions:end -->")
    rows = [line for line in readme[start:end].splitlines()
            if line.startswith("| `")]
    assert rows == analysis.suppression_catalogue([analysis.package_root()])


def test_inplace_read_under_the_step_lock_is_ordered():
    """read-of-inplace-buffer: a read under a lock every dispatch call
    site holds cannot overlap a dispatch; the same read under no lock is
    flagged."""
    src = (FIXTURES / "bad_inplace.py").read_text().replace(
        "        self._lens = _decode_fn(self._k, self._v, self._lens, x)\n",
        "        with self._mu:\n"
        "            self._lens = _decode_fn(self._k, self._v, self._lens, "
        "x)\n")
    assert "with self._mu:\n            self._lens" in src
    ordered = src.replace(
        '        return {"steps": steps,\n'
        '                "pool_norm": float(self._k.norm())}',
        '            return {"steps": steps,\n'
        '                    "pool_norm": float(self._k.norm())}')
    rules = [f.rule for f in lockorder.lint_lockorder_source("m.py", src)]
    assert rules == ["read-of-inplace-buffer"]
    assert lockorder.lint_lockorder_source("m.py", ordered) == []
