"""The benchmark is driven by files: a cell, a mix and a metric that a
later change adds are found by name alone. And nothing the benchmark runs
imports JAX or the JAX package (top-level names compared whole), reads
the JAX package's benchmark records, or, in the reference, imports the
port."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import cell as cells

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "k8s_gpu_scheduler_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for f in HERE.rglob("*.py"):
        bad = set(_imports(f)) & FORBIDDEN
        assert not bad, (f, bad)


def test_reference_imports_nothing_of_the_port():
    for f in (HERE / "reference").rglob("*.py"):
        mods = set(_imports(f))
        assert "k8s_gpu_scheduler_tpu_torch" not in mods, f
        assert not {"portbench"} & mods or f.name == "__init__.py", f


def test_no_source_reads_the_jax_records():
    for f in HERE.rglob("*.py"):
        if f.parent.name == "tests":
            continue
        text = f.read_text()
        for word in ("bench.py", "BENCH_r", "MULTICHIP_r"):
            assert word not in text, (f, word)


def test_a_run_loads_no_jax_module():
    code = ("import json, portbench.run, portbench.control\n"
            "from portbench import cell as c\n"
            "import k8s_gpu_scheduler_tpu_torch.models.llama\n"
            "b = json.load(open('BENCHMARK.json'))\n"
            "[c.reader(m['name']) for m in b['per_layer'] + b['end_to_end']]\n"
            "for w in b['workloads']:\n"
            "    c.loop(c.load(w['name']).mix['kind'])\n"
            "print(portbench.run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = cells.load(w["name"], ROOT)
        assert c.end_to_end and c.per_layer
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        for m in c.end_to_end + c.per_layer:
            assert callable(cells.reader(m["name"]))


def test_new_cell_mix_and_metric_found_from_files_alone(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (base / "traffic" / "train-short.json").write_text(json.dumps(
        {"kind": "train", "batch": 2, "seq": 512}))
    (base / "workloads" / "mistral-7b.train-short.json").write_text(
        json.dumps({"limits": {"grad_gap": 1e-2}}))
    (base / "metrics" / "steps.train-short.py").write_text(
        "def read(ctx):\n    return float(len(ctx.steps))\n")
    bench["workloads"].append({"name": "mistral-7b.train-short",
                               "config": "mistral-7b-16l",
                               "traffic": "train-short", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps.train-short", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step",
                               "moves": "train_tok_s",
                               "workloads": ["mistral-7b.train-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cells.load("mistral-7b.train-short", tmp_path, base)
    assert c.mix["seq"] == 512 and c.workload["limits"]["grad_gap"] == 1e-2
    assert c.config["hidden_size"] == 4096
    assert [m["name"] for m in c.per_layer] == ["steps.train-short"]
    assert [m["name"] for m in c.end_to_end] == ["setup_s"]
    assert cells.reader("steps.train-short", base)(type("C", (), {
        "steps": [1, 2]})) == 2.0


def test_new_kind_of_traffic_found_from_its_loop_file(tmp_path,
                                                      monkeypatch):
    from portbench import loops

    (tmp_path / "echo.py").write_text(
        "from ..check import verdict\n"
        "def run(cell, seed, seconds, trace, device):\n"
        "    return verdict({'x': 0.0}, {'x': 1.0})\n")
    monkeypatch.setattr(loops, "__path__",
                        list(loops.__path__) + [str(tmp_path)])
    try:
        mod = cells.loop("echo")
        assert mod.run(None, 1, 1.0, False, None) == {
            "x": {"value": 0.0, "limit": 1.0}}
    finally:
        sys.modules.pop("portbench.loops.echo", None)
