"""The port stands alone: it imports with JAX blocked and references no
module of the JAX package (its own name, k8s_gpu_scheduler_tpu_torch,
shares the prefix, so the scan matches the JAX package's name only when
followed by a dot or a word boundary)."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "k8s_gpu_scheduler_tpu_torch"
# chip_smoke.py and the card tests run where JAX is not installed; the
# rank workers are re-imported by every spawned rank; the port's graftcheck
# executes its seeded fixtures there.
SOURCES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
    ROOT / "tests" / "torch_tp_workers.py",
    ROOT / "tests" / "torch_train_workers.py",
    ROOT / "tests" / "torch_gang_workers.py",
    ROOT / "tests" / "torch_gang_int8_workers.py"] + sorted(
    (ROOT / "tests" / "data" / "graftcheck_torch").glob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "")
    for p in PORT.rglob("*.py"))

# The modules of the entry-point and fleet slice: copies of framework-free
# JAX modules, which must still import nothing of the JAX package.
FLEET_SLICE = ["k8s_gpu_scheduler_tpu_torch." + m for m in (
    "config", "fleet", "fleet.health", "fleet.journal", "fleet.pools",
    "fleet.router", "fleet.summary", "recommender", "recommender.collector",
    "registry", "registry.client", "registry.inventory", "utils",
    "utils.checkpoint", "utils.enforcement", "utils.retry")]

# The modules of the scheduler's control-plane slice: copies of the JAX
# package's framework-free api/cluster/sched/plugins/cmd modules, which
# must still import nothing of it.
SCHED_SLICE = ["k8s_gpu_scheduler_tpu_torch." + m for m in (
    "api", "api.objects", "api.topology", "cluster", "cluster.apiserver",
    "cluster.informers", "cluster.resources", "sched", "sched.cache",
    "sched.framework", "sched.queue", "sched.reshaper", "sched.scheduler",
    "plugins", "plugins.gang", "plugins.preemption", "plugins.tpu", "cmd",
    "cmd.scheduler", "config", "registry.inventory")]

# The modules of the SLO-scored, in-cluster scheduler: the REST adapter,
# the leader elector, the recommender's codec, imputer, server and client,
# and the Prometheus client — copies of the JAX package's, which must
# still import nothing of it.
INCLUSTER_SLICE = ["k8s_gpu_scheduler_tpu_torch." + m for m in (
    "cluster.kubeapi", "sched.leaderelection", "recommender.wire",
    "recommender.model", "recommender.server", "recommender.client",
    "recommender.collector", "metrics", "metrics.client")]

# The modules of the node side: the agent (scraper, device-plugin source,
# publisher, metrics logger and the prober's build helper), the registry
# CLI and pod discovery — copies of the JAX package's, which must still
# import nothing of it.
AGENT_SLICE = ["k8s_gpu_scheduler_tpu_torch." + m for m in (
    "agent", "agent.scrape", "agent.deviceplugin", "agent.publisher",
    "agent.metrics_logger", "agent._build", "registry.ctl",
    "utils.discovery")]

JAX_PKG = re.compile(
    r"^\s*(from|import)\s+k8s_gpu_scheduler_tpu(\.|\b)"
    r"|import_module\(\s*['\"]k8s_gpu_scheduler_tpu(\.|\b)", re.M)
JAX = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)


def test_every_module_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "import importlib\n"
            f"for name in {MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "leaked = sorted(m for m in sys.modules\n"
            "                if m.startswith('k8s_gpu_scheduler_tpu')\n"
            "                and not m.startswith('k8s_gpu_scheduler_tpu_torch'))\n"
            "assert not leaked, leaked\n"
            "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "k8s_gpu_scheduler_tpu_torch.models.proposers" in MODULES
    assert "k8s_gpu_scheduler_tpu_torch.ops.flash_attention" in MODULES
    assert "k8s_gpu_scheduler_tpu_torch.parallel.collectives" in MODULES
    assert "k8s_gpu_scheduler_tpu_torch.models.pipeline" in MODULES
    assert {"k8s_gpu_scheduler_tpu_torch.analysis." + m for m in (
        "findings", "retrylint", "astlint", "tracelint", "lockorder",
        "determinism", "smem", "wirecompat", "alias", "steady",
        "entrypoints", "__main__")} <= set(MODULES)
    assert set(FLEET_SLICE) <= set(MODULES)
    assert set(SCHED_SLICE) <= set(MODULES)
    assert set(INCLUSTER_SLICE) <= set(MODULES)
    assert set(AGENT_SLICE) <= set(MODULES)
    assert len(MODULES) >= 14 + len(FLEET_SLICE) + len(SCHED_SLICE) - 2


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_reference_no_jax(path):
    text = path.read_text()
    assert not JAX_PKG.search(text), "imports the JAX package"
    assert not JAX.search(text), "imports jax"


# The port builds and execs its own node prober (agent/csrc/tpuprobe.cpp),
# never the JAX package's.
PROBER_SOURCES = sorted(p for p in PORT.rglob("*") if p.is_file() and
                        p.suffix in (".py", ".cpp", ".cu", ".cuh", ".h")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"]
JAX_PROBER = re.compile(r"native[/\\]tpuprobe")


@pytest.mark.parametrize("path", PROBER_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_jax_prober(path):
    assert not JAX_PROBER.search(path.read_text()), \
        "names the JAX package's prober"


def test_prober_scan_has_teeth():
    assert PORT / "agent" / "csrc" / "tpuprobe.cpp" in PROBER_SOURCES
    assert JAX_PROBER.search('os.path.join("native/tpuprobe", "tpuprobe")')
    assert not JAX_PROBER.search("agent/csrc/tpuprobe.cpp")


def test_scan_has_teeth():
    assert JAX_PKG.search("from k8s_gpu_scheduler_tpu.ops import quant")
    assert JAX_PKG.search("import k8s_gpu_scheduler_tpu")
    assert not JAX_PKG.search("from k8s_gpu_scheduler_tpu_torch import ops")
    assert JAX.search("import jax.numpy as jnp")
    assert not JAX.search("import jaxtyping")


# The kernels build with nvcc into a plain C library (route (b) of the
# build): a PyTorch header would make each compile take minutes.
KERNEL_SOURCES = sorted((PORT / "ops" / "csrc").glob("*.cu*"))
TORCH_HEADER = re.compile(r'^\s*#\s*include\s*[<"](torch|ATen|c10)/', re.M)


@pytest.mark.parametrize("path", KERNEL_SOURCES,
                         ids=lambda p: p.name)
def test_kernel_sources_include_no_pytorch_header(path):
    assert not TORCH_HEADER.search(path.read_text())


def test_kernel_header_scan_has_teeth():
    assert len(KERNEL_SOURCES) >= 11
    assert TORCH_HEADER.search("#include <torch/extension.h>")
    assert TORCH_HEADER.search('#include "ATen/cuda/CUDAContext.h"')
    assert not TORCH_HEADER.search("#include <cuda_bf16.h>")
