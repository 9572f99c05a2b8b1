"""The port's node side against the JAX package's, on the same inputs:
the two probers (the JAX package's ``native/tpuprobe/tpuprobe.cpp`` and
the port's ``agent/csrc/tpuprobe.cpp``, each built here with ``g++``) print
the same bytes and exit codes on the fake-file and device-glob sources;
the port's NVML source is held to a stub ``libnvidia-ml`` compiled here;
the scrapers, device-plugin sources, publishers (one injected clock),
metrics loggers, registry CLIs (one kvstored), discovery helpers and the
Score of agent-published utilization give equal results; the proto's
schema lines are JAX's byte for byte. Mirrors ``tests/test_agent.py``."""
import dataclasses
import importlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from test_torch_sched_e2e import free_port, kvstored, wait_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROOTS = {"jax": "k8s_gpu_scheduler_tpu", "torch": "k8s_gpu_scheduler_tpu_torch"}
GIB = 1 << 30


def mod(side, name):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


@pytest.fixture(scope="module")
def probers(tmp_path_factory):
    """{side: prober binary}: the JAX package's built privately (no race
    with ``tests/test_agent.py``'s ``make``), the port's by its own
    build helper."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the probers")
    out = tmp_path_factory.mktemp("jaxprobe") / "tpuprobe"
    subprocess.run(["g++", "-std=c++17", "-O2", "-o", str(out),
                    str(ROOT / "native" / "tpuprobe" / "tpuprobe.cpp")],
                   check=True, capture_output=True, timeout=300)
    from k8s_gpu_scheduler_tpu_torch.agent import _build

    return {"jax": str(out), "torch": str(_build.build())}


STUB = r"""
#include <cstring>
extern "C" {
static int failing(const char* call) {
  return std::strcmp(FAIL_CALL, call) == 0 ? 999 : 0;
}
struct Util { unsigned int gpu, memory; };
struct Mem { unsigned long long total, free, used; };
int nvmlInit_v2() { return failing("nvmlInit_v2"); }
int nvmlShutdown() { return 0; }
int nvmlDeviceGetCount_v2(unsigned int* n) {
  *n = N_DEVICES;
  return failing("nvmlDeviceGetCount_v2");
}
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void** h) {
  *h = reinterpret_cast<void*>(static_cast<unsigned long>(i + 1));
  return failing("nvmlDeviceGetHandleByIndex_v2");
}
int nvmlDeviceGetUtilizationRates(void* h, Util* u) {
  u->gpu = h == reinterpret_cast<void*>(1) ? 37 : 100;
  u->memory = 5;
  return failing("nvmlDeviceGetUtilizationRates");
}
int nvmlDeviceGetMemoryInfo(void* h, Mem* m) {
  m->total = 85899345920ULL;
  m->used = static_cast<unsigned long long>(
      reinterpret_cast<unsigned long>(h)) << 30;
  m->free = m->total - m->used;
  return failing("nvmlDeviceGetMemoryInfo");
}
const char* nvmlErrorString(int rc) {
  return rc == 999 ? "Unknown Error (stub)" : "Success";
}
}
"""
NVML_CALLS = ("nvmlInit_v2", "nvmlDeviceGetCount_v2",
              "nvmlDeviceGetHandleByIndex_v2", "nvmlDeviceGetUtilizationRates",
              "nvmlDeviceGetMemoryInfo")


@pytest.fixture(scope="module")
def nvml_stubs(tmp_path_factory):
    """{failing call, "" or "none": stub libnvidia-ml}: two devices at 37 %
    and 100 %, 80 GiB each, 1 and 2 GiB used; the named call returns 999;
    "none" answers every call and counts no device."""
    d = tmp_path_factory.mktemp("nvml")
    src = d / "stub.cpp"
    src.write_text(STUB)
    stubs = {}
    for call, n in [("", 2), ("none", 0)] + [(c, 2) for c in NVML_CALLS]:
        lib = d / f"libnvml-{call or 'ok'}.so"
        fail = "" if call == "none" else call
        subprocess.run(["g++", "-shared", "-fPIC", f'-DFAIL_CALL="{fail}"',
                        f"-DN_DEVICES={n}", "-o", str(lib), str(src)],
                       check=True, capture_output=True, timeout=300)
        stubs[call] = str(lib)
    return stubs


def write_fake(tmp_path, chips, name="fake.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"chips": chips}))
    return str(path)


def run_probe(binary, args=(), **env):
    clean = {k: v for k, v in os.environ.items()
             if k not in ("TPUPROBE_FAKE", "TPUPROBE_DEV_GLOB",
                          "TPUPROBE_NVML_LIB")}
    return subprocess.run([binary, *args], capture_output=True, timeout=30,
                          env={**clean, **env})


# -- the prober ------------------------------------------------------------------

TWO = [{"device_id": 0, "duty_cycle": 0.75, "hbm_used": 8 * GIB,
        "hbm_total": 16 * GIB},
       {"device_id": 1, "duty_cycle": 0.123456, "hbm_used": 4,
        "hbm_total": 16}]
REORDERED = ('{ "chips" : [\n  { "hbm_total" : 2048 ,\t"duty_cycle":0.5,'
             '\n "device_id" : 3, "hbm_used": 7 },\n{"device_id":9 } ] }\n')


def probe_case(case, tmp_path):
    """(argv, env) of one prober case."""
    if case == "two_chips":
        return ["--once", "--fake", write_fake(tmp_path, TWO)], {}
    if case == "fake_env":
        return ["--once"], {"TPUPROBE_FAKE": write_fake(tmp_path, TWO)}
    if case == "reordered_whitespace":
        (tmp_path / "r.json").write_text(REORDERED)
        return ["--once", "--fake", str(tmp_path / "r.json")], {}
    if case == "malformed":
        (tmp_path / "bad.json").write_text('{"chips": [{"id": 1}')
        return ["--once", "--fake", str(tmp_path / "bad.json")], {}
    if case == "fake_over_glob":
        (tmp_path / "accel0").touch()
        return (["--once", "--fake", write_fake(tmp_path, TWO)],
                {"TPUPROBE_DEV_GLOB": str(tmp_path / "accel*")})
    if case == "glob":
        for i in (0, 1, 2, 3):
            (tmp_path / f"accel{i}").touch()
        return ["--once"], {"TPUPROBE_DEV_GLOB": str(tmp_path / "accel*")}
    if case == "glob_empty":
        return ["--once"], {"TPUPROBE_DEV_GLOB": str(tmp_path / "nope*")}
    assert case == "help"
    return ["--help"], {}


@pytest.mark.parametrize("case", [
    "two_chips", "fake_env", "reordered_whitespace", "malformed",
    "fake_over_glob", "glob", "glob_empty", "help"])
def test_probers_print_the_same_bytes(probers, nvml_stubs, tmp_path, case):
    argv, env = probe_case(case, tmp_path)
    # A working NVML is offered to the port's prober: the fake and glob
    # sources must still come first.
    got = {side: run_probe(b, argv, TPUPROBE_NVML_LIB=nvml_stubs[""], **env)
           for side, b in probers.items()}
    assert got["torch"].stdout == got["jax"].stdout
    assert got["torch"].returncode == got["jax"].returncode
    if case in ("malformed", "glob_empty"):
        assert got["torch"].returncode == 1
        assert got["torch"].stdout == b'{"chips":[]}\n'
    elif case == "glob":
        assert [c["device_id"] for c in json.loads(got["torch"].stdout)[
            "chips"]] == [0, 1, 2, 3]
    elif case != "help":
        assert got["torch"].returncode == 0
        json.loads(got["torch"].stdout)


def test_prober_reads_nvml(probers, nvml_stubs):
    p = run_probe(probers["torch"], ["--once"],
                  TPUPROBE_NVML_LIB=nvml_stubs[""])
    assert p.returncode == 0, p.stderr
    assert p.stdout == (
        b'{"chips":[{"device_id":0,"duty_cycle":0.3700,"hbm_used":1073741824,'
        b'"hbm_total":85899345920},{"device_id":1,"duty_cycle":1.0000,'
        b'"hbm_used":2147483648,"hbm_total":85899345920}]}\n')
    assert p.stderr == b""


def test_prober_fails_when_nvml_counts_no_device(probers, nvml_stubs):
    """No device through NVML is a broken node: exit 1, never the /tmp
    last resort of the fake and glob sources."""
    p = run_probe(probers["torch"], ["--once"],
                  TPUPROBE_NVML_LIB=nvml_stubs["none"])
    assert p.returncode == 1
    assert p.stdout == b'{"chips":[]}\n'
    assert p.stderr == b"tpuprobe: nvmlDeviceGetCount_v2 counted no device\n"


@pytest.mark.parametrize("call", NVML_CALLS)
def test_prober_names_a_failed_nvml_call(probers, nvml_stubs, call):
    p = run_probe(probers["torch"], ["--once"],
                  TPUPROBE_NVML_LIB=nvml_stubs[call])
    assert p.returncode == 1
    assert p.stdout == b'{"chips":[]}\n'
    assert p.stderr.decode() == (
        f"tpuprobe: {call} failed: Unknown Error (stub) (999)\n")


def test_prober_without_nvml_fails(probers, tmp_path):
    missing = str(tmp_path / "libnvidia-ml.so.1")
    p = run_probe(probers["torch"], ["--once"], TPUPROBE_NVML_LIB=missing)
    assert p.returncode == 1
    assert p.stdout == b'{"chips":[]}\n'
    assert f"dlopen {missing} failed" in p.stderr.decode()


# -- the scraper -----------------------------------------------------------------

class TextServer:
    """A metrics endpoint serving fixed Prometheus text."""

    def __init__(self, text):
        body = text.encode()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_port}/metrics"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def gke_text(per_chip):
    lines = ["# HELP duty_cycle TPU duty cycle percent",
             "# TYPE duty_cycle gauge"]
    for idx, (duty, used, total) in per_chip.items():
        lab = f'accelerator_id="4804277629165885214-{idx}",make="cloud-tpu"'
        lines += [f"duty_cycle{{{lab}}} {duty}",
                  f"memory_used{{{lab}}} {used}",
                  f"memory_total{{{lab}}} {total}"]
    return "\n".join(lines)


def chips_of(side, binary, **kw):
    return [dataclasses.asdict(c)
            for c in mod(side, "agent").Scraper(binary=binary, **kw).scrape()]


def test_scrapers_parse_equal_chips(probers, tmp_path):
    fake = write_fake(tmp_path, TWO + [
        {"device_id": 5, "duty_cycle": 1.0, "hbm_used": 0, "hbm_total": 0}])
    got = {s: chips_of(s, b, fake_file=fake) for s, b in probers.items()}
    assert got["torch"] == got["jax"]
    assert [c["device_id"] for c in got["torch"]] == [0, 1, 5]
    assert got["torch"][1]["duty_cycle"] == 0.1235


def test_scrapers_overlay_a_device_plugin_alike(probers, tmp_path):
    fake = write_fake(tmp_path, [
        {"device_id": i, "duty_cycle": 0.0, "hbm_used": 0, "hbm_total": 0}
        for i in range(4)])
    server = TextServer(gke_text({0: (87.5, 12 * GIB, 16 * GIB),
                                  3: (2.0, GIB, 16 * GIB),
                                  7: (50.0, 1, 2)}))
    try:
        got = {s: chips_of(s, b, fake_file=fake, device_plugin=mod(
            s, "agent.deviceplugin").DevicePluginSource(server.url))
            for s, b in probers.items()}
    finally:
        server.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["duty_cycle"] == 0.875
    assert got["torch"][3]["hbm_used_bytes"] == GIB
    assert got["torch"][1]["duty_cycle"] == 0.0


def test_scrapers_overlay_from_the_environment(probers, tmp_path, monkeypatch):
    fake = write_fake(tmp_path, [{"device_id": 0, "duty_cycle": 0.0}])
    server = TextServer(gke_text({0: (40.0, 3, 9)}))
    monkeypatch.setenv("TPU_DEVICE_PLUGIN_URL", server.url)
    try:
        got = {s: chips_of(s, b, fake_file=fake) for s, b in probers.items()}
    finally:
        server.close()
    assert got["torch"] == got["jax"] == [dict(
        device_id=0, coords=[], duty_cycle=0.4, hbm_used_bytes=3,
        hbm_total_bytes=9)]


@pytest.mark.parametrize("fault", ["missing_binary", "nonzero_exit",
                                   "non_json"])
def test_scrapers_raise_alike(probers, tmp_path, fault):
    kw = {}
    bins = dict(probers)
    if fault == "missing_binary":
        bins = {s: str(tmp_path / "nonexistent" / "tpuprobe") for s in bins}
    elif fault == "nonzero_exit":
        (tmp_path / "bad.json").write_text("{}")
        kw["fake_file"] = str(tmp_path / "bad.json")
    else:
        script = tmp_path / "garbage"
        script.write_text("#!/bin/sh\necho 'chips: none'\n")
        script.chmod(0o755)
        bins = {s: str(script) for s in bins}
    errors = {}
    for side, binary in bins.items():
        with pytest.raises(RuntimeError) as e:
            mod(side, "agent").Scraper(binary=binary, **kw).scrape()
        errors[side] = str(e.value)
    assert errors["torch"] == errors["jax"]


def test_scraper_raises_on_nvml_failure(probers, nvml_stubs, monkeypatch):
    monkeypatch.delenv("TPUPROBE_FAKE", raising=False)
    monkeypatch.delenv("TPUPROBE_DEV_GLOB", raising=False)
    monkeypatch.setenv("TPUPROBE_NVML_LIB", nvml_stubs["nvmlInit_v2"])
    scrape = mod("torch", "agent").Scraper(binary=probers["torch"])
    with pytest.raises(RuntimeError, match="nvmlInit_v2 failed"):
        scrape.scrape()
    monkeypatch.setenv("TPUPROBE_NVML_LIB", nvml_stubs[""])
    assert [(c.device_id, c.duty_cycle, c.hbm_used_bytes)
            for c in scrape.scrape()] == [(0, 0.37, GIB), (1, 1.0, 2 * GIB)]


def test_probe_binary_path(probers, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUPROBE_BIN", "/opt/x/tpuprobe")
    assert (mod("torch", "agent").probe_binary_path()
            == mod("jax", "agent").probe_binary_path() == "/opt/x/tpuprobe")
    monkeypatch.delenv("TPUPROBE_BIN")
    path = mod("torch", "agent").probe_binary_path()
    assert path == probers["torch"]
    assert pathlib.Path(path).parent == ROOT / "build" / "agent"
    # The default scraper runs the port's own build.
    fake = write_fake(tmp_path, TWO)
    assert chips_of("torch", None, fake_file=fake) == chips_of(
        "jax", probers["jax"], fake_file=fake)


# -- the device-plugin source ----------------------------------------------------

PROM_TEXTS = {
    "gke": gke_text({0: (87.5, 12 * GIB, 16 * GIB), 3: (2, GIB, 16 * GIB)}),
    "reexported": (
        "# TYPE tpu_duty_cycle_percent gauge\n"
        'tpu_duty_cycle_percent{node="n1",device_id="2"} 42\n'
        'tpu_hbm_memory_usage_bytes{node="n1",device_id="2"} 5\n'
        'tpu_hbm_memory_total_bytes{node="n1",device_id="2"} 9e3\n'
        'tpu_duty_cycle_percent{node="n1",chip="4"} 250\n'),
    "tensorcore_only": (
        'tensorcore_utilization{accelerator_id="x-0"} 66.5\n'
        'tensorcore_utilization{accelerator_id="x-1"} 10\n'
        'duty_cycle{accelerator_id="x-1"} 0\n'
        'tpu_tensorcore_utilization{device_id="2"} 0\n'),
    "malformed": (
        "duty_cycle{accelerator_id=\"a-0\"} not_a_number\n"
        "{no_name=\"1\"} 3\n"
        "duty_cycle{accelerator_id=\"a-1\"} 12 1700000000\n"
        'memory_used{accelerator_id="no-index-x",label="q\\"uoted"} 8\n'
        "   \n# comment\n"
        'duty_cycle{device_id="-1"} 50\n'
        "memory_total 77\n"),
}


@pytest.mark.parametrize("name", sorted(PROM_TEXTS))
def test_device_plugin_sources_parse_alike(name):
    text = PROM_TEXTS[name]
    got = {}
    for side in ROOTS:
        dp = mod(side, "agent.deviceplugin")

        class Src(dp.DevicePluginSource):
            def fetch_text(self):
                return text

        got[side] = (list(dp.parse_prom_text(text)),
                     [dp.device_index(lab) for _, lab, _ in
                      dp.parse_prom_text(text)],
                     {i: dataclasses.asdict(m)
                      for i, m in Src("unused").read().items()})
    assert got["torch"] == got["jax"]
    assert got["torch"][0]
    if name == "tensorcore_only":
        metrics = got["torch"][2]
        assert metrics[0]["duty_cycle"] == 0.665      # the fallback
        assert metrics[1]["duty_cycle"] == 0.0        # duty given: kept
        assert metrics[2]["duty_cycle"] == 0.0


def test_device_plugin_sources_over_http_and_unreachable():
    server = TextServer(PROM_TEXTS["gke"])
    try:
        got = {s: {i: dataclasses.asdict(m) for i, m in mod(
            s, "agent.deviceplugin").DevicePluginSource(server.url).read()
            .items()} for s in ROOTS}
    finally:
        server.close()
    assert got["torch"] == got["jax"] and set(got["torch"]) == {0, 3}
    for side in ROOTS:
        src = mod(side, "agent.deviceplugin").DevicePluginSource(
            f"http://127.0.0.1:{free_port()}/metrics", timeout_s=0.5)
        assert src.read() == {}


# -- the publisher ---------------------------------------------------------------

class MemRegistry:
    def __init__(self):
        self.data = {}

    def set(self, key, value):
        self.data[key] = value

    def get(self, key):
        return self.data.get(key)

    def get_keys(self, pattern="*"):
        return [k for k in self.data if k.startswith(pattern.rstrip("*"))]


class StepClock:
    """One injected clock for both publishers."""

    def __init__(self):
        self.mono, self.now = 1000.0, 1.7e9

    def monotonic(self):
        return self.mono

    def wall(self):
        return self.now


def chips(duty, n=4, used=0):
    return [{"device_id": i, "duty_cycle": duty, "hbm_used": used + i,
             "hbm_total": 16 * GIB} for i in range(n)]


def test_publishers_agree_step_by_step(probers, tmp_path):
    fake = write_fake(tmp_path, chips(0.5))
    clock = StepClock()
    regs, metrics, pubs = {}, {}, {}
    for side, binary in probers.items():
        regs[side] = MemRegistry()
        metrics[side] = mod(side, "metrics.exporter").Registry()
        pubs[side] = mod(side, "agent").Publisher(
            regs[side], scraper=mod(side, "agent").Scraper(
                binary=binary, fake_file=fake),
            node_name="w0", accelerator="tpu-v5-lite-podslice",
            topology="2x4", worker_id=3, heartbeat_s=60,
            metrics_registry=metrics[side], clock=clock)

    def changed():
        write_fake(tmp_path, chips(0.9, used=5))

    def stale():
        clock.mono += 60.0

    def later():
        clock.now += 5.0
        clock.mono += 1.0

    steps = [("first", None, False), ("unchanged", None, False),
             ("changed", changed, False), ("unchanged", None, False),
             ("wall moved", later, False), ("stale", stale, False),
             ("forced", None, True)]
    results = []
    for label, action, force in steps:
        if action:
            action()
        got = {s: p.publish_once(force=force) for s, p in pubs.items()}
        assert got["torch"] == got["jax"], label
        results.append(got["torch"])
        assert regs["torch"].data == regs["jax"].data, label
        assert metrics["torch"].expose() == metrics["jax"].expose(), label
    assert results == [True, False, True, False, False, True, True]
    assert set(regs["torch"].data) == {"node/w0", "node/w0/heartbeat"}
    assert regs["torch"].data["node/w0/heartbeat"] == str(clock.now)
    inv = mod("torch", "registry.inventory").read_inventory(regs["torch"], "w0")
    assert inv.utilization == pytest.approx(0.9) and inv.worker_id == 3


def test_publishers_need_a_node_name(probers, monkeypatch):
    monkeypatch.delenv("NODE_NAME", raising=False)
    for side, binary in probers.items():
        agent = mod(side, "agent")
        with pytest.raises(ValueError, match="node name required"):
            agent.Publisher(MemRegistry(), scraper=agent.Scraper(binary=binary))


def test_publishers_read_the_environment(probers, tmp_path, monkeypatch):
    fake = write_fake(tmp_path, chips(0.25, n=2))
    monkeypatch.setenv("NODE_NAME", "env-node")
    monkeypatch.setenv("TPU_ACCELERATOR_TYPE", "tpu-v5p-slice")
    monkeypatch.setenv("TPU_TOPOLOGY", "2x2x1")
    clock, regs = StepClock(), {}
    for side, binary in probers.items():
        regs[side] = MemRegistry()
        agent = mod(side, "agent")
        assert agent.Publisher(regs[side], scraper=agent.Scraper(
            binary=binary, fake_file=fake), clock=clock).publish_once()
    assert regs["torch"].data == regs["jax"].data
    assert '"topology": "2x2x1"' in regs["torch"].data["node/env-node"]


def test_publisher_loop_publishes(probers, tmp_path):
    reg = MemRegistry()
    agent = mod("torch", "agent")
    pub = agent.Publisher(reg, scraper=agent.Scraper(
        binary=probers["torch"], fake_file=write_fake(tmp_path, chips(0.5))),
        node_name="w0", interval_s=0.05, heartbeat_s=60)
    pub.start()
    try:
        deadline = time.time() + 5
        while time.time() < deadline and "node/w0" not in reg.data:
            time.sleep(0.02)
        assert "node/w0" in reg.data
    finally:
        pub.stop()
    assert pub._thread is None


# -- the metrics logger ----------------------------------------------------------

def test_metrics_loggers_write_the_same_tsv(probers, tmp_path, monkeypatch):
    fake = write_fake(tmp_path, [
        {"device_id": 0, "duty_cycle": 0.5, "hbm_used": 10, "hbm_total": 100},
        {"device_id": 1, "duty_cycle": 0.25, "hbm_used": 20,
         "hbm_total": 100}])
    texts = {}
    for side, binary in probers.items():
        ticks = iter([1700000000.25, 1700000001.5, 1700000002.125])
        monkeypatch.setattr(time, "time", lambda: next(ticks))
        ml = mod(side, "agent.metrics_logger")
        logger = ml.MetricsLogger(ml.Scraper(binary=binary, fake_file=fake),
                                  str(tmp_path / f"{side}.tsv"),
                                  interval_s=0.0)
        logger.run(max_samples=3)
        texts[side] = pathlib.Path(logger.dump()).read_bytes()
        assert ml.COLUMNS == mod("jax", "agent.metrics_logger").COLUMNS
    monkeypatch.undo()
    assert texts["torch"] == texts["jax"]
    lines = texts["torch"].decode().splitlines()
    assert len(lines) == 1 + 3 * 2
    assert lines[1] == "1700000000.250000\t0\t0.500000\t10\t100"


def test_metrics_logger_cli_runs_as_a_module(probers, tmp_path):
    fake = write_fake(tmp_path, [
        {"device_id": 0, "duty_cycle": 0.75, "hbm_used": 1, "hbm_total": 2}])
    outs = {}
    for side, binary in probers.items():
        out = tmp_path / f"{side}.tsv"
        proc = subprocess.run(
            [sys.executable, "-m", f"{ROOTS[side]}.agent.metrics_logger",
             "-o", str(out), "--interval", "0.01", "--samples", "2",
             "--fake", fake], capture_output=True, text=True, timeout=120,
            cwd=ROOT, env={**os.environ, "TPUPROBE_BIN": binary})
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout == f"wrote 2 samples to {out}\n"
        outs[side] = [ln.split("\t")[1:] for ln in
                      out.read_text().strip().split("\n")]
    assert outs["torch"] == outs["jax"] and len(outs["torch"]) == 3


# -- registryctl -----------------------------------------------------------------

@pytest.fixture
def kv(tmp_path):
    port = free_port()
    proc = subprocess.Popen(
        [kvstored(), "--port", str(port), "--requirepass", "pw"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        assert wait_port(port), "kvstored did not come up"
        yield port
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_registry_ctls_agree(kv, capsys):
    endpoint = ["--host", "127.0.0.1", "--port", str(kv), "--password", "pw"]
    steps = [["-f"], ["--set", "node/a", '{"x": 1}'], ["--set", "b", "two"],
             ["--get", "node/a"], ["-l"], ["--get", "missing"],
             ["--set", "c", "3", "--get", "c", "-l"], ["-f", "-l"],
             ["--get", "b"]]
    seen = []
    for argv in steps:
        got = {}
        for side in ROOTS:
            rc = mod(side, "registry.ctl").main(endpoint + argv)
            got[side] = (rc, *capsys.readouterr())
        assert got["torch"] == got["jax"], argv
        seen.append(got["torch"])
    assert seen[3] == (0, '{"x": 1}\n', "")
    assert seen[4] == (0, 'b\ttwo\nnode/a\t{"x": 1}\n', "")
    assert seen[5] == (1, "", "(nil)\n")
    assert seen[8] == (1, "", "(nil)\n")


def test_registry_ctl_runs_as_a_module(kv):
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_gpu_scheduler_tpu_torch.registry.ctl",
         "--set", "k", "v", "--get", "k"], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "TPU_SCHED_REGISTRY_HOST": "127.0.0.1",
             "TPU_SCHED_REGISTRY_PORT": str(kv),
             "TPU_SCHED_REGISTRY_PASSWORD": "pw"})
    assert (proc.returncode, proc.stdout) == (0, "OK\nv\n"), proc.stderr


# -- discovery -------------------------------------------------------------------

def discovery_answers(side):
    o = mod(side, "api.objects")
    disc = mod(side, "utils")
    server = mod(side, "cluster").APIServer()
    for name, addrs in (("n0", ["10.0.0.5", "10.0.0.6"]), ("n1", [])):
        server.create(o.Node(metadata=o.ObjectMeta(name=name),
                             status=o.NodeStatus(addresses=addrs)))
    for name, ns, node in (("redis-0", "redis", "n0"),
                           ("redis-1", "redis", "n1"),
                           ("redis-2", "redis", ""),
                           ("redis-3", "redis", "ghost"),
                           ("tpu-agent-x", "kube-system", "n0"),
                           ("tpu-agent-y", "kube-system", "n1"),
                           ("other", "default", "n1")):
        server.create(o.Pod(metadata=o.ObjectMeta(name=name, namespace=ns),
                            spec=o.PodSpec(node_name=node)))
    desc = mod(side, "cluster.resources").Descriptor(server)

    def name(pod):
        return None if pod is None else pod.metadata.name
    return dict(
        exists=[disc.exists_substring(["tpu-agent-x", "redis-0"], s)
                for s in ("agent", "redis-1", "", "zz")],
        node=[disc.find_node_from_pod(desc, s, ns) for s, ns in (
            ("redis", "redis"), ("redis-2", "redis"), ("redis", "default"),
            ("agent", "kube-system"))],
        ips=[disc.find_nodes_ip_from_pod(desc, s, ns) for s, ns in (
            ("redis", "redis"), ("tpu-agent", "kube-system"),
            ("nope", "redis"))],
        agent=[name(disc.find_agent_pod_on_node(desc, n, *a)) for n, a in (
            ("n0", ()), ("n1", ()), ("n1", ("other",)),
            ("n1", ("tpu-agent", "default")), ("ghost", ()))])


def test_discovery_answers_agree():
    got = {side: discovery_answers(side) for side in ROOTS}
    assert got["torch"] == got["jax"]
    assert got["torch"]["ips"][0] == ["10.0.0.5", "n1"]
    assert got["torch"]["agent"][:2] == ["tpu-agent-x", "tpu-agent-y"]


# -- the score of agent-published utilization ------------------------------------

def agent_scores(side, binary, tmp_path):
    o = mod(side, "api.objects")
    agent = mod(side, "agent")
    reg = MemRegistry()
    for name, duty in [("busy", 0.95), ("idle", 0.05)]:
        fake = write_fake(tmp_path, chips(duty, n=8), name=f"{side}-{name}")
        agent.Publisher(reg, scraper=agent.Scraper(
            binary=binary, fake_file=fake), node_name=name,
            accelerator="tpu-v5-lite-podslice", topology="2x4").publish_once()
    sched_mod = mod(side, "sched")
    sched = sched_mod.Scheduler(mod(side, "cluster").APIServer(),
                                profile=sched_mod.Profile(),
                                config=mod(side, "config").SchedulerConfig())
    plugin = mod(side, "plugins").TPUPlugin(sched.handle, registry=reg)
    for n in ("busy", "idle"):
        sched.cache.add_node(o.Node(
            metadata=o.ObjectMeta(name=n, labels={
                o.LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
                o.LABEL_TPU_TOPOLOGY: "2x4"}),
            status=o.NodeStatus(capacity={o.TPU_RESOURCE: 8},
                                allocatable={o.TPU_RESOURCE: 8},
                                addresses=["10.0.0.1"])))
    state = sched_mod.CycleState()
    pod = o.Pod(metadata=o.ObjectMeta(name="p"), spec=o.PodSpec(containers=[
        o.Container(resources=o.ResourceRequirements(
            requests={o.TPU_RESOURCE: 1}))]))
    plugin.pre_filter(state, pod)
    for n in ("busy", "idle"):
        assert plugin.filter(state, pod, sched.cache.snapshot()[n]).ok
    return {n: plugin.score(state, pod, n)[0] for n in ("busy", "idle")}


def test_score_consumes_agent_utilization_alike(probers, tmp_path):
    got = {s: agent_scores(s, b, tmp_path) for s, b in probers.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"]["idle"] > got["torch"]["busy"]
    assert got["torch"]["idle"] == pytest.approx(95.0)


# -- the schema ------------------------------------------------------------------

def test_proto_is_the_same_schema():
    """Byte for byte but the header comment, whose citation of the
    reference service names its repository instead of a checkout path."""
    rel = pathlib.Path("recommender") / "protos" / "recom.proto"
    port = ROOT / ROOTS["torch"] / rel

    def schema(path):
        return [ln for ln in path.read_bytes().splitlines(keepends=True)
                if not ln.startswith(b"//")]
    assert schema(port) == schema(ROOT / ROOTS["jax"] / rel)
    assert len(schema(port)) > 10
    assert (port.parent.parent / "wire.py").exists()
