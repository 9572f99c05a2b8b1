"""The port's scheduler entry point against the JAX package's:
``python -m <package>.cmd.scheduler --demo 8 --once --metrics-port 0``
exits 0 with the same ``scheduled <pod> -> <node>`` lines (each in a
subprocess, since ``main`` sets the interpreter's switch interval and
signal handlers); ``--in-cluster`` (a TLS fakekube behind a patched
service account), ``--apiserver URL`` and ``--leader-elect`` each
schedule, alone and together; and ``build_scheduler`` wires the JAX
package's profile, sidecar clients and elector."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

from k8s_gpu_scheduler_tpu_torch.cmd import scheduler as tcmd
from k8s_gpu_scheduler_tpu_torch.config import SchedulerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCHEDULED = re.compile(r"scheduled (\S+) -> (\S+)$")


def demo_lines(package):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               # No registry answers here: fail its probe fast.
               TPU_SCHED_REGISTRY_PORT="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"{package}.cmd.scheduler", "--demo", "8",
         "--once", "--metrics-port", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    lines = [m.group(0) for m in map(SCHEDULED.search,
                                     proc.stderr.splitlines()) if m]
    return proc.returncode, lines, proc.stderr


def test_demo_once_lines_equal_jax():
    jcode, jlines, jerr = demo_lines("k8s_gpu_scheduler_tpu")
    tcode, tlines, terr = demo_lines("k8s_gpu_scheduler_tpu_torch")
    assert jcode == tcode == 0, (jerr, terr)
    assert tlines == jlines
    assert tlines == [f"scheduled demo-{i} -> v5e-0" for i in range(8)]
    # The degraded paths are named as JAX names them.
    for line in ("registry unavailable", "recommender unavailable",
                 "utilization scoring"):
        assert line in jerr and line in terr
    assert "not ported" not in terr


@pytest.fixture
def process_state():
    """``main`` changes the switch interval and may install signal
    handlers: put both back."""
    import signal

    interval = sys.getswitchinterval()
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    yield
    sys.setswitchinterval(interval)
    for s, h in handlers.items():
        signal.signal(s, h)


@pytest.fixture
def sidecars_down(monkeypatch):
    """No registry, recommender or Prometheus answers: fail fast."""
    monkeypatch.setenv("TPU_SCHED_REGISTRY_PORT", "1")
    monkeypatch.setenv("TPU_SCHED_RECOMMENDER_PORT", "1")
    monkeypatch.setenv("TPU_SCHED_METRICS_URL", "http://127.0.0.1:1")


def submit_pods(api, n):
    from k8s_gpu_scheduler_tpu_torch.api import objects as o

    for i in range(n):
        api.create(o.ConfigMap(metadata=o.ObjectMeta(name=f"cm-{i}")))
        api.create(o.Pod(metadata=o.ObjectMeta(name=f"pod-{i}"),
                         spec=o.PodSpec(containers=[o.Container(
                             env_from=[o.ConfigMapRef(f"cm-{i}")],
                             resources=o.ResourceRequirements(
                                 requests={o.TPU_RESOURCE: 2}))])))


@pytest.mark.parametrize("argv", [
    ["--in-cluster"], ["--apiserver", "URL"],
    ["--demo", "2", "--leader-elect"], ["--in-cluster", "--leader-elect"]],
    ids=["in-cluster", "apiserver", "leader-elect", "both"])
def test_options_run(argv, process_state, sidecars_down, tmp_path,
                     monkeypatch, caplog):
    """Each option schedules every pod with ``--once`` and exits 0; with
    ``--leader-elect`` the run took the Lease and released it."""
    import logging

    from test_torch_sched_rest import service_account, tls_fake
    from tests.fakekube import FakeKube

    from k8s_gpu_scheduler_tpu_torch.cluster.kubeapi import KubeAPIServer

    caplog.set_level(logging.INFO, logger="tpu-scheduler")
    fake, demo = None, []
    if "--in-cluster" in argv:
        fake, port, cert = tls_fake(tmp_path)
        service_account(tmp_path, monkeypatch, "torch", port, cert)
        api = KubeAPIServer()
    elif "--apiserver" in argv:
        fake = FakeKube()
        argv = ["--apiserver", fake.url]
        api = KubeAPIServer(base_url=fake.url)
    else:
        real = tcmd.demo_cluster
        monkeypatch.setattr(tcmd, "demo_cluster",
                            lambda n: demo.append(real(n)) or demo[-1])
    try:
        if fake is not None:
            for i in range(2):
                fake.add_node(f"v5e-{i}")
            submit_pods(api, 3)
        assert tcmd.main(argv + ["--once", "--metrics-port", "0"]) == 0
        lines = [r.getMessage() for r in caplog.records
                 if r.getMessage().startswith("scheduled ")]
        server = api if fake is not None else demo[0]
        pods = server.list("Pod")
        assert len(lines) == len(pods) >= 2
        assert all(p.spec.node_name for p in pods)
        if "--leader-elect" in argv:
            lease = server.get("Lease", "tpu-scheduler", "default")
            # Released at stop: a standby need not wait out the duration.
            assert lease.holder_identity == ""
            assert lease.lease_duration_s == 15.0
        if fake is not None:
            assert len(fake.binding_posts) == 3
            assert all("TPU_VISIBLE_CHIPS" in c.data
                       for c in server.list("ConfigMap"))
    finally:
        if fake is not None:
            fake.close()


def test_leader_elect_by_build_scheduler(sidecars_down):
    """``build_scheduler(leader_elect=True)`` builds JAX's elector (the
    host and process as identity, the scheduler's name as the Lease),
    which leads, schedules and releases."""
    import socket
    import time

    from k8s_gpu_scheduler_tpu.cmd import scheduler as jcmd
    from k8s_gpu_scheduler_tpu.config import SchedulerConfig as JConfig

    from k8s_gpu_scheduler_tpu_torch.sched import LeaderElector

    electors = []
    for cmd, cfg in ((jcmd, JConfig(backoff_initial_s=0.02)),
                     (tcmd, SchedulerConfig(backoff_initial_s=0.02))):
        sched = cmd.build_scheduler(cmd.demo_cluster(0), cfg,
                                    leader_elect=True)
        el = sched.elector
        electors.append((type(el).__name__, el.identity, el.name,
                         el.namespace, el.lease_duration_s, el.renew_period_s,
                         el.retry_period_s, el.renew_deadline_s))
        sched._reshaper.stop()
    assert electors[0] == electors[1]
    assert electors[1][1] == f"{socket.gethostname()}_{os.getpid()}"
    server = tcmd.demo_cluster(2)
    sched = tcmd.build_scheduler(server, SchedulerConfig(
        backoff_initial_s=0.02), leader_elect=True,
        allow_simulated_reshape=True)
    assert isinstance(sched.elector, LeaderElector)
    sched.start()
    try:
        assert sched.elector.wait_until_leader(5)
        deadline = time.monotonic() + 10
        while not all(p.spec.node_name for p in server.list("Pod")):
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        sched.stop()
        sched._reshaper.stop()
    assert server.get("Lease", "tpu-scheduler").holder_identity == ""


def test_no_mode_is_a_usage_error(process_state, capsys):
    with pytest.raises(SystemExit) as e:
        tcmd.main([])
    assert e.value.code == 2
    assert "pick a mode" in capsys.readouterr().err


def test_build_scheduler_profile_matches_jax(monkeypatch):
    """The same plugins at the same extension points, in the same order,
    and the same degraded clients (the registry probe fails here)."""
    from k8s_gpu_scheduler_tpu.cmd import scheduler as jcmd
    from k8s_gpu_scheduler_tpu.config import SchedulerConfig as JConfig

    monkeypatch.setenv("TPU_SCHED_REGISTRY_PORT", "1")
    monkeypatch.setenv("TPU_SCHED_RECOMMENDER_PORT", "1")
    shapes = []
    for cmd, cfg in ((jcmd, JConfig.from_env()),
                     (tcmd, SchedulerConfig.from_env())):
        cfg.recommender.timeout_s = 0.2
        sched = cmd.build_scheduler(cmd.demo_cluster(2), cfg,
                                    allow_simulated_reshape=True)
        try:
            prof = sched.profile
            tpu = prof.score[0]
            shapes.append((
                {point: [type(p).__name__ for p in getattr(prof, point)]
                 for point in ("pre_filter", "filter", "post_filter", "score",
                               "reserve", "permit", "post_bind")},
                tpu.registry, tpu.recommender,
                (type(tpu.prom).__name__, tpu.prom.base_url,
                 tpu.prom.timeout_s), sched.elector,
                sched._reshaper.auto_confirm_delay_s,
                sched._reshaper.simulate_without_registry,
                [type(p).__name__ for p in
                 prof.post_filter[0].filter_plugins]))
        finally:
            sched.stop()
            sched._reshaper.stop()
    # Both build a Prometheus client without contacting it; the
    # recommender's startup probe fails, so both score without it.
    jshape, tshape = shapes
    assert jshape == tshape
    assert tshape[2] is None and tshape[3][0] == "PromClient"
    assert tshape[0]["pre_filter"] == ["TPUPlugin", "GangPlugin"]


def test_config_from_env_equal(monkeypatch):
    from k8s_gpu_scheduler_tpu.config import SchedulerConfig as JConfig

    env = {"TPU_SCHED_NAME": "s2", "TPU_SCHED_PERMIT_TIMEOUT": "7.5",
           "TPU_SCHED_BACKOFF_INITIAL": "0.25", "TPU_SCHED_BACKOFF_MAX": "3",
           "TPU_SCHED_SCORE_WEIGHT": "10100", "TPU_SCHED_PARALLELISM": "4",
           "TPU_SCHED_PCT_NODES_TO_SCORE": "10",
           "TPU_SCHED_REGISTRY_HOST": "kv", "TPU_SCHED_REGISTRY_PORT": "9",
           "TPU_SCHED_REGISTRY_PASSWORD": "pw",
           "TPU_SCHED_METRICS_URL": "http://prom:9090",
           "TPU_SCHED_RECOMMENDER_HOST": "rec",
           "TPU_SCHED_RECOMMENDER_PORT": "33"}
    assert repr(JConfig.from_env()) == repr(SchedulerConfig.from_env())
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = JConfig.from_env(), SchedulerConfig.from_env()
    assert repr(j) == repr(t)
    assert t.percentage_of_nodes_to_score == 10 and t.registry.port == 9
