"""The port's scheduler entry point against the JAX package's:
``python -m <package>.cmd.scheduler --demo 8 --once --metrics-port 0``
exits 0 with the same ``scheduled <pod> -> <node>`` lines (each in a
subprocess, since ``main`` sets the interpreter's switch interval and
signal handlers); the options that need the REST adapter or the leader
elector raise ``NotImplementedError`` naming slice B; and
``build_scheduler`` wires the JAX package's profile."""
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
    # The degraded paths are named, the unported clients as unported.
    assert "recommender unavailable" in terr
    assert "not ported yet" in terr and "slice B" in terr


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


@pytest.mark.parametrize("argv", [
    ["--in-cluster"], ["--apiserver", "http://127.0.0.1:1"],
    ["--demo", "2", "--leader-elect"], ["--in-cluster", "--leader-elect"]],
    ids=["in-cluster", "apiserver", "leader-elect", "both"])
def test_unported_options_refuse_naming_slice_b(argv, process_state):
    with pytest.raises(NotImplementedError, match="slice B"):
        tcmd.main(argv)


def test_leader_elect_refused_by_build_scheduler():
    server = tcmd.demo_cluster(1)
    with pytest.raises(NotImplementedError, match="slice B"):
        tcmd.build_scheduler(server, SchedulerConfig(), leader_elect=True)


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
                tpu.registry, tpu.recommender, tpu.prom,
                sched._reshaper.auto_confirm_delay_s,
                sched._reshaper.simulate_without_registry,
                [type(p).__name__ for p in
                 prof.post_filter[0].filter_plugins]))
        finally:
            sched.stop()
            sched._reshaper.stop()
    # JAX builds a Prometheus client object without contacting it; the
    # port has none yet.
    jshape, tshape = shapes
    assert jshape[:3] == tshape[:3] and jshape[4:] == tshape[4:]
    assert tshape[3] is None
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
