"""The port's whole control plane over real seams at once (the mirror of
``tests/test_e2e.py``): the C++ kvstored as the registry, the port's gRPC
recommender as a subprocess on its seed matrices (its collector polling
the registry), the fakekube apiserver as a subprocess, and the port's
scheduler over the REST adapter with the TPU and Gang plugins and the
real registry and recommender clients. A gang and an SLO-scored
singleton are scheduled, and the device environment injected into their
ConfigMaps is checked. The node inventories are published by the port's
node agents (``agent.Publisher`` over ``agent.Scraper``, execing the
port's prober on a fake metrics file), as ``tests/test_e2e.py`` runs the
JAX package's."""
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import time

import pytest

from test_torch_sched_rest import start_fakekube, stop

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "k8s_gpu_scheduler_tpu_torch" / "recommender" / "data"


def kvstored():
    """The registry's server binary, built by the port's helper into
    ``build/`` (renamed into place: no race with another test's build or
    ``make``)."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build native/kvstore")
    from k8s_gpu_scheduler_tpu_torch.agent import _build

    return str(_build.build_kvstored())


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_port(port, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.3).close()
            return True
        except OSError:
            time.sleep(0.05)
    return False


def wait(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.05)
    return False


def test_all_real_components_schedule_a_gang(tmp_path):
    from k8s_gpu_scheduler_tpu_torch.api.objects import (
        ConfigMap, ConfigMapRef, Container, EnvVar, ObjectMeta, Pod, PodGroup,
        PodSpec, ResourceRequirements, TPU_RESOURCE,
    )
    from k8s_gpu_scheduler_tpu_torch.cluster.kubeapi import KubeAPIServer
    from k8s_gpu_scheduler_tpu_torch.config import SchedulerConfig
    from k8s_gpu_scheduler_tpu_torch.plugins import GangPlugin, TPUPlugin
    from k8s_gpu_scheduler_tpu_torch.recommender.client import (
        Client as RecomClient,
    )
    from k8s_gpu_scheduler_tpu_torch.agent import Publisher, Scraper
    from k8s_gpu_scheduler_tpu_torch.registry.client import Client
    from k8s_gpu_scheduler_tpu_torch.sched import Profile, Scheduler

    procs = []
    try:
        # 1. the registry
        kv_port = free_port()
        procs.append(subprocess.Popen(
            [kvstored(), "--port", str(kv_port), "--requirepass", "pw"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        assert wait_port(kv_port), "kvstored did not come up"

        # 2. the port's recommender on copies of its seed matrices
        conf, intf = tmp_path / "conf.tsv", tmp_path / "intf.tsv"
        shutil.copy(DATA / "configurations_train.tsv", conf)
        shutil.copy(DATA / "interference_train.tsv", intf)
        rec_port = free_port()
        rec_log = open(tmp_path / "recommender.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "k8s_gpu_scheduler_tpu_torch.recommender.server"], cwd=ROOT,
            env={**os.environ, "PORT": str(rec_port), "JOB_DELAY": "30",
                 "CONFIGURATIONS_DATA_PATH": str(conf),
                 "INTERFERENCE_DATA_PATH": str(intf),
                 "TPU_SCHED_REGISTRY_HOST": "127.0.0.1",
                 "TPU_SCHED_REGISTRY_PORT": str(kv_port),
                 "TPU_SCHED_REGISTRY_PASSWORD": "pw"},
            stdout=rec_log, stderr=subprocess.STDOUT))
        assert wait_port(rec_port, 60), "recommender did not come up"

        # 3. the apiserver
        kube, url = start_fakekube("--nodes", "2", "--slice-size", "2")
        procs.append(kube)

        # 4. real agents: the port's prober -> Publisher -> kvstored
        fake = tmp_path / "chips.json"
        fake.write_text(json.dumps({"chips": [
            {"device_id": i, "duty_cycle": 0.1 * i, "hbm_used": 1,
             "hbm_total": 16} for i in range(8)
        ]}))
        agent_reg = Client("127.0.0.1", kv_port, password="pw")
        for node in ("v5e-0", "v5e-1"):
            assert Publisher(
                agent_reg, scraper=Scraper(fake_file=str(fake)),
                node_name=node, accelerator="tpu-v5-lite-podslice",
                topology="2x4",
            ).publish_once(force=True)
        assert {k for k in agent_reg.get_keys("node/*")} == {
            f"node/v5e-{i}{s}" for i in range(2) for s in ("", "/heartbeat")}

        # 5. the scheduler over REST with the real registry + recommender
        server = KubeAPIServer(base_url=url)
        recom = RecomClient("127.0.0.1", rec_port)
        sched = Scheduler(server, profile=Profile(), config=SchedulerConfig(
            backoff_initial_s=0.05, backoff_max_s=0.5))
        tpu = TPUPlugin(sched.handle, registry=Client(
            "127.0.0.1", kv_port, password="pw"), recommender=recom,
            metrics=sched.metrics)
        gang = GangPlugin(sched.handle)
        sched.profile = Profile(
            pre_filter=[tpu, gang], filter=[tpu, gang], score=[tpu, gang],
            reserve=[tpu, gang], permit=[gang], post_bind=[tpu, gang])
        calls = []
        real = recom.impute_configurations
        recom.impute_configurations = lambda ix: calls.append(ix) or real(ix)

        # 6. a 2-member gang and an SLO singleton
        server.create(PodGroup(metadata=ObjectMeta(name="gang"), min_member=2,
                               topology="", schedule_timeout_s=20.0))
        for i in range(2):
            server.create(ConfigMap(metadata=ObjectMeta(name=f"cm-gang-{i}"),
                                    data={}))
            server.create(Pod(
                metadata=ObjectMeta(name=f"gang-{i}",
                                    labels={"tpu.sched/pod-group": "gang"}),
                spec=PodSpec(containers=[Container(
                    env_from=[ConfigMapRef(f"cm-gang-{i}")],
                    resources=ResourceRequirements(
                        requests={TPU_RESOURCE: 4}))])))
        server.create(ConfigMap(metadata=ObjectMeta(name="cm-solo"), data={}))
        server.create(Pod(
            metadata=ObjectMeta(name="llama3-8b-serve-0"),
            spec=PodSpec(containers=[Container(
                env=[EnvVar("SLO", "5"),
                     EnvVar("WORKLOAD_NAME", "llama3_8b_serve")],
                env_from=[ConfigMapRef("cm-solo")],
                resources=ResourceRequirements(requests={TPU_RESOURCE: 2}))])))

        sched.start()
        try:
            assert wait(lambda: all(
                server.get("Pod", n, "default").spec.node_name
                for n in ("gang-0", "gang-1", "llama3-8b-serve-0")
            )), "pods did not all bind through the real stack"
            nodes = {server.get("Pod", f"gang-{i}", "default").spec.node_name
                     for i in range(2)}
            assert nodes == {"v5e-0", "v5e-1"}
            ids, hostlists = set(), set()
            for i in range(2):
                cm = server.get("ConfigMap", f"cm-gang-{i}", "default")
                assert "TPU_VISIBLE_CHIPS" in cm.data, cm.data
                assert cm.data["TPU_WORKER_COUNT"] == "2"
                ids.add(cm.data["TPU_WORKER_ID"])
                hostlists.add(cm.data["TPU_WORKER_HOSTNAMES"])
            assert ids == {"0", "1"} and len(hostlists) == 1
            assert wait(lambda: "TPU_VISIBLE_CHIPS" in server.get(
                "ConfigMap", "cm-solo", "default").data)
            cm = server.get("ConfigMap", "cm-solo", "default")
            assert cm.data["TPU_ACCELERATOR_TYPE"] == "tpu-v5-lite-podslice"
            # The SLO pod was scored on the real gRPC predictions.
            assert "llama3-8b-serve-0" in calls
            assert sched.metrics.counter("tpu_sched_score_degraded_total"
                                         ).value(client="recommender") == 0
        finally:
            sched.stop()
            recom.close()
        rec_log.flush()
        text = (tmp_path / "recommender.log").read_text()
        assert f"recommender serving on :{rec_port}" in text
        assert "collector polling registry" in text
    finally:
        for p in procs:
            stop(p)
