"""tpu-scheduler entry point of the port (copy of the JAX package's
``cmd/scheduler.py``): it wires every layer of the control plane,

  config (env) → registry client → recommender client → metrics client →
  reshaper → TPU + Gang + Preemption plugins → Profile → Scheduler →
  metrics exporter

Every sidecar is optional with graceful degradation: no registry →
metrics-fallback scoring, no recommender → utilization scoring, no
Prometheus → neutral scores.

``--demo N`` boots the in-memory API server with a demo topology (one v5e
host, one 4-host v5p slice) and N single-chip pods. ``--in-cluster``
schedules against the kube-apiserver named by the pod's service account,
``--apiserver URL`` against an explicit one (``cluster/kubeapi.py``), and
``--leader-elect`` takes a coordination Lease before scheduling
(``sched/leaderelection.py``), so two replicas fail over.
"""
from __future__ import annotations

import argparse
import logging
import signal
import threading

from ..config import SchedulerConfig
from ..metrics.exporter import MetricsServer, Registry
from ..plugins import GangPlugin, PreemptionPlugin, TPUPlugin
from ..sched import Profile, Scheduler, SliceReshaper

log = logging.getLogger("tpu-scheduler")


def build_scheduler(server, config: SchedulerConfig,
                    metrics: Registry | None = None,
                    leader_elect: bool = False,
                    allow_simulated_reshape: bool = False) -> Scheduler:
    """Wire plugins + sidecar clients into a ready-to-start Scheduler."""
    elector = None
    if leader_elect:
        import os
        import socket

        from ..sched import LeaderElector

        elector = LeaderElector(
            server,
            identity=f"{socket.gethostname()}_{os.getpid()}",
            name=config.scheduler_name,
        )
    sched = Scheduler(server, profile=Profile(), config=config,
                      metrics=metrics, elector=elector)

    # Bounded-retry visibility: both control-plane clients count each
    # backoff retry here (utils/retry.py on_retry hook), labeled per
    # client — the flap-rate signal that distinguishes "the registry is
    # restarting" from "scoring went degraded" on one dashboard.
    rpc_retries = sched.metrics.counter(
        "tpu_sched_rpc_retries_total",
        "Bounded control-plane RPC retries, by client")

    registry = None
    try:
        from ..registry.client import Client as RegistryClient

        registry = RegistryClient(
            config.registry.host, config.registry.port,
            password=config.registry.password,
            on_retry=lambda: rpc_retries.inc(client="registry"),
        )
        registry.ping()
        log.info("registry connected at %s:%d",
                 config.registry.host, config.registry.port)
    except Exception as e:  # noqa: BLE001
        registry = None
        log.warning("registry unavailable (%s) — metrics-fallback scoring", e)

    recommender = None
    try:
        from ..recommender.client import Client as RecommenderClient

        recommender = RecommenderClient(
            config.recommender.host, config.recommender.port,
            timeout_s=config.recommender.timeout_s,
            on_retry=lambda: rpc_retries.inc(client="recommender"),
        )
        recommender.impute_configurations("startup-probe")
        log.info("recommender connected at %s:%d",
                 config.recommender.host, config.recommender.port)
    except Exception as e:  # noqa: BLE001
        recommender = None
        log.warning("recommender unavailable (%s) — utilization scoring", e)

    prom = None
    try:
        from ..metrics.client import PromClient

        prom = PromClient(config.metrics.url,
                          timeout_s=config.metrics.query_timeout_s)
    except Exception as e:  # noqa: BLE001
        log.warning("metrics endpoint unavailable (%s)", e)

    # Without a registry, reshape confirmation can only be SIMULATED.
    # Demo mode opts in (taking ~2 s so the applying→idle window shows);
    # in-cluster the reshaper refuses instead — a timer must never stand
    # in for a hardware observation.
    reshaper = SliceReshaper(sched.descriptor, registry=registry,
                             auto_confirm_delay_s=0.0 if registry else 2.0,
                             simulate_without_registry=allow_simulated_reshape)
    tpu = TPUPlugin(sched.handle, registry=registry, prom=prom,
                    recommender=recommender, reshaper=reshaper,
                    metrics=sched.metrics)
    gang = GangPlugin(sched.handle)
    preempt = PreemptionPlugin(sched.handle, filter_plugins=[tpu, gang], tpu=tpu)
    sched.profile = Profile(
        pre_filter=[tpu, gang],
        filter=[tpu, gang],
        post_filter=[preempt],
        score=[tpu, gang],
        reserve=[tpu, gang],
        permit=[gang],
        post_bind=[tpu, gang],
    )
    sched._reshaper = reshaper  # stopped alongside the scheduler
    return sched


def demo_cluster(n_pods: int):
    """In-memory cluster: one v5e-8 host + a 4-host v5p-16 slice + pods."""
    from ..api.objects import (
        ConfigMap, ConfigMapRef, Container, LABEL_SLICE_GROUP,
        LABEL_TPU_ACCELERATOR, LABEL_TPU_TOPOLOGY, LABEL_WORKER_INDEX, Node,
        NodeStatus, ObjectMeta, Pod, PodSpec, ResourceRequirements,
        TPU_RESOURCE,
    )
    from ..cluster import APIServer

    server = APIServer()
    server.create(Node(
        metadata=ObjectMeta(name="v5e-0", labels={
            LABEL_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
            LABEL_TPU_TOPOLOGY: "2x4"}),
        status=NodeStatus(capacity={TPU_RESOURCE: 8},
                          allocatable={TPU_RESOURCE: 8}),
    ))
    for i in range(4):
        server.create(Node(
            metadata=ObjectMeta(name=f"v5p-w{i}", labels={
                LABEL_TPU_ACCELERATOR: "tpu-v5p-slice",
                LABEL_TPU_TOPOLOGY: "2x2x4",
                LABEL_SLICE_GROUP: "v5p-pool", LABEL_WORKER_INDEX: str(i)}),
            status=NodeStatus(capacity={TPU_RESOURCE: 4},
                              allocatable={TPU_RESOURCE: 4}),
        ))
    for i in range(n_pods):
        server.create(ConfigMap(metadata=ObjectMeta(name=f"demo-cm-{i}")))
        server.create(Pod(
            metadata=ObjectMeta(name=f"demo-{i}"),
            spec=PodSpec(containers=[Container(
                env_from=[ConfigMapRef(f"demo-cm-{i}")],
                resources=ResourceRequirements(requests={TPU_RESOURCE: 1}),
            )]),
        ))
    return server


def main(argv=None) -> int:
    # Process-level latency tuning (entrypoint, not library: it's an
    # interpreter-wide knob): the default 5 ms GIL switch interval lets one
    # thread hold the interpreter while a 1 ms bind waits — a direct
    # tail-latency tax under churn. kube-scheduler's goroutines preempt
    # far finer.
    import sys as _sys

    _sys.setswitchinterval(0.001)
    parser = argparse.ArgumentParser(
        prog="python -m k8s_gpu_scheduler_tpu_torch.cmd.scheduler")
    parser.add_argument("--demo", type=int, metavar="N", default=None,
                        help="boot an in-memory demo cluster with N pods")
    parser.add_argument("--in-cluster", action="store_true",
                        help="schedule against the real kube-apiserver "
                             "(service-account auth)")
    parser.add_argument("--apiserver", default=None, metavar="URL",
                        help="explicit apiserver base URL (implies "
                             "--in-cluster; for dev/kind clusters)")
    parser.add_argument("--metrics-port", type=int, default=10251,
                        help="Prometheus exporter port (0 = disabled)")
    parser.add_argument("--leader-elect", action="store_true",
                        help="acquire a coordination Lease before scheduling "
                             "(run replicas: 2 for HA)")
    parser.add_argument("--once", action="store_true",
                        help="exit after the demo pods are all scheduled")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )

    if args.demo is None and not (args.in_cluster or args.apiserver):
        parser.error("pick a mode: --demo N (in-memory) or --in-cluster/"
                     "--apiserver URL (real kube-apiserver)")

    if args.demo is not None:
        server = demo_cluster(args.demo)
    else:
        from ..cluster.kubeapi import KubeAPIServer

        server = KubeAPIServer(base_url=args.apiserver)
        log.info("connected to kube-apiserver at %s", server.base_url)
    config = SchedulerConfig.from_env()
    sched = build_scheduler(server, config, leader_elect=args.leader_elect,
                            allow_simulated_reshape=args.demo is not None)

    exporter = None
    if args.metrics_port:
        exporter = MetricsServer(sched.metrics, port=args.metrics_port).start()
        log.info("metrics on :%d/metrics", exporter.port)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())

    sched.start()
    log.info("tpu-scheduler running (profile: %s)", config.scheduler_name)
    try:
        if args.once:
            import time

            # Monotonic deadline: a 60s WAIT is a duration — the wall
            # clock (NTP steps) must not stretch or collapse it.
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not stop.is_set():
                pods = server.list("Pod")
                if pods and all(p.spec.node_name for p in pods):
                    for p in pods:
                        log.info("scheduled %s -> %s", p.metadata.name,
                                 p.spec.node_name)
                    return 0
                time.sleep(0.1)
            log.error("demo pods not fully scheduled within 60s")
            return 1
        stop.wait()
        return 0
    finally:
        sched.stop()
        getattr(sched, "_reshaper", None) and sched._reshaper.stop()
        if exporter is not None:
            exporter.stop()


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
