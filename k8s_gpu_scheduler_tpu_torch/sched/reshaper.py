"""Async slice repartitioning (copy of the JAX package's
``sched/reshaper.py``): the state machine

    idle ──request()──▶ applying ──agent republishes──▶ idle (new config)
                          │
                          └────────timeout────────▶ idle (rolled back)

- ``request(node, config)`` annotates the node (``tpu.sched/slice.config``
  = target, ``tpu.sched/slice.reshape-state`` = applying) and returns; a
  worker thread owns all waiting.
- Confirmation = the node agent publishing a fresh inventory (its
  heartbeat advancing past the request). With no registry wired the
  confirmation is simulated, after ``auto_confirm_delay_s``.
- While a node is ``applying``, the TPU plugin filters it out."""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from ..api.objects import ANN_RESHAPE_STATE, ANN_SLICE_CONFIG, Node
from ..obs import SYSTEM_CLOCK
from ..registry.inventory import HEARTBEAT_SUFFIX, node_key

log = logging.getLogger(__name__)

STATE_APPLYING = "applying"


@dataclass
class _Pending:
    node_name: str
    target: str
    previous: str
    # TWO request timestamps, deliberately: the timeout/auto-confirm math
    # is a DURATION and rides the monotonic clock (the old single
    # time.time() field meant an NTP step forward instantly timed out and
    # rolled back a healthy reshape, and a step backward stalled the
    # timeout — the wall-clock-for-duration bug the obs.Clock sweep
    # found); the agent-heartbeat comparison crosses processes and stays
    # on the wall clock the agent publishes.
    requested_mono: float
    requested_wall: float


class SliceReshaper:
    def __init__(
        self,
        descriptor,
        registry=None,
        poll_interval_s: float = 0.25,
        timeout_s: float = 60.0,
        auto_confirm_delay_s: float = 0.0,
        simulate_without_registry: bool = True,
        clock=None,
    ):
        self.descriptor = descriptor
        self.registry = registry
        self._clock = clock or SYSTEM_CLOCK
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s
        # No-registry mode: confirmation is SIMULATED (there is no agent to
        # republish). Each request is loudly logged as such and confirms
        # only after this delay — so a demo shows the applying→idle window
        # instead of pretending hardware repartitioned instantly. Tests
        # keep 0.0 for instant confirm.
        self.auto_confirm_delay_s = auto_confirm_delay_s
        # With neither a registry NOR simulation opted into (in-cluster
        # against real hardware without an agent feed), request() REFUSES:
        # flipping applying→idle on a timer with no observer would tell the
        # scheduler a repartition happened that nothing confirmed. Demo and
        # test rigs pass True (the default keeps hermetic rigs working);
        # cmd/scheduler.py passes False for --in-cluster.
        self.simulate_without_registry = simulate_without_registry
        self._mu = threading.Lock()
        self._pending: Dict[str, _Pending] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._adopt_orphans()

    def _adopt_orphans(self) -> None:
        """A node still annotated 'applying' from a dead reshaper instance
        (crash/restart mid-reshape) would otherwise be filtered out of
        scheduling forever — adopt it so the normal confirm/timeout path
        clears the state. Rollback target = its current config (the previous
        value died with the old instance)."""
        try:
            nodes = self.descriptor.list_nodes()
        except Exception:  # noqa: BLE001 — API unavailable at construction
            return
        for node in nodes:
            if node.metadata.annotations.get(ANN_RESHAPE_STATE) == STATE_APPLYING:
                cfg = node.metadata.annotations.get(ANN_SLICE_CONFIG, "")
                with self._mu:
                    self._pending[node.metadata.name] = _Pending(
                        node.metadata.name, cfg, cfg,
                        self._clock.monotonic(), self._clock.wall()
                    )
                log.warning("adopted orphaned reshape on %s (config %r)",
                            node.metadata.name, cfg)
        self._ensure_worker()

    # -- API ---------------------------------------------------------------
    def request(self, node_name: str, target_config: str) -> bool:
        """Begin repartitioning ``node_name`` to ``target_config``.
        Non-blocking; returns False if a reshape is already in flight (the
        reference serializes with a global mutex, gpu_plugins.go:480-496)."""
        if self._stop.is_set():
            return False  # shut down — never annotate a state nobody clears
        if self.registry is None and not self.simulate_without_registry:
            log.warning(
                "refusing reshape of %s: no registry to confirm the new "
                "partitioning and simulation not enabled", node_name)
            return False
        with self._mu:
            if node_name in self._pending:
                return False
            try:
                node: Node = self.descriptor.get_node(node_name)
            except Exception:  # noqa: BLE001 — node gone
                return False
            if node.metadata.annotations.get(ANN_RESHAPE_STATE) == STATE_APPLYING:
                return False
            previous = node.metadata.annotations.get(ANN_SLICE_CONFIG, "")
            if previous == target_config:
                return False
            self._annotate(node_name, {
                ANN_SLICE_CONFIG: target_config,
                ANN_RESHAPE_STATE: STATE_APPLYING,
            })
            self._pending[node_name] = _Pending(
                node_name, target_config, previous,
                self._clock.monotonic(), self._clock.wall()
            )
        log.info("reshape %s: %r -> %r", node_name, previous, target_config)
        self._ensure_worker()
        return True

    def in_flight(self, node_name: str) -> bool:
        with self._mu:
            return node_name in self._pending

    @staticmethod
    def is_applying(node: Node) -> bool:
        return node.metadata.annotations.get(ANN_RESHAPE_STATE) == STATE_APPLYING

    # -- worker ------------------------------------------------------------
    #
    # The drained-exit decision and the spawn decision both happen under
    # _mu: the worker sets _thread=None BEFORE returning, so a request()
    # racing the exit either sees the entry picked up by the live worker or
    # spawns a fresh one — an accepted request can never be stranded.
    def _ensure_worker(self) -> None:
        with self._mu:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="slice-reshaper"
                )
                self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # _thread is lock-guarded state (the worker nulls it on drained
        # exit, _ensure_worker respawns under _mu) — snapshot it under the
        # same lock; join() on the snapshot is then race-free either way.
        with self._mu:
            thread = self._thread
        if thread is not None:
            thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._mu:
                pending = list(self._pending.values())
                if not pending:
                    self._thread = None
                    return
            for p in pending:
                try:
                    self._advance(p)
                except Exception:  # noqa: BLE001 — one node must not stall all
                    log.exception("reshape of %s failed", p.node_name)
                    self._finish(p, rollback=True)
            self._stop.wait(self.poll_interval_s)

    def _advance(self, p: _Pending) -> None:
        if self._confirmed(p):
            self._finish(p, rollback=False)
        elif self._clock.monotonic() - p.requested_mono > self.timeout_s:
            log.warning("reshape of %s timed out; rolling back to %r",
                        p.node_name, p.previous)
            self._finish(p, rollback=True)

    def _confirmed(self, p: _Pending) -> bool:
        """Agent republished since the request → the host observed the new
        partitioning (UUID-change parity, gpu_plugins.go:436-452)."""
        if self.registry is None:
            if self._clock.monotonic() - p.requested_mono \
                    < self.auto_confirm_delay_s:
                return False
            log.warning(
                "reshape of %s to %r confirmed WITHOUT a registry — "
                "simulated confirmation, no agent observed the new "
                "partitioning", p.node_name, p.target)
            return True
        try:
            raw = self.registry.get(node_key(p.node_name) + HEARTBEAT_SUFFIX)
        except Exception:  # noqa: BLE001 — registry down: keep waiting
            return False
        if raw is None:
            return False
        try:
            # Cross-process comparison: the agent publishes WALL time, so
            # this one stays on the wall clock (monotonic clocks share no
            # epoch across processes).
            return float(raw) >= p.requested_wall
        except ValueError:
            return False

    def _finish(self, p: _Pending, rollback: bool) -> None:
        # Drop the entry FIRST: if the annotate below fails (node deleted,
        # API down) we must not retry it forever and wedge the worker on one
        # node — a vanished node's annotations vanished with it anyway.
        with self._mu:
            self._pending.pop(p.node_name, None)
        ann = {ANN_RESHAPE_STATE: ""}
        if rollback:
            ann[ANN_SLICE_CONFIG] = p.previous
        try:
            self._annotate(p.node_name, ann)
        except Exception:  # noqa: BLE001
            log.exception("could not clear reshape state on %s", p.node_name)

    def _annotate(self, node_name: str, ann: Dict[str, str]) -> None:
        def fn(n: Node) -> None:
            for k, v in ann.items():
                if v:
                    n.metadata.annotations[k] = v
                else:
                    n.metadata.annotations.pop(k, None)

        self.descriptor.server.mutate("Node", node_name, "default", fn)
