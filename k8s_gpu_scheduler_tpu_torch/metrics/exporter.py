"""Prometheus text-format metrics exporter of the port (copy of the JAX
package's ``metrics/exporter.py``): counters, gauges and histograms
registered in a ``Registry``, served as Prometheus text exposition on
/metrics, and ``export_serving_pool``, which publishes one
``ContinuousBatcher.pool_metrics()`` snapshot under the JAX engine's
metric names (``tpu_serve_*``), so one dashboard reads either engine.

Not copied: the fleet-router counters and gauges (they come with the
fleet tier) and ``export_decode_fallbacks`` (the port never downgrades a
fused decode to a dense path: its kernel wrappers launch or raise).
"""
from __future__ import annotations

import threading
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, Dict, List, Optional, Tuple

# Default latency buckets (seconds) — kube-scheduler's
# scheduling_attempt_duration ladder, shortened.
DEFAULT_BUCKETS = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str) -> None:
        self.name = name
        self.help = help_
        self._mu = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._mu:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._mu:
            return self._values.get(key, 0.0)

    def expose(self) -> List[str]:
        with self._mu:
            items = list(self._values.items())
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for key, val in sorted(items):
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
        return lines


class Gauge:
    def __init__(self, name: str, help_: str) -> None:
        self.name = name
        self.help = help_
        self._mu = threading.Lock()
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._mu:
            self._values[key] = float(value)

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._mu:
            return self._values.get(key, 0.0)

    def expose(self) -> List[str]:
        with self._mu:
            items = list(self._values.items())
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for key, val in sorted(items):
            lines.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
        return lines


class _HistState:
    """Per-label-set histogram accumulator (bucket counts, sum, total,
    bounded raw window)."""

    __slots__ = ("counts", "sum", "total", "observations")

    def __init__(self, n_buckets: int, window: int) -> None:
        self.counts = [0] * (n_buckets + 1)  # +Inf bucket last
        self.sum = 0.0
        self.total = 0
        self.observations: Deque[float] = deque(maxlen=window)


class Histogram:
    # Raw observations kept for quantile() are bounded: a long-running
    # scheduler daemon observes every cycle, and an unbounded list would be
    # a slow memory leak. 100k covers any bench run; beyond that the window
    # slides (recent observations win, which is what a latency quantile
    # should reflect anyway).
    MAX_RAW_OBSERVATIONS = 100_000

    def __init__(self, name: str, help_: str, buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._mu = threading.Lock()
        # Keyed by sorted label items; () is the unlabeled series, so the
        # no-label API (the scheduler's cycle/e2e histograms) is unchanged
        # while labeled series (tpu_serve_phase_duration_seconds{phase=})
        # ride the same metric. The unlabeled series exists EAGERLY:
        # a registered-but-unobserved histogram must keep exposing its
        # zeroed _bucket/_sum/_count lines (pre-label behavior — alerting
        # distinguishes "zero observations" from "metric absent").
        self._states: Dict[Tuple[Tuple[str, str], ...], _HistState] = {
            (): _HistState(len(self.buckets), self.MAX_RAW_OBSERVATIONS)}

    def _state_locked(self, key) -> _HistState:
        st = self._states.get(key)
        if st is None:
            st = _HistState(len(self.buckets), self.MAX_RAW_OBSERVATIONS)
            self._states[key] = st
        return st

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._mu:
            st = self._state_locked(key)
            st.sum += value
            st.total += 1
            st.observations.append(value)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st.counts[i] += 1
                    return
            st.counts[-1] += 1

    @property
    def count(self) -> int:
        with self._mu:
            return sum(st.total for st in self._states.values())

    def count_for(self, **labels: str) -> int:
        key = tuple(sorted(labels.items()))
        with self._mu:
            st = self._states.get(key)
            return st.total if st else 0

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """Exact quantile over the (bounded window of) raw observations —
        bench convenience; real Prometheus would estimate from buckets.
        With labels, the quantile of that one series; without, of the
        unlabeled series (the pre-label behavior)."""
        key = tuple(sorted(labels.items()))
        with self._mu:
            st = self._states.get(key)
            if st is None or not st.observations:
                return None
            xs = sorted(st.observations)
        idx = min(len(xs) - 1, max(0, int(q * len(xs))))
        return xs[idx]

    def expose(self) -> List[str]:
        with self._mu:
            states = [(key, list(st.counts), st.total, st.sum)
                      for key, st in sorted(self._states.items())]
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for key, counts, total, s in states:
            labels = dict(key)
            cumulative = 0
            for b, c in zip(self.buckets, counts):
                cumulative += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels({**labels, 'le': str(b)})} {cumulative}")
            lines.append(
                f"{self.name}_bucket"
                f"{_fmt_labels({**labels, 'le': '+Inf'})} {total}")
            lines.append(f"{self.name}_sum{_fmt_labels(labels)} {s}")
            lines.append(f"{self.name}_count{_fmt_labels(labels)} {total}")
        return lines


class Registry:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "", buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(name, lambda: Histogram(name, help_, buckets), Histogram)

    def _get_or_create(self, name, factory, klass):
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, klass):
                raise TypeError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def expose(self) -> str:
        with self._mu:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"


# Serving page-pool / prefix-cache gauges (ContinuousBatcher.pool_metrics
# key -> help text), the JAX engine's names and help texts, so the two
# engines' expositions differ only where their pool_metrics() keys do.
# Keys of slices not ported yet (tp, weight_sliced_device_bytes,
# requests_shed_total) stay listed: a snapshot without them skips them.
SERVING_POOL_GAUGES = {
    "pages_total": "usable KV pages in the serving pool",
    "pages_free": "KV pages currently on the free list",
    "pages_in_use": "KV pages with at least one live reference",
    "pages_cached": "KV pages held (possibly shared) by the prefix tree",
    "pages_watermark": "high-water mark of referenced KV pages",
    "page_allocs": "cumulative page allocations",
    "page_frees": "cumulative page reference drops",
    "page_denied": "admissions denied for lack of free pages",
    "page_utilization": "referenced pages / usable pool (instantaneous)",
    "prefix_cached_pages": "pages (= radix-tree nodes) in the prefix cache",
    "prefix_hit_rate": "token-weighted prefix-cache hit rate",
    "prefix_request_hit_rate": "fraction of lookups matching any prefix",
    # NOTE: the pool_metrics key "prefix_hit_tokens" (cumulative) stays
    # available to host-side consumers (bench, fleet router), but its
    # Prometheus surface is now the tpu_serve_prefix_hit_tokens
    # HISTOGRAM below — per-admission hit lengths, whose _sum series IS
    # the old cumulative gauge and whose buckets show the distribution
    # (8-token system prompts vs whole mounted conversations).
    "prefix_lookup_tokens": "cumulative prompt tokens looked up",
    "prefix_lookups": "cumulative prefix-cache lookups (admissions)",
    "prefix_lookup_hits": "cumulative lookups that matched any prefix",
    "prefix_inserted_pages": "cumulative pages adopted into the tree",
    "prefix_evictions": "cumulative prefix-cache pages evicted (LRU)",
    # Decoded-suffix donations (multi-turn serving): adopted pages whose
    # token chunk extends past the donor's prompt — the reuse that lets
    # turn N+1 of a conversation mount turn N's whole transcript.
    "decoded_pages_donated_total":
        "decoded-suffix pages donated into the prefix tree at reap",
    "prefill_tokens_skipped": "prefill rows skipped via prefix reuse",
    # Chunked prefill (serving.ContinuousBatcher prefill_chunk_tokens):
    # backlog = admitted-but-unfinished prefill tokens (the fleet
    # router's prefill-pressure input), chunks = cumulative budgeted
    # chunk dispatches.
    "prefill_backlog_tokens":
        "prompt tokens admitted but not yet prefilled (chunked prefill)",
    "prefill_chunks_total":
        "cumulative chunked-prefill dispatches (per-slot chunks)",
    # Multi-chip sharded serving: island width and the per-chip pool
    # residency (the port serves one card: the whole pool).
    "tp": "tensor-parallel island width (1 = single-chip)",
    "kv_pool_device_bytes":
        "per-chip KV pool residency (pool + scale-plane shard bytes)",
    # Per-chip weight residency — total, and the Megatron-sliced subset
    # (multi-device). Build-time constants, never live-tensor reads.
    "weight_device_bytes":
        "per-chip model-weight residency (sliced + replicated leaves)",
    "weight_sliced_device_bytes":
        "per-chip bytes of the Megatron-sliced weight leaves "
        "(exactly 1/tp of their unsharded total)",
    # KV tiering (serving kv_tiering=): host-DRAM second tier + optional
    # disk third tier behind the radix tree (models/paging.py
    # HostTierStore). These keys exist only on tiered engines, so the
    # exposition of every untiered caller stays byte-identical.
    "tier_dram_pages": "KV pages demoted to the host-DRAM tier",
    "tier_dram_capacity": "host-DRAM tier capacity (pages)",
    "tier_disk_pages": "KV pages spilled to the disk tier",
    "tier_pending_demotions":
        "pages reserved for demotion, awaiting step-boundary readback",
    "page_demotions_total": "cumulative KV pages demoted HBM -> host DRAM",
    "page_promotions_total": "cumulative KV pages promoted host DRAM -> HBM",
    "prefix_demoted_pages": "radix-tree nodes whose page is demoted off-pool",
    "tier_spills_total": "cumulative DRAM-tier pages spilled to the disk tier",
    "tier_forgotten_total":
        "cumulative demoted pages forgotten at DRAM capacity (no disk tier)",
    "tier_cancelled_demotions":
        "pending demotions cancelled by a mid-match retain (pins win)",
    "spec_accept_rate": "speculative proposals accepted / proposed",
    "spec_tokens_per_dispatch":
        "tokens committed per active slot per verify dispatch",
    "spec_rewound_tokens_total":
        "cumulative rejected overshoot rows rewound by the lens clamp",
    # Lifecycle robustness (drain/snapshot/restore + watchdog —
    # models/serving.py drain()/restore(), models/snapshot.py).
    "drain_duration_seconds":
        "wall time of the last engine drain (flush + page gather)",
    "restore_duration_seconds":
        "wall time of the last snapshot restore (re-layout + scatter)",
    "requests_resumed_total":
        "interrupted requests resumed by restore/absorb on this engine",
    "requests_shed_total":
        "requests shed to a peer replica via partial drain (fleet tier)",
    "request_errors_total":
        "poison requests failed in isolation (step loop error containment)",
    "last_step_age_seconds":
        "seconds since the last batcher step started (liveness watchdog)",
}


# Per-phase request-lifecycle latency histogram (obs/ tracing): observed
# from the phase durations ContinuousBatcher.pool_metrics() drains
# atomically with the gauges above (one lock snapshot — a scrape can
# never see a phase batch from one step next to a watchdog age from
# another). Sub-millisecond lower buckets: admit/reap are host-side
# bookkeeping phases far below the scheduler's cycle ladder.
PHASE_HISTOGRAM = "tpu_serve_phase_duration_seconds"
PHASE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

# Per-admission prefix-cache hit lengths (tokens), fed from the
# ``prefix_hit_token_batch`` pool_metrics() drains in the same lock
# snapshot as the phase batch. Power-of-two token buckets spanning one
# page to whole mounted conversations; the 0-observations (misses) land
# below the first bucket, so hit-given-lookup is readable off the le=8
# edge. The _sum series is the cumulative hit-token count the old gauge
# carried.
PREFIX_HIT_HISTOGRAM = "tpu_serve_prefix_hit_tokens"
PREFIX_HIT_BUCKETS = (8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
                      1024.0, 2048.0, 4096.0, 8192.0)

# Promoted-hit lengths (tokens served through a DRAM->HBM promotion
# upload per admission), fed from ``promoted_hit_token_batch`` — drained
# in the SAME _obs_mu snapshot as the prefix-hit batch (the torn-read
# rule), present only on tiered engines. Same token buckets: the ratio
# promoted_sum / prefix_hit_sum is the fraction of cache hits the DRAM
# tier rescued from eviction.
PROMOTED_HIT_HISTOGRAM = "tpu_serve_promoted_hit_tokens"

# Info-style metric for the island weight-combine mode (pool_metrics()
# "tp_combine": "all_gather" | "psum" | "replicated" | "none"): value 1
# under {kind=} — the PromQL-friendly encoding of an enum that never
# changes after engine birth, so no stale one-hot cleanup is needed.
TP_COMBINE_INFO = "tpu_serve_tp_combine"

# Adaptive speculative gamma (serving spec_adaptive=True, pool_metrics()
# "spec_gamma_agg": {"min","mean","max"}): the effective verify-window
# spread across active slots under {slot_agg=} — one gauge, three
# aggregate series, the PromQL idiom for a small per-slot distribution
# whose slot cardinality must not leak into the exposition. Non-adaptive
# speculative engines publish the flat configured gamma on all three.
SPEC_GAMMA_GAUGE = "tpu_serve_spec_gamma"

# Per-dispatch speculative accept rates (pool_metrics()
# "spec_accept_batch", drained in the same _obs_mu snapshot as the phase
# batch — the torn-read rule), observed under {proposer=} so a fleet
# mixing bigram/ngram/draft replicas can compare sources side by side.
# Rate buckets are uniform in [0, 1]; the _sum/_count ratio is the mean
# accept rate the cumulative gauge also carries. Registered lazily only
# when a batch is present — non-speculative exposition stays
# byte-identical.
SPEC_ACCEPT_HISTOGRAM = "tpu_serve_spec_accept"
SPEC_ACCEPT_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                       1.0)


def export_serving_pool(registry: "Registry", pool_metrics: Dict[str, float],
                        prefix: str = "tpu_serve_",
                        labels: Optional[Dict[str, str]] = None) -> None:
    """Publish a ``ContinuousBatcher.pool_metrics()`` snapshot as gauges
    (``tpu_serve_page_utilization``, ``tpu_serve_prefix_hit_rate``, ...).
    Keys absent from the snapshot (contiguous layout → {}, prefix cache
    off → no prefix_* keys) are simply skipped, so callers can publish
    unconditionally on every scrape/step.

    The ``phase_durations`` key (present when the engine has a tracer
    attached) is a drained-once batch of ``(phase, seconds)`` pairs from
    the same lock snapshot as the gauges; it folds into the
    ``tpu_serve_phase_duration_seconds{phase=...}`` histogram rather
    than a gauge — durations are a distribution, not a level.

    ``labels`` stamps every gauge value and phase observation with a
    constant label set — the fleet tier publishes each replica under
    ``{replica="r0"}`` so one scrape shows N engines side by side
    (Gauge/Histogram per-label-set series, the same machinery the
    ``phase=`` label rides). ``labels=None`` (every pre-fleet caller)
    writes the unlabeled series — the text exposition stays
    byte-identical."""
    labels = labels or {}
    for key, help_ in SERVING_POOL_GAUGES.items():
        if key in pool_metrics:
            registry.gauge(prefix + key, help_).set(
                pool_metrics[key], **labels)
    phases = pool_metrics.get("phase_durations") or ()
    if phases:
        hist = registry.histogram(
            PHASE_HISTOGRAM,
            "Request-lifecycle phase durations (queue|admit|prefill|"
            "prefill_chunk|decode_chunk|verify|rewind|reap, plus "
            "demote|promote on tiered engines), by phase",
            buckets=PHASE_BUCKETS)
        for phase, seconds in phases:
            hist.observe(float(seconds), phase=str(phase), **labels)
    hits = pool_metrics.get("prefix_hit_token_batch") or ()
    if hits:
        hist = registry.histogram(
            PREFIX_HIT_HISTOGRAM,
            "Prefix-cache hit length per admission, in prompt tokens "
            "(0 = miss; whole mounted conversations land in the tail)",
            buckets=PREFIX_HIT_BUCKETS)
        for tokens in hits:
            hist.observe(float(tokens), **labels)
    promoted = pool_metrics.get("promoted_hit_token_batch") or ()
    if promoted:
        hist = registry.histogram(
            PROMOTED_HIT_HISTOGRAM,
            "Prefix-hit tokens served through a DRAM->HBM promotion "
            "upload, per admission (KV tiering)",
            buckets=PREFIX_HIT_BUCKETS)
        for tokens in promoted:
            hist.observe(float(tokens), **labels)
    combine = pool_metrics.get("tp_combine")
    if combine:
        registry.gauge(
            TP_COMBINE_INFO,
            "island weight-combine mode (Megatron-sliced weights), "
            "info-style: 1 under {kind=all_gather|psum|replicated|none}",
        ).set(1.0, kind=str(combine), **labels)
    gamma_agg = pool_metrics.get("spec_gamma_agg")
    if gamma_agg:
        gauge = registry.gauge(
            SPEC_GAMMA_GAUGE,
            "effective speculative verify window across active slots "
            "(adaptive gamma), under {slot_agg=min|mean|max}")
        for agg, value in gamma_agg.items():
            gauge.set(float(value), slot_agg=str(agg), **labels)
    accepts = pool_metrics.get("spec_accept_batch") or ()
    if accepts:
        proposer = str(pool_metrics.get("spec_proposer", "unknown"))
        hist = registry.histogram(
            SPEC_ACCEPT_HISTOGRAM,
            "Per-dispatch speculative accept rate (accepted / effective "
            "proposals), by proposal source",
            buckets=SPEC_ACCEPT_BUCKETS)
        for rate in accepts:
            hist.observe(float(rate), proposer=proposer, **labels)


class MetricsServer:
    """Serves a Registry at /metrics (Prometheus text exposition)."""

    def __init__(self, registry: Registry, host: str = "127.0.0.1", port: int = 0) -> None:
        self.registry = registry
        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404)
                    return
                body = reg.expose().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request logging
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
