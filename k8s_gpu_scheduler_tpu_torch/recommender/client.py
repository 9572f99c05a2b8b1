"""gRPC client of the recommender (copy of the JAX package's
``recommender/client.py``), returning column→value dicts that satisfy
``plugins.tpu.PredictionClient`` directly.

One channel persists for the client's lifetime (the scoring hot loop
makes 2 calls per resident pod), and replies are memoized for a short
TTL: predictions only move on the server's retrain cadence, so scoring
many nodes against the same resident pods repeats identical queries.
Errors are never cached.

Each RPC retries transient gRPC failures under a bounded ``RetryPolicy``
(``utils/retry.py``), then raises to the caller; the TPU plugin's Score
path catches that, counts it, and scores without the recommender signal
for the cycle (degraded scoring). ``on_retry`` feeds
``tpu_sched_rpc_retries_total{client="recommender"}`` and
``fault_injector`` exposes the ``recommender.call`` hook
(``testing/faults.py``)."""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..utils.retry import RetryPolicy, retry_call
from .wire import (
    METHOD_CONFIGURATIONS,
    METHOD_INTERFERENCE,
    decode_reply,
    encode_request,
)


class Client:
    def __init__(self, host: str = "127.0.0.1", port: int = 32700,
                 timeout_s: float = 2.0, cache_ttl_s: float = 5.0,
                 retry: Optional[RetryPolicy] = None,
                 on_retry: Optional[Callable[[], None]] = None,
                 fault_injector=None):
        import grpc

        self._timeout = timeout_s
        self._ttl = cache_ttl_s
        # Bounded: 3 tries, ~20/40 ms jittered backoff, whole-call
        # deadline — the Score hot loop makes 2 calls per resident pod,
        # so a dead recommender must cost milliseconds-bounded failures
        # the plugin can degrade around, never a hang per call.
        self._retry = retry or RetryPolicy(attempts=3, base_s=0.02,
                                           max_s=0.2, deadline_s=1.5)
        self.on_retry = on_retry
        self._faults = fault_injector
        self._retryable: tuple = (grpc.RpcError,)
        # (method, index) -> (expiry, reply dict). Errors are never cached
        # (a transient server outage must not pin failures for a TTL).
        self._cache: Dict[Tuple[str, str], Tuple[float, Dict[str, float]]] = {}
        self._mu = threading.Lock()
        self._channel = grpc.insecure_channel(f"{host}:{port}")
        self._conf = self._channel.unary_unary(
            METHOD_CONFIGURATIONS,
            request_serializer=encode_request,
            response_deserializer=decode_reply,
        )
        self._intf = self._channel.unary_unary(
            METHOD_INTERFERENCE,
            request_serializer=encode_request,
            response_deserializer=decode_reply,
        )

    def _cached(self, kind: str, index: str, call) -> Dict[str, float]:
        now = time.monotonic()
        key = (kind, index)
        if self._ttl > 0:
            with self._mu:
                hit = self._cache.get(key)
                if hit is not None and hit[0] > now:
                    # Copy: callers own their reply dict — handing out the
                    # cached object would let one caller's mutation poison
                    # every later hit.
                    return dict(hit[1])
        result, columns = self._call_bounded(call, index)
        reply = dict(zip(columns, result))
        if self._ttl > 0:
            with self._mu:
                if len(self._cache) > 4096:          # scoring-universe bound
                    self._cache.clear()
                self._cache[key] = (now + self._ttl, reply)
        return reply

    def _call_bounded(self, call, index: str):
        """One RPC under the bounded-retry policy: transient gRPC
        failures (server restarting, connection reset) and injected
        chaos faults retry with jittered backoff until the attempt or
        deadline bound, then raise to the caller — who degrades (the
        plugin scores without the signal) rather than hangs."""
        from ..testing.faults import InjectedFault

        def attempt():
            if self._faults is not None:
                self._faults.fire("recommender.call")
            return call(index, timeout=self._timeout)

        on_retry = self.on_retry

        def count(_attempt, _exc):
            if on_retry is not None:
                on_retry()

        return retry_call(attempt, self._retry,
                          retry_on=self._retryable + (InjectedFault,),
                          on_retry=count)

    def impute_configurations(self, index: str) -> Dict[str, float]:
        return self._cached("conf", index, self._conf)

    def impute_interference(self, index: str) -> Dict[str, float]:
        return self._cached("intf", index, self._intf)

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def find_max_index(predictions: Dict[str, float], substring: str = "") -> Optional[Tuple[str, float]]:
    """Highest-valued column (optionally filtered by substring) — parity with
    FindMaxIndForNode (go_client/utils/utils.go:9-18)."""
    best: Optional[Tuple[str, float]] = None
    for col, val in predictions.items():
        if substring and substring not in col:
            continue
        if best is None or val > best[1]:
            best = (col, val)
    return best
