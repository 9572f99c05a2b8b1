"""Seeded, deterministic fault injection for the port's serving engine
and fleet (copy of the JAX package's ``testing/faults.py``).

Hook points are named ``site`` strings fired from the engine and the
fleet router: ``serve.step`` once per step before any state changes,
``serve.propose`` once per slot per speculative proposal, ``fleet.step``
once per router step and ``replica.crash`` once per serving replica per
router step; a ``FaultProxy`` fires ``<site>.<method>`` before every
public method call of the object it wraps (a summary store, an engine).
A site's call
counter is the injection clock. A ``FaultRule`` picks call indices at a
site (explicit ``at``, periodic ``every``, an ``after``/``until`` window,
or a seeded probability ``p``) and names the fault: ``drop`` raises,
``delay`` sleeps, ``preempt`` raises ``Preempted`` (the in-process
stand-in for SIGTERM that a drain/restore loop catches), ``crash`` raises
``ReplicaCrashed`` (the hard kill: the router discards the engine), and
``page_pressure`` is returned to the engine, which holds that many pool
pages hostage. Matching depends only on (rule, call index) and, for ``p``,
a ``random.Random`` seeded from (seed, rule, site), so a seed replays its
faults; ``FaultInjector.log`` records each as ``(site, index, kind)``.
"""
from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Type

_KINDS = ("drop", "delay", "preempt", "page_pressure", "crash")


class InjectedFault(Exception):
    """An injected failure (default exception for ``drop`` rules when
    the hook point doesn't name a site-appropriate one)."""


class Preempted(InjectedFault):
    """The preemption signal: raised out of the batcher step loop so the
    serve loop can drain/snapshot/restore — the in-process stand-in for the
    SIGTERM a GKE spot preemption delivers."""


class ReplicaCrashed(InjectedFault):
    """The hard-kill signal (kind="crash"): unlike :class:`Preempted`,
    nothing cooperative follows — the fleet router discards the engine
    object outright (no drain, no snapshot) and recovery is the router's
    journal replay. Fired from ``fleet.step`` and ``replica.crash``; the
    per-site call index picks which replica dies, since the router visits
    replicas in id order."""


@dataclass(frozen=True)
class FaultRule:
    """One deterministic injection rule at one site (or site prefix:
    ``site="apiserver"`` matches ``apiserver.get``, ``apiserver.update``,
    ... — how one rule flaps a whole proxied client)."""

    site: str
    kind: str
    at: Optional[Sequence[int]] = None   # explicit 1-based call indices
    every: int = 0                       # fire when index % every == 0
    after: int = 0                       # only indices strictly above
    until: int = 0                       # only indices <= until (0 = inf)
    p: float = 0.0                       # seeded per-rule probability
    delay_s: float = 0.0                 # for kind="delay"
    pages: int = 0                       # for kind="page_pressure"
    exc: Optional[Type[BaseException]] = None   # override for kind="drop"

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {_KINDS})")
        if self.at is None and not self.every and not self.p:
            raise ValueError(
                f"rule at {self.site!r} can never fire: set at=, every= "
                f"or p=")

    def _matches_site(self, site: str) -> bool:
        return site == self.site or site.startswith(self.site + ".")

    def _in_window(self, index: int) -> bool:
        if index <= self.after:
            return False
        if self.until and index > self.until:
            return False
        if self.at is not None and index not in self.at:
            return False
        if self.every and index % self.every:
            return False
        return True


class FaultInjector:
    """Fires the rule schedule at named hook points. Thread-compatible
    for the tests' purposes (counters are plain ints guarded by the
    GIL; chaos scenarios drive one site from one thread)."""

    def __init__(self, seed: int = 0,
                 rules: Sequence[FaultRule] = ()) -> None:
        self.seed = seed
        self.rules: List[FaultRule] = list(rules)
        self._counts: Dict[str, int] = {}
        self._rngs: Dict[Tuple[int, str], random.Random] = {}
        # Every injection, in firing order: (site, call index, kind) —
        # the replay transcript the determinism tests byte-compare.
        self.log: List[Tuple[str, int, str]] = []
        self._sleep = time.sleep

    def count(self, site: str) -> int:
        """Calls seen at ``site`` so far (the injection clock)."""
        return self._counts.get(site, 0)

    def _rng_for(self, rule_idx: int, site: str) -> random.Random:
        # crc32, not hash(): str hashing is salted per process
        # (PYTHONHASHSEED), which would silently break the cross-run
        # reproducibility contract the CI determinism gate asserts.
        # Cached PER (rule, site): a prefix-site rule matching several
        # proxied methods must draw from an independent stream at each,
        # or one site's traffic would shift another's injection points.
        key = zlib.crc32(
            f"{self.seed}:{rule_idx}:{site}".encode()) & 0x7FFFFFFF
        if (rule_idx, site) not in self._rngs:
            self._rngs[(rule_idx, site)] = random.Random(key)
        return self._rngs[(rule_idx, site)]

    def fire(self, site: str,
             drop_exc: Type[BaseException] = InjectedFault,
             ) -> List[FaultRule]:
        """One pass through hook point ``site``: advance its clock,
        evaluate every matching rule in declaration order, apply
        ``delay`` sleeps inline, RAISE on the first ``drop``/``preempt``
        (``drop`` raises ``rule.exc`` or the hook's ``drop_exc`` — the
        exception type the call site's real failure would be), and
        return the non-raising matches (``page_pressure``) for the
        caller to interpret."""
        index = self._counts.get(site, 0) + 1
        self._counts[site] = index
        passive: List[FaultRule] = []
        for i, rule in enumerate(self.rules):
            if not rule._matches_site(site) or not rule._in_window(index):
                continue
            if rule.p:
                # Draw exactly once per in-window call so the stream of
                # consumed variates — hence every later decision — is a
                # pure function of the call sequence.
                if self._rng_for(i, site).random() >= rule.p:
                    continue
            self.log.append((site, index, rule.kind))
            if rule.kind == "delay":
                self._sleep(rule.delay_s)
            elif rule.kind == "preempt":
                raise Preempted(f"injected preemption at {site}#{index}")
            elif rule.kind == "crash":
                raise ReplicaCrashed(f"injected crash at {site}#{index}")
            elif rule.kind == "drop":
                exc = rule.exc or drop_exc
                raise exc(f"injected {site}#{index} drop")
            else:
                passive.append(rule)
        return passive


class FaultProxy:
    """Wrap any object so every public method call first fires
    ``<site>.<method>`` on the injector — how a test flaps a summary store
    or an engine without the wrapped class knowing. Attribute reads pass
    through untouched; only calls inject, and only calls of methods the
    target has (a name it lacks raises ``AttributeError``, never a
    silent miss)."""

    def __init__(self, target, injector: FaultInjector, site: str,
                 drop_exc: Type[BaseException] = InjectedFault) -> None:
        self._target = target
        self._injector = injector
        self._site = site
        self._drop_exc = drop_exc

    def __getattr__(self, name: str):
        attr = getattr(self._target, name)
        if not callable(attr) or name.startswith("_"):
            return attr
        injector, site, exc = self._injector, self._site, self._drop_exc

        def fired(*args, **kwargs):
            injector.fire(f"{site}.{name}", drop_exc=exc)
            return attr(*args, **kwargs)

        return fired
