"""RESP client for the kvstored registry (copy of the JAX package's
``registry/client.py``): ``set``/``get``/``mget``/``get_keys``/``delete``
and friends over one socket, a lock per client serializing each
request/response pair.

Every transport failure retries under a bounded ``RetryPolicy``
(``utils/retry.py``: an attempt cap, jittered exponential backoff, a
wall-clock deadline), keeping the idempotency rule: a failure while
connecting is always retried (nothing was sent), a command that died
mid-flight is re-sent only if it is in ``_IDEMPOTENT``. Backoff sleeps
happen with the lock released. ``on_retry`` is a metrics hook, and
``fault_injector`` (``testing/faults.py``) fires ``registry.connect`` and
``registry.roundtrip``.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Callable, List, Optional

from ..utils.retry import RetryPolicy


class RegistryError(Exception):
    pass


class AuthError(RegistryError):
    pass


class ConnectionLost(RegistryError):
    """Transport-level failure (as opposed to a server -ERR reply)."""


# Commands safe to transparently re-send after a reconnect. DEL is absent on
# purpose: re-sending it after a dropped reply would erase the key a second
# time and report 0, lying to the caller about whether the key existed.
_IDEMPOTENT = {"GET", "MGET", "SET", "GETRANGE", "KEYS", "EXISTS", "DBSIZE", "PING", "INFO", "FLUSHDB"}


class Client:
    """``New(addr, password, db)`` parity (client.go:54-67)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 32767,
        password: Optional[str] = None,
        db: int = 0,
        timeout_s: float = 5.0,
        retry: Optional[RetryPolicy] = None,
        on_retry: Optional[Callable[[], None]] = None,
        fault_injector=None,
    ) -> None:
        self.host = host
        self.port = port
        self._password = password
        self._db = db
        self._timeout = timeout_s
        # Default bound: 4 tries, ~20/40/80 ms jittered backoff, and the
        # whole call (sleeps included) never past 2 s — a dead registry
        # costs a scheduler cycle a bounded, predictable delay, not a hang.
        self._retry = retry or RetryPolicy(attempts=4, base_s=0.02,
                                           max_s=0.25, deadline_s=2.0)
        self.on_retry = on_retry
        self._faults = fault_injector
        self._mu = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._buf = b""

    # -- connection --------------------------------------------------------
    def _connect_locked(self) -> None:
        s = socket.create_connection((self.host, self.port), timeout=self._timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._buf = b""
        if self._password:
            try:
                reply = self._roundtrip_locked(["AUTH", self._password])
            except AuthError:
                raise
            except RegistryError as e:
                raise AuthError(f"AUTH failed: {e}") from e
            if reply != "OK":
                raise AuthError(f"AUTH failed: {reply}")
        if self._db:
            reply = self._roundtrip_locked(["SELECT", str(self._db)])
            if reply != "OK":
                raise RegistryError(f"SELECT failed: {reply}")

    def _close_locked(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        finally:
            self._sock = None

    def close(self) -> None:
        with self._mu:
            self._close_locked()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- protocol ----------------------------------------------------------
    def _send_locked(self, argv: List[str]) -> None:
        out = [f"*{len(argv)}\r\n".encode()]
        for a in argv:
            data = a.encode() if isinstance(a, str) else a
            out.append(f"${len(data)}\r\n".encode() + data + b"\r\n")
        assert self._sock is not None
        self._sock.sendall(b"".join(out))

    def _read_line_locked(self) -> bytes:
        assert self._sock is not None
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise ConnectionLost("connection closed by server")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact_locked(self, n: int) -> bytes:
        assert self._sock is not None
        while len(self._buf) < n:
            chunk = self._sock.recv(4096)
            if not chunk:
                raise ConnectionLost("connection closed by server")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def _read_reply_locked(self):
        line = self._read_line_locked()
        kind, rest = line[:1], line[1:].decode()
        if kind == b"+":
            return rest
        if kind == b"-":
            if rest.startswith("NOAUTH"):
                raise AuthError(rest)
            raise RegistryError(rest)
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._read_exact_locked(n + 2)[:-2]
            return data.decode()
        if kind == b"*":
            return [self._read_reply_locked() for _ in range(int(rest))]
        raise RegistryError(f"bad reply line: {line!r}")

    def _roundtrip_locked(self, argv: List[str]):
        self._send_locked(argv)
        return self._read_reply_locked()

    def _call(self, *argv: str):
        """One command under the bounded-retry policy. Two failure
        phases with different retry rights: a CONNECT-phase failure
        (dial, AUTH/SELECT transport) sent nothing, so ANY command
        retries it; a mid-flight failure (the server may have executed
        the command and the reply died) re-sends only idempotent
        commands — DEL stays absent from ``_IDEMPOTENT`` on purpose: a
        blind re-send after a dropped reply would erase the key a second
        time and report 0, lying to the caller about whether the key
        existed. A server -ERR reply never lands here (the server DID
        answer); AUTH failures abort immediately — retrying a bad
        password is a lockout, not a recovery."""
        policy = self._retry
        deadline = policy.deadline_from(time.monotonic())
        attempt = 0
        while True:
            sent = False
            try:
                with self._mu:
                    try:
                        if self._sock is None:
                            if self._faults is not None:
                                self._faults.fire("registry.connect",
                                                  drop_exc=ConnectionLost)
                            self._connect_locked()
                        sent = True
                        if self._faults is not None:
                            self._faults.fire("registry.roundtrip",
                                              drop_exc=ConnectionLost)
                        return self._roundtrip_locked(list(argv))
                    except (OSError, ConnectionLost):
                        # Transport died (server restarted, idle timeout,
                        # injected drop): the socket is poisoned either
                        # way — drop it so the next attempt redials.
                        self._close_locked()
                        raise
            except AuthError:
                raise
            except (OSError, ConnectionLost) as transport_err:
                if sent and argv[0].upper() not in _IDEMPOTENT:
                    raise ConnectionLost(
                        f"{argv[0]} failed mid-flight (not retried)"
                    ) from transport_err
                attempt += 1
                delay = policy.backoff_s(attempt)
                if policy.give_up(attempt, time.monotonic(), deadline,
                                  delay):
                    raise ConnectionLost(
                        f"{argv[0]} failed after {attempt} attempt(s): "
                        f"{transport_err}") from transport_err
                if self.on_retry is not None:
                    self.on_retry()
                # Backoff with the lock RELEASED: other threads' calls
                # proceed (and may themselves reconnect) while this one
                # waits out its jittered delay.
                time.sleep(delay)

    # -- API parity with client.go:26-67 ----------------------------------
    def set(self, key: str, value: str) -> None:
        reply = self._call("SET", key, value)
        if reply != "OK":
            raise RegistryError(f"SET: {reply}")

    def get(self, key: str) -> Optional[str]:
        return self._call("GET", key)

    def mget(self, *keys: str) -> List[Optional[str]]:
        """Values for ``keys`` in order, None per missing key — one round
        trip for a whole fleet's inventories (Redis MGET semantics)."""
        if not keys:
            return []
        return self._call("MGET", *keys)

    def get_range(self, key: str, start: int, end: int) -> str:
        return self._call("GETRANGE", key, str(start), str(end)) or ""

    def get_keys(self, pattern: str = "*") -> List[str]:
        return list(self._call("KEYS", pattern))

    def delete(self, *keys: str) -> int:
        return int(self._call("DEL", *keys))

    def exists(self, key: str) -> bool:
        return bool(self._call("EXISTS", key))

    def dbsize(self) -> int:
        return int(self._call("DBSIZE"))

    def flush(self) -> None:
        """FlushRedis parity (client.go:48-52)."""
        self._call("FLUSHDB")

    def ping(self) -> bool:
        return self._call("PING") == "PONG"
