"""Cluster-aware client: one ``handle()`` over a primary and its standbys.

``RemoteAPI`` binds a caller to one process; across a failover that
process is a corpse (connection refused) or a fenced zombie (409 on every
write). ``ClusterAPI`` keeps the same ``handle(method, path, body,
headers)`` signature but takes the *set* of fabric endpoints — primary
plus followers, order-agnostic — and routes per request (DESIGN.md §14):

  * **writes** (every non-GET) go to the current primary. On a 409 whose
    error is ``fenced`` / ``read_only_follower``, or on 503 unreachable,
    the cached primary is discarded, re-resolved by probing
    ``GET /admin/replication`` on every endpoint (role ``primary``, not
    fenced, highest epoch wins — the epoch totally orders takeovers, so a
    zombie that still calls itself primary loses to its successor), and
    the write is retried with bounded backoff. Tenants and
    ``worker_main.py`` therefore ride an auto-promotion without config
    changes: the first write after the takeover lands on the winner.
  * **reads** fan out across every endpoint round-robin — followers serve
    the same event-sourced views as the primary — with two carve-outs:
    a 404/410 from a replica that is not the current primary falls
    through to the primary (read-your-writes: the replica may simply not
    have folded the segment yet), and **feed cursors are sticky**: a
    ``GET /jobs/{id}/events`` feed pins to the replica that served its
    first page, so one consumer's cursor walks one replica's retention
    window and the gap-free-or-marked contract survives. If the pinned
    replica dies the feed re-pins — cursors are global bus seqs, valid on
    every replica, so resuming elsewhere stays gap-free by construction.

No thread is spawned and no state is shared beyond the primary cache and
the pin table; the client is as dumb as possible — all consistency lives
in the epoch fence, not here.
"""
from __future__ import annotations

import threading
import time
from urllib.parse import urlsplit

from .http import RemoteAPI

#: writes re-resolve/retry this many times before giving up — with the
#: default backoff that spans several seconds, enough to cover an
#: auto-promotion (lease TTL + one follower wake interval)
DEFAULT_WRITE_ATTEMPTS = 8
DEFAULT_RETRY_BACKOFF_S = 0.25

#: 409 error values that mean "this endpoint is not the primary (anymore)";
#: every other 409 (quota, no_remote_transport, ...) is a real answer
_NOT_PRIMARY_ERRORS = frozenset({"fenced", "read_only_follower"})


class ClusterAPI:
    """Drop-in for ``RemoteAPI``/``FabricAPI`` over a set of endpoints."""

    def __init__(self, endpoints, *, token: str | None = None,
                 timeout_s: float = 60.0,
                 write_attempts: int = DEFAULT_WRITE_ATTEMPTS,
                 retry_backoff_s: float = DEFAULT_RETRY_BACKOFF_S,
                 make_api=None, sleep=time.sleep) -> None:
        if isinstance(endpoints, str):
            endpoints = [u for u in endpoints.split(",") if u.strip()]
        urls = [u.strip().rstrip("/") for u in endpoints]
        if not urls:
            raise ValueError("ClusterAPI needs at least one endpoint")
        if make_api is None:
            def make_api(url):
                return RemoteAPI(url, timeout_s=timeout_s, token=token)
        self._apis = {u: make_api(u) for u in dict.fromkeys(urls)}
        self.endpoints = list(self._apis)
        self._lock = threading.Lock()
        self._primary: str | None = None
        self._sticky: dict[str, str] = {}      # feed job id -> pinned url
        self._rr = 0
        self.write_attempts = max(1, write_attempts)
        self.retry_backoff_s = retry_backoff_s
        self._sleep = sleep
        self.resolutions = 0                   # primary probes run

    # ------------------------------------------------------------ routing --
    @property
    def primary_url(self) -> str | None:
        """The cached primary endpoint (None until the first write or an
        explicit ``resolve_primary``)."""
        return self._primary

    def handle(self, method: str, path: str, body: dict | None = None,
               headers: dict | None = None) -> tuple[int, object]:
        if method.upper() == "GET":
            return self._read(method, path, body, headers)
        return self._write(method, path, body, headers)

    @staticmethod
    def _feed_job(path: str) -> str | None:
        """The job id when ``path`` is a feed read (the sticky case)."""
        parts = [p for p in urlsplit(path).path.split("/") if p]
        if len(parts) == 3 and parts[0] == "jobs" and parts[2] == "events":
            return parts[1]
        return None

    # ------------------------------------------------------------- writes --
    def resolve_primary(self) -> str | None:
        """Probe every endpoint's ``/admin/replication`` and cache the
        best claimant: role ``primary``, not fenced, highest epoch."""
        best, best_epoch = None, -1
        for url, api in self._apis.items():
            try:
                code, repl = api.handle("GET", "/admin/replication")
            except Exception:
                continue
            if code != 200 or not isinstance(repl, dict):
                continue
            if repl.get("role") != "primary" or repl.get("fenced"):
                continue
            epoch = (repl.get("journal") or {}).get("epoch") or 0
            if epoch > best_epoch:
                best, best_epoch = url, epoch
        with self._lock:
            self._primary = best
            self.resolutions += 1
        return best

    def _write(self, method, path, body, headers) -> tuple[int, object]:
        last: tuple[int, object] = (503, {
            "error": "no_primary",
            "detail": ["no reachable endpoint claims the primary role"]})
        for attempt in range(self.write_attempts):
            if attempt:
                self._sleep(self.retry_backoff_s)
            url = self._primary or self.resolve_primary()
            if url is None:
                continue
            code, payload = self._apis[url].handle(method, path, body,
                                                   headers)
            err = payload.get("error") if isinstance(payload, dict) else None
            if (code == 503 and err == "unreachable") \
                    or (code == 409 and err in _NOT_PRIMARY_ERRORS):
                # dead or deposed: forget it and re-resolve on the retry
                with self._lock:
                    self._primary = None
                last = (code, payload)
                continue
            return code, payload
        return last

    # -------------------------------------------------------------- reads --
    def _read_order(self, path: str) -> tuple[list[str], str | None]:
        """Endpoint try-order for one read: the sticky pin first for feed
        paths, otherwise round-robin; the cached primary is always in the
        list (last unless it is the pin) for the read-your-writes
        fallback."""
        job = self._feed_job(path)
        with self._lock:
            urls = list(self._apis)
            start = self._rr % len(urls)
            self._rr += 1
            order = urls[start:] + urls[:start]
            pin = self._sticky.get(job) if job is not None else None
            primary = self._primary
        if pin is not None and pin in self._apis:
            order.remove(pin)
            order.insert(0, pin)
        if primary is not None and primary in order \
                and order[-1] != primary and pin != primary:
            # keep followers ahead of the primary: reads are its fallback,
            # not its default load (unless a feed pinned it)
            order.remove(primary)
            order.append(primary)
        return order, job

    def _read(self, method, path, body, headers) -> tuple[int, object]:
        order, job = self._read_order(path)
        last: tuple[int, object] | None = None
        missing: tuple[int, object] | None = None
        for url in order:
            code, payload = self._apis[url].handle(method, path, body,
                                                   headers)
            err = payload.get("error") if isinstance(payload, dict) else None
            if code == 503 and err == "unreachable":
                last = (code, payload)
                if job is not None and self._sticky.get(job) == url:
                    with self._lock:       # pinned replica died: re-pin
                        self._sticky.pop(job, None)
                continue
            if code in (404, 410) and url != self._primary \
                    and urlsplit(path).path.lstrip("/").startswith("jobs"):
                # replica lag: the record may exist where writes land —
                # keep probing and fall through to the primary
                missing = (code, payload)
                continue
            if job is not None:
                with self._lock:
                    self._sticky[job] = url
            return code, payload
        if missing is not None:
            return missing
        return last if last is not None else (503, {
            "error": "unreachable",
            "detail": ["every cluster endpoint is unreachable"]})
