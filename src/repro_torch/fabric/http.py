"""HTTP shim: the FabricAPI handler table behind a real socket server.

Stdlib-only (``http.server`` + ``urllib``), as the ROADMAP prescribes: the
in-process ``FabricAPI.handle()`` already speaks (method, path, JSON body) —
this module just moves those triples across TCP so tenants can drive a
fabric from another process.

  * ``FabricHTTPServer`` — threading HTTP server. All API calls are
    serialized through one lock (the engine is single-threaded by design);
    an optional **auto-pump** thread advances the live engine between
    requests so submitted work makes progress without a client driving
    ``POST /pump``.
  * Long-polling — ``GET /jobs/{id}/events?since=<cursor>&wait_s=<s>``
    holds the request open (lock released between probes) until new events
    land, the job goes terminal, or the wait budget expires: a tenant can
    ``tail`` a job feed over plain HTTP with no websockets.
  * ``RemoteAPI`` — urllib client with the same ``handle()`` signature as
    ``FabricAPI``, so the CLI/examples/tests run unchanged against either
    an in-process fabric or a remote one.
"""
from __future__ import annotations

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlsplit

from repro_torch.core.cas import RefFencedError

from .api import FabricAPI
from .service import TERMINAL_STATUSES as _TERMINAL

#: cap one long-poll hold; clients re-issue with the same cursor
MAX_WAIT_S = 30.0


class FabricHTTPServer:
    """Serve one FabricAPI over TCP. ``port=0`` picks a free port."""

    def __init__(self, api: FabricAPI, host: str = "127.0.0.1",
                 port: int = 0, *, auto_pump: bool = True,
                 pump_steps: int = 256, pump_interval_s: float = 0.02,
                 ) -> None:
        self.api = api
        self.lock = threading.RLock()
        self.auto_pump = auto_pump
        self.pump_steps = pump_steps
        self.pump_interval_s = pump_interval_s
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._pump_thread: threading.Thread | None = None
        self.httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------- driving --
    #: error backoff: first retry after this, doubling up to the cap — a
    #: transient DiskCAS hiccup costs milliseconds, a broken store doesn't
    #: spin the thread
    PUMP_BACKOFF_S = 0.05
    PUMP_BACKOFF_MAX_S = 5.0

    def _pump_loop(self) -> None:
        svc = self.api.service
        health = {"running": True, "iterations": 0, "errors": 0,
                  "consecutive_errors": 0, "last_error": None}
        svc.pump_health = health
        metrics = getattr(svc, "metrics", None)
        m_errors = (None if metrics is None else metrics.counter(
            "fabric_pump_errors_total",
            "Exceptions survived by the auto-pump thread "
            "(fencing excluded — that stops the pump)").child())
        while not self._stop.is_set():
            try:
                with self.lock:
                    stepped = svc.pump(max_steps=self.pump_steps)
                    journal = getattr(svc, "journal", None)
                    if journal is not None:
                        if stepped == 0 and journal.pending:
                            journal.flush()  # idle: make history durable
                            svc.maybe_retain()  # flush may tip thresholds
                        # liveness lease (DESIGN.md §14): the pump IS the
                        # primary's heartbeat — a wedged or dead pump stops
                        # renewing, and auto-promote followers take over.
                        # Rate-limited inside the journal (TTL/3).
                        journal.heartbeat_lease()
            except RefFencedError as e:
                # another process took over the journal head (promotion
                # or a newer claim): this fabric no longer owns its
                # history — stop persisting, and flip the API surface
                # so writes are refused instead of acknowledged into
                # a void (a 201 from a zombie is lost work)
                svc.fenced = True
                health["running"] = False
                health["last_error"] = f"fenced: {e}"
                print(f"journal fenced off; pump stopped: {e}",
                      file=sys.stderr, flush=True)
                return
            except Exception as e:
                # anything else (a transient OSError from a DiskCAS flush,
                # a bug in one operator's bookkeeping) must NOT kill the
                # thread: a dead pump with a live HTTP surface acknowledges
                # work that never progresses. Count it, log it, back off
                # boundedly, try again.
                health["errors"] += 1
                health["consecutive_errors"] += 1
                health["last_error"] = repr(e)
                if m_errors is not None:
                    m_errors.inc()
                backoff = min(
                    self.PUMP_BACKOFF_S * 2 ** (
                        health["consecutive_errors"] - 1),
                    self.PUMP_BACKOFF_MAX_S)
                print(f"pump error ({health['errors']} total), retrying "
                      f"in {backoff:.2f}s: {e!r}", file=sys.stderr,
                      flush=True)
                self._stop.wait(backoff)
                continue
            health["iterations"] += 1
            health["consecutive_errors"] = 0
            if stepped == 0:        # idle or stalled: back off, don't spin
                self._stop.wait(self.pump_interval_s)
        health["running"] = False

    def _start_pump(self) -> None:
        if self.auto_pump:
            self._pump_thread = threading.Thread(target=self._pump_loop,
                                                 daemon=True)
            self._pump_thread.start()

    def enable_pump(self) -> None:
        """Begin auto-pumping mid-flight — a served warm-standby follower
        that just promoted itself read-write needs the engine driven from
        now on (before promotion there is nothing to pump)."""
        if self._pump_thread is None or not self._pump_thread.is_alive():
            self.auto_pump = True
            self._start_pump()

    def start(self) -> "FabricHTTPServer":
        """Run the server (and pump) in daemon threads; returns self."""
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        self._start_pump()
        return self

    def serve_forever(self) -> None:
        """Foreground variant for the CLI ``serve`` command."""
        self._start_pump()
        try:
            self.httpd.serve_forever()
        finally:
            self.stop()

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        # the pump thread may buffer more events after any flush we take —
        # join it first so the shutdown flush is really the last word
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10.0)
        svc = self.api.service
        if getattr(svc, "journal", None) is not None:
            with self.lock:
                try:
                    svc.journal.flush()    # clean shutdown loses nothing
                except RefFencedError as e:
                    # fenced mid-shutdown: the buffered tail belongs to a
                    # history this process no longer owns
                    svc.fenced = True
                    print(f"journal fenced off; shutdown flush dropped: {e}",
                          file=sys.stderr, flush=True)

    def __enter__(self) -> "FabricHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ handler --
    def _handle_locked(self, method: str, path: str, body, headers=None):
        with self.lock:
            metrics = getattr(self.api.service, "metrics", None)
            if metrics is None:
                return self.api.handle(method, path, body, headers)
            with metrics.histogram(
                    "fabric_http_request_seconds",
                    "Wall-clock duration of one API dispatch "
                    "(under the service lock)",
                    labels=("method",)).time(method=method):
                return self.api.handle(method, path, body, headers)

    def _handle(self, method: str, path: str, body, headers=None):
        """One request; events GETs and worker lease polls honor ``wait_s``
        by re-probing with the lock released so the pump thread keeps
        making progress."""
        url = urlsplit(path)
        query = dict(parse_qsl(url.query))
        wait_s = 0.0
        lease_poll = False
        if method == "GET" and url.path.rstrip("/").endswith("/events"):
            try:
                wait_s = min(float(query.get("wait_s", 0.0)), MAX_WAIT_S)
            except (TypeError, ValueError):
                return 400, {"error": "invalid_query",
                             "detail": ["'wait_s' must be a number"]}
        elif method == "POST" \
                and url.path.rstrip("/").endswith("/worker/lease"):
            # worker long-poll: hold until an offer is granted (each probe
            # also refreshes the lane's liveness in the transport)
            lease_poll = True
            try:
                wait_s = min(float((body or {}).get("wait_s", 0.0)),
                             MAX_WAIT_S)
            except (TypeError, ValueError):
                return 400, {"error": "invalid_body",
                             "detail": ["'wait_s' must be a number"]}
        deadline = time.monotonic() + wait_s
        while True:
            code, payload = self._handle_locked(method, path, body, headers)
            if lease_poll:
                if (code != 200 or not isinstance(payload, dict)
                        or payload.get("lease") is not None
                        or time.monotonic() >= deadline):
                    return code, payload
            # non-dict payloads (the /metrics text) can't be a feed poll
            elif (code != 200 or not isinstance(payload, dict)
                    or payload.get("events")
                    or payload.get("status") in _TERMINAL
                    or time.monotonic() >= deadline):
                return code, payload
            time.sleep(0.01)

    def _handler_class(self):
        shim = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:      # quiet by default
                pass

            def _respond(self, code: int, payload) -> None:
                if isinstance(payload, str):
                    # the /metrics exposition: plain text, not JSON
                    data = payload.encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                else:
                    data = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _dispatch(self, method: str) -> None:
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    try:
                        body = json.loads(self.rfile.read(length))
                    except (ValueError, UnicodeDecodeError):
                        self._respond(400, {
                            "error": "invalid_body",
                            "detail": ["request body must be JSON"]})
                        return
                try:
                    code, payload = shim._handle(method, self.path, body,
                                                 dict(self.headers))
                except Exception as e:      # never leak a stack over the wire
                    code, payload = 500, {"error": "internal_error",
                                          "detail": [str(e)]}
                self._respond(code, payload)

            def do_GET(self) -> None:
                self._dispatch("GET")

            def do_POST(self) -> None:
                self._dispatch("POST")

            def do_PUT(self) -> None:
                self._dispatch("PUT")

            def do_DELETE(self) -> None:
                self._dispatch("DELETE")

        return Handler


class RemoteAPI:
    """Drop-in for ``FabricAPI`` that speaks to a ``FabricHTTPServer``."""

    def __init__(self, base_url: str, *, timeout_s: float = 60.0,
                 token: str | None = None) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        #: bearer token forwarded on every request (admin writes need it
        #: when the server was started with --admin-token)
        self.token = token

    def handle(self, method: str, path: str, body: dict | None = None,
               headers: dict | None = None) -> tuple[int, object]:
        data = None if body is None else json.dumps(body).encode()
        send_headers = {"Content-Type": "application/json",
                        **(headers or {})}
        if self.token and "Authorization" not in send_headers:
            send_headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method.upper(),
            headers=send_headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                raw = resp.read()
                if "text/plain" in (resp.headers.get("Content-Type") or ""):
                    return resp.status, raw.decode()    # /metrics exposition
                return resp.status, json.loads(raw or b"null")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"null")
            except ValueError:
                payload = {"error": "non_json_response"}
            return e.code, payload
        except OSError as e:      # URLError / refused / timeout: the server
            # is unreachable — a structured error, not a raw traceback
            return 503, {"error": "unreachable",
                         "detail": [f"{self.base_url}: {e}"]}
