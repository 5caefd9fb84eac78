"""In-process request/response API over the FabricService.

A single handler table maps ``(METHOD, /path/{param}/...)`` routes onto
service calls, so examples, benchmarks, the CLI, and tests all drive the
fabric through one interface — and a future HTTP shim only has to translate
sockets into ``handle()`` calls. Payloads are JSON-shaped plain dicts.

Routes:

    POST /workflows                  {"spec": {...}} | {"template": name,
                                      "params": {...}}
    GET  /workflows/templates
    GET  /jobs                       ?tenant=<id>
    GET  /jobs/{id}                  (410 {"status": "archived"} once
                                      retention has evicted the record)
    GET  /jobs/{id}/events           ?since=<cursor>&limit=<n>
    GET  /jobs/{id}/lineage
    GET  /jobs/{id}/trace            ?format=chrome for trace_event JSON
    POST /jobs/{id}/cancel
    GET  /tenants/{id}/usage
    GET  /health
    GET  /metrics                    Prometheus text (always open)
    POST /pump                       {"max_steps": n?, "until": t?}
    POST /drain                      {"until": t?}   (run_until_idle)
    POST /admin/compact              {"keep_segments": n?}  (409 w/o journal)
    POST /admin/gc                   reports reclaimed blobs/bytes
    GET  /admin/retention            effective policy + footprint + auto stats
    PUT  /admin/retention            patch retention fields live (persisted
                                     to the CAS operator document)
    PUT  /tenants/{id}/quota         replace one tenant's quota (persisted)
    GET  /admin/replication          role + journal head/epoch (a follower's
                                     FollowerAPI overrides with lag stats)
    POST /admin/promote              409 here; the follower surface promotes

Writes against a warm-standby follower (``FollowerAPI``) answer 409 — the
read-only surface flips to this full table only after promotion.

With an ``admin_token`` configured, mutating ``/admin/*`` routes and
``PUT /tenants/{id}/quota`` require ``Authorization: Bearer <token>`` and
answer 401 without it; every read-only route (and ``/metrics``) stays
open. No token configured = the surface stays open, so single-operator
setups and the CI failover pipeline keep working unchanged.

The events feed is cursor-based: pass the ``cursor`` from the previous
response as ``since`` to receive only newer events — no duplicates, no
gaps, suitable for long-polling (the HTTP shim adds ``wait_s``).
"""
from __future__ import annotations

import dataclasses
import hmac
import time

from typing import Any, Callable
from urllib.parse import parse_qsl, urlsplit

from ..core.transport import FencedLease, UnknownWorker
from .admission import TenantQuota
from .replay import RetentionPolicy
from .service import FabricService
from .spec import SpecError, list_templates


class FabricAPI:
    def __init__(self, service: FabricService, *,
                 admin_token: str | None = None) -> None:
        self.service = service
        #: static bearer token guarding the operator write surface; None
        #: (the default) leaves it open — auth is opt-in (DESIGN.md §11)
        self.admin_token = admin_token
        #: (METHOD, pattern) -> handler(params, query, body)
        self.routes: list[tuple[str, tuple[str, ...], Callable]] = [
            ("POST", ("workflows",), self._post_workflow),
            ("GET", ("workflows", "templates"), self._get_templates),
            ("GET", ("jobs",), self._list_jobs),
            ("GET", ("jobs", "{id}"), self._get_job),
            ("GET", ("jobs", "{id}", "events"), self._get_events),
            ("GET", ("jobs", "{id}", "lineage"), self._get_lineage),
            ("GET", ("jobs", "{id}", "trace"), self._get_trace),
            ("POST", ("jobs", "{id}", "cancel"), self._cancel_job),
            ("GET", ("tenants", "{id}", "usage"), self._get_usage),
            ("GET", ("health",), self._get_health),
            ("GET", ("metrics",), self._get_metrics),
            ("POST", ("pump",), self._pump),
            ("POST", ("drain",), self._drain),
            ("POST", ("admin", "compact"), self._compact),
            ("POST", ("admin", "gc"), self._gc),
            ("GET", ("admin", "retention"), self._retention),
            ("PUT", ("admin", "retention"), self._put_retention),
            ("PUT", ("tenants", "{id}", "quota"), self._put_quota),
            ("GET", ("admin", "replication"), self._replication),
            ("POST", ("admin", "promote"), self._promote),
            # worker data plane (lease transport only; 409 without one).
            # Deliberately unauthenticated like the tenant surface — and
            # the service-fenced gate above applies: workers must stop
            # feeding results to a zombie primary
            ("POST", ("worker", "register"), self._worker_register),
            ("POST", ("worker", "lease"), self._worker_lease),
            ("POST", ("worker", "heartbeat"), self._worker_heartbeat),
            ("POST", ("worker", "complete"), self._worker_complete),
            ("GET", ("admin", "transport"), self._transport_status),
        ]

    # ------------------------------------------------------------ routing --
    @staticmethod
    def _match(pattern: tuple[str, ...], parts: tuple[str, ...],
               ) -> dict[str, str] | None:
        if len(pattern) != len(parts):
            return None
        params: dict[str, str] = {}
        for pat, part in zip(pattern, parts):
            if pat.startswith("{") and pat.endswith("}"):
                params[pat[1:-1]] = part
            elif pat != part:
                return None
        return params

    @staticmethod
    def _admin_route(method: str, pattern: tuple[str, ...]) -> bool:
        """Mutating operator routes: everything under ``/admin/*`` plus the
        quota write. Read-only admin GETs stay open — observability must
        not need credentials (DESIGN.md §11)."""
        if method == "GET":
            return False
        return (pattern[:1] == ("admin",)
                or pattern == ("tenants", "{id}", "quota"))

    def _authorized(self, headers: dict | None) -> bool:
        if self.admin_token is None:
            return True
        auth = next((v for k, v in (headers or {}).items()
                     if k.lower() == "authorization"), "")
        scheme, _, token = auth.partition(" ")
        return (scheme.lower() == "bearer"
                and hmac.compare_digest(token.strip(), self.admin_token))

    def handle(self, method: str, path: str, body: dict | None = None,
               headers: dict | None = None) -> tuple[int, Any]:
        """Dispatch one request; returns ``(status_code, payload)``.
        Payloads are JSON-shaped dicts except ``/metrics``, which returns
        the Prometheus exposition as a plain string."""
        if body is not None and not isinstance(body, dict):
            return 400, {"error": "invalid_body",
                         "detail": ["request body must be an object"]}
        url = urlsplit(path)
        parts = tuple(p for p in url.path.split("/") if p)
        query = dict(parse_qsl(url.query))
        method = method.upper()
        if method != "GET" and getattr(self.service, "fenced", False):
            # another process owns the journal now (DESIGN.md §10): reads
            # may continue (stale but honest), writes must not be
            # acknowledged — they could never be persisted or replicated
            return 409, {"error": "fenced",
                         "detail": ["another fabric took over this journal;"
                                    " write to the current primary"]}
        matched_path = False
        for m, pattern, handler in self.routes:
            params = self._match(pattern, parts)
            if params is None:
                continue
            matched_path = True
            if m != method:
                continue
            if self._admin_route(m, pattern) \
                    and not self._authorized(headers):
                return 401, {"error": "unauthorized",
                             "detail": ["admin routes require "
                                        "'Authorization: Bearer <token>'"]}
            try:
                return handler(params, query, body or {})
            except SpecError as e:
                return 400, {"error": "invalid_spec", "detail": e.errors}
        if matched_path:
            return 405, {"error": "method_not_allowed"}
        return 404, {"error": "no_such_route", "path": path}

    # ----------------------------------------------------------- handlers --
    def _post_workflow(self, params, query, body) -> tuple[int, Any]:
        if "template" in body:
            tpl_params = body.get("params", {})
            if not isinstance(tpl_params, dict):
                return 400, {"error": "invalid_template_params",
                             "detail": ["'params' must be an object"]}
            try:
                job = self.service.submit_template(body["template"],
                                                   **tpl_params)
            except SpecError:
                raise                  # handled by the dispatcher -> 400
            except (TypeError, ValueError) as e:
                # tenant-supplied params that the template rejects (unknown
                # keyword, wrong type) are a client error, not a crash
                return 400, {"error": "invalid_template_params",
                             "detail": [str(e)]}
        elif "spec" in body:
            job = self.service.submit(body["spec"])
        else:
            return 400, {"error": "body_requires_spec_or_template"}
        if job["status"] == "rejected":
            return 429, job          # quota exceeded — retry later
        return 201, job

    def _get_templates(self, params, query, body) -> tuple[int, Any]:
        return 200, {"templates": list_templates()}

    def _list_jobs(self, params, query, body) -> tuple[int, Any]:
        return 200, {"jobs": self.service.list_jobs(query.get("tenant"))}

    def _archived(self, job_id: str) -> tuple[int, Any] | None:
        """410 Gone stub for retention-evicted jobs: the record is gone,
        but its tombstone proves the id existed — provenance degrades
        instead of disappearing into a 404."""
        entry = getattr(self.service, "archived", {}).get(job_id)
        if entry is None:
            return None
        return 410, {"status": "archived", "job_id": job_id,
                     "tenant": entry["tenant"],
                     "detail": ["record evicted by the retention policy; "
                                "full history may survive in the journal"]}

    def _get_job(self, params, query, body) -> tuple[int, Any]:
        job = self.service.job(params["id"])
        if job is None:
            return (self._archived(params["id"])
                    or (404, {"error": "no_such_job",
                              "job_id": params["id"]}))
        return 200, job

    def _get_trace(self, params, query, body) -> tuple[int, Any]:
        chrome = query.get("format") == "chrome"
        trace = self.service.trace(params["id"], chrome=chrome)
        if trace is None:
            return (self._archived(params["id"])
                    or (404, {"error": "no_such_job",
                              "job_id": params["id"]}))
        return 200, (trace if not chrome
                     else {"traceEvents": trace, "displayTimeUnit": "ms"})

    def _get_metrics(self, params, query, body) -> tuple[int, Any]:
        """The Prometheus exposition — a plain string payload; the HTTP
        shim serves it as ``text/plain; version=0.0.4``."""
        return 200, self.service.metrics.render()

    def _get_events(self, params, query, body) -> tuple[int, Any]:
        try:
            since = int(query.get("since", -1))
            limit = int(query["limit"]) if "limit" in query else None
        except (TypeError, ValueError):
            return 400, {"error": "invalid_query",
                         "detail": ["'since'/'limit' must be integers"]}
        if limit is not None and limit <= 0:
            return 400, {"error": "invalid_query",
                         "detail": ["'limit' must be positive"]}
        feed = self.service.events(params["id"], since=since, limit=limit)
        if feed is None:
            return (self._archived(params["id"])
                    or (404, {"error": "no_such_job",
                              "job_id": params["id"]}))
        return 200, feed

    def _get_lineage(self, params, query, body) -> tuple[int, Any]:
        lin = self.service.lineage(params["id"])
        if lin is None:
            return (self._archived(params["id"])
                    or (404, {"error": "no_such_job",
                              "job_id": params["id"]}))
        return 200, {"job_id": params["id"], "lineage": lin}

    def _cancel_job(self, params, query, body) -> tuple[int, Any]:
        job = self.service.cancel(params["id"])
        if job is None:
            return 404, {"error": "no_such_job", "job_id": params["id"]}
        return 200, job

    def _get_usage(self, params, query, body) -> tuple[int, Any]:
        return 200, self.service.usage(params["id"])

    def _get_health(self, params, query, body) -> tuple[int, Any]:
        return 200, self.service.health()

    @staticmethod
    def _number(body, key) -> tuple[Any, Any]:
        """(value, error_payload): None is allowed, anything else must be a
        real number — client bodies must never escape handle() as crashes."""
        v = body.get(key)
        if v is None or (isinstance(v, (int, float))
                         and not isinstance(v, bool)):
            return v, None
        return None, {"error": "invalid_body",
                      "detail": [f"{key!r} must be a number"]}

    def _pump(self, params, query, body) -> tuple[int, Any]:
        max_steps, err = self._number(body, "max_steps")
        until, err2 = self._number(body, "until")
        if err or err2:
            return 400, err or err2
        steps = self.service.pump(max_steps, until)
        return 200, {"steps": steps, "now": self.service.engine.now}

    def _drain(self, params, query, body) -> tuple[int, Any]:
        until, err = self._number(body, "until")
        if err:
            return 400, err
        tel = self.service.run_until_idle(until)
        return 200, {"now": self.service.engine.now,
                     "summary": tel.summary()}

    def _compact(self, params, query, body) -> tuple[int, Any]:
        keep, err = self._number(body, "keep_segments")
        if err:
            return 400, err
        if self.service.journal is None:
            return 409, {"error": "no_journal"}
        if keep is None:       # the policy's tail floor, like the serve loop
            keep = self.service.retention_policy.keep_segments
        return 200, self.service.compact(keep_segments=int(keep))

    def _gc(self, params, query, body) -> tuple[int, Any]:
        return 200, self.service.gc()

    def _retention(self, params, query, body) -> tuple[int, Any]:
        return 200, self.service.retention_status()

    # ----------------------------------------------- operator write surface --
    def _put_retention(self, params, query, body) -> tuple[int, Any]:
        """Patch retention fields over the effective policy — no restart:
        the new policy applies to live state immediately and is persisted to
        the CAS operator document, so offline tools, restores, and a tailing
        follower all adopt it (DESIGN.md §9–§10)."""
        names = {f.name for f in dataclasses.fields(RetentionPolicy)}
        unknown = sorted(set(body) - names)
        if unknown:
            return 400, {"error": "invalid_body",
                         "detail": [f"unknown retention field(s): {unknown}"]}
        try:
            policy = dataclasses.replace(self.service.retention_policy,
                                         **body)
        except (TypeError, ValueError) as e:
            return 400, {"error": "invalid_retention", "detail": [str(e)]}
        self.service.set_retention(policy)
        return 200, self.service.retention_status()

    @staticmethod
    def _quota_errors(body: dict) -> list[str]:
        """Value validation for PUT quota bodies. ``TenantQuota`` itself
        does none, and a mistyped value (``"weight": "2"``) would pass
        construction, persist to the operator document, and then crash
        admission charging on every later submission *and* every restore —
        a poisoned config must die here, at the request."""
        errors = []
        for k in ("max_inflight_ops", "max_active_workflows"):
            v = body.get(k)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int) or v < 0):
                errors.append(f"{k!r} must be a non-negative integer or null")
        v = body.get("budget_usd")
        if v is not None and (isinstance(v, bool)
                              or not isinstance(v, (int, float)) or v < 0):
            errors.append("'budget_usd' must be a non-negative number "
                          "or null")
        if "weight" in body:
            v = body["weight"]
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v <= 0:
                errors.append("'weight' must be a positive number")
        return errors

    def _put_quota(self, params, query, body) -> tuple[int, Any]:
        """Replace one tenant's quota; written through to the CAS operator
        document like ``set_quota`` always was."""
        names = {f.name for f in dataclasses.fields(TenantQuota)}
        unknown = sorted(set(body) - names)
        if unknown:
            return 400, {"error": "invalid_body",
                         "detail": [f"unknown quota field(s): {unknown}"]}
        errors = self._quota_errors(body)
        if errors:
            return 400, {"error": "invalid_quota", "detail": errors}
        quota = TenantQuota(**body)
        self.service.set_quota(params["id"], quota)
        return 200, {"tenant": params["id"],
                     "quota": dataclasses.asdict(quota)}

    # ------------------------------------------------- worker data plane ----
    def _lease_transport(self):
        """The engine's transport when it leases to remote workers, else
        None (in-process transports have no worker-facing surface)."""
        t = getattr(self.service.engine, "transport", None)
        return t if getattr(t, "remote", False) else None

    def _worker_register(self, params, query, body) -> tuple[int, Any]:
        t = self._lease_transport()
        if t is None:
            return 409, {"error": "no_remote_transport",
                         "detail": ["this fabric executes in-process; "
                                    "serve with --remote-workers"]}
        wid = body.get("worker_id")
        cls = body.get("device_class")
        if not isinstance(wid, str) or not wid or not isinstance(cls, str):
            return 400, {"error": "invalid_body",
                         "detail": ["'worker_id' and 'device_class' must be "
                                    "non-empty strings"]}
        try:
            return 200, t.register(wid, cls)
        except KeyError:
            return 400, {"error": "unknown_device_class",
                         "device_class": cls}

    def _worker_lease(self, params, query, body) -> tuple[int, Any]:
        t = self._lease_transport()
        if t is None:
            return 409, {"error": "no_remote_transport"}
        wid = body.get("worker_id")
        if not isinstance(wid, str) or not wid:
            return 400, {"error": "invalid_body",
                         "detail": ["'worker_id' must be a non-empty string"]}
        try:
            # None = no work yet; the HTTP shim long-polls this route
            # (re-probing also refreshes lane liveness)
            return 200, {"lease": t.poll(wid)}
        except UnknownWorker:
            return 410, {"error": "unknown_worker", "worker_id": wid,
                         "detail": ["lane expired or was never registered; "
                                    "re-register and adopt the returned id"]}

    def _worker_heartbeat(self, params, query, body) -> tuple[int, Any]:
        t = self._lease_transport()
        if t is None:
            return 409, {"error": "no_remote_transport"}
        wid, lease_id = body.get("worker_id"), body.get("lease_id")
        if not isinstance(wid, str) or not isinstance(lease_id, str):
            return 400, {"error": "invalid_body",
                         "detail": ["'worker_id'/'lease_id' required"]}
        try:
            return 200, t.heartbeat(wid, lease_id)
        except FencedLease:
            return 410, {"error": "fenced_lease", "lease_id": lease_id}

    def _worker_complete(self, params, query, body) -> tuple[int, Any]:
        t = self._lease_transport()
        if t is None:
            return 409, {"error": "no_remote_transport"}
        wid, lease_id = body.get("worker_id"), body.get("lease_id")
        result = body.get("result")
        if not isinstance(wid, str) or not isinstance(lease_id, str) \
                or not isinstance(result, dict):
            return 400, {"error": "invalid_body",
                         "detail": ["'worker_id', 'lease_id' and a 'result' "
                                    "object are required"]}
        try:
            out = t.complete(wid, lease_id, result)
        except FencedLease:
            # the lease lapsed or was superseded: the result is discarded —
            # its groups were requeued and may already run elsewhere
            return 410, {"error": "fenced_lease", "lease_id": lease_id}
        except (KeyError, TypeError, ValueError) as e:
            # malformed result wire dict (missing field, bad base64)
            return 400, {"error": "invalid_result", "detail": [repr(e)]}
        return 200, out

    def _transport_status(self, params, query, body) -> tuple[int, Any]:
        return 200, self.service.engine.transport.status()

    # ----------------------------------------------------------- replication --
    def _replication(self, params, query, body) -> tuple[int, Any]:
        """This surface is a primary; a follower's ``FollowerAPI`` override
        reports tail lag instead. Alongside the head-ref entry this reports
        the liveness lease (is this primary *heartbeating*, DESIGN.md §14)
        and the auto-pump's health (is the engine being *driven*) — the
        two signals that distinguish a healthy primary from a wedged one
        that still answers HTTP."""
        svc = self.service
        out: dict[str, Any] = {"role": "primary",
                               "fenced": bool(getattr(svc, "fenced", False))}
        pump = getattr(svc, "pump_health", None)
        if pump is not None:
            out["pump"] = dict(pump)
        j = svc.journal
        if j is not None:
            key, epoch = j.cas.ref_entry(j.ref)
            lease = j.cas.ref_lease(j.ref)
            now = time.time()
            out["journal"] = {"ref": j.ref, "head": key, "epoch": epoch,
                              "pending": j.pending}
            out["journal"]["lease"] = {
                "ttl_s": j.lease_ttl_s,
                "held": lease > 0.0,
                "until": lease if lease > 0.0 else None,
                "remaining_s": (lease - now) if lease > 0.0 else None,
                "expired": lease > 0.0 and now >= lease,
            }
        return 200, out

    def _promote(self, params, query, body) -> tuple[int, Any]:
        return 409, {"error": "already_primary"}
