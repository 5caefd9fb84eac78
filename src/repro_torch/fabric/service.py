"""FabricService: the long-lived, tenant-facing front of the FlowMesh engine.

Where the batch-era entry point was ``Engine.submit() ... Engine.run()`` to
completion, the service keeps one engine *live*: declarative workflow specs
arrive (validated + compiled + admission-checked), become jobs with stable
ids, and the caller pumps the engine incrementally (``pump`` /
``run_until_idle``) while submitting, cancelling, and querying concurrently.
Nothing restarts between submissions — dedup, worker warmth, and the result
index all persist across the fabric's lifetime, which is exactly what makes
cross-tenant consolidation pay off.

The service is an **event-plane consumer** (DESIGN.md §7): it subscribes to
the engine's bus to maintain per-job event feeds (cursor-based incremental
reads behind ``GET /jobs/{id}/events``), optionally attaches a CAS-backed
``EventJournal``, and — after a restart — ``restore_from_journal`` replays
that journal to rebuild job records, lineage, per-tenant usage accounting,
and the result index (so dedup keeps working across restarts).
"""
from __future__ import annotations

import bisect
import enum

from repro_torch.core import events as E
from repro_torch.core.control_plane import EngineConfig, FlowMeshEngine
from repro_torch.core.cost_model import DEVICE_CLASSES
from repro_torch.core.dag import OpState, WorkflowDAG
from repro_torch.core.journal import EventJournal
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.scheduler import estimate_exec
from repro_torch.core.simulator import SimExecutor
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.tracing import TraceState
from repro_torch.core.worker import WorkerState

from .admission import AdmissionController, QuotaExceeded, TenantQuota
from .operator import save_operator_config
from .replay import (FEED_KINDS, TERMINAL_EVENT_KINDS, JobRecord,
                     ReplayState, RetentionPolicy, snapshot_fold,
                     trim_result_index, truncation_marker, window_feed)
from .spec import SpecError, compile_spec, render_template

DEFAULT_DEVICE_CLASSES = ("h100-nvl-94g", "rtx4090-48g", "rtx4090-24g")


class JobStatus(str, enum.Enum):
    REJECTED = "rejected"      # failed admission; never entered the engine
    QUEUED = "queued"          # submitted; arrival not yet processed
    RUNNING = "running"        # live in the engine
    COMPLETED = "completed"
    CANCELLED = "cancelled"


#: statuses with no further transitions — feed pollers stop here (single
#: source for the CLI tail, the HTTP long-poll, and the smoke scripts)
TERMINAL_STATUSES = frozenset((JobStatus.COMPLETED.value,
                               JobStatus.CANCELLED.value,
                               JobStatus.REJECTED.value))


class FabricService:
    """One shared fabric instance serving every tenant's workflows."""

    def __init__(self, *, engine: FlowMeshEngine | None = None,
                 admission: AdmissionController | None = None,
                 executor=None, policy=None, config: EngineConfig | None = None,
                 autoscaler=None,
                 device_classes: tuple[str, ...] = DEFAULT_DEVICE_CLASSES,
                 seed: int = 0,
                 retention: "RetentionPolicy | int | None" = None,
                 cas=None, journal: EventJournal | None = None,
                 transport=None) -> None:
        #: retention governs the fabric's footprint (DESIGN.md §9): terminal
        #: job records beyond ``max_terminal_jobs`` are evicted (usage
        #: accounting is unaffected), feeds are windowed to ``feed_window``
        #: events with an explicit truncation marker, and the compact_every_*
        #: thresholds drive scheduled journal compaction + GC. A plain int is
        #: accepted as ``max_terminal_jobs`` (the pre-policy signature).
        #: Precedence: this argument > ``EngineConfig.retention`` > default.
        cfg = config if config is not None else (
            engine.cfg if engine is not None else None)
        if retention is None:
            retention = getattr(cfg, "retention", None)
            self.retention_source = ("engine-config" if retention is not None
                                     else "default")
        else:
            self.retention_source = "flag"
        if retention is None:
            retention = RetentionPolicy()
        elif isinstance(retention, int):
            retention = RetentionPolicy(max_terminal_jobs=retention)
        self.retention_policy = retention
        self.admission = admission or AdmissionController()
        if engine is None:
            engine = FlowMeshEngine(
                policy=policy, executor=executor or SimExecutor(seed=seed),
                cas=cas, config=cfg or EngineConfig(seed=seed),
                autoscaler=autoscaler, admission=self.admission,
                transport=transport)
            # a remote transport has no bootstrap lanes: worker processes
            # join the data plane by registering (DESIGN.md §13)
            if not getattr(engine.transport, "remote", False):
                engine.bootstrap_workers(list(device_classes))
        else:
            engine.attach_admission(self.admission)
        self.engine = engine
        self.jobs: dict[str, JobRecord] = {}
        self._restored = False
        #: per-job event feeds: job_id -> [event dicts] (bus-seq ordered)
        self._feeds: dict[str, list[dict]] = {}
        #: feed truncation watermarks: job_id -> [dropped, last_dropped_seq]
        self._feed_trunc: dict[str, list[int]] = {}
        #: terminal-transition order — the same eviction queue the replay
        #: fold keeps, so a job evicted live cannot resurrect on restart
        self._terminal_order: list[str] = []
        self._terminal_seen: set[str] = set()
        #: replay-derived span trees (DESIGN.md §11): the live service runs
        #: the same TraceState fold over the bus that ReplayState runs over
        #: the journal, so GET /jobs/{id}/trace replays byte-identically
        self._trace = TraceState(
            span_window=retention.feed_window,
            max_producers=retention.max_result_index)
        #: tombstones for retention-evicted jobs: job_id -> {"tenant": ...}
        self.archived: dict[str, dict] = {}
        #: wall-clock metrics (DESIGN.md §11) — process-local by design,
        #: never journaled; one registry per service instance
        self.metrics = MetricsRegistry()
        self._m_events = self.metrics.counter(
            "fabric_events_total", "Events published on the engine bus",
            labels=("kind", "tenant"))
        #: bound counter handles per (kind, tenant) — label resolution is
        #: per-event cost; both label values come from closed sets so this
        #: cache is as bounded as the metric's own cardinality
        self._m_events_fast: dict[tuple[str, str], object] = {}
        self._m_pump = self.metrics.histogram(
            "fabric_pump_seconds", "Wall-clock duration of one pump() call")
        self._m_gc = self.metrics.histogram(
            "fabric_cas_gc_seconds",
            "Wall-clock duration of CAS mark-and-sweep")
        # one merged subscriber for feeds + trace + metrics: per-publish
        # fan-out cost is per-subscriber, and these three share the event
        self.engine.bus.subscribe(self._on_event)
        self.journal = journal
        if journal is not None:
            journal.metrics = self.metrics
            self.engine.bus.subscribe(journal.on_event)
        self.auto_compactions = 0
        self.last_retention: dict | None = None
        #: set when another process takes over this service's journal head
        #: (RefFencedError observed): the API layer refuses writes from
        #: then on — a zombie primary must not acknowledge work it can
        #: neither persist nor (with its pump stopped) run
        self.fenced = False
        #: written by the HTTP shim's auto-pump thread (errors survived,
        #: last error, liveness) — surfaced through health() and
        #: GET /admin/replication so a wedged pump is visible from outside
        self.pump_health: dict | None = None
        self._ref_dev = DEVICE_CLASSES["h100-nvl-94g"]

    # ------------------------------------------------------------ tenants --
    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        self.admission.set_quota(tenant, quota)
        self._persist_operator_config()

    def set_retention(self, policy: RetentionPolicy, *,
                      source: str = "api") -> None:
        """Adopt a new retention policy live (``PUT /admin/retention``):
        re-enforce it on existing state immediately — window feeds, evict
        terminal records and index entries beyond the new caps ("keep the
        newest N" composes, so this equals having run under the policy all
        along) — and persist it to the CAS operator document so offline
        tools, restores, and a tailing follower agree without a restart."""
        self.retention_policy = policy
        self.retention_source = source
        for jid in list(self._feeds):
            window_feed(self._feeds, self._feed_trunc, jid,
                        policy.feed_window)
        self._trace.set_caps(policy.feed_window, policy.max_result_index)
        self._evict_terminal()
        self._persist_operator_config()

    def _persist_operator_config(self) -> None:
        """Write-through of operator config (quotas + retention) to the CAS
        behind the journal, so offline ``fabric_cli.py compact`` and future
        restores fold with the same fair-share weights this live service
        charges by (DESIGN.md §9). No journal => nothing durable to agree
        with => nothing to persist."""
        if self.journal is not None:
            save_operator_config(self.journal.cas, self.admission,
                                 self.retention_policy)

    # ------------------------------------------------------- event plane ----
    def _on_event(self, e: E.FabricEvent) -> None:
        """Bus subscriber: feeds + trace fold + metrics in one pass.

        Routes job-scoped events into per-job feeds (windowed under the
        retention policy — the same trim the replay fold applies, so
        restored feeds match live ones), feeds the trace fold (attribute
        indirection so restore/follower sync can swap the fold object),
        counts the event, and holds the live dedup index at its policy cap
        at the same event-stream point the fold trims (group_completed),
        so LFU eviction picks identical victims live and on replay."""
        kind = e.kind
        self._trace.apply(e)
        # cardinality stays ≤ tenants × event kinds: both label values come
        # from closed sets ("-" covers system events with no tenant)
        tenant = e.__dict__.get("tenant") or "-"
        counter = self._m_events_fast.get((kind, tenant))
        if counter is None:
            counter = self._m_events_fast[(kind, tenant)] = \
                self._m_events.child(kind=kind, tenant=tenant)
        counter.inc()
        if kind == "group_completed":
            # the engine inserted into the index just before emitting, so
            # trimming here mirrors the fold's per-apply trim exactly
            trim_result_index(self.engine.result_index,
                              self.retention_policy.max_result_index,
                              self.engine.result_index_hits)
        if kind not in FEED_KINDS:
            return
        dag_id = e.__dict__.get("dag_id")
        if dag_id in self.jobs:
            self._feeds.setdefault(dag_id, []).append(e.to_dict())
            window_feed(self._feeds, self._feed_trunc, dag_id,
                        self.retention_policy.feed_window)
            if kind in TERMINAL_EVENT_KINDS \
                    and dag_id not in self._terminal_seen:
                self._terminal_seen.add(dag_id)
                self._terminal_order.append(dag_id)

    def events(self, job_id: str, since: int = -1,
               limit: int | None = None) -> dict | None:
        """Cursor-based incremental read of one job's event feed.

        Returns events with bus seq strictly greater than ``since`` (so a
        client that remembers the returned ``cursor`` resumes without
        duplicates or gaps, across ``pump()`` boundaries and across a
        journal-restored restart) plus the job's current status — pollers
        stop when the status is terminal and the feed is drained.

        When retention has windowed the feed, a cursor that predates the
        window start receives one synthetic ``feed_truncated`` entry ahead
        of the retained events (and ``truncated: true`` on the response) —
        history is never silently skipped (DESIGN.md §9). The marker's seq
        is the last dropped event's, so after it is consumed the cursor has
        moved past the gap and no later poll sees it again.
        """
        rec = self.jobs.get(job_id)
        if rec is None:
            return None
        feed = self._feeds.get(job_id, [])
        # feeds append in bus-seq order, so the resume point is a bisect,
        # not a scan — long-polling re-probes this under the API lock
        start = bisect.bisect_right(feed, since, key=lambda d: d["seq"])
        out = feed[start:] if limit is None else feed[start:start + limit]
        resp = {
            "job_id": job_id,
            "status": self._status(rec).value,
            "events": out,
            "cursor": out[-1]["seq"] if out else since,
        }
        trunc = self._feed_trunc.get(job_id)
        if trunc is not None and since < trunc[1]:
            # marker rides outside `limit`: it reports the gap, it is not
            # one of the requested events
            resp["events"] = [truncation_marker(job_id, *trunc), *out]
            resp["truncated"] = True
        return resp

    # ----------------------------------------------------------- restore ----
    def restore_from_journal(self, journal: EventJournal | None = None,
                             ) -> dict:
        """Rebuild service state from a journaled event history.

        Loads the chain's snapshot node (if compaction has run), then folds
        the tail oldest-first — both through the same ``ReplayState`` the
        compactor uses, so a snapshot+tail restore is byte-identical to a
        full-chain replay. Rebuilt: job records (per-op states, lineage
        rows), per-job feeds (original seqs — tenant cursors resume without
        gaps), per-tenant usage accounting, and the engine's result index
        (artifacts still in the CAS keep deduping across the restart).
        Jobs that were live mid-journal are closed out as cancelled with an
        ``interrupted`` error — their in-flight engine state is gone; thanks
        to the result index a resubmission only pays for unfinished ops.
        """
        journal = journal if journal is not None else self.journal
        if journal is None:
            raise ValueError("no journal attached and none given")
        if self.jobs or self._restored:
            # replaying into a non-fresh service would double every usage
            # charge and re-append feed events under their original seqs
            raise ValueError("restore_from_journal requires a fresh service")
        self._restored = True
        state = ReplayState(self.admission, retention=self.retention_policy)
        base = journal.base_state()
        from_snapshot = 0
        if base is not None:
            state.load(base)
            from_snapshot = state.events
        for e in journal.replay():
            state.apply(e)
        self.jobs = state.jobs
        self._feeds = state.feeds
        self._feed_trunc = state.feed_trunc
        self._terminal_order = list(state.terminal)
        self._terminal_seen = set(state.terminal)
        self._trace = state.trace
        self.archived = state.archived
        # the scheduled-retention trigger counts the un-folded tail; a fresh
        # journal object starts at zero even over a long chain — sync it so
        # auto-compaction does not sleep through the first post-restart spell
        stats = journal.chain_stats()
        journal.segments_since_compact = (
            stats["segments"] - (1 if stats["snapshot"] else 0))
        journal.bytes_since_compact = stats["tail_bytes"]
        for h_task, key in state.result_index.items():
            if key in self.engine.cas:
                # dedup across restarts: the artifact survived in the CAS
                self.engine.result_index[h_task] = key
                hits = state.result_index_hits.get(h_task)
                if hits:
                    # hit counts follow surviving entries so LFU eviction
                    # keeps ranking them after the restart
                    self.engine.result_index_hits[h_task] = hits
        self.engine.bus.advance_past(state.max_seq)
        self.engine.now = max(self.engine.now,
                              max((r.completed_at or r.submitted_at
                                   for r in self.jobs.values()), default=0.0))
        self.engine._last_progress = self.engine.now
        interrupted = 0
        for rec in self.jobs.values():
            if (rec.submitted and not rec.cancelled
                    and rec.completed_at is None and rec.dag is None):
                rec.cancelled = True
                rec.error = "interrupted by fabric restart"
                self.admission.replay_interrupted(rec.tenant)
                interrupted += 1
                if rec.job_id not in self._terminal_seen:
                    self._terminal_seen.add(rec.job_id)
                    self._terminal_order.append(rec.job_id)
        # in-flight scheduling counters died with the old process
        self.admission.reset_transients()
        return {"events": state.events, "jobs": len(self.jobs),
                "interrupted": interrupted, "from_snapshot": from_snapshot}

    # -------------------------------------------------------- retention ----
    def compact(self, *, keep_segments: int = 0) -> dict:
        """Fold the journal's oldest segments into a snapshot node
        (DESIGN.md §8) using this service's quota configuration AND
        retention policy for the fold — the snapshot drops exactly what a
        retention-trimmed replay would (DESIGN.md §9). Leaves live state
        untouched — only the durable chain changes; the old segments become
        garbage for ``gc`` to reclaim."""
        if self.journal is None:
            raise ValueError("no journal attached")
        return self.journal.compact(
            snapshot_fold(self.admission, retention=self.retention_policy),
            keep_segments=keep_segments)

    def maybe_retain(self) -> dict | None:
        """The scheduled-retention hook: compact (+ gc) once the un-folded
        journal tail crosses the policy's segment/byte thresholds, keeping
        the ``keep_segments`` floor for tail consumers. Called from ``pump``
        (virtual-time driver) and the HTTP shim's pump thread; O(1) when not
        due. Returns the compact/gc stats when it fired, else None."""
        p, j = self.retention_policy, self.journal
        if j is None or not p.auto_compaction:
            return None
        due = ((p.compact_every_segments is not None
                and j.segments_since_compact >= p.compact_every_segments)
               or (p.compact_every_bytes is not None
                   and j.bytes_since_compact >= p.compact_every_bytes))
        # never thrash at the floor: only fire when there is tail to fold
        if not due or j.segments_since_compact <= p.keep_segments:
            return None
        out = {"at": self.engine.now,
               "compact": self.compact(keep_segments=p.keep_segments)}
        # the live dedup cache roots its artifacts through gc — trim it to
        # the policy cap (LFU/recency hybrid) or the store never shrinks
        # under dedup-disabled baselines
        trim_result_index(self.engine.result_index, p.max_result_index,
                          self.engine.result_index_hits)
        if p.gc_on_compact:
            out["gc"] = self.gc()
        self.auto_compactions += 1
        self.last_retention = out
        return out

    def retention_status(self) -> dict:
        """The ``GET /admin/retention`` surface: effective policy (and where
        it came from), live footprint, and scheduled-compaction history."""
        out = {
            "policy": self.retention_policy.to_dict(),
            "source": self.retention_source,
            "auto_compactions": self.auto_compactions,
            "last": self.last_retention,
            "jobs": len(self.jobs),
            "feeds": sum(len(f) for f in self._feeds.values()),
            "feeds_truncated": len(self._feed_trunc),
        }
        if self.journal is not None:
            out["journal"] = self.journal.chain_stats()
        return out

    def gc(self, extra_roots: tuple[str, ...] = ()) -> dict:
        """Mark-and-sweep the engine's CAS. Roots: every named ref (journal
        heads), the live result index's artifacts, the resolved inputs of
        every live workflow (interned literals are in no journaled event
        until ``op_completed`` — an in-flight op must still find them), and
        ``extra_roots``. The journal buffer is flushed first so nothing
        reachable only through pending events is swept."""
        with self._m_gc.time():
            if self.journal is not None:
                self.journal.flush()
            roots = set(extra_roots) | set(self.engine.result_index.values())
            for dag in self.engine.dags.values():
                for hashes in dag.input_hashes.values():
                    roots.update(hashes)
                roots.update(dag.output_hash.values())
            return self.engine.cas.gc(roots=roots)

    # ----------------------------------------------------------- submit ----
    def submit(self, doc: dict) -> dict:
        """Validate, compile, admission-check, and enqueue one spec document.

        Returns the job view. Raises ``SpecError`` for malformed documents;
        quota rejections do NOT raise — they return a ``rejected`` job so the
        tenant can inspect the reason through the normal job API.
        """
        dag = compile_spec(doc)
        # the dag-N counter is process-local: after a journal restore the
        # restarted process starts at dag-0 again, which must not clobber a
        # restored record (or any still-queryable terminal job)
        while dag.dag_id in self.jobs or dag.dag_id in self.engine.dags:
            dag = compile_spec(doc)
        rec = JobRecord(job_id=dag.dag_id, tenant=dag.tenant, dag=dag,
                        submitted=False, submitted_at=self.engine.now)
        self.jobs[rec.job_id] = rec
        try:
            self.admission.admit_workflow(dag)
        except QuotaExceeded as e:
            rec.error = e.reason
            self.engine.bus.publish(E.JobRejected(
                time=self.engine.now, dag_id=rec.job_id, tenant=rec.tenant,
                reason=e.reason, ops=tuple(dag.ops)))
            self._evict_terminal()       # a rejection flood must not pile up
            return self.job(rec.job_id)
        rec.submitted = True
        self.engine.submit(dag, at=self.engine.now)
        self._evict_terminal()
        return self.job(rec.job_id)

    def submit_template(self, name: str, **params) -> dict:
        return self.submit(render_template(name, **params))

    def cancel(self, job_id: str) -> dict | None:
        rec = self.jobs.get(job_id)
        if rec is None:
            return None
        if rec.submitted and not rec.cancelled and rec.dag is not None \
                and not self._dag(rec).done:
            if self.engine.cancel(job_id):
                rec.cancelled = True     # accounting flows from the event
        return self.job(job_id)

    # ------------------------------------------------------------- drive ----
    def pump(self, max_steps: int | None = None,
             until: float | None = None) -> int:
        """Advance the live engine by up to ``max_steps`` events (or until
        virtual time ``until``). Returns the number of events processed."""
        with self._m_pump.time():
            self.engine._arm_recurring()
            steps = 0
            while max_steps is None or steps < max_steps:
                if self.engine.idle or not self.engine.step(until):
                    break
                steps += 1
            # wall-clock liveness for remote lessees (lease expiry, silent
            # lanes) — a no-op on the in-process transport
            self.engine.transport.tick()
            self.maybe_retain()
        return steps

    def run_until_idle(self, until: float | None = None):
        tel = self.engine.run_until_idle(until)
        if self.journal is not None:
            self.journal.flush()       # idle point: make history durable
        self.maybe_retain()
        return tel

    def _evict_terminal(self) -> None:
        """Drop the oldest terminal job records (and their engine-side DAG
        state and event feed) once more than the policy's
        ``max_terminal_jobs`` have accumulated — in terminal-transition
        order, the same eviction queue the replay fold keeps, so a job
        evicted live cannot resurrect after a restart. Also holds the live
        dedup index at its policy cap."""
        trim_result_index(self.engine.result_index,
                          self.retention_policy.max_result_index,
                          self.engine.result_index_hits)
        cap = self.retention_policy.max_terminal_jobs
        if cap is None:
            return
        # hysteresis: trim back to the cap only once ~10% over it, so at
        # steady state the O(jobs) scan amortizes to O(1) per submission
        if len(self.jobs) <= max(cap + 1, int(cap * 1.1)):
            return
        evictable = [
            jid for jid in self._terminal_order
            if jid in self.jobs
            # a job cancelled before its arrival event fired must keep its
            # engine.cancelled entry until the event is consumed, or the
            # arrival would resurrect the workflow and corrupt accounting
            and not (self.jobs[jid].cancelled and jid in self.engine.cancelled
                     and jid not in self.engine.dags)]
        for jid in evictable[:max(0, len(evictable) - cap)]:
            # tombstone first: GET /jobs/{id} degrades to 410 "archived"
            # instead of a bare 404 (re-insert keeps last-eviction order)
            self.archived.pop(jid, None)
            self.archived[jid] = {"tenant": self.jobs[jid].tenant}
            del self.jobs[jid]
            self._feeds.pop(jid, None)
            self._feed_trunc.pop(jid, None)
            self._trace.drop_job(jid)
            self.engine.dags.pop(jid, None)
            self.engine.cancelled.discard(jid)
        trim_result_index(self.archived, cap)
        self._terminal_order = [j for j in self._terminal_order
                                if j in self.jobs]
        self._terminal_seen = set(self._terminal_order)

    # ------------------------------------------------------------- query ----
    def _dag(self, rec: JobRecord) -> WorkflowDAG:
        # monolithic baseline policies replace the DAG at submission; the
        # engine's registry holds the live object once it has arrived
        return self.engine.dags.get(rec.job_id, rec.dag)

    def _status(self, rec: JobRecord) -> JobStatus:
        if not rec.submitted:
            return JobStatus.REJECTED
        if rec.cancelled:
            return JobStatus.CANCELLED
        if rec.dag is None:                      # journal-restored record
            if rec.completed_at is not None:
                return JobStatus.COMPLETED
            # synthesize RUNNING from the op events the fold has seen: a
            # follower (or a not-yet-closed restore) knows work started the
            # moment any op left `pending` — reporting `queued` until the
            # terminal event made "caught up" indistinguishable from
            # "primary silent" on the standby surface
            if any(s != "pending" for s in rec.op_states.values()):
                return JobStatus.RUNNING
            return JobStatus.QUEUED
        if self._dag(rec).done:
            return JobStatus.COMPLETED
        if rec.job_id in self.engine.dags:
            return JobStatus.RUNNING
        return JobStatus.QUEUED

    def job(self, job_id: str, *, deadline_view: bool = True) -> dict | None:
        rec = self.jobs.get(job_id)
        if rec is None:
            return None
        dag = self._dag(rec)
        if dag is not None:
            ops = {n: s.value for n, s in dag.state.items()}
            metadata = dag.metadata
            completed_at = dag.completed_at
            latency = dag.latency
        else:                                    # journal-restored record
            ops = dict(rec.op_states)
            metadata = rec.metadata
            completed_at = rec.completed_at
            latency = (None if completed_at is None
                       else completed_at - rec.submitted_at)
        out = {
            "job_id": rec.job_id,
            "tenant": rec.tenant,
            "status": self._status(rec).value,
            "submitted_at": rec.submitted_at,
            "ops": ops,
            "metadata": metadata,
        }
        if rec.error:
            out["error"] = rec.error
        if completed_at is not None:
            out["completed_at"] = completed_at
            out["latency_s"] = latency
        deadline = metadata.get("deadline_s") if metadata else None
        if deadline is not None and deadline_view:
            out["deadline"] = self._deadline_view(
                rec, dag, float(deadline), latency)
        return out

    def _deadline_view(self, rec: JobRecord, dag: WorkflowDAG | None,
                       deadline_s: float, latency: float | None) -> dict:
        """SLO surface for ``GET /jobs/{id}``: compare the deadline against
        the realized latency (terminal jobs) or elapsed time + the
        critical-path estimate of the remaining ops (live jobs)."""
        view = {"deadline_s": deadline_s}
        if latency is not None:                  # terminal: realized outcome
            view["predicted_miss"] = latency > deadline_s
            view["critical_path_s"] = 0.0
            return view
        if dag is None:                          # restored + interrupted
            view["predicted_miss"] = True
            return view
        remaining = self._critical_path_s(dag)
        elapsed = max(0.0, self.engine.now - rec.submitted_at)
        view["critical_path_s"] = round(remaining, 3)
        view["predicted_miss"] = elapsed + remaining > deadline_s
        return view

    def _critical_path_s(self, dag: WorkflowDAG) -> float:
        """Longest chain of estimated single-instance durations over the
        DAG's incomplete ops on the reference device (optimistic: hot model,
        no queueing) — the paper's predicted-miss signal, not a guarantee."""
        memo: dict[str, float] = {}

        def path(name: str) -> float:
            if dag.state.get(name) is OpState.COMPLETED:
                return 0.0
            if name in memo:
                return memo[name]
            dur, _, _ = estimate_exec(dag.ops[name], 1, self._ref_dev,
                                      hot=True)
            memo[name] = dur + max((path(p) for p in dag.parents(name)),
                                   default=0.0)
            return memo[name]

        return max((path(n) for n in dag.ops), default=0.0)

    def list_jobs(self, tenant: str | None = None) -> list[dict]:
        # listings skip the per-job critical-path walk (O(ops) each, and
        # /jobs may enumerate thousands) — the single-job GET carries it
        return [self.job(jid, deadline_view=False)
                for jid, rec in self.jobs.items()
                if tenant is None or rec.tenant == tenant]

    def trace(self, job_id: str, *, chrome: bool = False) -> object | None:
        """One workflow's span tree (``GET /jobs/{id}/trace``), or its
        Chrome ``trace_event`` export with ``chrome=True``. Replay-derived:
        the primary, a tailing follower, and a journal-restored service all
        return byte-identical documents for the same job. ``None`` for
        unknown jobs; a job restored from a pre-trace snapshot answers with
        an empty tree (its history predates the fold's cut)."""
        if job_id not in self.jobs:
            return None
        if chrome:
            out = self._trace.chrome_trace(job_id)
            return out if out is not None else []
        tree = self._trace.span_tree(job_id)
        if tree is None:
            return {"job_id": job_id, "spans": [], "edges": [],
                    "truncated": False}
        return tree

    def lineage(self, job_id: str) -> list[dict] | None:
        """Per-edge provenance: ``executed=False`` rows are op-instances that
        were satisfied by another tenant's run or the result index."""
        rec = self.jobs.get(job_id)
        if rec is None:
            return None
        dag = self._dag(rec)
        if dag is None:                          # journal-restored record
            return sorted(rec.lineage_rows, key=lambda r: r["t_complete"])
        return [{
            "op": l.op, "executed": l.executed, "worker": l.worker,
            "output_hash": l.output_hash, "input_hashes": list(l.input_hashes),
            "h_task": l.h_task, "t_complete": l.t_complete,
        } for l in dag.replay_order()]

    def usage(self, tenant: str) -> dict:
        out = self.admission.usage_snapshot(tenant)
        stats = self.engine.pool.stats
        out["pool"] = {
            "ops_arrived": stats.arrived_by_tenant.get(tenant, 0),
            "dedup_joins": stats.joins_by_tenant.get(tenant, 0),
        }
        # single source for latency: the engine's policy-neutral telemetry
        xs = self.engine.telemetry.tenant_latencies.get(tenant, [])
        out["latency"] = {
            "p50_s": round(Telemetry.percentile(xs, 0.50), 2),
            "p99_s": round(Telemetry.percentile(xs, 0.99), 2),
        }
        return out

    def health(self) -> dict:
        eng = self.engine
        by_status: dict[str, int] = {}
        for rec in self.jobs.values():
            s = self._status(rec).value
            by_status[s] = by_status.get(s, 0) + 1
        workers = list(eng.workers.values())
        out = {
            "status": "stalled" if eng.stalled else "ok",
            "now": eng.now,
            "idle": eng.idle,
            "workers": {
                "total": len(workers),
                "active": sum(1 for w in workers
                              if w.state is WorkerState.ACTIVE),
            },
            "pool_depth": eng.pool.depth,
            "jobs": by_status,
            "tenants": sorted({r.tenant for r in self.jobs.values()}),
            "executions": eng.telemetry.executions,
            "dedup_savings": eng.telemetry.dedup_savings,
        }
        # live meter integrals (run_until_idle's CostSnapshot never fires
        # under pump-driven operation, so the scenario engine reads them here)
        cost, energy = eng.cost_energy()
        out["cost"] = {"total_usd": round(cost, 6),
                       "total_energy_j": round(energy, 3)}
        if self.journal is not None:
            # `written` counts this process only — after a restore the
            # durable history lives behind `head`, not in this counter
            out["journal"] = {"head": self.journal.head,
                              "written": self.journal.events_written,
                              "pending": self.journal.pending}
        if self.pump_health is not None:
            out["pump"] = dict(self.pump_health)
        return out
