"""The event fold shared by journal restore and journal compaction.

``ReplayState`` rebuilds tenant-observable service state from the typed
event stream: job records (per-op states, lineage rows), per-job feeds
(original bus seqs — cursors resume without gaps), the result index, and —
through the attached ``AdmissionController``'s ``on_event`` — per-tenant
usage accounting. It is the *only* body that interprets history:

  * ``FabricService.restore_from_journal`` folds (snapshot base + tail
    events) through it after a restart;
  * ``EventJournal.compact`` folds the oldest segments through it and
    serializes ``to_blob()`` as the chain's snapshot node (DESIGN.md §8).

Because both paths run the same fold, restore-from-(snapshot+tail) is
byte-identical to restore-from-full-replay — the crash/replay harness
(tests/harness.py) asserts exactly this for arbitrary compaction points.
"""
from __future__ import annotations

from collections import deque
from dataclasses import asdict, dataclass, field, fields
from itertools import islice

from repro_torch.core import events as E
from repro_torch.core.dag import OpState, WorkflowDAG
from repro_torch.core.tracing import TraceState

from .admission import AdmissionController

#: event kinds that appear in a job's tenant-visible feed
FEED_KINDS = {"workflow_submitted", "op_ready", "dedup_hit", "op_completed",
              "workflow_completed", "workflow_cancelled", "job_rejected"}

#: snapshot blob schema version (bump on incompatible fold-state changes)
#: v2: retention-trimmed folds (terminal-job eviction order + feed
#: truncation watermarks travel with the snapshot)
#: v3: trace fold state + archived-job tombstones travel with the snapshot
#: v4: result-index dedup hit counts travel with the snapshot (the
#: LFU/recency eviction hybrid needs them to stay live/replay-identical)
SNAPSHOT_FORMAT = 4

#: kind of the synthetic feed entry that marks windowed-away history; never
#: published on the bus or journaled — ``FabricService.events`` synthesizes
#: it per read so a cursor that predates the window start observes the loss
#: exactly once instead of silently skipping it (DESIGN.md §9)
TRUNCATED_KIND = "feed_truncated"

#: statuses of terminal events that start the retention clock for a job
TERMINAL_EVENT_KINDS = ("workflow_completed", "workflow_cancelled",
                        "job_rejected")

#: lease-transport narration (DESIGN.md §13). Journaled like every other
#: event — history must show *why* a group requeued — but deliberately
#: excluded from job feeds, traces, and every replay fold: the engine-side
#: consequences of a lease (requeue on lapse, finish on revoke) are already
#: carried by ``GroupRequeued``/``WorkerFailed``, so folding lease events
#: too would double-count, and a journal written by a lease fabric must
#: restore byte-identically on a fabric that has never seen a lease.
LEASE_KINDS = frozenset(("lease_granted", "lease_expired", "lease_revoked"))
assert not (LEASE_KINDS & FEED_KINDS)


@dataclass(frozen=True)
class RetentionPolicy:
    """What a bounded fabric may forget, and when to fold the journal.

    The first two fields govern *state* retention and are applied
    identically by the live service and the replay fold (DESIGN.md §9):

      * ``max_terminal_jobs`` — keep at most N terminal (completed /
        cancelled / rejected) job records; older ones are evicted together
        with their feeds. ``None`` = unbounded. Usage accounting is never
        affected by eviction.
      * ``feed_window`` — cap each per-job feed at the newest K events; a
        read whose cursor predates the window start sees one synthetic
        ``feed_truncated`` marker (never silent loss). ``None`` = unbounded.
      * ``max_result_index`` — cap the result index at N entries, evicted
        by an LFU/recency hybrid (least-dedup-hit among the stalest; exact
        oldest-first when no entry has hits). The index is a dedup cache,
        so eviction only costs re-execution — but without a cap the
        dedup-disabled baseline policies accrete one artifact-rooting entry
        per job forever, and the CAS can never shrink. ``None`` = unbounded.

    The rest schedule *durable* retention: the serve loop triggers
    ``compact`` + ``gc`` once the un-folded journal tail exceeds
    ``compact_every_segments`` segments or ``compact_every_bytes`` bytes,
    always keeping a ``keep_segments`` floor for tail consumers.
    """
    max_terminal_jobs: int | None = 10_000
    feed_window: int | None = None
    max_result_index: int | None = None
    compact_every_segments: int | None = None
    compact_every_bytes: int | None = None
    keep_segments: int = 2
    gc_on_compact: bool = True

    def __post_init__(self) -> None:
        if self.max_terminal_jobs is not None and self.max_terminal_jobs < 0:
            raise ValueError("max_terminal_jobs must be >= 0 or None")
        if self.feed_window is not None and self.feed_window < 1:
            raise ValueError("feed_window must be >= 1 or None")
        if self.max_result_index is not None and self.max_result_index < 0:
            raise ValueError("max_result_index must be >= 0 or None")
        if self.keep_segments < 0:
            raise ValueError("keep_segments must be >= 0")
        for name in ("compact_every_segments", "compact_every_bytes"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1 or None")
        if (self.compact_every_segments is not None
                and self.compact_every_segments <= self.keep_segments):
            # otherwise the trigger is permanently due while the tail can
            # never shrink below its floor — compaction would thrash
            raise ValueError("compact_every_segments must exceed "
                             "keep_segments")

    @property
    def auto_compaction(self) -> bool:
        return (self.compact_every_segments is not None
                or self.compact_every_bytes is not None)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RetentionPolicy":
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def truncation_marker(job_id: str, dropped: int, last_seq: int) -> dict:
    """The synthetic feed entry for windowed-away history. Its ``seq`` is
    the *last dropped* event's seq, so cursor arithmetic consumes it exactly
    once: a client resuming at or past it never sees it again, and every
    retained event (all with larger seqs) still follows it in order."""
    return {"kind": TRUNCATED_KIND, "seq": last_seq, "dag_id": job_id,
            "dropped": dropped}


def window_feed(feeds: dict[str, list[dict]], trunc: dict[str, list[int]],
                job_id: str, window: int | None) -> None:
    """Trim one feed to its newest ``window`` events, advancing the
    truncation watermark ``trunc[job_id] = [dropped_total, last_dropped_seq]``.

    Shared by the live service (``FabricService._on_event``) and the replay
    fold so a windowed restore is byte-identical to a windowed replay:
    "keep the newest K" composes — trimming a snapshot and then folding the
    tail drops exactly the events a full trimmed replay would have dropped,
    and the cumulative dropped counts agree.
    """
    feed = feeds.get(job_id)
    if window is None or feed is None or len(feed) <= window:
        return
    drop = len(feed) - window
    entry = trunc.setdefault(job_id, [0, -1])
    entry[0] += drop
    entry[1] = max(entry[1], feed[drop - 1]["seq"])
    del feed[:drop]


#: how many entries beyond the excess the LFU hybrid considers per trim —
#: a small fixed window keeps the per-event cost O(1) while still letting a
#: frequently-re-derived entry outlive younger never-hit ones
_LFU_WINDOW = 8


def trim_result_index(index: dict[str, str], cap: int | None,
                      hits: dict[str, int] | None = None) -> None:
    """Evict result-index entries beyond ``cap``.

    Without ``hits`` (or with an all-zero window): keep the newest ``cap``
    entries (insertion order — the fold re-inserts on every write AND on
    every index dedup hit, so order is last-use recency). With ``hits``
    (H_task -> dedup hit count): an LFU/recency hybrid — among the stalest
    ``excess + _LFU_WINDOW`` entries, evict the least-hit first, breaking
    ties oldest-first. Because the sort is stable, zero hit counts degrade
    EXACTLY to the legacy oldest-first order. Evicting a dedup entry is
    always safe: the worst case is re-executing the op. Live service and
    replay fold call this at identical event-stream points with identical
    (index order, hits) state, so trimmed restores equal trimmed replays.
    At steady state the excess is one entry, so the cost stays O(1)."""
    if cap is None or len(index) <= cap:
        return
    excess = len(index) - cap
    if not hits:
        for h in list(islice(iter(index), excess)):
            del index[h]
        return
    cand = list(islice(iter(index), excess + _LFU_WINDOW))
    cand.sort(key=lambda h: hits.get(h, 0))     # stable: ties stay stalest-first
    for h in cand[:excess]:
        del index[h]
        hits.pop(h, None)

#: JobRecord fields carried by a snapshot (``dag`` is live-only state)
_RECORD_FIELDS = ("job_id", "tenant", "submitted", "submitted_at", "error",
                  "cancelled", "op_states", "lineage_rows", "metadata",
                  "completed_at")


@dataclass
class JobRecord:
    job_id: str
    tenant: str
    submitted: bool            # False => rejected at admission
    submitted_at: float
    #: live records hold the compiled DAG; journal-restored records hold
    #: None and answer queries from the event-sourced fields below
    dag: WorkflowDAG | None = None
    error: str | None = None
    cancelled: bool = False
    op_states: dict[str, str] = field(default_factory=dict)
    lineage_rows: list[dict] = field(default_factory=list)
    metadata: dict = field(default_factory=dict)
    completed_at: float | None = None

    def to_dict(self) -> dict:
        return {name: getattr(self, name) for name in _RECORD_FIELDS}

    @classmethod
    def from_dict(cls, d: dict) -> "JobRecord":
        return cls(dag=None, **{name: d[name] for name in _RECORD_FIELDS})


class ReplayState:
    """Fold of journaled history into restorable service state.

    With a ``RetentionPolicy`` the fold is *retention-trimmed*: terminal
    jobs beyond the cap are evicted (in terminal-transition order) and
    feeds are windowed as events are applied — so a snapshot written by a
    trimmed fold stops growing with total history, and restoring it plus
    the tail equals a trimmed replay of the full chain.
    """

    def __init__(self, admission: AdmissionController | None = None,
                 retention: RetentionPolicy | None = None) -> None:
        self.admission = admission or AdmissionController()
        self.retention = retention or RetentionPolicy()
        self.jobs: dict[str, JobRecord] = {}
        self.feeds: dict[str, list[dict]] = {}
        #: job_id -> [dropped_total, last_dropped_seq] per windowed feed
        self.feed_trunc: dict[str, list[int]] = {}
        #: job ids in terminal-transition order — the eviction queue (a
        #: deque: at-cap folds evict one id per terminal event, and a list's
        #: pop(0) would make a long-chain replay quadratic in history)
        self.terminal: deque[str] = deque()
        self._terminal_set: set[str] = set()
        self.result_index: dict[str, str] = {}   # unfiltered: h_task -> key
        #: h_task -> dedup hit count (DedupHit source="index" events) —
        #: mirrors the engine's ``result_index_hits`` so LFU eviction picks
        #: the same victims live and on replay
        self.result_index_hits: dict[str, int] = {}
        #: replay-derived span trees (DESIGN.md §11) — windowed in lockstep
        #: with the feed window and the result-index cap
        self.trace = TraceState(
            span_window=self.retention.feed_window,
            max_producers=self.retention.max_result_index)
        #: job_id -> {"tenant": ...} tombstones for retention-evicted jobs,
        #: in eviction order; bounded by the same terminal cap so the
        #: archived map cannot regrow what eviction reclaimed
        self.archived: dict[str, dict] = {}
        self.max_seq = -1
        self.events = 0

    # ------------------------------------------------------------- fold ----
    def apply(self, e: E.FabricEvent) -> None:
        """Fold one journaled event — mirrors exactly what the live service
        derives from the same event on the bus."""
        self.events += 1
        self.max_seq = max(self.max_seq, e.seq)
        kind = e.kind
        if kind == "workflow_submitted":
            self.jobs[e.dag_id] = JobRecord(
                job_id=e.dag_id, tenant=e.tenant, submitted=True,
                submitted_at=e.time, dag=None,
                op_states={op: OpState.PENDING.value for op in e.ops},
                metadata=dict(e.metadata))
        elif kind == "job_rejected":
            self.jobs[e.dag_id] = JobRecord(
                job_id=e.dag_id, tenant=e.tenant, submitted=False,
                submitted_at=e.time, dag=None, error=e.reason,
                op_states={op: OpState.PENDING.value for op in e.ops})
        else:
            rec = self.jobs.get(getattr(e, "dag_id", None))
            if kind == "op_ready" and rec is not None:
                rec.op_states[e.op] = OpState.READY.value
            elif kind == "op_completed" and rec is not None:
                rec.op_states[e.op] = OpState.COMPLETED.value
                rec.lineage_rows.append({
                    "op": e.op, "executed": e.executed, "worker": e.worker,
                    "output_hash": e.output_hash,
                    "input_hashes": list(e.input_hashes),
                    "h_task": e.h_task, "t_complete": e.time,
                })
            elif kind == "dedup_hit":
                if rec is not None:
                    rec.op_states[e.op] = OpState.COMPLETED.value
                if e.source == "index" and e.h_task in self.result_index:
                    # mirror the engine: hit bump + recency touch (the entry
                    # may be absent under a tighter restore-time policy —
                    # then the live hit simply has nothing to touch here)
                    self.result_index_hits[e.h_task] = \
                        self.result_index_hits.get(e.h_task, 0) + 1
                    self.result_index[e.h_task] = \
                        self.result_index.pop(e.h_task)
            elif kind == "workflow_completed" and rec is not None:
                rec.completed_at = e.time
            elif kind == "workflow_cancelled":
                if rec is None:
                    # defensive: a journal whose submission event predates
                    # the chain (e.g. written before submissions were
                    # journaled) — synthesize the record and the submit side
                    # of the accounting so counts cannot skew
                    rec = self.jobs[e.dag_id] = JobRecord(
                        job_id=e.dag_id, tenant=e.tenant, submitted=True,
                        submitted_at=e.time, dag=None)
                    self.admission.on_event(E.WorkflowSubmitted(
                        time=e.time, dag_id=e.dag_id, tenant=e.tenant))
                rec.cancelled = True
        if kind == "group_completed":
            # unfiltered here; restore keeps only entries whose artifact
            # still exists in the CAS (dedup across restarts). Re-insert so
            # dict order is last-write — the retention trim keeps the newest
            self.result_index.pop(e.h_task, None)
            self.result_index[e.h_task] = e.output_hash
            trim_result_index(self.result_index,
                              self.retention.max_result_index,
                              self.result_index_hits)
        self.admission.on_event(e)
        self.trace.apply(e)
        if kind in FEED_KINDS:
            dag_id = getattr(e, "dag_id", None)
            if dag_id in self.jobs:
                self.feeds.setdefault(dag_id, []).append(e.to_dict())
                window_feed(self.feeds, self.feed_trunc, dag_id,
                            self.retention.feed_window)
        if kind in TERMINAL_EVENT_KINDS:
            self._note_terminal(e.dag_id)

    def _note_terminal(self, job_id: str) -> None:
        """Enter a job into the eviction queue the moment it goes terminal;
        evict the oldest terminal records beyond the retention cap."""
        if job_id in self._terminal_set or job_id not in self.jobs:
            return
        self._terminal_set.add(job_id)
        self.terminal.append(job_id)
        self._enforce_terminal_cap()

    def _enforce_terminal_cap(self) -> None:
        cap = self.retention.max_terminal_jobs
        if cap is None:
            return
        while len(self.terminal) > cap:
            old = self.terminal.popleft()
            self._terminal_set.discard(old)
            rec = self.jobs.pop(old, None)
            self.feeds.pop(old, None)
            self.feed_trunc.pop(old, None)
            self.trace.drop_job(old)
            if rec is not None:
                # tombstone so the job's existence degrades to "archived"
                # (HTTP 410) instead of disappearing into a 404; re-insert
                # so order is last-eviction and the trim keeps the newest
                self.archived.pop(old, None)
                self.archived[old] = {"tenant": rec.tenant}
        trim_result_index(self.archived, cap)

    def set_retention(self, retention: RetentionPolicy) -> None:
        """Swap the fold's policy mid-stream and re-enforce it on the state
        already folded (a live-reconfigured primary writes the new policy to
        the operator document; a tailing follower adopts it here). Every
        trim is "keep the newest N", so tightening now equals having folded
        under the tighter policy all along."""
        self.retention = retention
        for jid in list(self.feeds):
            window_feed(self.feeds, self.feed_trunc, jid,
                        retention.feed_window)
        self.trace.set_caps(retention.feed_window,
                            retention.max_result_index)
        self._enforce_terminal_cap()
        trim_result_index(self.archived, retention.max_terminal_jobs)
        trim_result_index(self.result_index, retention.max_result_index,
                          self.result_index_hits)

    # -------------------------------------------------------- snapshotting --
    def to_blob(self) -> dict:
        """Serialize the fold as the journal's snapshot node payload."""
        return {
            "format": SNAPSHOT_FORMAT,
            "events": self.events,
            "max_seq": self.max_seq,
            "jobs": {jid: rec.to_dict() for jid, rec in self.jobs.items()},
            "feeds": {jid: [dict(d) for d in evs]
                      for jid, evs in self.feeds.items()},
            "feed_trunc": {jid: list(v)
                           for jid, v in self.feed_trunc.items()},
            "terminal": list(self.terminal),
            "result_index": dict(self.result_index),
            "result_index_hits": dict(self.result_index_hits),
            "trace": self.trace.to_blob(),
            "archived": {jid: dict(v) for jid, v in self.archived.items()},
            "admission": self.admission.dump_state(),
            #: informational: the policy the writing fold applied — restore
            #: takes its policy from operator config, never from here
            "retention": self.retention.to_dict(),
        }

    def load(self, blob: dict) -> None:
        """Resume the fold from a snapshot node (inverse of ``to_blob``).

        This fold's *own* retention policy is re-enforced on the loaded
        state: a snapshot written under a looser policy is trimmed down to
        ours ("keep the newest" composes, so the result still equals a
        trimmed full replay); dropped history can never be resurrected.

        Format 1 snapshots (pre-retention) load with empty watermarks; their
        terminal order is unrecorded, so it is approximated by record
        (submission) order — this only affects *which* records a tighter cap
        evicts from an old chain, never accounting. Format 1/2 snapshots
        predate the trace fold and archived tombstones: both load empty, so
        traces simply start at the snapshot cut. Format <= 3 snapshots
        predate dedup hit counts: they load empty, so eviction degrades to
        the legacy oldest-first order until new hits accrue.
        """
        if blob.get("format") not in (1, 2, 3, SNAPSHOT_FORMAT):
            raise ValueError(
                f"unsupported snapshot format {blob.get('format')!r}")
        self.events = blob["events"]
        self.max_seq = blob["max_seq"]
        self.jobs = {jid: JobRecord.from_dict(d)
                     for jid, d in blob["jobs"].items()}
        self.feeds = {jid: [dict(d) for d in evs]
                      for jid, evs in blob["feeds"].items()}
        self.feed_trunc = {jid: list(v)
                           for jid, v in blob.get("feed_trunc", {}).items()}
        terminal = blob.get("terminal")
        if terminal is None:                    # v1 migration
            terminal = [jid for jid, rec in self.jobs.items()
                        if (rec.completed_at is not None or rec.cancelled
                            or not rec.submitted)]
        self.terminal = deque(jid for jid in terminal if jid in self.jobs)
        self._terminal_set = set(self.terminal)
        self.result_index = dict(blob["result_index"])
        self.result_index_hits = {
            h: int(n) for h, n in blob.get("result_index_hits", {}).items()}
        self.trace.load(blob.get("trace"))
        self.archived = {jid: dict(v)
                         for jid, v in blob.get("archived", {}).items()}
        self.admission.load_state(blob["admission"])
        for jid in list(self.feeds):
            window_feed(self.feeds, self.feed_trunc, jid,
                        self.retention.feed_window)
        self._enforce_terminal_cap()
        trim_result_index(self.archived, self.retention.max_terminal_jobs)
        trim_result_index(self.result_index, self.retention.max_result_index,
                          self.result_index_hits)


def snapshot_fold(admission_template: AdmissionController | None = None,
                  retention: RetentionPolicy | None = None):
    """Build the ``fold_factory`` that ``EventJournal.compact`` expects.

    ``admission_template`` supplies quota configuration (fair-share weights
    change how vtime folds); usage state always starts from the snapshot
    base, never from the template — compaction must not absorb the live
    controller's runtime state. ``retention`` makes the fold
    retention-trimmed; it must match what restore will apply (the persisted
    operator document keeps offline compaction and live restores in
    agreement — DESIGN.md §9).
    """
    def factory(base: dict | None) -> ReplayState:
        adm = AdmissionController()
        if admission_template is not None:
            adm.deadline_boost = admission_template.deadline_boost
            adm.default_quota = admission_template.default_quota
            adm.quotas = dict(admission_template.quotas)
        state = ReplayState(adm, retention=retention)
        if base is not None:
            state.load(base)
        return state
    return factory
