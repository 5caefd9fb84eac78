"""Lineage-aware tracing: fold the typed event stream into span trees.

``TraceState`` is a pure event fold (DESIGN.md §11): it consumes the same
``FabricEvent`` stream the journal records and derives, per workflow, a
tree of virtual-time spans —

  * ``workflow``  — submission .. terminal transition;
  * ``admit``     — submission .. the first operator turning READY (the
    admission + compile + arrival wait);
  * ``<op>:queue``— ready-pool residency (OpReady .. first dispatch of the
    op's execution group);
  * ``<op>:exec`` — dispatch .. completion, tagged with the worker;
  * ``<op>:dedup``— an op-instance satisfied *without* executing, carrying
    a **dedup edge** to the producer workflow that actually ran the
    operator (the paper's cross-tenant provenance, made visible).

Producer attribution: a batch-shared group names its consumers on
``GroupCompleted`` — the first consumer is the instance that executed, so
every other consumer's edge points at it. Result-index hits (dedup across
time) resolve through a bounded ``h_task -> (job, op)`` producer map
maintained from past groups; once the map has evicted the producer the
edge reports ``producer_job: null`` — explicitly unknown, never silently
wrong.

Because the fold is deterministic over the journaled stream, traces
*replay*: the live service, a tailing follower, and a journal-restored
process all derive byte-identical span trees (``ReplayState`` embeds one
of these, and the snapshot carries its state across compaction cuts).
Wall-clock cost of the control plane is deliberately out of scope here —
that is ``core/metrics.py``; span times are virtual engine time.

Retention: ``span_window`` caps the per-job op-span list at the newest K
entries (the same "keep the newest" trim feeds use, so it composes across
snapshot cuts); dropped spans surface as exactly one ``trace_truncated``
marker span in the tree — never silent loss.
"""
from __future__ import annotations

from .events import FabricEvent

#: trace-state blob schema version (carried inside the journal snapshot)
#: v2: producer-map dedup hit counts travel with the blob (LFU eviction)
TRACE_FORMAT = 2

#: the event kinds the fold consumes — everything else returns immediately
_TRACE_KINDS = frozenset((
    "workflow_submitted", "job_rejected", "op_ready", "dedup_hit",
    "dispatch", "group_completed", "op_completed", "group_requeued",
    "workflow_completed", "workflow_cancelled"))

#: span kind of the synthetic marker that reports windowed-away op spans
TRACE_TRUNCATED_KIND = "trace_truncated"

#: stale-window the LFU hybrid considers beyond the excess (kept equal to
#: replay._LFU_WINDOW so the producer map evicts like the result index)
_LFU_WINDOW = 8


def _trim_oldest(d: dict, cap: int | None,
                 hits: dict[str, int] | None = None) -> None:
    """Drop entries beyond ``cap`` in place. Without ``hits``: oldest
    (insertion-order) first. With ``hits``: LFU/recency hybrid — among the
    stalest ``excess + _LFU_WINDOW`` entries evict the least-hit first,
    ties oldest-first (stable sort ⇒ all-zero hits degrade exactly to the
    legacy order). Same discipline as ``replay.trim_result_index``."""
    if cap is None or len(d) <= cap:
        return
    excess = len(d) - cap
    if not hits:
        for key in list(d)[:excess]:
            del d[key]
        return
    cand = list(d)[:excess + _LFU_WINDOW]
    cand.sort(key=lambda k: hits.get(k, 0))
    for key in cand[:excess]:
        del d[key]
        hits.pop(key, None)


class TraceState:
    """Fold of the event stream into per-workflow span records.

    JSON-shaped throughout (plain dicts/lists/scalars), so the snapshot
    round-trip (positional rows, see ``to_blob``) cannot change equality.
    """

    def __init__(self, *, span_window: int | None = None,
                 max_producers: int | None = None) -> None:
        #: cap per-job op spans at the newest K (None = unbounded); mirrors
        #: the feed window so a trace is never less bounded than its feed
        self.span_window = span_window
        #: cap on the h_task -> producer map (None = unbounded); mirrors
        #: the result-index cap — an index hit implies a producer entry of
        #: the same age, so the two evict in lockstep
        self.max_producers = max_producers
        #: job_id -> trace record (see _new_job)
        self.jobs: dict[str, dict] = {}
        #: h_task -> [producer_job, producer_op], last-use order
        self.producers: dict[str, list] = {}
        #: h_task -> times a dedup edge resolved through the producer map;
        #: drives LFU eviction so frequently-referenced producers outlive
        #: merely-recent ones (lockstep with the result index's hit counts)
        self.producer_hits: dict[str, int] = {}
        #: h_task -> [[job_id, op], ...] ready-but-undispatched instances
        self.pending: dict[str, list] = {}

    # ------------------------------------------------------------- fold ----
    @staticmethod
    def _new_job(tenant: str, start: float, status: str, seq: int) -> dict:
        return {"tenant": tenant, "start": start, "end": None,
                "status": status, "seq": seq, "admit_end": None,
                "ops": {}, "dropped": [0, -1]}

    def apply(self, e: FabricEvent) -> None:
        kind = e.kind
        # one set probe instead of walking the whole dispatch chain for the
        # kinds the trace plane ignores (batch/worker/lease events)
        if kind not in _TRACE_KINDS:
            return
        if kind == "workflow_submitted":
            self.jobs[e.dag_id] = self._new_job(e.tenant, e.time,
                                                "running", e.seq)
        elif kind == "job_rejected":
            rec = self._new_job(e.tenant, e.time, "rejected", e.seq)
            rec["end"] = e.time
            self.jobs[e.dag_id] = rec
        elif kind == "op_ready":
            rec = self.jobs.get(e.dag_id)
            if rec is None:
                return
            if rec["admit_end"] is None:
                rec["admit_end"] = e.time
            rec["ops"][e.op] = {
                "seq": e.seq, "h_task": e.h_task, "ready_at": e.time,
                "dispatch_at": None, "end": None, "worker": None,
                "queue_wait": None, "executed": None, "dedup": None,
            }
            self._window_spans(e.dag_id, rec)
            if e.h_task:
                self.pending.setdefault(e.h_task, []).append(
                    [e.dag_id, e.op])
        elif kind == "dedup_hit":
            # satisfied from the result index: the instance never dispatches,
            # so retire its awaiting-dispatch registration (OpReady may have
            # fired first) or the pending map grows with every index hit
            pend = self.pending.get(e.h_task)
            if pend is not None:
                pend[:] = [p for p in pend if p != [e.dag_id, e.op]]
                if not pend:
                    del self.pending[e.h_task]
            rec = self.jobs.get(e.dag_id)
            if rec is None:
                return
            producer = self.producers.get(e.h_task)
            if producer is not None:
                # the edge resolved through the map: hit bump + recency
                # touch, so eviction favors producers nothing references
                self.producer_hits[e.h_task] = \
                    self.producer_hits.get(e.h_task, 0) + 1
                self.producers[e.h_task] = self.producers.pop(e.h_task)
            dedup = {"source": e.source,
                     "producer_job": producer[0] if producer else None,
                     "producer_op": producer[1] if producer else None}
            entry = rec["ops"].get(e.op)
            if entry is None:
                rec["ops"][e.op] = {
                    "seq": e.seq, "h_task": e.h_task, "ready_at": None,
                    "dispatch_at": None, "end": e.time, "worker": None,
                    "queue_wait": None, "executed": False, "dedup": dedup,
                }
                self._window_spans(e.dag_id, rec)
            else:
                # OpReady fired first: keep the queue residency, close the
                # span as an index hit
                entry["end"] = e.time
                entry["executed"] = False
                entry["dedup"] = dedup
        elif kind == "dispatch":
            for job_id, op in self.pending.pop(e.h_task, []):
                entry = self._op(job_id, op)
                if entry is not None and entry["dispatch_at"] is None:
                    entry["dispatch_at"] = e.time
                    entry["worker"] = e.worker
                    entry["queue_wait"] = e.queue_wait
        elif kind == "group_completed":
            consumers = [list(c) for c in e.consumers]
            producer = consumers[0][:2] if consumers else None
            if producer is not None:
                # re-insert so dict order is last-write (the trim below
                # keeps the newest — same discipline as the result index)
                self.producers.pop(e.h_task, None)
                self.producers[e.h_task] = producer
                _trim_oldest(self.producers, self.max_producers,
                             self.producer_hits)
                for job_id, op, _tenant in consumers[1:]:
                    entry = self._op(job_id, op)
                    if entry is not None:
                        entry["dedup"] = {"source": "batch",
                                          "producer_job": producer[0],
                                          "producer_op": producer[1]}
            # consumers that joined after the group dispatched were never
            # popped by a dispatch event — the group is done, drop them
            self.pending.pop(e.h_task, None)
        elif kind == "op_completed":
            entry = self._op(e.dag_id, e.op)
            if entry is not None:
                entry["end"] = e.time
                entry["executed"] = e.executed
                if e.worker is not None:
                    entry["worker"] = e.worker
        elif kind == "group_requeued":
            if not e.requeued:          # abandoned: nothing left to dispatch
                self.pending.pop(e.h_task, None)
        elif kind == "workflow_completed":
            rec = self.jobs.get(e.dag_id)
            if rec is not None:
                rec["end"] = e.time
                rec["status"] = "completed"
        elif kind == "workflow_cancelled":
            rec = self.jobs.get(e.dag_id)
            if rec is None:             # cancel recorded before submission
                rec = self.jobs[e.dag_id] = self._new_job(
                    e.tenant, e.time, "cancelled", e.seq)
            rec["end"] = e.time
            rec["status"] = "cancelled"

    #: bus-subscriber alias, so a live service can hook the fold directly
    on_event = apply

    def _op(self, job_id: str, op: str) -> dict | None:
        rec = self.jobs.get(job_id)
        return None if rec is None else rec["ops"].get(op)

    def _window_spans(self, job_id: str, rec: dict) -> None:
        """Trim one job's op spans to the newest ``span_window``, advancing
        the ``[dropped, last_seq]`` watermark — "keep the newest K" composes
        across snapshot cuts exactly like the feed window."""
        window = self.span_window
        if window is None or len(rec["ops"]) <= window:
            return
        for op in list(rec["ops"])[:len(rec["ops"]) - window]:
            dropped = rec["ops"].pop(op)
            rec["dropped"][0] += 1
            rec["dropped"][1] = max(rec["dropped"][1], dropped["seq"])

    # -------------------------------------------------------- retention ----
    def drop_job(self, job_id: str) -> None:
        """Forget one workflow's trace (terminal-record eviction)."""
        self.jobs.pop(job_id, None)

    def set_caps(self, span_window: int | None,
                 max_producers: int | None) -> None:
        """Adopt new retention caps and re-enforce them on folded state —
        tightening now equals having folded under the tighter caps."""
        self.span_window = span_window
        self.max_producers = max_producers
        for job_id, rec in self.jobs.items():
            self._window_spans(job_id, rec)
        _trim_oldest(self.producers, max_producers, self.producer_hits)

    # ------------------------------------------------------ serialization --
    #: positional row layouts — the snapshot stores rows, not dicts, so the
    #: trace state does not balloon the chain with repeated field names
    #: (the snapshot must stay a small constant factor of the caps: §9)
    _OP_FIELDS = ("seq", "h_task", "ready_at", "dispatch_at", "end",
                  "worker", "queue_wait", "executed")
    _JOB_FIELDS = ("tenant", "start", "end", "status", "seq", "admit_end")

    def to_blob(self) -> dict:
        def op_row(d: dict) -> list:
            row = [d[f] for f in self._OP_FIELDS]
            dd = d["dedup"]
            row.append(None if dd is None else
                       [dd["source"], dd["producer_job"], dd["producer_op"]])
            return row

        return {
            "format": TRACE_FORMAT,
            "jobs": {jid: [rec[f] for f in self._JOB_FIELDS]
                     + [{op: op_row(d) for op, d in rec["ops"].items()},
                        list(rec["dropped"])]
                     for jid, rec in self.jobs.items()},
            "producers": {h: list(v) for h, v in self.producers.items()},
            "producer_hits": dict(self.producer_hits),
            "pending": {h: [list(p) for p in v]
                        for h, v in self.pending.items()},
        }

    def load(self, blob: dict | None) -> None:
        """Resume from a snapshot (inverse of ``to_blob``); ``None`` — a
        snapshot written before traces existed — loads as empty, so old
        chains restore with traces starting at the snapshot cut."""
        self.jobs = {}
        self.producers = {}
        self.producer_hits = {}
        self.pending = {}
        if blob is None:
            return
        if blob.get("format") not in (1, TRACE_FORMAT):
            raise ValueError(
                f"unsupported trace format {blob.get('format')!r}")

        def op_entry(row: list) -> dict:
            d = dict(zip(self._OP_FIELDS, row))
            dd = row[len(self._OP_FIELDS)]
            d["dedup"] = (None if dd is None else
                          {"source": dd[0], "producer_job": dd[1],
                           "producer_op": dd[2]})
            return d

        n = len(self._JOB_FIELDS)
        for jid, row in blob["jobs"].items():
            rec = dict(zip(self._JOB_FIELDS, row))
            rec["ops"] = {op: op_entry(r) for op, r in row[n].items()}
            rec["dropped"] = list(row[n + 1])
            self.jobs[jid] = rec
        self.producers = {h: list(v)
                          for h, v in blob["producers"].items()}
        # format-1 blobs predate hit counts: eviction degrades to legacy
        # oldest-first until new dedup edges accrue hits
        self.producer_hits = {h: int(n) for h, n
                              in blob.get("producer_hits", {}).items()}
        self.pending = {h: [list(p) for p in v]
                        for h, v in blob["pending"].items()}
        # our caps, not the writer's: re-enforce like every other trim
        self.set_caps(self.span_window, self.max_producers)

    # ------------------------------------------------------------ queries --
    def span_tree(self, job_id: str) -> dict | None:
        """One workflow's trace as a span-tree document (the
        ``GET /jobs/{id}/trace`` payload). Deterministic: identical folds
        produce identical dicts, key order included."""
        rec = self.jobs.get(job_id)
        if rec is None:
            return None
        spans: list[dict] = [{
            "name": "workflow", "kind": "workflow",
            "start": rec["start"], "end": rec["end"],
            "status": rec["status"],
        }]
        if rec["admit_end"] is not None:
            spans.append({"name": "admit", "kind": "admit",
                          "start": rec["start"], "end": rec["admit_end"]})
        truncated = rec["dropped"][0] > 0
        if truncated:
            # exactly one watermark span — the trace's feed_truncated
            spans.append({"name": TRACE_TRUNCATED_KIND,
                          "kind": TRACE_TRUNCATED_KIND,
                          "dropped": rec["dropped"][0],
                          "last_seq": rec["dropped"][1]})
        edges: list[dict] = []
        for op, entry in rec["ops"].items():
            if entry["ready_at"] is not None:
                spans.append({
                    "name": f"{op}:queue", "kind": "queue", "op": op,
                    "start": entry["ready_at"],
                    "end": (entry["dispatch_at"]
                            if entry["dispatch_at"] is not None
                            else entry["end"]),
                })
            if entry["dispatch_at"] is not None:
                spans.append({
                    "name": f"{op}:exec", "kind": "exec", "op": op,
                    "start": entry["dispatch_at"], "end": entry["end"],
                    "worker": entry["worker"],
                    "queue_wait": entry["queue_wait"],
                    "executed": entry["executed"],
                })
            if entry["dedup"] is not None:
                d = entry["dedup"]
                spans.append({
                    "name": f"{op}:dedup", "kind": "dedup", "op": op,
                    "start": (entry["ready_at"]
                              if entry["ready_at"] is not None
                              else entry["end"]),
                    "end": entry["end"],
                    "source": d["source"],
                    "producer_job": d["producer_job"],
                    "producer_op": d["producer_op"],
                })
                edges.append({"op": op, "h_task": entry["h_task"],
                              "source": d["source"],
                              "producer_job": d["producer_job"],
                              "producer_op": d["producer_op"]})
        return {"job_id": job_id, "tenant": rec["tenant"],
                "status": rec["status"], "start": rec["start"],
                "end": rec["end"], "truncated": truncated,
                "dropped_spans": rec["dropped"][0],
                "spans": spans, "edges": edges}

    def chrome_trace(self, job_id: str) -> list[dict] | None:
        """The same tree as Chrome ``trace_event`` JSON (about://tracing):
        complete ("X") events for finished spans, instants ("i") for open
        spans and the truncation watermark; virtual seconds become µs."""
        tree = self.span_tree(job_id)
        if tree is None:
            return None
        out: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": f"job {job_id} ({tree['tenant']})"},
        }]
        for tid, span in enumerate(tree["spans"], start=1):
            args = {k: v for k, v in span.items()
                    if k not in ("name", "kind", "start", "end")}
            args["kind"] = span["kind"]
            start = span.get("start")
            end = span.get("end")
            if start is None:
                start = tree["start"]
            ts = int(round(start * 1e6))
            if end is None:
                out.append({"name": span["name"], "ph": "i", "s": "t",
                            "pid": 1, "tid": tid, "ts": ts, "args": args})
            else:
                out.append({"name": span["name"], "ph": "X", "pid": 1,
                            "tid": tid, "ts": ts,
                            "dur": max(0, int(round((end - start) * 1e6))),
                            "args": args})
        return out

    def span_count(self, job_id: str) -> int:
        """Spans a tree for this job would carry (soak bound checks)."""
        tree = self.span_tree(job_id)
        return 0 if tree is None else len(tree["spans"])
