"""Warm-standby follower fabric: bootstrap, tail, fence, promote.

The journal's chained-head design (DESIGN.md §7–§9) already admits a second
process replaying the primary's CAS; this module turns that into a live
**follower** (DESIGN.md §10):

  * **bootstrap** — load the chain's newest snapshot node and fold the tail
    through the shared ``ReplayState`` — the same trimmed fold restore uses,
    so the follower's state equals a retention-trimmed replay;
  * **tail** — watch the head ref (``CAS.watch_ref``) and incrementally
    apply only the *new* segments. Events carry monotone bus seqs, so a
    compaction on the primary (which rewrites the kept tail segments under
    new keys) folds idempotently: already-applied events are skipped by
    seq, and a snapshot cut past our position triggers a cheap re-bootstrap;
  * **promote** — atomically take over the head ref with an epoch bump
    (compare-and-set on the stored ``(key, epoch)`` entry), after which a
    zombie primary's next append is refused with ``RefFencedError``. The
    promoted process restores through the existing interrupt-on-restart
    path and serves read-write.

The follower never executes work: it holds no live engine state, only the
event-sourced view (job records, feeds, usage accounting) — which is
exactly what ``GET /jobs``, ``/jobs/{id}``, ``/jobs/{id}/events``, and
``/tenants/{id}/usage`` answer from.
"""
from __future__ import annotations

import sys
import threading
import time

from repro_torch.core.cas import RefFencedError
from repro_torch.core.events import event_from_dict
from repro_torch.core.journal import HEAD_REF, EventJournal

from .api import FabricAPI
from .operator import OPERATOR_REF, configured_admission, load_operator_doc
from .replay import ReplayState, RetentionPolicy
from .service import FabricService


class FollowerFabric:
    """A read-only fabric tailing another process's journal in one CAS.

    ``retention`` pins the *follower's* policy; when None the follower
    adopts (and live-tracks) the CAS operator document, falling back to the
    default policy — either way the fold is retention-trimmed with the
    follower's own policy, never the snapshot writer's (DESIGN.md §9).
    """

    def __init__(self, cas, *, ref: str = HEAD_REF,
                 retention: RetentionPolicy | None = None,
                 seed: int = 0, batch_size: int = 256,
                 device_classes: tuple[str, ...] | None = None,
                 auto_promote: bool = False,
                 lease_ttl_s: float | None = None,
                 clock=time.time) -> None:
        self.cas = cas
        self.ref = ref
        self.seed = seed
        self.batch_size = batch_size
        self.device_classes = device_classes
        #: self-healing HA (DESIGN.md §14): when True, the tail loop watches
        #: the head-ref liveness lease and elects itself primary once the
        #: lease is *held and expired*. A lease-less head (0.0) never
        #: triggers — a primary that does not heartbeat opted out of
        #: auto-failover and keeps requiring an operator `promote`.
        self.auto_promote = auto_promote
        #: TTL this follower will heartbeat with *after* winning an election
        #: (and stamp on the takeover CAS, so rival followers instantly see
        #: a fresh lease instead of re-electing over the winner)
        self.lease_ttl_s = lease_ttl_s
        self._clock = clock
        #: factory for the promoted service's worker transport — set by the
        #: CLI when the standby should serve remote lanes after takeover
        self.transport_factory = None
        #: callback run with the promoted service however promotion happens
        #: (operator POST or auto-election); FollowerAPI hooks this to flip
        #: itself read-write
        self.on_promoted = None
        self.elections_won = 0
        self.elections_lost = 0
        self._retention_pinned = retention is not None
        self._operator_key = cas.get_ref(OPERATOR_REF)
        doc = load_operator_doc(cas)
        self.admission = configured_admission(doc)
        if retention is None:
            retention = (RetentionPolicy.from_dict(doc["retention"])
                         if doc is not None else RetentionPolicy())
        self.retention = retention
        self.state = ReplayState(self.admission, retention=retention)
        #: newest segment key whose events are fully folded (the tail cursor)
        self._applied_head: str | None = None
        self.events_applied = 0
        self.segments_applied = 0
        self.bootstraps = 0
        self.catch_ups = 0
        self.promoted: FabricService | None = None
        #: read-only query surface: a FabricService shell whose engine never
        #: runs — its state dicts are re-pointed at the fold's after every
        #: catch-up, so job views / feeds / cursor semantics (including
        #: feed_truncated markers) are served by the exact same code paths
        #: tenants see on the primary
        kwargs = {} if device_classes is None else {
            "device_classes": device_classes}
        self.view = FabricService(seed=seed, admission=self.admission,
                                  cas=cas, retention=retention, **kwargs)
        #: the view's registry doubles as the follower's — GET /metrics on
        #: a FollowerAPI serves replication lag next to the service gauges
        self.metrics = self.view.metrics
        self._m_lag_segments = self.metrics.gauge(
            "fabric_replication_lag_segments",
            "Chain segments behind the head at the last look")
        self._m_lag_bytes = self.metrics.gauge(
            "fabric_replication_lag_bytes",
            "Chain bytes behind the head at the last look")
        self._m_lag_events = self.metrics.gauge(
            "fabric_replication_lag_events",
            "Events behind the head at the last look")
        self._m_catch_ups = self.metrics.counter(
            "fabric_replication_catch_ups_total",
            "Tail catch-up passes run")
        self._m_events_applied = self.metrics.counter(
            "fabric_replication_events_applied_total",
            "Events folded from the tail")
        self._m_bootstraps = self.metrics.counter(
            "fabric_replication_bootstraps_total",
            "Snapshot re-bootstraps (the primary compacted past us)")
        _elections = self.metrics.counter(
            "fabric_elections_total",
            "Auto-promotion attempts after an expired head-ref lease",
            labels=("outcome",))
        self._m_election_won = _elections.child(outcome="won")
        self._m_election_lost = _elections.child(outcome="lost")
        self._sync_view()

    # ------------------------------------------------------------- tailing --
    def _sync_view(self) -> None:
        svc = self.view
        svc.retention_policy = self.retention
        # shared references, not copies: the view never mutates them (it
        # takes no submissions, so _evict_terminal/_on_event never run) and
        # a per-catch-up copy would make long-lived tailing O(state) per
        # segment
        svc.jobs = self.state.jobs
        svc._feeds = self.state.feeds
        svc._feed_trunc = self.state.feed_trunc
        svc._terminal_order = self.state.terminal
        svc._terminal_seen = self.state._terminal_set
        svc._trace = self.state.trace
        svc.archived = self.state.archived
        # same filter restore applies: only artifacts still in the CAS —
        # but incrementally: entries that survived the previous sync are
        # trusted, so one catch-up stats only the *new* entries instead of
        # the whole index (on DiskCAS each check is a filesystem stat)
        old = svc.engine.result_index
        svc.engine.result_index = {h: k
                                   for h, k in self.state.result_index.items()
                                   if old.get(h) == k or k in self.cas}
        svc.engine.result_index_hits = {
            h: n for h, n in self.state.result_index_hits.items()
            if h in svc.engine.result_index}

    def _maybe_reload_config(self) -> bool:
        """Adopt operator-document changes (quota weights, retention) the
        primary wrote through since our last look — config is not journaled
        history, so the tail fold alone would never see it. Returns whether
        anything was applied."""
        key = self.cas.get_ref(OPERATOR_REF)
        if key == self._operator_key:
            return False
        self._operator_key = key
        doc = load_operator_doc(self.cas)
        if doc is None:
            return False
        self.admission.load_config(doc["admission"])
        if not self._retention_pinned:
            self.retention = RetentionPolicy.from_dict(doc["retention"])
            self.state.set_retention(self.retention)
        return True

    def catch_up(self) -> dict:
        """Fold everything the chain holds beyond our position; returns
        ``{head, segments, events, bootstrapped}`` for this pass.

        Walks head→prev collecting unseen segments until it meets the last
        applied key (pure append) or the chain's snapshot root (the primary
        compacted: kept-tail segments were rewritten under new keys). Events
        are applied through the shared fold strictly by bus seq — an event
        already folded is skipped, so rewritten segments are idempotent; a
        snapshot whose ``max_seq`` is past ours replaces the fold state
        wholesale (trimmed load ≡ trimmed replay, DESIGN.md §9)."""
        self._maybe_reload_config()
        self.catch_ups += 1
        self._m_catch_ups.inc()
        head, _, segs, snapshot = self._unseen_chain()
        self._observe_lag(segs, snapshot)
        out = {"head": head, "segments": 0, "events": 0,
               "bootstrapped": False}
        if snapshot is not None and snapshot["max_seq"] > self.state.max_seq:
            # the primary folded history we never applied — resume the fold
            # from its snapshot (admission usage included) and tail from there
            self.state = ReplayState(self.admission,
                                     retention=self.retention)
            self.state.load(snapshot)
            self.bootstraps += 1
            self._m_bootstraps.inc()
            out["bootstrapped"] = True
        for _key, blob, _size in segs:
            for d in blob["events"]:
                e = event_from_dict(d)
                if e.seq > self.state.max_seq:
                    self.state.apply(e)
                    out["events"] += 1
            out["segments"] += 1
        if out["segments"] == 0 and not out["bootstrapped"]:
            return out                      # nothing new (or empty chain)
        self._applied_head = head
        self.events_applied += out["events"]
        self.segments_applied += out["segments"]
        self._m_events_applied.inc(out["events"])
        self._sync_view()
        # the pass consumed everything it measured: the steady-state lag
        # served by GET /metrics is zero until the head moves again
        self._observe_lag((), None)
        return out

    def _lag(self, segs, snapshot) -> tuple[int, int, int]:
        """(segments, bytes, events) behind the head, from one
        ``_unseen_chain`` measurement."""
        lag_events = sum(1 for _k, blob, _s in segs for d in blob["events"]
                         if d["seq"] > self.state.max_seq)
        if snapshot is not None:
            lag_events += max(0, snapshot["events"] - self.state.events)
        return (len(segs), sum(size for _k, _b, size in segs), lag_events)

    def _observe_lag(self, segs, snapshot) -> None:
        lag_segments, lag_bytes, lag_events = self._lag(segs, snapshot)
        self._m_lag_segments.set(lag_segments)
        self._m_lag_bytes.set(lag_bytes)
        self._m_lag_events.set(lag_events)

    def _unseen_chain(self) -> tuple:
        """``(head, epoch, segments, snapshot)`` for the chain suffix we
        have not folded: walk head→prev until the last-applied key, or the
        snapshot node that proves the primary compacted past our marker.
        Segments come back oldest-first as ``(key, blob, size)``. One retry
        on a ``KeyError``: the primary may compact + gc the chain under the
        walk — the *new* head's chain is fully durable (a second miss is
        real corruption and raises). Shared by ``catch_up`` (folds) and
        ``replication_status`` (measures)."""
        for attempt in (0, 1):
            head, epoch = self.cas.ref_entry(self.ref)
            segs: list[tuple] = []          # newest-first during the walk
            snapshot: dict | None = None
            key = head
            try:
                while key is not None and key != self._applied_head:
                    blob = self.cas.get(key)
                    segs.append((key, blob, self.cas.size_of(key)))
                    if "snapshot" in blob:
                        snapshot = blob["snapshot"]
                        break
                    key = blob["prev"]
            except KeyError:
                if attempt:
                    raise
                continue
            segs.reverse()                  # oldest first, like replay()
            return head, epoch, segs, snapshot

    def tail_loop(self, stop: threading.Event, lock,
                  *, poll_interval_s: float = 0.05,
                  wake_every_s: float = 0.5) -> None:
        """Follow the head ref until ``stop`` is set (or promotion): park on
        ``watch_ref`` and fold under ``lock`` — the same lock the HTTP shim
        serializes requests with, so reads never observe a half-applied
        segment. With ``auto_promote`` every wake-up (head movement *or*
        ``wake_every_s`` timeout) also checks the liveness lease, so a
        silent primary is detected within one wake interval of expiry."""
        while not stop.is_set() and self.promoted is None:
            head = self.cas.watch_ref(self.ref, since=self._applied_head,
                                      timeout_s=wake_every_s,
                                      poll_interval_s=poll_interval_s)
            if stop.is_set() or self.promoted is not None:
                return
            with lock:
                if self.promoted is not None:
                    return
                if head is not None and head != self._applied_head:
                    self.catch_up()
                elif self._maybe_reload_config():
                    # operator-config writes move their own ref, not the
                    # journal head — an idle primary's PUT /admin/retention
                    # must still reach the standby on the timeout wake-up
                    self._sync_view()
                self.maybe_elect()

    # ------------------------------------------------------------ election --
    def lease_status(self) -> dict:
        """The head-ref liveness lease as this follower sees it — the
        "caught up, but is the primary *alive*?" half of replication
        status. ``held`` False means the last head writer did not
        heartbeat (no auto-failover possible); ``expired`` True is the
        election trigger."""
        lease = self.cas.ref_lease(self.ref)
        now = self._clock()
        held = lease > 0.0
        return {"held": held,
                "until": lease if held else None,
                "remaining_s": (lease - now) if held else None,
                "expired": held and now >= lease}

    def maybe_elect(self) -> FabricService | None:
        """One election attempt, iff armed and the lease is held-and-expired.

        The election itself is nothing but the existing fenced promotion,
        conditioned on the epoch we observed *while the lease was expired*:
        N followers racing all CAS against that same stored epoch, exactly
        one lands the bump, and every loser's CAS is refused with
        ``RefFencedError`` — split-brain stays structurally excluded, no
        coordinator required. A loser logs, counts the loss, and simply
        resumes tailing: the winner's takeover stamped a fresh lease, so
        the next wake-up sees ``expired=False`` and stands down."""
        if not self.auto_promote or self.promoted is not None:
            return None
        key, epoch = self.cas.ref_entry(self.ref)
        lease = self.cas.ref_lease(self.ref)
        now = self._clock()
        if key is None or lease <= 0.0 or now < lease:
            return None
        print(f"follower: head-ref lease expired {now - lease:.2f}s ago "
              f"(epoch {epoch}); attempting self-promotion",
              file=sys.stderr, flush=True)
        try:
            svc = self.promote(expect_epoch=epoch)
        except RefFencedError as exc:
            self.elections_lost += 1
            self._m_election_lost.inc()
            print(f"follower: election lost ({exc}); resuming tail",
                  file=sys.stderr, flush=True)
            return None
        self.elections_won += 1
        self._m_election_won.inc()
        # the promoted service serves /metrics from its own registry from
        # now on — the election that created it must be scrapable there
        svc.metrics.counter(
            "fabric_elections_total",
            "Auto-promotion attempts after an expired head-ref lease",
            labels=("outcome",)).child(outcome="won").inc()
        print(f"follower: self-promoted to epoch {svc.journal.epoch} "
              f"({len(svc.jobs)} jobs restored)", file=sys.stderr, flush=True)
        return svc

    # ------------------------------------------------------------ lag view --
    def replication_status(self) -> dict:
        """The ``GET /admin/replication`` payload: where the head is, where
        we are, and the gap in segments / bytes / events. ``lag.events`` is
        exact for tail segments (counted by seq) and best-effort across a
        snapshot cut (difference of cumulative fold counters)."""
        head, epoch, segs, snapshot = self._unseen_chain()
        self._observe_lag(segs, snapshot)
        lag_segments, lag_bytes, lag_events = self._lag(segs, snapshot)
        return {
            "role": "follower",
            "ref": self.ref,
            "epoch": epoch,
            "head": head,
            "applied_head": self._applied_head,
            "caught_up": head == self._applied_head,
            "lease": self.lease_status(),
            "auto_promote": self.auto_promote,
            "elections": {"won": self.elections_won,
                          "lost": self.elections_lost},
            "applied": {"segments": self.segments_applied,
                        "events": self.events_applied,
                        "max_seq": self.state.max_seq,
                        "jobs": len(self.state.jobs)},
            "bootstraps": self.bootstraps,
            "catch_ups": self.catch_ups,
            "lag": {"segments": lag_segments, "bytes": lag_bytes,
                    "events": lag_events},
        }

    # ------------------------------------------------------------ takeover --
    def promote(self, *, seed: int | None = None,
                expect_epoch: int | None = None) -> FabricService:
        """Become the primary: catch up, fence, restore, serve read-write.

        The fence is a compare-and-set on the head ref's ``(key, epoch)``
        entry — the ref keeps pointing at the same head, only the epoch is
        bumped. From that instant the old primary's journal (which presents
        the previous epoch on every ``set_ref``) is refused: its appends die
        with ``RefFencedError`` and the chain it no longer owns stays
        consistent. A crash anywhere before the CAS lands leaves the old
        entry fully intact (the promotion simply retries); after it lands,
        the restore is ordinary crash recovery — in-flight work is closed
        out through the existing interrupt-on-restart path, and the result
        index makes re-submission pay only for unfinished ops.

        Idempotent: a second call returns the already-promoted service.

        ``expect_epoch`` pins the takeover to one observed epoch: the CAS
        must land against exactly that stored value or the call raises
        ``RefFencedError``. This is what makes an *election* of N racing
        followers safe — each conditions on the epoch it saw while the
        lease was expired, so a rival's bump (which also stamps a fresh
        lease) fences everyone else instead of being promoted over."""
        if self.promoted is not None:
            return self.promoted
        pinned = expect_epoch is not None
        first_epoch: int | None = expect_epoch
        while True:
            self.catch_up()
            head, epoch = self.cas.ref_entry(self.ref)
            if first_epoch is None:
                first_epoch = epoch
            elif epoch > first_epoch:
                raise RefFencedError(self.ref, epoch, first_epoch + 1)
            new_epoch = epoch + 1
            if head != self._applied_head:
                continue                   # head moved mid-pass: re-fold
            lease_until = (None if self.lease_ttl_s is None
                           else self._clock() + self.lease_ttl_s)
            try:
                if head is None:
                    # empty journal: publish an empty root segment so the
                    # fenced epoch is durable — otherwise an un-flushed old
                    # primary and this promotion could both believe they
                    # own epoch 1 (same materialization as claim())
                    root = self.cas.put({"prev": None, "events": []})
                    self.cas.set_ref(self.ref, root, epoch=new_epoch,
                                     expect_epoch=epoch,
                                     lease_until=lease_until)
                else:
                    self.cas.set_ref(self.ref, head, epoch=new_epoch,
                                     expect_epoch=epoch, expect_key=head,
                                     lease_until=lease_until)
                break
            except RefFencedError:
                if pinned:
                    raise                  # pinned takeover: the loser path
                continue                   # lost a race with a live append
        journal = EventJournal(self.cas, batch_size=self.batch_size,
                               ref=self.ref, epoch=new_epoch,
                               lease_ttl_s=self.lease_ttl_s,
                               clock=self._clock)
        doc = load_operator_doc(self.cas)
        kwargs = {} if self.device_classes is None else {
            "device_classes": self.device_classes}
        if self.transport_factory is not None:
            kwargs["transport"] = self.transport_factory()
        svc = FabricService(seed=self.seed if seed is None else seed,
                            cas=self.cas, journal=journal,
                            retention=self.retention, **kwargs)
        configured_admission(doc, svc.admission)
        if journal.head is not None:
            svc.restore_from_journal()
        svc._persist_operator_config()
        self.promoted = svc
        if self.on_promoted is not None:
            self.on_promoted(svc)
        return svc


class FollowerAPI(FabricAPI):
    """The follower's HTTP surface: every GET of the normal API, writes
    refused with 409 — until ``POST /admin/promote`` flips it read-write
    over the promoted service (same process, same port, same handler
    table)."""

    def __init__(self, follower: FollowerFabric, *,
                 on_promoted=None, admin_token: str | None = None) -> None:
        super().__init__(follower.view, admin_token=admin_token)
        self.follower = follower
        self.read_only = True
        #: callback run with the promoted service (the CLI uses it to start
        #: the HTTP server's auto-pump thread)
        self.on_promoted = on_promoted
        # however promotion happens — operator POST or the tail loop's
        # auto-election — the HTTP surface flips read-write through here
        follower.on_promoted = self._adopt_promotion

    def _adopt_promotion(self, svc) -> None:
        self.service = svc
        self.read_only = False
        if self.on_promoted is not None:
            self.on_promoted(svc)

    def handle(self, method: str, path: str, body: dict | None = None,
               headers: dict | None = None) -> tuple[int, object]:
        if self.read_only and method.upper() != "GET" \
                and not path.split("?", 1)[0].rstrip("/").endswith(
                    "/admin/promote"):
            return 409, {"error": "read_only_follower",
                         "detail": ["this fabric is a warm standby; promote "
                                    "it or write to the primary"]}
        return super().handle(method, path, body, headers)

    def _replication(self, params, query, body) -> tuple[int, object]:
        if not self.read_only:
            return super()._replication(params, query, body)
        return 200, self.follower.replication_status()

    def _promote(self, params, query, body) -> tuple[int, object]:
        if not self.read_only:
            return super()._promote(params, query, body)
        svc = self.follower.promote()   # flips us via _adopt_promotion
        return 200, {"promoted": True, "epoch": svc.journal.epoch,
                     "jobs": len(svc.jobs),
                     "head": svc.journal.head}
