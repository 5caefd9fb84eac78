"""CAS-backed event journal: the control plane's durable history.

A bus subscriber that appends event batches to the CAS as a hash chain
(DESIGN.md §7–8). Each flushed segment is one immutable blob::

    {"prev": <key of previous segment | None>, "events": [event dicts]}

and a single mutable *named ref* (``CAS.set_ref``) points at the newest
segment. The write order is blob-then-ref, so a crash mid-flush leaves at
worst an orphan blob — the head never dangles, and replay always sees a
consistent prefix of history. Because every segment names its predecessor
by content hash, the chain is tamper-evident end to end (``DiskCAS`` also
re-hashes on read).

``replay()`` walks the chain head→tail, reverses it, and yields typed
events oldest-first — the input to ``FabricService.restore_from_journal``
and to offline provenance tooling (``fabric_cli.py tail --journal``).

**Compaction** (DESIGN.md §8): without retention the chain grows one
segment per ``batch_size`` events forever. ``compact()`` folds the oldest
segments through a caller-supplied *fold* (the same event-fold restore
uses — ``repro_torch.fabric.replay.ReplayState``) and replaces them with one
**snapshot node** at the root of the chain::

    {"prev": None, "snapshot": <fold state blob>, "events": []}

The kept tail segments are re-chained on top of the snapshot (their
``prev`` pointers change, so they are rewritten content-addressed), and a
single ``set_ref`` publishes the new head *after* every blob is durable —
the same crash discipline as ``flush``: a crash mid-compaction leaves the
old chain fully intact plus orphan blobs that ``CAS.gc`` reclaims. The
old segments become unreachable and are likewise reclaimed by GC.
"""
from __future__ import annotations

import time
from typing import Callable, Iterator, Protocol

from .cas import CAS
from .events import FabricEvent, event_from_dict

HEAD_REF = "journal-head"


class _NullTimer:
    """Stand-in for ``Histogram.time()`` when no registry is attached."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_TIMER = _NullTimer()


class SnapshotFold(Protocol):
    """What ``compact()`` needs from a fold: apply events, serialize state.

    The canonical implementation is ``repro_torch.fabric.replay.ReplayState`` —
    the *same* object ``FabricService.restore_from_journal`` folds events
    through, which is what makes restore-from-(snapshot+tail) byte-identical
    to restore-from-full-replay."""

    def apply(self, e: FabricEvent) -> None: ...

    def to_blob(self) -> dict: ...


class EventJournal:
    """Append-only, chained event log on top of a CAS."""

    def __init__(self, cas: CAS, *, batch_size: int = 256,
                 ref: str = HEAD_REF, epoch: int | None = None,
                 commit_latency_s: float | None = None,
                 max_buffer: int | None = None,
                 lease_ttl_s: float | None = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.cas = cas
        self.batch_size = max(1, batch_size)
        #: liveness lease (opt-in, DESIGN.md §14): when set, every head
        #: advance — and the idle-pump ``heartbeat_lease`` — stamps the ref
        #: with a wall-clock expiry ``clock() + lease_ttl_s``. A follower
        #: running with ``--auto-promote`` treats an *expired* lease as
        #: "primary silent" and elects itself through the fenced CAS path.
        #: ``None`` writes no lease (0.0 stored): manual promotion only.
        self.lease_ttl_s = lease_ttl_s
        self._clock = clock
        self._lease_beat = 0.0          # clock() of the last lease write
        #: adaptive **group commit** (opt-in): when set, segment cuts are
        #: driven by wall-clock buffer age instead of a fixed event count —
        #: a burst coalesces into ONE segment provided no buffered event
        #: waits longer than ``commit_latency_s`` for durability, with
        #: ``max_buffer`` as the hard cap on coalescing. ``None`` keeps the
        #: legacy fixed-``batch_size`` boundaries (what the crash/replay
        #: suites count segments against). Trade-off documented in
        #: DESIGN.md §12: a crash loses at most ``commit_latency_s`` worth
        #: of acknowledged-but-unflushed events, exactly as it previously
        #: lost up to ``batch_size - 1`` of them.
        self.commit_latency_s = commit_latency_s
        self.max_buffer = (max_buffer if max_buffer is not None
                           else max(self.batch_size, 1024))
        self._buf_opened: float | None = None   # perf_counter of first append
        self.ref = ref
        #: fencing epoch presented on every head advance (DESIGN.md §10):
        #: adopted from the stored ref by default, so a process that owned
        #: the journal keeps owning it across restarts — until a promotion
        #: bumps the stored epoch, after which this journal's appends raise
        #: ``RefFencedError`` (the zombie-primary cutoff)
        if epoch is None:
            key, epoch = cas.ref_entry(ref)
        self.epoch = epoch
        self._buf: list[dict] = []
        self.segments_written = 0
        self.events_written = 0
        self.bytes_flushed = 0        # cumulative segment bytes (this process)
        self.compactions = 0
        #: un-folded tail accounting — the scheduled-retention trigger
        #: (``FabricService.maybe_retain``) compares these against the
        #: policy's ``compact_every_segments`` / ``compact_every_bytes``;
        #: ``compact()`` resets them to the kept tail
        self.segments_since_compact = 0
        self.bytes_since_compact = 0
        #: optional ``MetricsRegistry`` (attached by the owning service):
        #: when set, append/flush/compact and the underlying CAS put are
        #: timed — the journal itself stays dependency-free
        self._metrics = None
        self._hists: dict[str, object] = {}
        self._append_probe = None   # bound histogram series (per registry)

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, registry) -> None:
        self._metrics = registry
        self._hists = {}        # cached handles belong to the old registry
        self._append_probe = None

    def _timer(self, name: str, help_text: str):
        """A wall-clock probe, or a no-op when no registry is attached.
        Histogram handles are cached per name — the registry lookup
        (lock + dict probe + label validation) is hot-path cost at one
        call per event."""
        if self._metrics is None:
            return _NULL_TIMER
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = self._metrics.histogram(name, help_text)
        return h.time()

    def claim(self) -> int:
        """Take explicit ownership of the head ref: bump the stored epoch
        (compare-and-set), fencing every other writer that held the journal
        — including a dead primary a supervisor later restarts, which would
        otherwise silently *re-adopt* the current epoch from the ref and
        defeat the fence. Long-lived writers (``fabric_cli.py serve``,
        promotion) claim at startup; read-only consumers and offline tools
        never do.

        The claim is always **durable**: on a chain with no head yet, an
        empty root segment is published first so the epoch has an entry to
        live in — two concurrent claimants of a fresh store therefore race
        on the same compare-and-set and exactly one wins (an in-memory-only
        claim would let both sides believe they own epoch 1)."""
        key, stored = self.cas.ref_entry(self.ref)
        if key is None:
            root = self.cas.put({"prev": None, "events": []})
            self.cas.set_ref(self.ref, root, epoch=stored + 1,
                             expect_epoch=stored,
                             lease_until=self._lease_until())
        else:
            self.cas.set_ref(self.ref, key, epoch=stored + 1,
                             expect_epoch=stored, expect_key=key,
                             lease_until=self._lease_until())
        self.epoch = stored + 1
        return self.epoch

    # ------------------------------------------------------------- lease --
    def _lease_until(self) -> float | None:
        """The expiry to stamp on the next head advance (None = no lease).
        Records the beat so ``heartbeat_lease`` can rate-limit itself."""
        if self.lease_ttl_s is None:
            return None
        self._lease_beat = self._clock()
        return self._lease_beat + self.lease_ttl_s

    def heartbeat_lease(self, *, force: bool = False) -> bool:
        """Re-assert liveness on the head ref *without* flushing: rewrite
        the current head key with this journal's epoch and a fresh lease
        expiry. Called from the serving pump each iteration; internally
        rate-limited to one write per ``lease_ttl_s / 3`` so an idle pump
        costs three ref writes per TTL, not one per tick. Raises
        ``RefFencedError`` if the journal lost the head (zombie primary) —
        same contract as ``flush``. Returns True when a write happened."""
        if self.lease_ttl_s is None:
            return False
        now = self._clock()
        if not force and now - self._lease_beat < self.lease_ttl_s / 3.0:
            return False
        key = self.head
        if key is None:
            return False        # nothing published yet: claim()/flush lease
        self.cas.set_ref(self.ref, key, epoch=self.epoch,
                         lease_until=now + self.lease_ttl_s)
        self._lease_beat = now
        return True

    # ------------------------------------------------------------- write --
    def on_event(self, e: FabricEvent) -> None:
        """Bus subscriber: buffer the event; cut a segment at the commit
        boundary. The append probe times ONLY the buffer append — the
        amortized segment flush runs outside it under its own
        ``fabric_journal_flush_seconds`` probe, so the append histogram's
        p95 reflects what every event pays, not what one unlucky event at
        the batch boundary absorbed for its whole cohort."""
        buf = self._buf
        if self._metrics is None:
            if not buf:
                self._buf_opened = time.perf_counter()
            buf.append(e.to_dict())
        else:
            # bound series handle + inline timing: this probe fires once per
            # published event, so it must not pay context-manager or label
            # resolution overhead
            probe = self._append_probe
            if probe is None:
                probe = self._append_probe = self._metrics.histogram(
                    "fabric_journal_append_seconds",
                    "Wall-clock cost of buffering one event "
                    "(segment flush is timed separately)").child()
            t0 = time.perf_counter()
            if not buf:
                self._buf_opened = t0
            buf.append(e.to_dict())
            probe.observe(time.perf_counter() - t0)
        if self.commit_latency_s is None:
            if len(self._buf) >= self.batch_size:
                self.flush()
        elif (len(self._buf) >= self.max_buffer
              or time.perf_counter() - self._buf_opened
              >= self.commit_latency_s):
            self.flush()

    def flush(self) -> str | None:
        """Persist buffered events as one chained segment; returns its key
        (None when the buffer was empty)."""
        if not self._buf:
            return None
        with self._timer("fabric_journal_flush_seconds",
                         "Wall-clock duration of one segment flush"):
            with self._timer("fabric_cas_put_seconds",
                             "Wall-clock duration of one CAS put"):
                # put_sized: one serialization reports the stored size, so
                # the byte accounting below costs no second store touch
                # (DiskCAS previously stat'ed every segment twice)
                key, size = self.cas.put_sized(
                    {"prev": self.head, "events": self._buf})
            # blob first, then the head; a fenced (post-promotion) writer
            # dies here with the buffer intact and the chain untouched
            self.cas.set_ref(self.ref, key, epoch=self.epoch,
                             lease_until=self._lease_until())
        self.segments_written += 1
        self.events_written += len(self._buf)
        self.bytes_flushed += size
        self.segments_since_compact += 1
        self.bytes_since_compact += size
        self._buf = []
        self._buf_opened = None
        return key

    @property
    def head(self) -> str | None:
        return self.cas.get_ref(self.ref)

    @property
    def pending(self) -> int:
        """Buffered events not yet durable (lost if the process dies now)."""
        return len(self._buf)

    # -------------------------------------------------------------- read --
    def _segment_keys(self) -> list[str]:
        keys: list[str] = []
        key = self.head
        while key is not None:
            keys.append(key)
            key = self.cas.get(key)["prev"]
        keys.reverse()                      # oldest first
        return keys

    def base_state(self) -> dict | None:
        """The snapshot blob at the root of the chain, if compaction has
        run — the fold state restore starts from before tail replay."""
        keys = self._segment_keys()
        if not keys:
            return None
        return self.cas.get(keys[0]).get("snapshot")

    def replay(self) -> Iterator[FabricEvent]:
        """Yield the journaled history oldest-first as typed events (the
        *tail* after any snapshot node — compacted history is carried by
        ``base_state()``, not re-yielded). Events still sitting in the
        write buffer are included (so an in-process reader sees everything
        the bus has published)."""
        for key in self._segment_keys():
            for d in self.cas.get(key)["events"]:
                yield event_from_dict(d)
        for d in self._buf:
            yield event_from_dict(d)

    def __len__(self) -> int:
        return self.events_written + len(self._buf)

    def chain_stats(self) -> dict:
        """Walk the durable chain and report its true footprint (segments,
        bytes, tail events, snapshot presence) — the `GET /admin/retention`
        surface. O(segments); the hot-path trigger uses the O(1)
        ``*_since_compact`` counters instead."""
        segments = total_bytes = tail_bytes = tail_events = 0
        has_snapshot = False
        key = self.head
        while key is not None:
            blob = self.cas.get(key)
            size = self.cas.size_of(key)
            segments += 1
            total_bytes += size
            tail_events += len(blob["events"])
            if "snapshot" in blob:
                has_snapshot = True
            else:
                tail_bytes += size      # un-folded history, not the snapshot
            key = blob["prev"]
        return {"segments": segments, "bytes": total_bytes,
                "tail_bytes": tail_bytes, "tail_events": tail_events,
                "snapshot": has_snapshot, "pending": self.pending,
                "since_compact": {"segments": self.segments_since_compact,
                                  "bytes": self.bytes_since_compact}}

    # --------------------------------------------------------- compaction --
    def compact(self, fold_factory: Callable[[dict | None], SnapshotFold],
                *, keep_segments: int = 0) -> dict:
        """Fold all but the newest ``keep_segments`` segments into a snapshot
        node and re-chain the head on top of it.

        ``fold_factory(base)`` must return a fold pre-loaded with ``base``
        (the existing snapshot state, or None) — compaction is incremental:
        an already-compacted chain folds only the segments that accumulated
        since the last snapshot. The caller supplies the fold because the
        journal is policy-agnostic: the fold's quota configuration (fair-
        share weights) must match what restore will use, exactly as the
        restore contract already requires (DESIGN.md §7).

        Write order: snapshot blob, rewritten tail blobs, then ONE
        ``set_ref`` — a crash anywhere before the ref advance leaves the old
        chain intact (orphans at worst, reclaimed by ``CAS.gc``).
        """
        self.flush()
        with self._timer("fabric_journal_compact_seconds",
                         "Wall-clock duration of one compaction"):
            return self._compact_locked(fold_factory, keep_segments)

    def _compact_locked(self, fold_factory, keep_segments: int) -> dict:
        keys = self._segment_keys()
        base: dict | None = None
        if keys and "snapshot" in (root := self.cas.get(keys[0])):
            base = root["snapshot"]
            keys = keys[1:]
        cut = len(keys) - max(0, keep_segments)
        if cut <= 0:
            return {"snapshot": None, "head": self.head,
                    "folded_segments": 0, "folded_events": 0,
                    "kept_segments": len(keys)}
        fold = fold_factory(base)
        folded_events = 0
        for key in keys[:cut]:
            for d in self.cas.get(key)["events"]:
                fold.apply(event_from_dict(d))
                folded_events += 1
        snap_key = self.cas.put({"prev": None, "snapshot": fold.to_blob(),
                                 "events": []})
        head = snap_key
        tail_bytes = 0
        for key in keys[cut:]:              # re-chain the kept tail
            head, size = self.cas.put_sized(
                {"prev": head, "events": self.cas.get(key)["events"]})
            tail_bytes += size
        # single atomic head advance (fenced like flush)
        self.cas.set_ref(self.ref, head, epoch=self.epoch,
                         lease_until=self._lease_until())
        self.compactions += 1
        # the un-folded tail is now exactly the kept segments
        self.segments_since_compact = len(keys) - cut
        self.bytes_since_compact = tail_bytes
        return {"snapshot": snap_key, "head": head,
                "folded_segments": cut, "folded_events": folded_events,
                "kept_segments": len(keys) - cut}
