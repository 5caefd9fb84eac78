"""Content-addressable store (CAS) — the data plane's source of truth.

Every artifact (model checkpoints, adapters, tokenizers, rollout samples,
reward scores, eval traces) is immutable and named by the hash of its bytes.
Properties the fabric relies on (§3.2–3.3):

  * at-most-once publication: ``publish`` is idempotent — the first write wins,
    duplicate/speculative completions are discarded by content identity;
  * provenance: downstream stages receive immutable hashes, never pointers;
  * retry safety: a retried operator re-reads the exact same inputs.

Backends: in-memory dict (simulation / tests) and a directory on disk
(checkpoints, examples). Both enforce immutability.

The port's copy of ``repro/core/cas.py``: the same names (``content_hash``
of ``identity.py``), the same on-disk layout and ref file format, so the
two packages read each other's stores.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import threading
import time
from typing import Any, Iterable, Iterator

from .identity import HASH_LEN, content_hash

try:                        # inter-process ref fencing on DiskCAS (POSIX)
    import fcntl
except ImportError:         # pragma: no cover - non-POSIX fallback
    fcntl = None


class IntegrityError(RuntimeError):
    pass


class RefFencedError(RuntimeError):
    """A ``set_ref`` lost the fencing check: the stored epoch has moved past
    the writer's. The canonical producer of this error is a *zombie primary*
    — a fabric process that kept running after a follower promoted itself
    (bumping the head ref's epoch) and then tried to append to the journal
    it no longer owns. The write never lands; the chain stays consistent."""

    def __init__(self, name: str, stored_epoch: int, epoch: int) -> None:
        self.name = name
        self.stored_epoch = stored_epoch
        self.epoch = epoch
        super().__init__(
            f"ref {name!r}: fenced (stored epoch {stored_epoch}, "
            f"writer epoch {epoch})")


#: what a CAS key looks like in a decoded blob (see ``CAS.gc``)
_KEY_RE = re.compile(rf"^[0-9a-f]{{{HASH_LEN}}}$")


def _candidate_keys(obj: Any) -> Iterator[str]:
    """Recursively yield every string in ``obj`` shaped like a CAS key.

    The GC tracer is deliberately format-agnostic: journal segments name
    their predecessor (``prev``), snapshots carry a result index, and events
    carry artifact hashes — all plain hex strings. Treating *any* key-shaped
    string found in a live blob as a reference is conservative (a false
    positive retains a blob; it never frees a live one)."""
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, str):
            if _KEY_RE.match(x):
                yield x
        elif isinstance(x, dict):
            stack.extend(x.keys())
            stack.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset)):
            stack.extend(x)


class CAS:
    """In-memory content-addressable store with byte-accounting."""

    def __init__(self) -> None:
        self._blobs: dict[str, bytes] = {}
        self._refs: dict[str, str] = {}
        self._ref_epochs: dict[str, int] = {}
        self._ref_leases: dict[str, float] = {}
        self._lock = threading.Lock()
        #: ref watchers park here; ``set_ref`` notifies (callback-driven —
        #: no polling for the in-memory backend)
        self._ref_cond = threading.Condition(self._lock)
        self.puts = 0            # write attempts
        self.dedup_hits = 0      # writes skipped because content already present
        self.gets = 0
        self.bytes_written = 0

    # -- named refs ----------------------------------------------------------
    # The one deliberately *mutable* cell per name in an otherwise immutable
    # store: a ref names the head of a hash-chained structure (e.g. the
    # event journal), and advancing it is the only non-idempotent write.
    # Each ref additionally carries a fencing **epoch** (default 0): a
    # writer that presents an epoch older than the stored one is rejected
    # with ``RefFencedError`` — the primitive warm-standby promotion uses to
    # cut a zombie primary off the journal head (DESIGN.md §10).
    @staticmethod
    def _fence(name: str, stored_key: str | None, stored_epoch: int,
               epoch: int | None, expect_epoch: int | None,
               expect_key: str | None) -> int:
        """Resolve the epoch a ``set_ref`` may write, or raise.

        ``epoch=None`` is an unconditional write that preserves the stored
        epoch (legacy refs: operator config, shadow journals). With
        ``expect_epoch`` the write is a compare-and-set — stored epoch (and
        ``expect_key`` when given) must match exactly; this is the promotion
        takeover. Otherwise the append rule applies: the write lands only if
        the stored epoch has not moved past the writer's."""
        if epoch is None:
            return stored_epoch
        if expect_epoch is not None:
            if stored_epoch != expect_epoch or (
                    expect_key is not None and stored_key != expect_key):
                raise RefFencedError(name, stored_epoch, epoch)
        elif stored_epoch > epoch:
            raise RefFencedError(name, stored_epoch, epoch)
        return epoch

    def set_ref(self, name: str, key: str, *, epoch: int | None = None,
                expect_epoch: int | None = None,
                expect_key: str | None = None,
                lease_until: float | None = None) -> None:
        """Advance a named ref.

        ``lease_until`` is a wall-clock (``time.time``) liveness lease: the
        writer asserts "I am alive and own this ref until T". A write that
        passes ``None`` clears any stored lease — a non-heartbeating writer
        must not leave a predecessor's stale promise behind. A stored lease
        of 0.0 means *no lease*: manual promotion only (DESIGN.md §14)."""
        with self._lock:
            self._ref_epochs[name] = self._fence(
                name, self._refs.get(name), self._ref_epochs.get(name, 0),
                epoch, expect_epoch, expect_key)
            self._refs[name] = key
            if lease_until is None:
                self._ref_leases.pop(name, None)
            else:
                self._ref_leases[name] = float(lease_until)
            self._ref_cond.notify_all()

    def get_ref(self, name: str) -> str | None:
        with self._lock:
            return self._refs.get(name)

    def ref_entry(self, name: str) -> tuple[str | None, int]:
        """One ref's ``(key, epoch)`` — epoch 0 when the ref is unset or was
        only ever written by epoch-unaware callers."""
        with self._lock:
            return self._refs.get(name), self._ref_epochs.get(name, 0)

    def ref_lease(self, name: str) -> float:
        """The stored liveness lease expiry (wall-clock seconds), 0.0 when
        the ref is unset or its last writer did not lease."""
        with self._lock:
            return self._ref_leases.get(name, 0.0)

    def watch_ref(self, name: str, since: str | None = None, *,
                  timeout_s: float | None = None,
                  poll_interval_s: float = 0.05) -> str | None:
        """Block until ref ``name`` points somewhere other than ``since``;
        returns the new key (or None on timeout). ``since=None`` waits for
        the ref to exist at all. The in-memory backend wakes on the
        ``set_ref`` notification (no polling); ``DiskCAS`` overrides with a
        cross-process poll that stat-short-circuits unchanged files."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._ref_cond:
            while True:
                cur = self._refs.get(name)
                if cur != since:
                    return cur
                if deadline is None:
                    self._ref_cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._ref_cond.wait(remaining)

    def refs(self) -> dict[str, str]:
        """All named refs — the GC root set."""
        with self._lock:
            return dict(self._refs)

    # -- raw byte interface -------------------------------------------------
    def put_bytes(self, data: bytes) -> str:
        key = content_hash(data)
        with self._lock:
            self.puts += 1
            if key not in self._blobs:
                self._blobs[key] = data
                self.bytes_written += len(data)
            else:
                self.dedup_hits += 1
        return key

    def get_bytes(self, key: str) -> bytes:
        with self._lock:
            self.gets += 1
            try:
                return self._blobs[key]
            except KeyError:
                raise KeyError(f"CAS miss: {key}") from None

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs

    def __len__(self) -> int:
        return len(self._blobs)

    def keys(self) -> Iterator[str]:
        return iter(list(self._blobs))

    def size_of(self, key: str) -> int:
        return len(self._blobs[key])

    def delete(self, key: str) -> None:
        """Drop one blob (GC only — callers must hold no live reference)."""
        with self._lock:
            self._blobs.pop(key, None)

    @staticmethod
    def _decode_for_trace(data: bytes) -> Any | None:
        """Decode a blob for reference tracing: pickle (journal segments,
        snapshots) or JSON (checkpoint manifests/pointers); anything else —
        raw artifact/tensor bytes — is an opaque leaf."""
        try:
            return pickle.loads(data)
        except Exception:
            pass
        try:
            return json.loads(data)
        except Exception:
            return None

    # -- garbage collection ---------------------------------------------------
    def gc(self, roots: Iterable[str] = ()) -> dict:
        """Mark-and-sweep: drop every blob unreachable from the named refs
        plus ``roots``.

        Mark walks *into* blobs: a reachable blob is decoded (pickle; raw
        artifacts are opaque leaves) and any key-shaped string it contains
        that names a stored blob is followed. This covers journal segments
        (``prev`` chains), snapshots (result index, lineage hashes), and the
        artifact hashes inside journaled events — so dedup-across-restart
        artifacts survive as long as the history naming them does. A crash
        between ``put`` and ``set_ref`` leaves exactly the orphan this
        reclaims. Callers are responsible for quiescence: blobs written but
        not yet referenced by a ref/root at sweep time are collected.
        """
        live: set[str] = set()
        queue: list[str] = [k for k in self.refs().values() if k]
        queue.extend(roots)
        while queue:
            key = queue.pop()
            if key in live or key not in self:
                continue
            live.add(key)
            obj = self._decode_for_trace(self.get_bytes(key))
            if obj is not None:
                queue.extend(_candidate_keys(obj))
        swept = [k for k in self.keys() if k not in live]
        reclaimed = 0
        for k in swept:
            try:
                reclaimed += self.size_of(k)
            except (KeyError, OSError):
                pass
            self.delete(k)
        # `reclaimed_*` duplicate deleted/bytes_reclaimed under the names the
        # operator surfaces (CLI `gc`, POST /admin/gc) report — one payload
        # serves both the legacy callers and the reclamation asserts in CI
        return {"kept": len(live), "deleted": len(swept),
                "bytes_reclaimed": reclaimed,
                "reclaimed_blobs": len(swept), "reclaimed_bytes": reclaimed}

    # -- object interface (pickle round-trip) --------------------------------
    def put(self, obj: Any) -> str:
        return self.put_bytes(pickle.dumps(obj, protocol=4))

    def put_sized(self, obj: Any) -> tuple[str, int]:
        """``put`` that also reports the stored size — one serialization and
        one store touch, where ``put`` + ``size_of`` would stat the blob a
        second time (on DiskCAS: a second disk access per journal segment).
        Works unchanged on both backends: the stored size IS ``len(data)``."""
        data = pickle.dumps(obj, protocol=4)
        return self.put_bytes(data), len(data)

    def get(self, key: str) -> Any:
        return pickle.loads(self.get_bytes(key))

    # -- at-most-once publication --------------------------------------------
    def publish(self, data: bytes) -> tuple[str, bool]:
        """Returns (key, won). ``won`` is False when an identical artifact was
        already published (late speculative replica -> discarded)."""
        key = content_hash(data)
        with self._lock:
            self.puts += 1
            if key in self._blobs:
                self.dedup_hits += 1
                return key, False
            self._blobs[key] = data
            self.bytes_written += len(data)
            return key, True


class DiskCAS(CAS):
    """Directory-backed CAS (used for checkpoints and cross-process examples).

    Layout: <root>/<hash[:2]>/<hash>. Writes are atomic (tmp + rename) so a
    preempted worker can never corrupt a published artifact.
    """

    def __init__(self, root: str) -> None:
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key)

    # -- named refs (cross-process: survive restarts) ------------------------
    # File format, versioned by line count (every parser accepts every
    # older version; newer files degrade gracefully for older readers
    # because extra tokens are simply ignored):
    #   v1: <key>                                  (pre-epoch refs)
    #   v2: <key>\n<epoch>                         (fencing, DESIGN.md §10)
    #   v3: <key>\n<epoch>\n<lease_until>          (liveness, DESIGN.md §14)
    # ``lease_until`` is a wall-clock expiry; 0.0 (or absent) = no lease.
    # Fenced writes take a per-ref flock so read-check-write is atomic
    # *across processes* — the promotion CAS and a zombie primary's append
    # cannot interleave.
    def _ref_path(self, name: str) -> str:
        safe = name.replace("/", "_")
        return os.path.join(self.root, "refs", safe)

    @classmethod
    def _parse_ref(cls, content: str) -> tuple[str | None, int]:
        return cls._parse_ref_full(content)[:2]

    @staticmethod
    def _parse_ref_full(content: str) -> tuple[str | None, int, float]:
        lines = content.split()
        key = lines[0] if lines else None
        try:
            epoch = int(lines[1]) if len(lines) > 1 else 0
        except ValueError:
            epoch = 0
        try:
            lease = float(lines[2]) if len(lines) > 2 else 0.0
        except ValueError:
            lease = 0.0
        return key or None, epoch, lease

    @contextlib.contextmanager
    def _ref_flock(self, name: str):
        """Inter-process mutex for one ref's read-check-write cycle."""
        lock_dir = os.path.join(self.root, "locks")
        os.makedirs(lock_dir, exist_ok=True)
        path = os.path.join(lock_dir, name.replace("/", "_"))
        fd = os.open(path, os.O_CREAT | os.O_RDWR)
        try:
            if fcntl is not None:
                fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            if fcntl is not None:
                fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def set_ref(self, name: str, key: str, *, epoch: int | None = None,
                expect_epoch: int | None = None,
                expect_key: str | None = None,
                lease_until: float | None = None) -> None:
        path = self._ref_path(name)
        with self._lock, self._ref_flock(name):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            stored_key, stored_epoch = self._read_ref(path)
            write_epoch = self._fence(name, stored_key, stored_epoch,
                                      epoch, expect_epoch, expect_key)
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                f.write(f"{key}\n{write_epoch}\n{lease_until or 0.0}\n")
            os.replace(tmp, path)       # atomic head advance

    @classmethod
    def _read_ref(cls, path: str) -> tuple[str | None, int]:
        return cls._read_ref_full(path)[:2]

    @classmethod
    def _read_ref_full(cls, path: str) -> tuple[str | None, int, float]:
        try:
            with open(path) as f:
                return cls._parse_ref_full(f.read())
        except FileNotFoundError:
            return None, 0, 0.0

    def get_ref(self, name: str) -> str | None:
        return self._read_ref(self._ref_path(name))[0]

    def ref_entry(self, name: str) -> tuple[str | None, int]:
        return self._read_ref(self._ref_path(name))

    def ref_lease(self, name: str) -> float:
        return self._read_ref_full(self._ref_path(name))[2]

    def watch_ref(self, name: str, since: str | None = None, *,
                  timeout_s: float | None = None,
                  poll_interval_s: float = 0.05) -> str | None:
        """Cross-process ref watch: poll the ref file, but only open and
        parse it when its stat signature (mtime_ns, inode, size) moved — an
        idle follower's watch loop costs one ``stat`` per interval, never a
        read. ``os.replace`` guarantees every advance lands as a new inode,
        so the signature cannot miss a change."""
        path = self._ref_path(name)
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        last_sig: tuple | None = ()       # sentinel: always read first pass
        while True:
            try:
                st = os.stat(path)
                sig = (st.st_mtime_ns, st.st_ino, st.st_size)
            except FileNotFoundError:
                sig = None
            if sig != last_sig:
                last_sig = sig
                cur = self.get_ref(name)
                if cur != since:
                    return cur
            wait = poll_interval_s
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                wait = min(wait, remaining)
            time.sleep(wait)

    def refs(self) -> dict[str, str]:
        refs_dir = os.path.join(self.root, "refs")
        out: dict[str, str] = {}
        try:
            names = os.listdir(refs_dir)
        except FileNotFoundError:
            return out
        for name in names:
            if ".tmp." in name:
                continue
            key = self.get_ref(name)
            if key:
                out[name] = key
        return out

    def put_bytes(self, data: bytes) -> str:
        key = content_hash(data)
        path = self._path(key)
        with self._lock:
            self.puts += 1
            if os.path.exists(path):
                self.dedup_hits += 1
                return key
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic publication
            self.bytes_written += len(data)
        return key

    def get_bytes(self, key: str) -> bytes:
        with self._lock:
            self.gets += 1
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise KeyError(f"CAS miss: {key}") from None
        if content_hash(data) != key:
            raise IntegrityError(f"corrupt artifact {key}")
        return data

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def __len__(self) -> int:
        return sum(1 for _ in self.keys())

    def size_of(self, key: str) -> int:
        try:
            return os.path.getsize(self._path(key))
        except FileNotFoundError:
            raise KeyError(f"CAS miss: {key}") from None

    def delete(self, key: str) -> None:
        with self._lock:
            try:
                os.remove(self._path(key))
            except FileNotFoundError:
                pass

    def keys(self) -> Iterator[str]:
        for sub in os.listdir(self.root):
            subdir = os.path.join(self.root, sub)
            # only hash-prefix shards are keyspace; skips refs/ and strays
            if len(sub) == 2 and os.path.isdir(subdir):
                for k in os.listdir(subdir):
                    if ".tmp." not in k:
                        yield k

    def publish(self, data: bytes) -> tuple[str, bool]:
        key = content_hash(data)
        existed = key in self
        self.put_bytes(data)
        return key, not existed
