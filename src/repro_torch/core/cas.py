"""Content-addressable store: the port's own copy of what checkpointing
needs from ``repro/core/cas.py`` (the port imports nothing of the
reference package).

Every blob is immutable and named by the hash of its bytes, the same
``content_hash`` as the reference's (``repro/core/identity.py``), so the
two packages name equal bytes alike. Named refs are the one mutable cell
per name. Left out: epochs and fencing, leases, watches, GC, the pickle
object interface and publication.
"""
from __future__ import annotations

import hashlib
import os
import threading

HASH_LEN = 20  # hex chars kept, as in the reference


def content_hash(data: bytes) -> str:
    """CAS artifact name: the reference's ``digest("cas", data)``."""
    h = hashlib.sha256()
    for p in (b"cas", data):
        h.update(len(p).to_bytes(8, "little"))  # length-prefix: no ambiguity
        h.update(p)
    return h.hexdigest()[:HASH_LEN]


class IntegrityError(RuntimeError):
    pass


class CAS:
    """In-memory content-addressable store with byte accounting."""

    def __init__(self) -> None:
        self._blobs: dict[str, bytes] = {}
        self._refs: dict[str, str] = {}
        self._lock = threading.Lock()
        self.dedup_hits = 0      # writes skipped: content already present
        self.bytes_written = 0

    def set_ref(self, name: str, key: str) -> None:
        with self._lock:
            self._refs[name] = key

    def get_ref(self, name: str) -> str | None:
        with self._lock:
            return self._refs.get(name)

    def put_bytes(self, data: bytes) -> str:
        key = content_hash(data)
        with self._lock:
            if key not in self._blobs:
                self._blobs[key] = data
                self.bytes_written += len(data)
            else:
                self.dedup_hits += 1
        return key

    def get_bytes(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._blobs[key]
            except KeyError:
                raise KeyError(f"CAS miss: {key}") from None

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs


class DiskCAS(CAS):
    """Directory-backed CAS, in the reference's layout: blobs at
    ``<root>/<hash[:2]>/<hash>``, refs at ``<root>/refs/<name>`` with "/"
    as "_". Writes are atomic (tmp + rename)."""

    def __init__(self, root: str) -> None:
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key)

    def _ref_path(self, name: str) -> str:
        return os.path.join(self.root, "refs", name.replace("/", "_"))

    def _write(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def set_ref(self, name: str, key: str) -> None:
        with self._lock:
            # the reference's ref file (v3: key, epoch, lease), epoch 0 and
            # no lease
            self._write(self._ref_path(name), f"{key}\n0\n0.0\n".encode())

    def get_ref(self, name: str) -> str | None:
        try:
            with open(self._ref_path(name)) as f:
                lines = f.read().split()
        except FileNotFoundError:
            return None
        return lines[0] if lines else None

    def put_bytes(self, data: bytes) -> str:
        key = content_hash(data)
        path = self._path(key)
        with self._lock:
            if os.path.exists(path):
                self.dedup_hits += 1
                return key
            self._write(path, data)
            self.bytes_written += len(data)
        return key

    def get_bytes(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise KeyError(f"CAS miss: {key}") from None
        if content_hash(data) != key:
            raise IntegrityError(f"corrupt artifact {key}")
        return data

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))
