"""The persisted operator document: config the fabric must agree on offline.

Quota configuration (fair-share weights change how vtime folds) and the
retention policy (what a snapshot may legally drop) are *operator config*,
not journaled history — yet every consumer of the journal must apply the
same values or restores and offline compactions silently diverge from what
the live fabric computed (DESIGN.md §7–§9).

This module roots that config in the CAS itself: one named ref
(``operator-config``) points at a content-addressed document blob::

    {"format": 1,
     "admission": {"deadline_boost": ..., "default_quota": {...},
                   "quotas": {tenant: {...}}},
     "retention": {<RetentionPolicy fields>}}

The live service writes through on every ``set_quota`` (and at startup), so
``fabric_cli.py compact`` / a restoring process can load the document from
the very store that holds the journal — no side-channel config file to
drift. Being a named ref, the document is automatically a GC root.

Precedence everywhere: **live flag > CAS document > built-in default** —
an operator overriding config at the CLI wins for that process, and the
override is written back so the next offline consumer agrees.
"""
from __future__ import annotations

from .admission import AdmissionController
from .replay import RetentionPolicy

OPERATOR_REF = "operator-config"

#: operator document schema version
OPERATOR_FORMAT = 1


def operator_doc(admission: AdmissionController,
                 retention: RetentionPolicy) -> dict:
    """Serialize the effective operator configuration as one document."""
    return {"format": OPERATOR_FORMAT,
            "admission": admission.dump_config(),
            "retention": retention.to_dict()}


def save_operator_config(cas, admission: AdmissionController,
                         retention: RetentionPolicy, *,
                         ref: str = OPERATOR_REF) -> str:
    """Persist the document and advance its named ref; returns the blob key.
    Blob-then-ref, like every other mutable head in the store."""
    key = cas.put(operator_doc(admission, retention))
    cas.set_ref(ref, key)
    return key


def load_operator_doc(cas, *, ref: str = OPERATOR_REF) -> dict | None:
    """The persisted document, or None when the store carries none."""
    key = cas.get_ref(ref)
    if key is None or key not in cas:
        return None
    doc = cas.get(key)
    if doc.get("format") != OPERATOR_FORMAT:
        raise ValueError(
            f"unsupported operator-config format {doc.get('format')!r}")
    return doc


def configured_admission(doc: dict | None,
                         admission: AdmissionController | None = None,
                         ) -> AdmissionController:
    """An AdmissionController carrying the document's quota config (fresh
    or applied onto ``admission``); defaults when there is no document."""
    admission = admission or AdmissionController()
    if doc is not None:
        admission.load_config(doc["admission"])
    return admission


def configured_retention(doc: dict | None,
                         override: RetentionPolicy | None = None,
                         ) -> RetentionPolicy:
    """Resolve a retention policy with the documented precedence:
    ``override`` (live flag) > ``doc`` (CAS document) > default."""
    if override is not None:
        return override
    if doc is not None:
        return RetentionPolicy.from_dict(doc["retention"])
    return RetentionPolicy()
