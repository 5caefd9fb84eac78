"""FlowMesh fabric on the port: the tenant-facing service layer, the
reference's ``repro/fabric`` with the port's imports (every module below).

``spec``       — declarative workflow documents + named templates
``admission``  — per-tenant quotas, fair share (+EDF boost); all usage
                 accounting event-derived (bus subscriber)
``replay``     — the event fold shared by journal restore and compaction,
                 retention-trimmed under a RetentionPolicy
``operator``   — the CAS-rooted operator config document (quotas +
                 retention) that offline tools and restores agree on
``service``    — the long-lived FabricService wrapping one live engine,
                 with per-job event feeds, journal restore, scheduled
                 compaction + GC
``api``        — in-process request/response handler table (HTTP-shaped)
``http``       — socket server + urllib client over the same handler table
``follower``   — warm-standby follower: snapshot bootstrap + journal
                 tailing over the shared fold, epoch-fenced promotion
                 (+ lease-triggered auto-election, DESIGN.md §14)
``cluster``    — cluster-aware client: write redirect to the current
                 primary, read fan-out with sticky feed cursors

Observability (DESIGN.md §11) lives in core and is re-exported here:
``repro_torch.core.tracing.TraceState`` (replay-derived span trees +
dedup edges) and ``repro_torch.core.metrics.MetricsRegistry`` (wall-clock
counters / gauges / histograms behind ``GET /metrics``).
"""
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.core.tracing import TRACE_TRUNCATED_KIND, TraceState

from .admission import (AdmissionController, QuotaExceeded, TenantQuota,
                        TenantUsage)
from .api import FabricAPI
from .cluster import ClusterAPI
from .follower import FollowerAPI, FollowerFabric
from .http import FabricHTTPServer, RemoteAPI
from .operator import (OPERATOR_REF, configured_admission,
                       configured_retention, load_operator_doc,
                       save_operator_config)
from .replay import (FEED_KINDS, TRUNCATED_KIND, JobRecord, ReplayState,
                     RetentionPolicy, snapshot_fold, truncation_marker)
from .service import TERMINAL_STATUSES, FabricService, JobStatus
from .spec import (SpecError, compile_spec, default_resource_class,
                   list_templates, render_template, validate_spec)

__all__ = [
    "AdmissionController", "QuotaExceeded", "TenantQuota", "TenantUsage",
    "FabricAPI", "FabricHTTPServer", "RemoteAPI", "ClusterAPI",
    "FabricService",
    "FollowerAPI", "FollowerFabric",
    "FEED_KINDS", "TRUNCATED_KIND", "JobRecord", "ReplayState",
    "RetentionPolicy", "snapshot_fold", "truncation_marker",
    "MetricsRegistry", "TraceState", "TRACE_TRUNCATED_KIND",
    "OPERATOR_REF", "configured_admission", "configured_retention",
    "load_operator_doc", "save_operator_config",
    "JobStatus", "TERMINAL_STATUSES", "SpecError", "compile_spec",
    "default_resource_class",
    "list_templates", "render_template", "validate_spec",
]
