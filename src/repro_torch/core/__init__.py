"""FlowMesh core on the port: the control plane as a composable library.

Public facade: build an engine with a policy + executor + backend, submit
workflow DAGs, run, read telemetry. The port's copy of ``repro/core``,
journal, tracing and metrics included; the real-compute executor is
``torch_executor.TorchExecutor``.
"""
from .autoscaler import Autoscaler, AutoscalerConfig
from .backends import KubernetesBackend, VastAiBackend
from .cas import CAS, DiskCAS
from .consolidation import ReadyPool
from .control_plane import EngineConfig, FlowMeshEngine
from .dag import OperatorSpec, OpState, OpType, Ref, WorkflowDAG
from .events import EventBus, FabricEvent, event_from_dict
from .identity import (canonical, content_hash, exec_signature, model_hash,
                       task_hash)
from .journal import EventJournal
from .scheduler import (POLICIES, FirstFitScheduler, FlowMeshScheduler,
                        RoundRobinScheduler, StaticRoutingScheduler)
from .simulator import FaultInjector, SimExecutor
from .telemetry import Telemetry
from .worker import ExecResult, Executor, Worker
from .workloads import WorkloadCfg, WorkloadGen

__all__ = [
    "Autoscaler", "AutoscalerConfig", "KubernetesBackend", "VastAiBackend",
    "CAS", "DiskCAS", "ReadyPool", "EngineConfig", "FlowMeshEngine",
    "EventBus", "FabricEvent", "event_from_dict", "EventJournal",
    "OperatorSpec", "OpState", "OpType", "Ref", "WorkflowDAG",
    "canonical", "content_hash", "exec_signature", "model_hash", "task_hash",
    "POLICIES", "FirstFitScheduler", "FlowMeshScheduler",
    "RoundRobinScheduler", "StaticRoutingScheduler",
    "FaultInjector", "SimExecutor", "Telemetry",
    "ExecResult", "Executor", "Worker", "WorkloadCfg", "WorkloadGen",
]
