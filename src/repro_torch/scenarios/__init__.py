"""Digital-twin scenario engine on the port (DESIGN.md §15): the
reference's ``repro/scenarios`` with the port's imports.

Declarative scenario documents (tenant mix, arrival processes, deadline
distributions, dedup shaping, fault injection) compile into deterministic
traffic schedules and replay against a fabric — in-process virtual time
for golden tests and calibration sweeps, open-loop wall clock against a
live deployment for the ci.sh ``scenarios`` stage. The package imports
neither ``torch`` nor the reference: a fabric's executor (``SimExecutor``
or ``TorchExecutor``) comes in with the ``FabricService`` a caller hands
``run_virtual``.
"""
from .driver import (FaultActions, run_open_loop, run_virtual,
                     sweep_edf_boost)
from .report import REPORT_KEYS, append_trajectory, build_report, machine_tag
from .schema import (ARRIVAL_PROCESSES, FAULT_KINDS, SCENARIO_VERSION,
                     Arrival, Fault, Scenario, ScenarioError,
                     compile_scenario, load_scenario, load_scenario_doc,
                     validate_scenario)

__all__ = [
    "ARRIVAL_PROCESSES", "Arrival", "Fault", "FAULT_KINDS", "FaultActions",
    "REPORT_KEYS", "SCENARIO_VERSION", "Scenario", "ScenarioError",
    "append_trajectory", "build_report", "compile_scenario", "load_scenario",
    "load_scenario_doc", "machine_tag", "run_open_loop", "run_virtual",
    "sweep_edf_boost", "validate_scenario",
]
