"""Deterministic scenario-matrix harness for fleet / fault / recovery runs.

``repro_torch.testing`` is a *library* (imported by the test suite and the
fault-recovery benchmark alike): a declarative grid of
(testbed x traffic x fault schedule x fleet size) scenarios, each of which
runs to a canonical trace that can be compared bit-for-bit across runs and
checked against physical invariants.
"""
from repro_torch.testing.scenarios import (
    SCENARIO_MATRIX,
    Scenario,
    build_faults,
    build_requests,
    build_scenario_db,
    canonical_trace,
    check_invariants,
    delivered_fraction,
    run_scenario,
    tracking_accuracy,
)

__all__ = [
    "SCENARIO_MATRIX",
    "Scenario",
    "build_faults",
    "build_requests",
    "build_scenario_db",
    "canonical_trace",
    "check_invariants",
    "delivered_fraction",
    "run_scenario",
    "tracking_accuracy",
]
