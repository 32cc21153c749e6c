"""A run with the timed path broken underneath comes out not correct:
each planted fault, and the control (the reference at TF32 in the
program's place), at cut sizes on the CPU."""

import pytest

from bench_small import WORKLOADS, run_small
from benchmark import faults


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    with faults.planted(fault):
        r = run_small(workload)
    assert r["correct"] is False
    failed = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert failed


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    r = run_small(workload, mode="tf32")
    assert r["correct"] is False
    err = r["checks"]["d_err"]
    assert err["value"] > err["limit"]
