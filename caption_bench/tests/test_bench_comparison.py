"""A whole run of each kind of loop at a tiny width on the CPU, the port's
CPU path judged by the reference: with the arithmetic alike (float32 on
both sides) every served token lies in its admitted set. Then the program's
int8 path, the control, and each planted fault, all of which come out not
correct."""
import pytest

from caption_bench import faults, harness

from bench_helpers import tiny_cell

KINDS = ["batch_warm", "served"]


@pytest.mark.parametrize("kind", KINDS)
def test_the_port_agrees_with_the_reference(kind):
    cell = tiny_cell(kind)
    r = harness.run_cell(cell, 2 ** 31 + 5, 2.0, False, device="cpu")
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["unjudged_requests"]["value"] == 0
    assert r["checks"]["mean_gap"]["value"] <= r["checks"]["mean_gap"]["limit"]
    assert r["correct"] is True
    assert list(r)[-2:] == ["checks", "_diagnostics"]


def test_the_int8_control_is_not_correct():
    cell = tiny_cell("batch_warm")
    r = harness.run_cell(cell, 11, 2.0, False, device="cpu", control=True)
    assert r["correct"] is False
    assert r["checks"]["mean_gap"]["value"] > r["checks"]["mean_gap"]["limit"]


CASES = [(k, f) for k in KINDS for f in ("token", "half", "stale")]
"""Every fault a cell can have (no cell runs on more than one chip)."""


@pytest.mark.parametrize("kind,fault", CASES)
def test_a_planted_fault_is_not_correct(kind, fault):
    cell = tiny_cell(kind)
    with faults.FAULTS[fault]():
        r = harness.run_cell(cell, 23, 2.0, False, device="cpu")
    assert r["correct"] is False
    assert r["checks"]["mean_gap"]["value"] > r["checks"]["mean_gap"]["limit"]
