"""Whole runs on the CPU at the tiny size, past the look for a card: a
sound run comes out correct under the cells' limits, and a run with a fault
planted underneath its timed path comes out not correct, for each fault the
cell can have."""

import pytest

from portbench.tests.tiny import drive, tiny_run

CASES = [
    ("serve-24k-bulk", None, True), ("serve-24k-bulk", "shift_output", False),
    ("stream-44k-chunk", None, True), ("stream-44k-chunk", "shift_output", False),
    ("fm-24k-b256", None, True), ("fm-24k-b256", "half_batch", False),
    ("fm-24k-b256", "frozen_step", False),
    ("fm-24k-dp4", "no_exchange", False), ("fm-24k-dp4", "half_batch", False),
]


@pytest.mark.parametrize("workload,fault,correct", CASES)
def test_correct_decides(workload, fault, correct):
    line = drive(tiny_run(workload, fault=fault))
    assert line["correct"] is correct, line["checks"]
    assert list(line)[-1] == "checks"


def test_traced_run_reads_the_spans():
    line = drive(tiny_run("fm-24k-b256", trace=True))
    assert "loader_wait_ms.train" in line["metrics"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line
