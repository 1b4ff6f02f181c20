"""The control on the card, at a size a test run can hold: the reference
in TF32 put in the program's place fails the cells' limits, where the
program passes them. Run with `python -m pytest portbench/tests -m card`
on a machine with a card; the cells' own readings at their sizes are in
PERF.md."""

import pytest

from portbench.tests.tiny import drive
from portbench import run as bench_run

SMALL = {
    "serve-24k-bulk": dict(lengths=2, min_s=0.5, max_s=1.0, trace_requests=2, check_requests=2),
    "stream-44k-chunk": dict(lengths=2, min_s=2.0, max_s=3.0, trace_chunks=4, check_streams=2),
    "fm-24k-b256": dict(batch=16, utterances=16, manifest_repeats=2, trace_steps=2,
                        reference_rows=8),
}


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("control", [False, True])
def test_control_fails_where_the_program_passes(card, workload, control):
    r = bench_run.make_run(bench_run.load_benchmark(), workload, 2**31 + 99, 1.0, False, card,
                           control=control, mix_override=SMALL[workload])
    assert drive(r)["correct"] is not control
