"""``correct`` comes out false where it should: the control (the
reference in the next lower precision in the program's place) fails the
cell's comparison, and so does a run whose timed path is broken
underneath -- half of the batch left out, an answer or a token altered
where it is produced. The harness runs whole, but for its look for a
card, at a size the CPU holds."""
import pytest

from perfbench_smoke import cnn_files, run

CNN = "resnet50.analyze.b256"


@pytest.mark.parametrize("fault", ["half", "answer"])
def test_cnn_faults_are_not_correct(fault):
    res = run(CNN, cnn_files(), fault=fault)
    assert res["correct"] is False
