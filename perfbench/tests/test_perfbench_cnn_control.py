"""``correct`` comes out false where it should: the control (the
reference in the next lower precision in the program's place) fails the
cell's comparison, and so does a run whose timed path is broken
underneath -- half of the batch left out, an answer or a token altered
where it is produced. The harness runs whole, but for its look for a
card, at a size the CPU holds."""
import pytest

from perfbench_smoke import cnn_files, run

CNN = "resnet50.analyze.b256"


@pytest.fixture(scope="module")
def cnn_control():
    return run(CNN, cnn_files(), control=True)


def test_cnn_sound_run_matches_the_reference(cnn_control):
    checks = cnn_control["checks"]
    for name in ("energy_gap", "summary_gap", "selection_differs",
                 "repeat_differs"):
        assert checks[name]["value"] <= checks[name]["limit"], name
    assert checks["energy_gap"]["value"] == 0.0
    assert cnn_control["attempted"] >= 1 and cnn_control["failed"] == 0
    assert list(cnn_control)[-1] == "checks"


def test_cnn_control_is_not_correct(cnn_control):
    control = cnn_control["control"]
    assert any(c["value"] > c["limit"] for c in control.values())
    assert control["energy_gap"]["value"] > control["energy_gap"]["limit"]
