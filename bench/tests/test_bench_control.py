"""The control of `correct` on the card, at a size a test run holds: the
reference in TF32 in the program's place fails the cell's limits, where the
program passes them.  Skips without a card."""
import pytest

from bench import control, judge

from . import tiny


@pytest.mark.chip
@pytest.mark.parametrize("name", ["sage3-igbs.b1024", "gat3-igbs.b1024"])
def test_control_fails_the_limits(tmp_path, cuda_device, name):
    cell = tiny.tiny_cell(tmp_path, name)
    cell.config |= {"in_dim": 1024, "hidden_dim": 128}   # the cell's widths
    limits = cell.config["limits"]
    for seed in (1, 2, 3):
        got = control.readings(cell, seed, cuda_device, planted=True)
        assert all(got["program"][k] <= limits[k] for k in judge.GAPS)
        for planted in ("control", "half_batch"):
            assert any(got[planted][k] > limits[k] for k in judge.GAPS)
