"""The control -- the reference in TF32 put in the program's place -- and
the block stage leaving half the block grid out come out not correct
under the cells' limits, while the program as configured comes out correct: on
the card, at the CPU tests' tiny sizes. ``readings.py`` takes the same
readings at the cells' own sizes."""

import pytest
import torch

from pmdbench import catalog

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", ["northstar_u16.view", "northstar_u16.resident"])
def test_control_fails_and_program_passes(tiny, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pmdbench import readings

    _, root = tiny
    limits = catalog.limits(cell)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        out = readings.readings(cell, seed, torch.device("cuda", 0), root)
        over = lambda nums: [k for k in limits if k in nums and nums[k] > limits[k]]  # noqa: E731
        assert not over(out["program"]), out
        assert over(out["control"]), out
        assert over(out["half_grid"]), out
        if "view_control" in out:
            assert out["view_program"] <= limits["view_gap"] < out["view_control"], out
