"""The control, the reference computed in bfloat16 in the program's place,
comes out not correct in every cell."""

import pytest
import torch

from portbench import control, harness
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.cells())
def test_control_fails(name):
    checks = control.control_numbers(tiny.cell(name), 2**40 + 11, torch.bfloat16,
                                     torch.device("cpu"))
    assert not harness.passed(checks), checks


@pytest.mark.parametrize("name", tiny.cells())
def test_float64_control_passes(name):
    """The same path in float64 is the reference itself: it passes, so the
    control fails for its precision and not for its plumbing."""
    checks = control.control_numbers(tiny.cell(name), 2**40 + 11, torch.float64,
                                     torch.device("cpu"))
    assert harness.passed(checks), checks
