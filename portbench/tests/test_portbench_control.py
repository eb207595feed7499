"""The control (the plain reference in the program's place, one precision
below the configuration's) comes out not correct, at a small size on the
CPU; the same reference in float64 passes the same check."""
import pytest
import torch

from portbench import control
from portbench.tests.test_portbench_run import SMALL, small_config


@pytest.mark.parametrize("cell_name", sorted(SMALL))
@pytest.mark.parametrize("dtype,correct", [("bfloat16", False), ("float64", True)])
def test_control(cell_name, dtype, correct):
    _, cfg = small_config(cell_name)
    out = control.run_control(cell_name, 2**31 + 17, dtype, torch.device("cpu"),
                              cfg)
    assert out["correct"] is correct, out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_control_on_the_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = control.run_control(cell_name, 2**31 + 19, "bfloat16",
                              torch.device("cuda"))
    assert out["correct"] is False, out["checks"]
