"""The control, at a cell's own size on the card: the program with its
lower-precision path switched on (W8A8 linears, an int8 KV cache) must
come out not correct under the cell's limit, where the program itself
comes out correct. Run on the chip:

    python3 -m pytest portbench/tests/test_portbench_control.py -m gpu -q
"""

import pytest
import torch

from portbench import calibrate, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(name, cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(name)
    limit = cell["limits"]["logit_err"]["limit"]
    out = calibrate.readings(cell, 4242424242, True, 15.0, cuda)
    assert out["program"]["logit_err"] <= limit < out["control"]["logit_err"], out
