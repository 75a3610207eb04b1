"""On the card only (skipped on the CPU): the control, the reference put
in the program's place with its matrix products in TF32, is not correct
under the cell's limits, at a size a test run holds (256 x 40;
``tools/readings.py`` reads it at the cells' own sizes).

    python -m pytest gpubench/test_gpubench_card.py -m cuda -o addopts= -p no:cacheprovider
"""

import pytest
import torch

from gpubench import harness, yardstick


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in yardstick.load("../BENCHMARK.json")["workloads"]])
def test_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(workload)
    dev = torch.device("cuda")
    su = harness.Setup(cell, 7, dev, {"num_traj": 256, "horizon": 40})
    su.free()
    numbers = harness.checker(cell).control(cell, su.capture, su.weights, dev)
    limits = cell.check["limits"]
    assert any(numbers[k] > v for k, v in limits.items()), numbers
