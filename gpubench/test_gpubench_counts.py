"""The frozen operation counts repeat exactly from the frozen plain
physics (~30 s on the CPU)."""

import json
import os

import pytest
import torch

from gpubench import counts, yardstick


@pytest.mark.parametrize("config", ["relocate", "pen"])
def test_counts_repeat(config):
    torch.set_num_threads(1)
    with open(os.path.join(yardstick.HERE, "counts", f"{config}.json")) as f:
        stored = json.load(f)
    assert json.loads(json.dumps(counts.counts_for(config))) == stored


def test_bound_and_iteration_ops():
    c = yardstick.load("counts/relocate.json")
    bound, by = yardstick.kernel_bound_ms(c, "penalty", 2048)
    assert by == "operations"
    assert bound == pytest.approx(114233 * 5 * 2048 / 67e12 * 1e3)
    ops = yardstick.iteration_ops(c, "penalty", 2048, 200, 39, 30, (64, 64), (128, 128), 2, 4096)
    assert ops["physics"] == 114233 * 5 * 2048 * 200
