"""A run of a tiny cell on the CPU through the harness (the chip's check
skipped): the result's keys, and ``correct`` false with the timed path
broken underneath in each way a training cell can be (~3 min)."""

import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from gpubench import faults, harness, yardstick

TINY = {"num_traj": 2, "horizon": 2, "baseline_kwargs": {"epochs": 2, "batch_size": 4}}


WORKLOADS = [w["name"] for w in yardstick.load("../BENCHMARK.json")["workloads"]]


def tiny_run(trace=False, plant=None, workload=WORKLOADS[0]):
    torch.set_num_threads(2)
    return harness.run(harness.Cell(workload), 2**33 + 5, 0.05, trace, time.perf_counter(),
                       device="cpu", extra=TINY, plant=plant, log=sys.stderr)


def test_result_line():
    out = tiny_run()
    numbers = out.pop("_numbers")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert set(out["check"]) == set(harness.Cell(WORKLOADS[0]).check["limits"])
    # the plain physics on both sides, the same returns
    assert numbers["q_err"] < 1e-6 and numbers["obs_err"] == 0 and numbers["return_err"] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault, workload):
    out = tiny_run(plant=faults.FAULTS[fault], workload=workload)
    assert out["correct"] is False, out["check"]


def test_traced_result_line():
    out = tiny_run(trace=True)
    out.pop("_numbers")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "check"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert {"rollout_ms", "gae_ms", "update_ms", "fit_ms", "host_ops_per_step",
            "iter_mfu_pct"} <= set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", WORKLOADS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", WORKLOADS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
