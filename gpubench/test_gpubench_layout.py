"""The benchmark's files are found by name and BENCHMARK.json keeps to the
shape the harness reads; the import guard compares whole top-level names.
CPU only, a few seconds."""

import json
import os
import re
import sys

import pytest

from gpubench import harness, yardstick

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in b["end_to_end"] + b["per_layer"])) == len(
        b["end_to_end"]) + len(b["per_layer"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])
    assert b["paths"] == ["gpubench"] and b["command"][1] == "gpubench/run.py"


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.Cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert {"num_traj", "horizon", "sample_mode", "constraint_solver"} <= set(cell.traffic)
    assert cell.config["reduced"] == []
    assert set(cell.check["limits"]) and int(cell.check["steps_per_iteration"]) >= 1
    for m in cell.end_to_end + cell.per_layer:
        assert os.path.exists(os.path.join(yardstick.HERE, "metrics", f"{m['name']}.py"))
    __import__(f"gpubench.reference.envs.{cell.config['reference_env']}")
    harness.checker(cell)
    overrides = cell.overrides()
    assert f"num_traj={cell.traffic['num_traj']}" in overrides


@pytest.mark.parametrize("config", [c for c in bench()["configs"]])
def test_config_file(config):
    assert config["file"].startswith("gpubench/configs/")
    with open(os.path.join(ROOT, config["file"])) as f:
        c = json.load(f)
    assert c["source"] == config["source"] and c["reduced"] == config["reduced"]
    assert os.path.exists(os.path.join(ROOT, c["model_asset"]))


def test_metric_reader_returns_nothing_without_data():
    data = {"phases": [], "profile": None}
    for name in ("rollout_ms", "gae_ms", "update_ms", "fit_ms", "kernel_ms", "K3_roofline",
                 "K4_roofline", "device_idle_pct", "iter_mfu_pct", "host_ops_per_step"):
        assert harness.read_metric(name, data) is None


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert not harness.forbidden_modules()
    for name in ("jaxfoo", "mjrl_tpu_torch_x", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mjrl_tpu.physics", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "mjrl_tpu.physics"]
