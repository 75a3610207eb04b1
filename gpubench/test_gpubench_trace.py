"""The per-layer metrics that read the program's own tracer
(``program_trace.py``, ``mjrl_tpu_torch/utils/trace.py``), on the CPU: a
tiny traced run reports all of them, with the step's parts inside the
step; every reader returns None without data and where the port has no
tracer (a parent commit's); and ``profile_summary`` reads the same busy
time, window, kernel time and device operations from a profile whether
the program's ``mjrl.`` ranges are in it or not (~2 min)."""

import sys
import time
from types import SimpleNamespace

import pytest
import torch

from gpubench import harness, program_trace

TINY = {"num_traj": 2, "horizon": 2, "baseline_kwargs": {"epochs": 2, "batch_size": 4}}
NEW = ("step_host_ms", "policy_host_ms", "env_host_ms", "physics_host_ms", "sync_wait_ms",
       "host_syncs_per_iteration", "K4_held_rows", "K4_held_rows_max")


def test_traced_run_reports_the_programs_metrics(monkeypatch):
    monkeypatch.setattr(program_trace, "ITERATIONS", 2)
    torch.set_num_threads(2)
    out = harness.run(harness.Cell("pen.newton"), 2**33 + 7, 0.05, True, time.perf_counter(),
                      device="cpu", extra=TINY, log=sys.stderr)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(m), sorted(m)
    parts = m["policy_host_ms"] + m["env_host_ms"] + m["physics_host_ms"]
    assert 0.0 < parts <= m["step_host_ms"]
    # CG's ten reads of rdotr and the plain version's read of its rows in
    # margin per substep (2 steps x 5 substeps; K4's check reads nothing
    # on the CPU)
    assert m["host_syncs_per_iteration"] == 10 + 2 * 5 and m["sync_wait_ms"] > 0.0
    assert 0.0 <= m["K4_held_rows"] <= m["K4_held_rows_max"] <= 96


def test_readers_return_nothing_without_data_or_tracer(monkeypatch):
    for name in NEW:
        assert harness.read_metric(name, {"phases": [], "profile": None}) is None
    import mjrl_tpu_torch.utils

    # a port without the tracer: its import fails
    monkeypatch.setitem(sys.modules, "mjrl_tpu_torch.utils.trace", None)
    monkeypatch.delattr(mjrl_tpu_torch.utils, "trace", raising=False)
    data = {"cell": harness.Cell("pen.newton"), "num_traj": 2, "horizon": 2}
    for name in NEW:
        assert harness.read_metric(name, data) is None


def _event(name, start, end, device=False, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=annotation)


@pytest.mark.parametrize("with_program_ranges", [False, True])
def test_profile_summary_ignores_program_ranges(with_program_ranges):
    """A synthetic profile: the harness's iteration and phase ranges, three
    kernels and a copy on the device; with the program's ``mjrl.`` ranges
    on the host and mirrored on the device's timeline (user annotations),
    the busy union, window, kernel time and device ops stay as without."""
    events = [_event("gpubench.iteration", 0, 1000), _event("gpubench.update", 600, 800),
              _event("mj_ext_newton_kernel_x", 100, 300, device=True),
              _event("mj_ext_newton_kernel_x", 350, 500, device=True),
              _event("elementwise_kernel", 520, 540, device=True),
              _event("Memcpy DtoH", 700, 710, device=True)]
    if with_program_ranges:
        events += [_event("mjrl.train_step", 0, 990), _event("mjrl.sampler.step", 50, 320),
                   _event("mjrl.npg.cg", 610, 790),
                   _event("mjrl.train_step", 0, 990, device=True, annotation=True),
                   _event("mjrl.sampler.step", 50, 320, device=True, annotation=True)]
    got = harness.profile_summary(SimpleNamespace(events=lambda: events), "mj_ext_newton_kernel")
    assert got["busy_s"] == pytest.approx((200 + 150 + 20 + 10) * 1e-6)
    assert got["window_s"] == pytest.approx(1000e-6)
    assert got["kernel_ms"] == pytest.approx(175e-3) and got["kernel_launches"] == 2
    assert [n for n, _ in got["device_ops"]] == ["mj_ext_newton_kernel_x", "elementwise_kernel",
                                                  "Memcpy DtoH"]
