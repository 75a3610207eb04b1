"""The program's tracer (``mjrl_tpu_torch/utils/trace.py``) on tiny train
steps on the CPU: off, it records nothing and runs no profiler range and no
clock read; on, a step gives the same bits as off, its spans form the tree
of the train step (``sampler.step`` once per control step, ``env.step``
inside it, ``physics.frame_step`` inside that), with self times >= 0 and
one root identifier, and its device reads are counted; K4's wrapper counts
the plain version's held rows on the CPU; the CLI's ``--trace`` writes
Chrome trace JSON with the spans of NPG, model-based NPG and BC's warm
start. The test marked ``cuda`` holds the reads the tracer counts against
those ``torch.cuda.set_sync_debug_mode`` finds in one pen iteration on the
card."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.physics import pkernel, probe, soa
from mjrl_tpu_torch.train import load_config, main
from mjrl_tpu_torch.utils import trace
from mjrl_tpu_torch.utils.configs import build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HORIZON = 4


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def hopper_agent():
    cfg = load_config(os.path.join(ROOT, "examples", "hopper_npg.json"),
                      ["num_traj=2", f"horizon={HORIZON}"])
    return build(cfg, device="cpu")[3]


def step(agent, seed=1):
    return agent.train_step(torch.Generator().manual_seed(seed))


def test_off_records_nothing(monkeypatch):
    """Off: a train step runs no ``record_function`` and no clock read of
    the tracer, and leaves nothing to take."""
    calls = []
    monkeypatch.setattr(trace, "_now", lambda: calls.append("clock") or 0)
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or real(name))
    step(hopper_agent())
    assert calls == []
    got = trace.take()
    assert got == {"spans": {}, "counters": {}, "peaks": {}, "reads": {}, "roots": []}
    trace.enable()
    step(hopper_agent())
    assert "clock" in calls and "mjrl.train_step" in calls


def test_on_and_off_give_the_same_bits():
    off, on = hopper_agent(), hopper_agent()
    m_off = step(off)
    trace.enable()
    m_on = step(on)
    assert list(m_off) == list(m_on)
    assert all(torch.equal(m_off[k], m_on[k]) for k in m_off)
    for a, b in zip(off.policy.state_dict().values(), on.policy.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(off.baseline.state_dict().values(), on.baseline.state_dict().values()):
        assert torch.equal(a, b)


def test_span_tree_and_reads(tmp_path):
    """One traced step: the tree of the train step, one root for all, self
    times >= 0, and CG's ten reads of ``rdotr`` (the only device reads of
    a step with K1's plain version, whose ``check()`` reads nothing)."""
    agent = hopper_agent()
    trace.enable()
    step(agent)
    got = trace.take()
    trace.write_chrome(str(tmp_path / "t.json"))
    spans = got["spans"]
    for name in ("sampler.step", "sampler.policy", "env.step", "physics.frame_step"):
        assert spans[name]["count"] == HORIZON, name
    for name in ("train_step", "sample", "process_batch", "update", "npg.cg", "fit",
                 "statistics"):
        assert spans[name]["count"] == 1, name
    assert spans["fit.adam_step"]["count"] >= 1
    assert all(s["self_ms"] >= 0.0 and s["total_ms"] >= s["self_ms"] for s in spans.values())
    assert got["roots"] == [0]
    assert got["reads"] == {"cg.rdotr": {"count": agent.cg_iters,
                                         "wait_ms": got["reads"]["cg.rdotr"]["wait_ms"]}}
    events = json.load(open(tmp_path / "t.json"))["traceEvents"]
    by_id = {e["args"]["id"]: e for e in events if e["cat"] == "span"}
    assert {e["args"]["root"] for e in events} == {0}

    def parent(e):
        return by_id[e["args"]["parent"]]["name"]

    for e in by_id.values():
        if e["name"] == "physics.frame_step":
            assert parent(e) == "env.step"
        elif e["name"] in ("env.step", "sampler.policy"):
            assert parent(e) == "sampler.step"
        elif e["name"] == "sampler.step":
            assert parent(e) == "sample"
        elif e["name"] == "train_step":
            assert e["args"]["parent"] is None
    assert all(parent(e) == "npg.cg" for e in events if e["cat"] == "read")
    # a second take holds the second step alone, under its own root
    step(agent, seed=2)
    assert trace.take()["roots"] == [1]


def test_k4_counts_the_plain_versions_held_rows():
    """K4's wrapper on CPU tensors, traced: the env-substeps and the held
    rows of the plain version, which the kernel counts on the card; pen's
    kind states, one control frame."""
    from mjrl_tpu_torch.envs.adroit import adroit_model

    m = adroit_model("pen", "newton")
    q, qd, d = (torch.as_tensor(x) for x in probe.kind_states(m, 1, np.random.default_rng(0)))
    B = q.shape[1]
    ctrl = torch.zeros(m.nu, B)
    held = []
    want = soa.multistep(m, q, qd, ctrl, 1, link_delta=d, held=held)
    trace.enable()
    got = pkernel.PhysicsKernel("newton", True)(m, q, qd, ctrl, 1, link_delta=d)
    counted = trace.take()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rows = torch.stack(held)
    assert counted["counters"]["K4.env_substeps"] == B * m.n_substeps
    assert counted["counters"]["K4.held_rows"] == int(rows.sum()) > 0
    assert counted["peaks"]["K4.held_rows_max"] == int(rows.max())


@pytest.mark.parametrize("config, sets, names", [
    ("hopper_npg.json", ["num_traj=2", "horizon=4"],
     {"train_step", "sampler.step", "env.step", "physics.frame_step", "npg.cg",
      "fit.adam_step", "train_agent.metrics"}),
    ("point_mass_model_npg.json", ["num_traj=2", "horizon=4", "agent_kwargs.img_traj=4",
                                   "agent_kwargs.dyn_fit_epochs=1"],
     {"train_step", "model.ensemble_fit", "model.imagined_rollout", "env.step", "npg.cg"}),
    ("hopper_dapg.json", ["num_traj=2", "horizon=4", "bc_kwargs.epochs=1",
                          f"demo_file={os.path.join(ROOT, 'demos', 'hopper_expert.pickle')}"],
     {"bc.warm_start", "bc.loss", "train_step", "env.step"}),
])
def test_cli_trace_writes_chrome_json(tmp_path, config, sets, names):
    """``--trace PATH``: the run's spans and reads as Chrome trace JSON."""
    path = tmp_path / "trace.json"
    main(["--device", "cpu", "--config", os.path.join(ROOT, "examples", config),
          "--output", str(tmp_path / "run"), "--trace", str(path),
          "--set", *sets, "niter=1", "save_freq=1"])
    assert not trace.enabled()
    events = json.load(open(path))["traceEvents"]
    assert names <= {e["name"] for e in events}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)


@pytest.mark.cuda
def test_cuda_sync_debug_count_is_the_tracers():
    """One pen iteration (Newton, K4) at 64 x 10 on the card: every
    synchronizing call that ``torch.cuda.set_sync_debug_mode("warn")``
    reports inside ``train_step`` is one of the tracer's device reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = load_config(os.path.join(ROOT, "examples", "adroit_pen_npg_newton.json"),
                      ["num_traj=64", "horizon=10"])
    agent = build(cfg, device="cuda")[3]
    agent.train_step(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    trace.enable()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            agent.train_step(torch.Generator(device="cuda").manual_seed(1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    reads = trace.take()["reads"]
    assert len(syncs) == sum(r["count"] for r in reads.values()), (
        [f"{w.filename}:{w.lineno}" for w in syncs], reads)
