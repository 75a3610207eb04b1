"""The ``relocate.newton`` cell on the CPU (~80 s): the port's plain
relocate on the Newton solver against the plain reference
(``reference/``) bit for bit, from reset states whose balls sit at
nonzero link offsets; kernel K4's host build (``mj_host.cpp``, the code
the card runs, under the emulated warp) against the reference's Newton
control step on relocate's contact states, within tolerances that the
line search's near ties explain; and the harness's set-up and ``npg``
check of a tiny relocate-Newton job, ``correct`` sound and not correct
with the policy frozen after its first step."""

import ctypes
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from gpubench import faults, harness, yardstick
from gpubench.reference.envs.adroit_relocate import ReferenceEnv
from gpubench.reference.physics.soa import multistep

CELL = "relocate.newton"
TINY = {"num_traj": 2, "horizon": 2, "baseline_kwargs": {"epochs": 2, "batch_size": 4}}
# K4's host build against the reference, one control step (5 substeps of
# 10 Newton iterations) from the same state. The formulas are the same
# in float32, some sums in another order (the warp's rows and lanes), so
# where no line search of the env's step is a near tie the velocities
# agree as the kernel's own tests hold them (tests/
# test_torch_adroit_newton_kernel.py's 1e-4); a near tie (the kernel's
# K4.ls_near_ties: two fractions' costs within 1e-5 of each other) can
# flip a pick between the two orders and move that iteration's step, which
# the later iterations mostly take back: such envs read up to 7e-4 (ball
# against box), so 1e-2 bounds them with room; positions move by dt times
# that.
TOL_Q_TIED, TOL_QD_TIED = 1e-4, 1e-2
TOL_Q, TOL_QD = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def test_plain_relocate_newton_bit_for_bit():
    """Three envs from reset, each ball offset on the table, one control
    step: the port's plain physics (the frame stepper's CPU path, K4's
    plain version), observation and reward equal the reference's."""
    from mjrl_tpu_torch import envs

    env = envs.make("adroit_relocate", device="cpu", constraint_solver="newton")
    ref = ReferenceEnv("newton", device="cpu")
    g = torch.Generator().manual_seed(0)
    st, _ = env.reset(3, g)
    assert (st.link_delta != 0).flatten(1).any(1).all()
    action = torch.randn(3, env.spec.action_dim, generator=g)
    st2, obs2, r2, _, _ = env.step(st, action)
    q, qd = ref.physics(st._asdict(), action)
    obs, r = ref.obs_reward(st2._asdict())
    assert torch.equal(q, st2.q) and torch.equal(qd, st2.qd)
    assert torch.equal(obs, obs2) and torch.equal(r, r2)


def test_k4_host_build_against_the_reference(tmp_path):
    """Eight of relocate's contact states (``probe.kind_states``: each
    contact kind touching, the ball on the table and against the hand;
    where a kind's state needs no link offset, the ball placed on the table
    by one as a reset places it), one control step under random actions:
    K4's host build against the reference's Newton step; each env's own
    launch counts its near ties."""
    from mjrl_tpu_torch import envs
    from mjrl_tpu_torch.physics import pkernel, probe

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = ctypes.CDLL(str(pkernel.build_library(
        "mj_host.cpp", ("g++", *pkernel.GXX_FLAGS, *pkernel.size_flags(2)), tmp_path)))
    lib.mj_ext_newton_stats_host.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [
        ctypes.c_float]
    env = envs.make("adroit_relocate", device="cpu", constraint_solver="newton")
    m = env.model
    ref = ReferenceEnv("newton", device="cpu")
    rng = np.random.default_rng(0)
    q, qd, delta = probe.kind_states(m, 2, rng)
    cols = list(range(0, q.shape[1], 2)) + [1]  # one state per kind, and another
    q, qd, delta = (np.ascontiguousarray(x[:, cols]) for x in (q, qd, delta))
    B = q.shape[1]
    bare = ~(delta != 0).any(0)
    ball = 3 * env._obj_root
    delta[ball, bare] = rng.uniform(-0.15, 0.15, int(bare.sum())) - float(env._obj_base[0])
    delta[ball + 1, bare] = rng.uniform(-0.15, 0.3, int(bare.sum())) - float(env._obj_base[1])
    assert B == 8 and bare.any() and (delta != 0).any(0).all()
    action = torch.as_tensor(rng.uniform(-1, 1, (B, m.nu)), dtype=torch.float32)
    ctrl = (ref.act_mean + action * ref.act_rng).T.contiguous().numpy()
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    tables = (*pkernel.pack_tables(m, L, ext=True),
              *pkernel.pack_newton_tables(m, L, NL, ext=True))
    dt = float(np.float32(m.dt / m.n_substeps))
    n_sub = ReferenceEnv.frame_skip * m.n_substeps
    got_q, got_qd, ties = np.empty_like(q), np.empty_like(qd), []
    for e in range(B):
        cq, cqd, cc, cd = (np.ascontiguousarray(x[:, e:e + 1]) for x in (q, qd, ctrl, delta))
        out_q, out_qd = np.empty_like(cq), np.empty_like(cqd)
        over, stats = np.zeros(1, np.int32), np.zeros(len(pkernel.STAT_NAMES), np.int64)
        ptr = [a.ctypes.data for a in (*tables, cq, cqd, cc, cd, out_q, out_qd)]
        assert lib.mj_ext_newton_stats_host(*ptr, None, over.ctypes.data, stats.ctypes.data, 1,
                                            n_sub, m.solver_iters, dt) == 0
        assert over[0] == 0
        got_q[:, e], got_qd[:, e] = out_q[:, 0], out_qd[:, 0]
        ties.append(int(stats[pkernel.STAT_NAMES.index("ls_near_ties")]))
    want_q, want_qd = (x.numpy() for x in multistep(
        ref.model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), ReferenceEnv.frame_skip,
        link_delta=torch.as_tensor(delta)))
    tied = np.asarray(ties) > 0
    assert tied.any() and (~tied).any(), ties
    np.testing.assert_allclose(got_q[:, ~tied], want_q[:, ~tied], rtol=TOL_Q, atol=TOL_Q)
    np.testing.assert_allclose(got_qd[:, ~tied], want_qd[:, ~tied], rtol=TOL_QD, atol=TOL_QD)
    np.testing.assert_allclose(got_q, want_q, rtol=0, atol=TOL_Q_TIED)
    np.testing.assert_allclose(got_qd, want_qd, rtol=0, atol=TOL_QD_TIED)


def _setup(plant=None):
    return harness.Setup(harness.Cell(CELL), 2**33 + 11, torch.device("cpu"), TINY, plant)


@pytest.mark.parametrize("fault", [None, "frozen_after_first"])
def test_tiny_check(fault):
    """A tiny relocate-Newton job (2 x 2) through the harness's set-up and
    the ``npg`` checker on the CPU: ``correct`` under the cell's limits,
    and not correct with the policy frozen after its first step."""
    t0 = time.perf_counter()
    su = _setup(None if fault is None else faults.FAULTS[fault])
    assert su.settings["kernel"] == "K4" and su.settings["solver"] == "newton"
    su.free()
    numbers = su.check()
    limits = harness.Cell(CELL).check["limits"]
    ok = all(numbers[k] <= v for k, v in limits.items())
    print(f"{fault}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if fault is None:
        assert ok, {k: numbers[k] for k in limits}
        # the plain physics on both sides (test_gpubench_run.py's reading)
        assert numbers["q_err"] < 1e-6 and numbers["obs_err"] == 0 and numbers["return_err"] == 0
    else:
        assert not ok and numbers["policy_followed_median_leaf_err"] > limits[
            "policy_followed_median_leaf_err"], numbers


def test_config_is_relocate_under_its_task_source():
    """The cell's configuration ``relocate_v0`` is ``configs/relocate.json``
    under mj_envs' task file as its source (the paper stays as ``paper``):
    the same job, model and frozen counts, so the cell runs relocate as
    that file describes it."""
    cell = harness.Cell(CELL)
    assert cell.workload["config"] == "relocate_v0" == cell.config["name"]
    base = yardstick.load("configs/relocate.json")
    assert cell.config["paper"] == base["source"] != cell.config["source"]
    assert cell.config["source"].endswith("hand_manipulation_suite/relocate_v0.py")
    drop = ("name", "source", "paper")
    assert {k: v for k, v in cell.config.items() if k not in drop} == {
        k: v for k, v in base.items() if k not in drop}
    drop = ("config", "tool")
    assert cell.counts["config"] == "relocate_v0"
    assert {k: v for k, v in cell.counts.items() if k not in drop} == {
        k: v for k, v in yardstick.load("counts/relocate.json").items() if k not in drop}
