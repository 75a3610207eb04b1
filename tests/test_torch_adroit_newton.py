"""Parity of the port's plain Newton physics with Adroit's stages (the
kernel K4's reference) with the JAX package's, and pen NPG on the Newton
solver through the entry point.

The plain substep (physics/soa.py with physics/soa_newton.py: soft contact
and limit rows, frictionloss's force on the right-hand side and its
dt-scaled diagonal in both the unconstrained solve and the Newton metric,
the full tendon force) is held against the engine oracles
``tests/golden/adroit_{pen,hammer}_newton_substep.npz`` (4 envs, 3 Newton
iterations, link offsets; tools/gen_newton_golden.py) to the JAX test's
tolerances, and against ``mjrl_tpu.physics.soa.substep`` under
``jax.disable_jit()`` (never compiled) on the model that
``soa_newton.prune_to_active_pairs`` cuts to the pairs active at the
states, where each of pen's contact kinds touches, some joints are past
their limits and qd is nonzero. The plain version's own cut to the
contact points inside their margin somewhere in the batch is exact: it is
held bit for bit against the uncut rows.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import soa as jsoa
from mjrl_tpu.physics.soa_newton import prune_to_active_pairs
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.envs.adroit import adroit_model
from mjrl_tpu_torch.physics import probe, soa, soa_newton
from mjrl_tpu_torch.physics.model import HINGE
from mjrl_tpu_torch.train import load_config, run_job

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "adroit_{}_newton_substep.npz")
# against the engine oracle: tests/test_soa_newton.py's tolerances
TOL_GOLDEN_Q = dict(rtol=3e-4, atol=3e-5)
TOL_GOLDEN_QD = dict(rtol=3e-3, atol=3e-3)
# one substep against the JAX package's soa: the same f32 formulas, a few
# sums in another order, through 2 ms of stiff servos, limits and soft
# contacts (the penalty substep's tolerances, tests/test_torch_adroit.py)
TOL_Q = dict(rtol=0, atol=1e-6)
TOL_QD = dict(rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def pen():
    return make("adroit_pen", device="cpu", constraint_solver="newton")


@pytest.mark.parametrize("task", ["pen", "hammer"])
def test_plain_substep_matches_engine_golden(task):
    """One substep (3 Newton iterations, the golden's link offsets) of the
    full model against the engine oracle."""
    g = np.load(GOLDEN.format(task))
    model = adroit_model(task, "newton")
    model.solver_iters = int(g["solver_iters"])
    delta = g["link_delta"].reshape(g["link_delta"].shape[0], -1).T
    got_q, got_qd = soa.substep(model, *(torch.as_tensor(g[k].T) for k in ("q", "qd", "ctrl")),
                                float(g["dt"]), link_delta=torch.as_tensor(delta))
    np.testing.assert_allclose(got_q.numpy().T, g["ref_q"], **TOL_GOLDEN_Q)
    np.testing.assert_allclose(got_qd.numpy().T, g["ref_qd"], **TOL_GOLDEN_QD)


@pytest.fixture(scope="module")
def states(pen):
    """``(q, qd, ctrl, delta)`` batch-last numpy, B=5: one state per contact
    kind where that kind touches (``probe.kind_states``), two limited
    hinges of each pushed 0.01-0.03 rad past a bound, qd uniform in +-0.5."""
    m = pen.model
    rng = np.random.default_rng(4)
    q, _, delta = probe.kind_states(m, 1, rng)
    hinges = [i for i in range(m.nlink) if m.link_jnt_type[i] == HINGE and m.jnt_limited[i] > 0]
    for b in range(q.shape[1]):
        for i in rng.choice(hinges, 2, replace=False):
            lo, hi = m.jnt_range[i]
            past = rng.uniform(0.01, 0.03)
            q[m.link_qadr[i], b] = lo - past if rng.random() < 0.5 else hi + past
    qd = rng.uniform(-0.5, 0.5, (m.nv, q.shape[1])).astype(np.float32)
    ctrl = pen._scaled_ctrl(torch.as_tensor(rng.uniform(-1, 1, (q.shape[1], m.nu)),
                                            dtype=torch.float32)).T.numpy()
    return q, qd, np.ascontiguousarray(ctrl), delta


def test_plain_substep_matches_reference_soa(pen, states):
    """One 2 ms substep with 3 Newton iterations against the eager JAX
    ``soa.substep`` on the pruned model: every contact kind, condim 1, 3
    and 4 (1, 4 and 6 facets), limit rows, frictionloss, servos, tendons
    and link offsets take part."""
    q, qd, ctrl, delta = states
    m = pen.model
    rows = probe.held_rows(m, torch.as_tensor(q), torch.as_tensor(delta))
    for key in ("box_plane", "capsule_plane", "capsule_box", "box_box", "capsule_capsule",
                "facets_1", "facets_4", "facets_6", "limits"):
        assert int(rows[key].sum()) > 0, key
    m.solver_iters = 3
    jmodel = jenvs.make("adroit_pen", constraint_solver="newton").model
    pruned = prune_to_active_pairs(jmodel, q, jnp.asarray(delta))
    pruned.solver_iters = 3
    try:
        got = soa.substep(m, *map(torch.as_tensor, (q, qd, ctrl)), 0.002,
                          link_delta=torch.as_tensor(delta))
    finally:
        m.solver_iters = 10
    with jax.disable_jit():
        want = jsoa.substep(pruned, *map(jnp.asarray, (q, qd, ctrl)), 0.002,
                            link_delta=jnp.asarray(delta))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_Q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL_QD)
    assert np.abs(got[1].numpy() - qd).max() > 1e-2  # the substep moved the hand


def test_cut_to_rows_in_margin_is_exact(pen, states, monkeypatch):
    """The plain version builds rows only for the contact points inside
    their margin in some env; with a row for every one of pen's 406 points
    the substep and its line-search picks are the same, bit for bit."""
    q, qd, ctrl, delta = states
    m = pen.model
    args = (m, *map(torch.as_tensor, (q, qd, ctrl)), 0.002)
    kept = soa_newton._in_margin_somewhere(
        m, soa._contact_candidates(m, *soa._fk(m, torch.as_tensor(q), torch.as_tensor(delta))))
    assert 0 < len(kept) < 406
    m.solver_iters = 3
    try:
        cut_picks, all_picks = [], []
        cut = soa.substep(*args, picks=cut_picks, link_delta=torch.as_tensor(delta))
        monkeypatch.setattr(soa_newton, "_in_margin_somewhere", lambda _, cands: cands)
        every = soa.substep(*args, picks=all_picks, link_delta=torch.as_tensor(delta))
    finally:
        m.solver_iters = 10
    assert torch.equal(cut[0], every[0]) and torch.equal(cut[1], every[1])
    assert torch.equal(torch.cat(cut_picks), torch.cat(all_picks))


def test_pen_newton_config_runs_and_resumes(tmp_path):
    """``examples/adroit_pen_npg_newton.json`` at 2 envs x 2 steps: one
    iteration, then a second resumed from its checkpoint; every logged
    value finite."""
    path = os.path.join(ROOT, "examples", "adroit_pen_npg_newton.json")
    small = ["num_traj=2", "horizon=2", "save_freq=1"]
    agent = run_job(load_config(path, [*small, "niter=1"]), str(tmp_path), device="cpu")
    assert agent.env.model.constraint_solver == "newton" and agent.iteration == 1
    agent = run_job(load_config(path, [*small, "niter=2"]), str(tmp_path), device="cpu")
    assert agent.iteration == 2
    with open(tmp_path / "logs" / "log.csv") as f:
        header, *rows = [line.strip().split(",") for line in f]
    assert len(rows) == 2 and "success_rate" in header
    assert all(math.isfinite(float(v)) for row in rows for v in row), rows
    assert sorted(os.listdir(tmp_path / "iterations")) == ["1.pt", "2.pt"]
