"""Door's and relocate's Newton substep: the port's plain version against the
JAX package's, where every contact kind of the model holds rows.

Kernel K4 runs door, hammer and relocate on the Newton solver; its plain
version (physics/soa.py with physics/soa_newton.py) is what the card's
check holds it against. Hammer's plain substep is held against
``tests/golden/adroit_hammer_newton_substep.npz`` (test_torch_adroit_newton.py);
here door (760 contact points) and relocate (the sphere kinds:
sphere_plane, sphere_box, sphere_capsule, whose Newton rows no engine
golden covers) take one control frame of 3 Newton iterations, B=4, from
``probe.kind_states``: four states, each with one kind touching 0 to 1 cm
deep, that together hold a row of every kind of the model, with two
limited hinges per env pushed past a bound and random servo targets. The
reference, with those inputs, is ``tests/golden/adroit_<task>_newton_kind_states.npz``:
``mjrl_tpu.physics.soa.multistep`` under ``jax.disable_jit()`` on the
model ``soa_newton.prune_to_active_pairs`` cuts to the pairs active at
these states, written by ``tools/torch_newton_tasks_golden.py``; it is held
to the tolerances the hammer golden is held to
(``tests/test_soa_newton.py``'s). The rows held stay within the 64 of
K4's smaller held-row class (``pkernel.HELD_CLASSES``).
"""

import os

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, probe, soa
from mjrl_tpu_torch.physics.tables import pair_groups

torch.set_num_threads(1)

# tests/test_torch_adroit_newton_kernel.py's tolerances for hammer's golden
TOL_Q = dict(rtol=3e-4, atol=3e-5)
TOL_QD = dict(rtol=3e-3, atol=3e-3)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "adroit_{}_newton_kind_states.npz")


@pytest.fixture(scope="module", params=("door", "relocate"))
def case(request):
    """``(task, env, golden)``."""
    task = request.param
    env = make(f"adroit_{task}", device="cpu", constraint_solver="newton")
    return task, env, dict(np.load(GOLDEN.format(task)))


def test_every_kind_holds_rows_within_the_cap(case):
    task, env, g = case
    m = env.model
    rows = probe.held_rows(m, torch.as_tensor(g["q"]), torch.as_tensor(g["link_delta"]))
    for key in (*(k for k, _ in pair_groups(m).kinds), "facets_1", "facets_4", "facets_6",
                "limits"):
        assert int(rows[key].sum()) > 0, (task, key)
    assert int(rows["contacts"].max()) <= min(pkernel.HELD_CLASSES)


def test_plain_substep_matches_reference_soa(case):
    """One control frame of the port's ``soa.multistep`` against the JAX
    package's on the pruned model: every contact kind, condim 1, 3 and 4,
    limit rows, frictionloss, servos, tendons and link offsets."""
    task, env, g = case
    m = env.model
    assert g["pairs"] < g["model_pairs"] == len(m.contact_pairs)
    iters, m.solver_iters = m.solver_iters, int(g["solver_iters"])
    try:
        got = soa.multistep(m, *(torch.as_tensor(g[k]) for k in ("q", "qd", "ctrl")), 1,
                            link_delta=torch.as_tensor(g["link_delta"]))
    finally:
        m.solver_iters = iters
    np.testing.assert_allclose(got[0].numpy(), g["ref_q"], **TOL_Q)
    np.testing.assert_allclose(got[1].numpy(), g["ref_qd"], **TOL_QD)
    assert np.abs(got[1].numpy() - g["qd"]).max() > 1e-2  # the substep moved the hand


def test_replayed_fractions_steer_the_plain_substep(case):
    """``replay`` (how the card's check takes the line search's ties out):
    the plain version's own fractions replayed give its step bit for bit,
    -1 leaves an env's own pick, and other fractions give another step
    while ``picks`` still records the solve's own choices."""
    task, env, g = case
    m = env.model
    q, qd, ctrl, d = (torch.as_tensor(g[k]) for k in ("q", "qd", "ctrl", "link_delta"))
    iters, m.solver_iters = m.solver_iters, int(g["solver_iters"])
    try:
        own = []
        free = soa.multistep(m, q, qd, ctrl, 1, picks=own, link_delta=d)
        own = torch.cat(own)
        assert own.shape == (m.n_substeps * m.solver_iters, q.shape[1])
        for replay in (own, torch.full_like(own, -1)):
            again = soa.multistep(m, q, qd, ctrl, 1, link_delta=d, replay=replay)
            assert all(torch.equal(a, b) for a, b in zip(again, free))
        other = (own + 1) % 5
        seen = []
        moved = soa.multistep(m, q, qd, ctrl, 1, picks=seen, link_delta=d, replay=other)
    finally:
        m.solver_iters = iters
    assert not torch.equal(moved[1], free[1])
    assert torch.equal(torch.cat(seen)[:1], own[:1])  # the first iteration's own picks
