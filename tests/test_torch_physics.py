"""Parity of the port's physics (mjrl_tpu_torch.physics) with the JAX package.

The loaded ant model and its static tables must equal the reference's; one
plain PyTorch substep must match ``mjrl_tpu.physics.soa.substep`` (run
under ``jax.disable_jit()``, as the reference's own tests avoid compiling
an unrolled ant program) from the same warmed, contact-touching states.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import soa as jsoa
from mjrl_tpu.physics.contact import _pair_groups as j_pair_groups
from mjrl_tpu.physics.engine import tree_tables as j_tree_tables
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, soa, tables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ants():
    return make("ant", horizon=8, device="cpu"), jenvs.make("ant", horizon=8)


@pytest.fixture(scope="module")
def warm(ants):
    """B=8 ant states after 4 control steps of uniform random actions (some
    feet on the floor), plus a control for the next step."""
    env, _ = ants
    rng = np.random.default_rng(0)
    state, _ = env.reset(8, torch.Generator().manual_seed(0))
    for _ in range(4):
        a = torch.as_tensor(rng.uniform(-1, 1, (8, 8)), dtype=torch.float32)
        state, *_ = env.step(state, a)
    ctrl = rng.uniform(-1, 1, (8, 8)).astype(np.float32)
    return state.q.T.numpy().copy(), state.qd.T.numpy().copy(), ctrl


def _assert_field_equal(name, got, want):
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name in ("dof_limit_stiffness", "dof_limit_damping"):
            # the port's own f32 mass matrix vs the reference's dense crba
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        assert got == want, name


def test_ant_model_matches_reference(ants):
    env, jenv = ants
    for f in dataclasses.fields(jenv.model):
        _assert_field_equal(f.name, getattr(env.model, f.name), getattr(jenv.model, f.name))


def test_static_tables_match_reference(ants):
    env, jenv = ants
    m, jm = env.model, jenv.model
    got, want = tables.tree_tables(m), j_tree_tables(jm)
    for name in ("dof_link", "L_mask", "dof_mask", "hinge_slide_q", "hinge_slide_v",
                 "hinge_slide_link"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    groups, jgroups = tables.pair_groups(m).kinds, j_pair_groups(jm).kinds
    assert [k for k, _ in groups] == [k for k, _ in jgroups] == ["sphere_plane", "capsule_plane"]
    for (_, tab), (_, jtab) in zip(groups, jgroups):
        for key in ("gi", "gj", "li", "lj", "mu"):
            np.testing.assert_array_equal(tab[key], jtab[key])
    assert tables.num_contact_candidates(m) == jsoa.num_contact_candidates(jm) == 25
    tab, jtab = tables.soa_tables(m), jsoa._soa_tables(jm)
    assert tab.anc == jtab.anc and tab.lam == jtab.lam
    assert tab.dof_link == jtab.dof_link and tab.children == jtab.children
    np.testing.assert_array_equal(tab.c_mass, jtab.c_mass)
    for (d, Q), (jd, jQ) in zip(tab.inertia_eig, jtab.inertia_eig):
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(Q, jQ)


def test_substep_matches_reference(ants, warm):
    env, jenv = ants
    q, qd, ctrl = warm
    pos, quat = soa._fk(env.model, torch.as_tensor(q))
    depths = [c.depth for c in soa._contact_candidates(env.model, pos, quat)]
    assert int((torch.cat(depths) > 0).sum()) > 0, "no contact in the warmed states"
    dt = env.model.dt / env.model.n_substeps
    got_q, got_qd = soa.substep(env.model, torch.as_tensor(q), torch.as_tensor(qd),
                                torch.as_tensor(ctrl), dt)
    with jax.disable_jit():
        want_q, want_qd = jsoa.substep(jenv.model, jnp.asarray(q), jnp.asarray(qd),
                                       jnp.asarray(ctrl), dt)
    # tests/test_soa.py's per-substep bound (f32 reassociation only)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_qd.numpy(), np.asarray(want_qd), rtol=2e-3, atol=2e-3)


def test_mass_matrix_diag_matches_reference_crba(ants):
    from mjrl_tpu.physics.engine import PhysicsState, compute_kinematics, crba

    env, jenv = ants
    q0 = env.model.default_qpos
    kin = compute_kinematics(jenv.model, PhysicsState(q=jnp.asarray(q0), qd=jnp.zeros(jenv.model.nv)))
    want = np.diag(np.asarray(crba(jenv.model, kin)))
    np.testing.assert_allclose(soa.mass_matrix_diag(env.model, q0), want, rtol=1e-5)


@pytest.mark.parametrize(
    "edit",
    [
        dict(link_jnt_type=(0, -1, 1) + (2,) * 10),
        dict(act_gainprm=np.ones((8, 3), np.float32)),
        dict(dof_frictionloss=np.ones(14, np.float32)),
        dict(tendon_Jq=np.zeros((1, 15), np.float32)),
    ],
    ids=["ball", "gain_bias", "frictionloss", "tendon"],
)
def test_unsupported_features_raise(ants, edit):
    """A ball joint is refused everywhere. Gain/bias actuators,
    frictionloss and tendons are Adroit's stages: the plain version takes
    them and only kernel K3's build has them, so K1 refuses them."""
    model = copy.copy(ants[0].model)
    for k, v in edit.items():
        setattr(model, k, v)
    if "link_jnt_type" in edit:
        with pytest.raises(NotImplementedError):
            soa.check_supported(model)
        return
    assert soa.needs_ext(model)
    zeros = lambda n: torch.zeros(n, 2)  # noqa: E731
    with pytest.raises(ValueError, match="K3"):
        pkernel.PhysicsKernel("penalty", False)(model, zeros(model.nq), zeros(model.nv),
                                                zeros(model.nu), 1)
