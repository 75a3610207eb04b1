"""Parity of the port's plain physics with the JAX package on the planar
walkers: hopper, walker2d and half_cheetah (slide joints; hopper's
capsule-capsule contacts between links).

The loaded models must equal the reference's, and one substep and one
control step of ``physics/soa.py`` must match ``mjrl_tpu.physics.soa``
(run under ``jax.disable_jit()``, never compiled) on the same numpy
inputs: B=4 states after 6 control steps of random actions; for hopper the
last two are folded so a capsule-capsule pair overlaps
(``physics/probe.py``).
"""

import dataclasses
import os

import gymnasium
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import soa as jsoa
from mjrl_tpu.physics.contact import _pair_groups as j_pair_groups
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import probe, soa, tables
from mjrl_tpu_torch.physics.mjcf import load_mjcf

torch.set_num_threads(1)

B = 4
WALKERS = ("hopper", "walker2d", "half_cheetah")
KINDS = {
    "hopper": (["capsule_plane", "capsule_capsule"], 11),
    "walker2d": (["capsule_plane"], 14),
    "half_cheetah": (["capsule_plane"], 16),
}
# plain vs reference: the same f32 formulas, a few sums in another order
TOL_Q = dict(rtol=0, atol=1e-5)
TOL_QD = dict(rtol=0, atol=1e-3)


@pytest.fixture(scope="module", params=WALKERS)
def walker(request):
    """``(env, jenv, q, qd, ctrl)``: port and reference envs of one walker,
    batch-last states and the next control."""
    name = request.param
    env, jenv = make(name, horizon=8, device="cpu"), jenvs.make(name, horizon=8)
    nu = env.model.nu
    rng = np.random.default_rng(0)
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    for _ in range(6):
        state, *_ = env.step(state, torch.as_tensor(rng.uniform(-1, 1, (B, nu)), dtype=torch.float32))
    q, qd = state.q.T.numpy().copy(), state.qd.T.numpy().copy()
    if name == "hopper":
        q[:, 2:], qd[:, 2:] = probe.overlapping_states(env.model, B - 2, rng)
    return env, jenv, q, qd, rng.uniform(-1, 1, (nu, B)).astype(np.float32)


def test_walker_model_matches_reference(walker):
    env, jenv, *_ = walker
    for f in dataclasses.fields(jenv.model):
        got, want = getattr(env.model, f.name), getattr(jenv.model, f.name)
        if isinstance(want, np.ndarray):
            # the limit gains come from the port's own f32 mass matrix
            rtol = 1e-5 if f.name in ("dof_limit_stiffness", "dof_limit_damping") else 0
            np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=0, err_msg=f.name)
        else:
            assert got == want, f.name
    kinds, n_cand = KINDS[env.asset[:-4]]
    groups, jgroups = tables.pair_groups(env.model).kinds, j_pair_groups(jenv.model).kinds
    assert [k for k, _ in groups] == [k for k, _ in jgroups] == kinds
    for (_, tab), (_, jtab) in zip(groups, jgroups):
        for key in ("gi", "gj", "li", "lj", "mu"):
            np.testing.assert_array_equal(tab[key], jtab[key])
    assert tables.num_contact_candidates(env.model) == jsoa.num_contact_candidates(jenv.model) == n_cand


def test_walker_substep_matches_reference(walker):
    env, jenv, q, qd, ctrl = walker
    dt = env.model.dt / env.model.n_substeps
    got = soa.substep(env.model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), dt)
    with jax.disable_jit():
        want = jsoa.substep(jenv.model, *(jnp.asarray(x) for x in (q, qd, ctrl)), dt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_Q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL_QD)


def test_walker_control_step_matches_reference(walker):
    env, jenv, q, qd, ctrl = walker
    got = soa.multistep(env.model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), env.frame_skip)
    with jax.disable_jit():
        want = jsoa.multistep(jenv.model, *(jnp.asarray(x) for x in (q, qd, ctrl)), env.frame_skip)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_Q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL_QD)
    assert np.abs(got[1].numpy() - qd).max() > 1e-2  # the step moved the bodies


def test_capsule_capsule_candidates_match_reference():
    """Hopper's capsule-capsule narrow phase on folded states: depth,
    normal and point of every candidate as the reference computes them."""
    env, jenv = make("hopper", horizon=8, device="cpu"), jenvs.make("hopper", horizon=8)
    q, _ = probe.overlapping_states(env.model, 8, np.random.default_rng(4))
    got = soa._contact_candidates(env.model, *soa._fk(env.model, torch.as_tensor(q)))
    with jax.disable_jit():
        want = jsoa._contact_candidates(jenv.model, *jsoa._fk(jenv.model, jnp.asarray(q)))
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert (g.gi, g.gj, g.li, g.lj) == (w.gi, w.gj, w.li, w.lj)
        for name in ("depth", "n", "pt"):
            np.testing.assert_allclose(getattr(g, name).numpy(), np.asarray(getattr(w, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
    cc = [g for g in got if g.lj >= 0]
    assert len(cc) == 3 and bool((torch.cat([c.depth for c in cc]) > 0).any(dim=0).all())


@pytest.mark.parametrize("asset", ["swimmer.xml", "humanoid.xml"])
def test_check_supported_refuses_swimmer_and_humanoid(asset):
    """Swimmer's fluid forces and humanoid's sphere and capsule pair kinds
    are not ported."""
    path = os.path.join(os.path.dirname(gymnasium.__file__), "envs", "mujoco", "assets", asset)
    with pytest.raises(NotImplementedError):
        soa.check_supported(load_mjcf(path))
