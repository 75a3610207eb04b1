"""Parity of the port's humanoid with the JAX package's: the model, the
sphere-sphere and sphere-capsule narrow phases, one frame of the plain
physics, the 376-dim observation, and the reward and termination.

The port's ``HumanoidEnv`` (``mjrl_tpu_torch/envs/assets/humanoid.xml``)
must load to the reference's model field by field. Its plain physics
(``physics/soa.py``) is held against ``mjrl_tpu.physics.soa`` run under
``jax.disable_jit()`` (never compiled: an XLA compile of humanoid's SoA
program takes minutes), on states whose limbs are folded so that pairs of
every kind between links overlap (``physics/probe.py``). The observation
is held against ``jit(vmap(HumanoidEnv._obs))``; the reward against the
JAX ``step`` with its frame stepper replaced by the same post-step state
(on the CPU the JAX env steps through its per-env engine, not ``soa``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import PhysicsState
from mjrl_tpu.physics import soa as jsoa
from mjrl_tpu.physics.contact import _pair_groups as j_pair_groups
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.envs.base import EnvState
from mjrl_tpu_torch.physics import probe, soa, tables

torch.set_num_threads(1)

B = 4
KINDS = [("capsule_plane", 12), ("sphere_plane", 5), ("capsule_capsule", 52),
         ("sphere_capsule", 49), ("sphere_sphere", 10)]
# plain vs reference: the same f32 formulas, a few sums in another order;
# the penalty contacts are humanoid's weight over 2 mm, so qd carries
# forces of ~1e4 N through one substep
TOL_Q = dict(rtol=0, atol=1e-5)
TOL_QD = dict(rtol=0, atol=1e-3)
# the observation: its contact wrenches reach ~1e4 (N, N m)
TOL_OBS = dict(rtol=1e-4, atol=1e-4)
# cfrc_ext (the last 84 entries) of a post-step state, against the f64
# value: a penalty wrench is the contact stiffness (206579 N/m) times a
# depth that is a difference of ~1 m coordinates, so each f32 result
# carries an error of a few f32 ulps of 1 m times the stiffness. Measured
# on the test's folded env 6 against JAX in f64: the port's f32 wrench is
# off by up to 1.66e-2 and the reference's own f32 by up to 1.09e-2, on
# opposite sides (145.2761 and 145.25339 against 145.26170), which is why
# the two f32 results disagree by 2.27e-2. The bound: two f32 ulps of 1 m
# (2 x 1.19e-7 m) times the stiffness, 4.9e-2, held by both.
CFRC = slice(376 - 84, 376)
CFRC_ULPS_M = 2 * float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def envs():
    return make("humanoid", horizon=8, device="cpu"), jenvs.make("humanoid", horizon=8)


@pytest.fixture(scope="module")
def folded(envs):
    """``(q (nq, 8), qd (nv, 8))``: 4 envs after 6 control steps of random
    actions from reset, then 4 with folded limbs (a link pair overlaps)."""
    env, _ = envs
    rng = np.random.default_rng(0)
    state, _ = env.reset(4, torch.Generator().manual_seed(0))
    for _ in range(6):
        state, *_ = env.step(state, torch.as_tensor(rng.uniform(-0.4, 0.4, (4, env.model.nu)),
                                                    dtype=torch.float32))
    fq, fqd = probe.overlapping_states(env.model, 4, rng)
    q = np.concatenate([state.q.T.numpy(), fq], axis=1)
    qd = np.concatenate([state.qd.T.numpy(), fqd], axis=1)
    return np.ascontiguousarray(q), np.ascontiguousarray(qd)


def test_humanoid_model_matches_reference(envs):
    env, jenv = envs
    for f in dataclasses.fields(jenv.model):
        got, want = getattr(env.model, f.name), getattr(jenv.model, f.name)
        if isinstance(want, np.ndarray):
            # the limit gains come from the port's own f32 mass matrix
            rtol = 1e-5 if f.name in ("dof_limit_stiffness", "dof_limit_damping") else 0
            np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=0, err_msg=f.name)
        else:
            assert got == want, f.name
    m = env.model
    assert (m.nq, m.nv, m.nu, m.nlink) == (24, 23, 17, 20)
    assert m.tendon_Jq is None and m.n_substeps == 2 and env.frame_skip == 5
    groups, jgroups = tables.pair_groups(m).kinds, j_pair_groups(jenv.model).kinds
    assert [(k, len(t["gi"])) for k, t in groups] == KINDS
    assert [k for k, _ in jgroups] == [k for k, _ in KINDS]
    for (_, tab), (_, jtab) in zip(groups, jgroups):
        for key in ("gi", "gj", "li", "lj", "mu"):
            np.testing.assert_array_equal(tab[key], jtab[key])
    assert tables.num_contact_candidates(m) == jsoa.num_contact_candidates(jenv.model) == 140
    soa.check_supported(m)


def test_sphere_candidates_match_reference(envs, folded):
    """All 140 candidates (depth, normal, point) in the reference's kind,
    pair and point order, with a touching point of each sphere kind."""
    env, jenv = envs
    q = folded[0]
    got = soa._contact_candidates(env.model, *soa._fk(env.model, torch.as_tensor(q)))
    with jax.disable_jit():
        want = jsoa._contact_candidates(jenv.model, *jsoa._fk(jenv.model, jnp.asarray(q)))
    assert len(got) == len(want) == 140
    for g, w in zip(got, want):
        assert (g.gi, g.gj, g.li, g.lj, g.mu) == (w.gi, w.gj, w.li, w.lj, w.mu)
        for name in ("depth", "n", "pt"):
            np.testing.assert_allclose(getattr(g, name).numpy(), np.asarray(getattr(w, name)),
                                       rtol=0, atol=1e-5, err_msg=name)
    depth = probe.kind_depth(env.model, torch.as_tensor(q))
    for kind in ("sphere_sphere", "sphere_capsule"):
        assert bool((depth[kind] > 0).any()), kind


def test_humanoid_frame_matches_reference(envs, folded):
    """One frame (2 substeps) of the plain version against the reference's
    ``soa.multistep``, on 2 warmed and 2 folded states."""
    env, jenv = envs
    q, qd = (x[:, 2:6].copy() for x in folded)
    ctrl = np.random.default_rng(1).uniform(-1, 1, (env.model.nu, B)).astype(np.float32)
    got = soa.multistep(env.model, *(torch.as_tensor(x) for x in (q, qd, ctrl)), 1)
    with jax.disable_jit():
        want = jsoa.multistep(jenv.model, *(jnp.asarray(x) for x in (q, qd, ctrl)), 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_Q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL_QD)
    assert np.abs(got[1].numpy() - qd).max() > 1e-2  # the frame moved the bodies


@pytest.mark.parametrize("obs_mode", ["gym", "compact"])
def test_humanoid_obs_matches_reference(obs_mode, folded):
    """The observation of the same states with an action, and a reset's
    (no action: ``qfrc_actuator`` is 0)."""
    env = make("humanoid", horizon=8, device="cpu", obs_mode=obs_mode)
    jenv = jenvs.make("humanoid", horizon=8, obs_mode=obs_mode)
    assert env.spec.observation_dim == jenv.spec.observation_dim == (376 if obs_mode == "gym"
                                                                     else 45)
    q, qd = (np.ascontiguousarray(x.T) for x in folded)
    action = np.random.default_rng(2).uniform(-1.5, 1.5, (q.shape[0], env.model.nu))
    action = action.astype(np.float32)
    state = EnvState(torch.as_tensor(q), torch.as_tensor(qd))
    jobs = jax.jit(jax.vmap(lambda q, qd, a: jenv._obs(PhysicsState(q, qd), a)))
    jobs_reset = jax.jit(jax.vmap(lambda q, qd: jenv._obs(PhysicsState(q, qd))))
    got = env._obs(state, torch.as_tensor(action)).numpy()
    np.testing.assert_allclose(got, np.asarray(jobs(q, qd, action)), **TOL_OBS)
    got_reset = env._obs(state).numpy()
    np.testing.assert_allclose(got_reset, np.asarray(jobs_reset(q, qd)), **TOL_OBS)
    if obs_mode == "gym":
        # qfrc_actuator (after cinert and cvel) from the clipped action; 0 at a reset
        qfrc = slice(45 + 140 + 84, 45 + 140 + 84 + env.model.nv)
        assert np.abs(got[:, qfrc]).max() > 1.0 and not got_reset[:, qfrc].any()
        assert np.abs(got[:, -84:]).max() > 1.0  # cfrc_ext: the folded limbs push


def test_humanoid_reward_and_termination_match_reference(envs, folded):
    """Reward, ``x_velocity`` (the centre of mass's), termination and the
    observation of one step, given the same post-step state in both
    packages; the observation's contact wrenches against their f64 value
    (the reference's in f64), to which both packages' f32 are held."""
    env, jenv = envs
    q, qd = (np.ascontiguousarray(x.T) for x in folded)
    rng = np.random.default_rng(3)
    q2 = (q + rng.uniform(-0.05, 0.05, q.shape)).astype(np.float32)
    q2[:2, 2] = 0.8  # two envs fall below the healthy z
    qd2 = (qd + rng.uniform(-1, 1, qd.shape)).astype(np.float32)
    action = rng.uniform(-1, 1, (q.shape[0], env.model.nu)).astype(np.float32)

    def jstep(q, qd, a, q2, qd2):
        jenv._frame_step = lambda *_: (q2, qd2)
        return jenv.step(PhysicsState(q, qd), a)

    _, jobs, jrew, jterm, jinfo = jax.jit(jax.vmap(jstep))(q, qd, action, q2, qd2)
    frame_step, env._frame_step = env._frame_step, lambda *_: (torch.as_tensor(q2),
                                                               torch.as_tensor(qd2))
    try:
        _, obs, rew, term, info = env.step(EnvState(torch.as_tensor(q), torch.as_tensor(qd)),
                                           torch.as_tensor(action))
    finally:
        env._frame_step = frame_step
    np.testing.assert_allclose(info["x_velocity"].numpy(), np.asarray(jinfo["x_velocity"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    assert term.numpy()[:2].all() and not term.numpy()[2:].any()
    obs, jobs = obs.numpy(), np.asarray(jobs)
    np.testing.assert_allclose(obs[:, : CFRC.start], jobs[:, : CFRC.start], **TOL_OBS)
    with jax.enable_x64(True):
        f64 = jax.jit(jax.vmap(lambda q, qd, a: jenv._obs(PhysicsState(q, qd), a)))
        want = np.asarray(f64(*(x.astype(np.float64) for x in (q2, qd2, action))))
    assert want.dtype == np.float64
    tol = dict(rtol=1e-4, atol=CFRC_ULPS_M * env.model.contact_stiffness)
    np.testing.assert_allclose(obs[:, CFRC], want[:, CFRC], **tol)
    np.testing.assert_allclose(jobs[:, CFRC], want[:, CFRC], **tol)  # the reference's own f32
    assert np.abs(want[:, CFRC]).max() > 1.0  # the folded limbs push
