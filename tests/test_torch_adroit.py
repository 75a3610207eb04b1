"""Parity of the port's Adroit pen with the JAX package's: the model, the
box narrow phases, the tendon force, one substep and one control step of
the plain physics, the env, and the success statistics.

The port loads ``mjrl_tpu_torch/envs/assets/adroit_pen.npz`` (the JAX
bridge's compilation of the Gymnasium-Robotics asset) and must match the
reference env's model field by field. Its plain physics (``physics/soa.py``)
is held against ``mjrl_tpu.physics.soa`` under ``jax.disable_jit()`` (never
compiled), on states where each of pen's five contact kinds touches
(``physics/probe.py``), with per-env link offsets; the control step against
``tests/golden/adroit_pen_penalty_step.npz`` (``tools/gen_adroit_golden.py``).
The env's step is held against the JAX ``step`` with both frame steppers
replaced by the same post-step state (on the CPU the JAX env steps through
its per-env engine, not ``soa``).
"""

import dataclasses
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.envs.adroit import AdroitState as JAdroitState
from mjrl_tpu.models import GaussianMLP as JGaussianMLP
from mjrl_tpu.physics import mjcf as jmjcf
from mjrl_tpu.physics import soa as jsoa
from mjrl_tpu.samplers import rollout_statistics as j_rollout_statistics
from mjrl_tpu.samplers import sample_autoreset as j_sample_autoreset
from mjrl_tpu.types import EnvSpec as JEnvSpec
from mjrl_tpu.types import TrajectoryBatch as JTrajectoryBatch
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.envs.adroit import AdroitState
from mjrl_tpu_torch.models import GaussianMLP
from mjrl_tpu_torch.physics import mjcf, probe, soa
from mjrl_tpu_torch.samplers import AutoresetNoise, carry_from_noise, rollout_statistics
from mjrl_tpu_torch.samplers.rollout import run_autoreset
from mjrl_tpu_torch.types import EnvSpec, TrajectoryBatch
from test_torch_adroit_kernel import _SPHERE_BOX

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "adroit_pen_penalty_step.npz")
KINDS = [("box_plane", 2), ("capsule_plane", 1), ("capsule_box", 59), ("box_box", 10),
         ("capsule_capsule", 51)]
# the limit and tendon-limit gains: from each package's own f32 mass matrix
GAIN_FIELDS = ("dof_limit_stiffness", "dof_limit_damping", "tendon_limit_stiffness",
               "tendon_limit_damping")
# narrow phases: the same f32 formulas (rotations by the geoms' quaternions);
# a normal from the box is a short offset over its length, which amplifies
# the round-off where the point is just outside (measured 2.6e-6)
TOL_GEOM = {"depth": dict(rtol=0, atol=2e-6), "pt": dict(rtol=0, atol=2e-6),
            "n": dict(rtol=0, atol=1e-5)}
# one substep: the same f32 formulas, a few sums in another order; qd
# carries the stiff servos, limits and contacts of 2 ms
TOL_Q = dict(rtol=0, atol=1e-6)
TOL_QD = dict(rtol=0, atol=1e-4)
# one control step (5 substeps): the round-off of each grows through the next
TOL_STEP_Q = dict(rtol=0, atol=1e-5)
TOL_STEP_QD = dict(rtol=0, atol=1e-3)
TOL_OBS = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def envs():
    return make("adroit_pen", device="cpu"), jenvs.make("adroit_pen")


@pytest.fixture(scope="module")
def kind_states(envs):
    """``(q, qd, link_delta)`` batch-last numpy: 3 states per contact kind in
    which that kind touches."""
    return probe.kind_states(envs[0].model, 3, np.random.default_rng(0))


def _fields(model):
    return {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}


def test_pen_model_matches_reference(envs):
    """Every field after the env's settings: the gains to the f32 round-off
    of two mass matrices, everything else exactly."""
    env, jenv = envs
    got, want = _fields(env.model), _fields(jenv.model)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if w is None or isinstance(w, (str, int, float, tuple, dict)):
            assert g == w, name
        elif name in GAIN_FIELDS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
            assert np.asarray(g).dtype == np.asarray(w).dtype, name
    assert env.model.tendon_limit_stiffness.shape == (44,)
    assert [(k, len(t["gi"])) for k, t in soa.pair_groups(env.model).kinds] == KINDS


def _hold_candidates(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.gi, g.gj, g.li, g.lj) == (w.gi, w.gj, w.li, w.lj)
        assert g.mu == pytest.approx(w.mu)
        for name in ("depth", "n", "pt"):
            np.testing.assert_allclose(getattr(g, name).numpy(), np.asarray(getattr(w, name)),
                                       err_msg=name, **TOL_GEOM[name])


def test_box_narrow_phases_match_reference(envs, kind_states):
    """Every candidate of pen's 406 contact points at the same poses (with
    the link offsets), in the reference's kind, pair and sub-point order;
    each kind touches somewhere."""
    env, jenv = envs
    q, _, delta = kind_states
    got = soa._contact_candidates(env.model, *soa._fk(env.model, torch.as_tensor(q),
                                                      torch.as_tensor(delta)))
    with jax.disable_jit():
        want = jsoa._contact_candidates(
            jenv.model, *jsoa._fk(jenv.model, jnp.asarray(q), jnp.asarray(delta)))
    assert len(got) == 406
    _hold_candidates(got, want)
    depth = probe.kind_depth(env.model, torch.as_tensor(q), torch.as_tensor(delta))
    assert all(bool((d > 0).any()) for d in depth.values())




def test_sphere_box_matches_reference(tmp_path):
    """The sphere-box kind (relocate's; pen has none) on a small model both
    packages load: a ball over a rotated block, outside it, touching its
    faces, edges and corners, and with its centre inside."""
    path = tmp_path / "sphere_box.xml"
    path.write_text(_SPHERE_BOX)
    model, jmodel = mjcf.load_mjcf(str(path)), jmjcf.load_mjcf(str(path))
    assert [k for k, _ in soa.pair_groups(model).kinds] == ["sphere_plane", "sphere_box"]
    rng = np.random.default_rng(1)
    n = 64
    q = np.tile(np.asarray(model.default_qpos, np.float32)[:, None], (1, n))
    world = rng.uniform([-0.45, -0.35, 0.05], [0.45, 0.35, 0.45], (n, 3)).T
    world[:, :4] = [[0.0, 0.1, 0.0, 0.0], [0.0, 0.05, 0.0, 0.0], [0.2, 0.25, 0.35, 0.38]]
    q[:3] = world - np.asarray(model.link_pos[0], np.float32)[:, None]  # the ball's own offset
    got = soa._contact_candidates(model, *soa._fk(model, torch.as_tensor(q)))
    with jax.disable_jit():
        want = jsoa._contact_candidates(jmodel, *jsoa._fk(jmodel, jnp.asarray(q)))
    _hold_candidates(got, want)
    depth = got[1].depth.numpy()[0]
    assert (depth > 0.08).any() and ((depth > 0) & (depth < 0.08)).any() and (depth < 0).any()


def test_tendon_forces_match_reference(envs):
    """The tendon force at random joint angles in range (the coupled
    fingers' limits are violated in most) and beyond, and random qd."""
    env, jenv = envs
    rng = np.random.default_rng(2)
    q = probe._random_hinges(env.model, 16, rng)
    q[:24, 8:] += rng.uniform(-0.5, 0.5, (24, 8)).astype(np.float32)
    qd = rng.uniform(-2, 2, (env.model.nv, 16)).astype(np.float32)
    got = soa._tendon_forces(env.model, torch.as_tensor(q), torch.as_tensor(qd)).numpy()
    want = np.asarray(jsoa._tendon_forces(jenv.model, jnp.asarray(q), jnp.asarray(qd)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(want).max() > 1.0  # limits are hit


@pytest.fixture(scope="module")
def substep_inputs(envs):
    """B=4: two envs after 3 control steps of random actions from reset,
    two with a pair of links overlapping; a random control; link offsets
    uniform in +-5 mm on every link."""
    env, _ = envs
    rng = np.random.default_rng(3)
    state, _ = env.reset(2, torch.Generator().manual_seed(3))
    for _ in range(3):
        state, *_ = env.step(state, torch.as_tensor(rng.uniform(-1, 1, (2, 24)),
                                                    dtype=torch.float32))
    fq, fqd = probe.overlapping_states(env.model, 2, rng)
    q = np.concatenate([state.q.T.numpy(), fq], axis=1)
    qd = np.concatenate([state.qd.T.numpy(), fqd], axis=1)
    ctrl = env._scaled_ctrl(torch.as_tensor(rng.uniform(-1, 1, (4, 24)), dtype=torch.float32))
    delta = rng.uniform(-0.005, 0.005, (3 * env.model.nlink, 4)).astype(np.float32)
    return q, qd, np.ascontiguousarray(ctrl.T.numpy()), delta


def test_one_substep_matches_reference(envs, substep_inputs):
    """One 2 ms substep: servos, tendons, frictionloss, limits, contacts of
    every kind and the link offsets."""
    env, jenv = envs
    q, qd, ctrl, delta = substep_inputs
    got = soa.substep(env.model, *map(torch.as_tensor, (q, qd, ctrl)), 0.002,
                      link_delta=torch.as_tensor(delta))
    with jax.disable_jit():
        want = jsoa.substep(jenv.model, *map(jnp.asarray, (q, qd, ctrl)), 0.002,
                            link_delta=jnp.asarray(delta))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_Q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL_QD)
    assert np.abs(got[1].numpy() - qd).max() > 1e-2  # the substep moved the hand


def test_one_control_step_matches_golden(envs):
    """5 substeps from the golden's states, controls and link offsets."""
    env, _ = envs
    g = np.load(GOLDEN)
    q2, qd2 = soa.multistep(env.model, *(torch.as_tensor(g[k]) for k in ("q", "qd", "ctrl")),
                            env.frame_skip, link_delta=torch.as_tensor(g["link_delta"]))
    np.testing.assert_allclose(q2.numpy(), g["q_out"], **TOL_STEP_Q)
    np.testing.assert_allclose(qd2.numpy(), g["qd_out"], **TOL_STEP_QD)


def test_env_reset_step_reward_success_and_guard_match_reference(envs):
    """Reset with the reference's angle draws, then one step each from
    given post-step states: the 45-dim observation, the reward with its
    bonuses and penalty, ``success`` and the blow-up guard."""
    env, jenv = envs
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    jst, jobs0 = [], []
    for k in keys:
        s, o = jenv.reset(k)
        jst.append(s)
        jobs0.append(o)
    angles = np.asarray([[jax.random.uniform(kk, (), minval=-1.0, maxval=1.0)
                          for kk in jax.random.split(k)] for k in keys], np.float32)
    st, obs0 = env.reset_from_angles(torch.as_tensor(angles[:, 0]), torch.as_tensor(angles[:, 1]))
    np.testing.assert_allclose(obs0.numpy(), np.stack(jobs0), **TOL_OBS)
    assert env.spec.observation_dim == jenv.spec.observation_dim == 45

    # post-step states: the hand at rest (the pen at its place: the
    # target of env 0 is drawn near the pen's axis, so it may succeed), a
    # moved hand, the pen dropped to the table, and a diverged qd
    rng = np.random.default_rng(4)
    q2 = np.tile(np.asarray(env.model.default_qpos, np.float32), (4, 1))
    qd2 = np.zeros((4, env.model.nv), np.float32)
    q2[1, :24] += rng.uniform(-0.2, 0.2, 24).astype(np.float32)
    qd2[1] = rng.uniform(-1, 1, env.model.nv)
    q2[2, 24] = 0.2  # the pen's first slide (world -z): 5 cm over the table
    qd2[3, 5] = 2e4
    # env 0's target: the pen's axis at rest, so the pen succeeds
    rest = env._features(st._replace(q=torch.as_tensor(q2[:1]), qd=torch.as_tensor(qd2[:1]),
                                     link_delta=st.link_delta[:1]))[2][0]
    jst[0] = jst[0]._replace(target=jnp.asarray(rest.numpy()))
    st = st._replace(target=torch.stack([torch.tensor(np.asarray(s.target)) for s in jst]))
    action = rng.uniform(-1.5, 1.5, (4, 24)).astype(np.float32)
    want = []
    for i, s in enumerate(jst):
        jenv._frame_step = lambda *_, i=i: (jnp.asarray(q2[i]), jnp.asarray(qd2[i]))
        want.append(jenv.step(s, jnp.asarray(action[i])))
    frame_step, env._frame_step = env._frame_step, lambda *_: (torch.as_tensor(q2),
                                                               torch.as_tensor(qd2))
    try:
        _, obs, rew, term, info = env.step(st, torch.as_tensor(action))
    finally:
        env._frame_step = frame_step
    np.testing.assert_allclose(obs.numpy(), np.stack([np.asarray(w[1]) for w in want]), **TOL_OBS)
    np.testing.assert_allclose(rew.numpy(), [float(w[2]) for w in want], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(term.numpy(), [bool(w[3]) for w in want])
    np.testing.assert_array_equal(info["success"].numpy(), [bool(w[4]["success"]) for w in want])
    assert info["success"].numpy()[0] and term.numpy()[3] and not term.numpy()[:3].any()
    assert rew.numpy()[0] > 50.0 and rew.numpy()[3] == 0.0  # the bonuses; the guard
    assert obs.numpy()[2, 26] < 0.075 and rew.numpy()[2] < -4.0  # the dropped pen's penalty


# -- the success statistics ---------------------------------------------


class _JFakeState(NamedTuple):
    u: jax.Array
    t: jax.Array


def _fake_success(u, t):
    """A deterministic success and termination pattern of the reset draw
    ``u`` and the step count ``t``."""
    return ((u * 7.0 + t * 0.3) % 1.0) > 0.6, ((u * 3.0 + t * 0.5) % 1.0) > 0.85


class _JFakeEnv:
    spec = JEnvSpec(observation_dim=1, action_dim=1, horizon=3)

    def reset(self, key):
        u = jax.random.uniform(key, ())
        return _JFakeState(u, jnp.zeros(())), u[None]

    def step(self, st, action):
        t = st.t + 1.0
        success, term = _fake_success(st.u, t)
        return _JFakeState(st.u, t), st.u[None], st.u + t, term, {"success": success}


class _FakeState(NamedTuple):
    u: torch.Tensor
    t: torch.Tensor


class _FakeEnv:
    spec = EnvSpec(observation_dim=1, action_dim=1, horizon=3)
    device = torch.device("cpu")

    def reset_from_noise(self, u, _):
        return _FakeState(u[:, 0], torch.zeros_like(u[:, 0])), u.clone()

    def step(self, st, action):
        t = st.t + 1.0
        success, term = _fake_success(st.u, t)
        return _FakeState(st.u, t), st.u[:, None], st.u + t, term, {"success": success}

    def check(self):
        pass


def test_success_accumulator_and_rate_match_reference():
    """Samples mode: the reference's ``sample_autoreset`` and the port's
    ``run_autoreset`` on one fake env whose success and termination follow
    its reset draws (the reference's draws, injected), 6 rows over a
    12-step window with episode horizon 3: ``episode_success``,
    ``episode_score`` and ``success_rate``."""
    N, T, H = 6, 12, 3
    key = jax.random.PRNGKey(5)
    jenv = _JFakeEnv()
    jpol = JGaussianMLP(jenv.spec, hidden_sizes=(4,))
    params, tf = jpol.init(jax.random.PRNGKey(1)), jpol.init_transforms()
    jbatch = j_sample_autoreset(jenv, jpol, params, tf, key, N, T, episode_horizon=H)
    # the reference's reset draws: the carry's, then one set per step
    key_reset, key_scan = jax.random.split(key)
    u0 = jax.vmap(jenv.reset)(jax.random.split(key_reset, N))[0].u
    us, k = [], key_scan
    for _ in range(T):
        k, _, k_reset = jax.random.split(k, 3)
        us.append(jax.vmap(jenv.reset)(jax.random.split(k_reset, N))[0].u)
    env = _FakeEnv()
    carry = carry_from_noise(env, torch.as_tensor(np.asarray(u0))[:, None], torch.zeros(N, 0))
    noise = AutoresetNoise(reset_q=torch.as_tensor(np.stack([np.asarray(u) for u in us]))[..., None],
                           reset_qd=torch.zeros(T, N, 0), action=torch.zeros(T, N, 1))
    policy = GaussianMLP(env.spec, hidden_sizes=(4,), generator=torch.Generator().manual_seed(0))
    batch, carry = run_autoreset(env, policy, noise, carry, H)
    for name in ("episode_success", "episode_score", "success"):
        np.testing.assert_allclose(batch.env_info[name].numpy().astype(np.float32),
                                   np.asarray(jbatch.env_info[name]).astype(np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(batch.done.numpy(), np.asarray(jbatch.done))
    got, want = rollout_statistics(batch), j_rollout_statistics(jbatch)
    assert float(got.success_rate) == pytest.approx(float(want.success_rate), rel=1e-6)
    assert 0.0 < float(got.success_rate) < 100.0
    assert float(got.num_episodes) == float(want.num_episodes)


def test_episode_success_rate_matches_reference():
    """Episodes mode: ``success`` taken along each row to its ``done`` over
    the valid steps, on an injected sequence with early terminations."""
    rng = np.random.default_rng(6)
    N, T = 8, 10
    success = rng.uniform(size=(N, T)) > 0.8
    ends = rng.integers(3, T, N)
    valid = np.arange(T)[None, :] <= ends[:, None]
    done = np.arange(T)[None, :] == ends[:, None]
    rewards = rng.normal(size=(N, T)).astype(np.float32) * valid
    z = np.zeros((N, T), np.float32)
    z3 = np.zeros((N, T, 1), np.float32)
    common = dict(observations=z3, actions=z3, rewards=rewards, valid=valid, done=done,
                  terminated=done, mean=z3, log_std=z3, log_prob=z, time=z.astype(np.int32),
                  returns=z, baseline=z, advantages=z)
    jb = JTrajectoryBatch(**{k: jnp.asarray(v) for k, v in common.items()},
                          env_info={"success": jnp.asarray(success)})
    tb = TrajectoryBatch(**{k: torch.as_tensor(v) for k, v in common.items()},
                         env_info={"success": torch.as_tensor(success)})
    got, want = rollout_statistics(tb), j_rollout_statistics(jb)
    assert float(got.success_rate) == pytest.approx(float(want.success_rate), rel=1e-6)
    assert 0.0 < float(got.success_rate) < 100.0
    assert float(got.mean) == pytest.approx(float(want.mean), rel=1e-5)


def test_adroit_state_carries_offsets_and_target(envs):
    """The env's state type: what the sampler selects over and the
    checkpoint stores."""
    env, _ = envs
    assert env.state_type is AdroitState and AdroitState._fields == ("q", "qd", "link_delta",
                                                                     "target")
    assert set(JAdroitState._fields) == {"ps", "link_delta", "target"}
    st, obs = env.reset(3, torch.Generator().manual_seed(0))
    assert st.link_delta.shape == (3, env.model.nlink, 3) and not st.link_delta.any()
    assert obs.shape == (3, 45) and torch.isfinite(obs).all()
