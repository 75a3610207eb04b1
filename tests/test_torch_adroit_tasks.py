"""Parity of the port's Adroit door and relocate with the JAX package's: the
models, ``quat_to_euler``, the sphere-box and capsule-box narrow phases of
the observation's contact module, the envs' resets, steps, rewards and
success, and the curriculum reset.

The port loads ``mjrl_tpu_torch/envs/assets/adroit_{door,relocate}.npz``
(the JAX bridge's compilation of the Gymnasium-Robotics assets) and must
match the reference envs' models field by field. Each reset takes the
reference's own ``jax.random`` draws, in its split and fold order; each
step is held against the JAX ``step`` with both frame steppers replaced by
the same post-step state (the physics is held elsewhere: K3 against the
plain version in tests/test_torch_k3_warp.py and on the card). Hammer's
twins are in tests/test_torch_adroit_hammer.py, the configs through the
entry point in tests/test_torch_adroit_entry.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import contact as jcontact
from mjrl_tpu.physics import engine as jengine
from mjrl_tpu.physics import math3d as jm3
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import contact, engine, math3d, probe
from mjrl_tpu_torch.physics.tables import pair_groups

torch.set_num_threads(1)

KINDS = {
    "door": [("box_plane", 3), ("capsule_plane", 5), ("capsule_box", 108), ("box_box", 16),
             ("capsule_capsule", 146)],
    "relocate": [("box_plane", 2), ("sphere_plane", 1), ("capsule_box", 49), ("box_box", 10),
                 ("sphere_box", 6), ("sphere_capsule", 17), ("capsule_capsule", 17)],
}
# the limit and tendon-limit gains: from each package's own f32 mass matrix
GAIN_FIELDS = ("dof_limit_stiffness", "dof_limit_damping", "tendon_limit_stiffness",
               "tendon_limit_damping")
# tests/test_torch_adroit.py's: the same f32 formulas (rotations by the
# geoms' quaternions, sums in another order); a normal from the box is a
# short offset over its length, which amplifies the round-off
TOL_GEOM = {"depth": dict(rtol=0, atol=2e-6), "pt": dict(rtol=0, atol=2e-6),
            "n": dict(rtol=0, atol=1e-5)}
TOL_OBS = dict(rtol=1e-5, atol=1e-5)
B = 4


@pytest.fixture(scope="module")
def jax_envs():
    return {task: jenvs.make(f"adroit_{task}") for task in ("door", "relocate")}


def _fields(model):
    return {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}


@pytest.mark.parametrize("task", ["door", "relocate"])
def test_task_model_matches_reference(jax_envs, task):
    """Every field after the env's settings: the gains to the f32 round-off
    of two mass matrices, everything else exactly; the pairs by kind."""
    env, jenv = make(f"adroit_{task}", device="cpu"), jax_envs[task]
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
    assert [(k, len(t["gi"])) for k, t in pair_groups(env.model).kinds] == KINDS[task]
    assert env.spec.observation_dim == jenv.spec.observation_dim == 39


def test_quat_to_euler_matches_reference():
    """Random unit quaternions, and four at gimbal lock (``cy <= 1e-6``,
    where z is 0 and x takes the rest of the rotation)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    h = np.float32(np.sqrt(0.5))
    lock = np.asarray([[h, 0, h, 0], [h, 0, -h, 0], [0.5, 0.5, 0.5, 0.5],
                       [0.5, -0.5, 0.5, -0.5]], np.float32)
    q = np.concatenate([q, lock])
    m = math3d.quat_to_mat(torch.as_tensor(lock))
    assert bool((torch.sqrt(m[:, 2, 2] ** 2 + m[:, 1, 2] ** 2) <= 1e-6).all())
    got = math3d.quat_to_euler(torch.as_tensor(q)).numpy()
    want = np.asarray(jm3.quat_to_euler(jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[-4:, 2] == 0).all() and np.abs(got[-4:, 1]).min() > 1.5


def _jax_kinematics(jmodel, q, qd, delta):
    """The reference's per-env ``Kinematics`` of batch-first states, vmapped."""
    fn = lambda q, qd, d: jengine.compute_kinematics(  # noqa: E731
        jmodel, jengine.PhysicsState(q=q, qd=qd), link_pos_delta=d)
    return jax.vmap(fn)(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(delta))


@pytest.fixture(scope="module")
def relocate_kind_states():
    """Relocate's model and ``probe.kind_states``: 2 states per kind with
    their link offsets (the ball carried onto the hand for sphere_capsule)."""
    m = make("adroit_relocate", device="cpu").model
    return m, probe.kind_states(m, 2, np.random.default_rng(1))


@pytest.mark.parametrize("kind", ["sphere_box", "capsule_box"])
def test_box_kinds_match_reference(jax_envs, relocate_kind_states, kind):
    """The observation's batched sphere-box and capsule-box narrow phases
    (``contact._collide_kind``) against the reference's on relocate's
    ``probe.kind_states``; the kind touches in some env."""
    m, (q, qd, d) = relocate_kind_states
    jmodel = jax_envs["relocate"].model
    n = q.shape[1]
    q, qd, d = q.T.copy(), qd.T.copy(), d.T.reshape(n, m.nlink, 3).copy()
    kin = engine.compute_kinematics(m, *map(torch.as_tensor, (q, qd, d)))
    tab = dict(pair_groups(m).kinds)[kind]
    depth, nrm, pts, li, lj, mu = contact._collide_kind(m, kin, kind, tab)
    jkin = _jax_kinematics(jmodel, q, qd, d)
    jtab = dict(jcontact._pair_groups(jmodel).kinds)[kind]
    want = jax.vmap(lambda k: jcontact._collide_kind(jmodel, k, kind, jtab)[:3])(jkin)
    for name, got, w in (("depth", depth, want[0]), ("n", nrm, want[1]), ("pt", pts, want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=name, **TOL_GEOM[name])
    np.testing.assert_array_equal(li, np.repeat(jtab["li"], 3 if kind == "capsule_box" else 1))
    assert bool((depth > 0).any())


# -- the envs -----------------------------------------------------------


def _draws(task, key, curriculum=0.0):
    """The reference's reset draws for ``key``, in its split and fold order,
    as the port's ``reset_noise`` lays them out."""
    if task == "door":
        kx, ky, kz = jax.random.split(key, 3)
        return [jax.random.uniform(kx, (), minval=-0.3, maxval=-0.2),
                jax.random.uniform(ky, (), minval=0.25, maxval=0.35),
                jax.random.uniform(kz, (), minval=0.252, maxval=0.35)]
    kx, ky, kt = jax.random.split(key, 3)
    out = [jax.random.uniform(kx, (), minval=-0.15, maxval=0.15),
           jax.random.uniform(ky, (), minval=-0.15, maxval=0.3),
           *jax.random.uniform(kt, (3,), minval=jnp.array([-0.2, -0.2, 0.15]),
                               maxval=jnp.array([0.2, 0.2, 0.35]))]
    if curriculum > 0.0:
        out.append(jax.random.uniform(jax.random.fold_in(key, 1), (), maxval=curriculum))
    return out


def _hold_resets(env, jenv, task, curriculum=0.0):
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    want = [jenv.reset(k) for k in keys]
    draws = torch.as_tensor(np.asarray([[float(x) for x in _draws(task, k, curriculum)]
                                        for k in keys], np.float32))
    st, obs = env.reset_from_noise(draws, draws.new_zeros(B, 0))
    np.testing.assert_allclose(obs.numpy(), np.stack([np.asarray(o) for _, o in want]),
                               **TOL_OBS)
    np.testing.assert_allclose(st.link_delta.numpy(),
                               np.stack([np.asarray(s.link_delta) for s, _ in want]),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(st.target.numpy(),
                                  np.stack([np.asarray(s.target) for s, _ in want]))
    np.testing.assert_array_equal(st.q.numpy(), np.stack([np.asarray(s.ps.q) for s, _ in want]))
    assert st.link_delta.abs().amax() > 0.01  # the scene moved
    return st, want


@pytest.mark.parametrize("task", ["door", "relocate"])
def test_reset_matches_reference(jax_envs, task):
    """Four resets with the reference's draws: the observation, the link
    offsets (door's frame, relocate's ball) and the target."""
    env, jenv = make(f"adroit_{task}", device="cpu"), jax_envs[task]
    _hold_resets(env, jenv, task)


def test_relocate_curriculum_reset_matches_reference(jax_envs):
    """``curriculum=1``: the blend ``u`` from ``fold_in(key, 1)`` carries
    the ball part-way to its target, and the spawn and target draws stay
    those of curriculum 0."""
    env, jenv = make("adroit_relocate", device="cpu", curriculum=1.0), jax_envs["relocate"]
    jenv.curriculum = 1.0
    try:
        st, want = _hold_resets(env, jenv, "relocate", curriculum=1.0)
    finally:
        jenv.curriculum = 0.0
    plain = make("adroit_relocate", device="cpu").reset_from_noise(
        torch.as_tensor(np.asarray([[float(x) for x in _draws("relocate", k)] for k in
                                    jax.random.split(jax.random.PRNGKey(7), B)], np.float32)))[0]
    torch.testing.assert_close(st.target, plain.target, rtol=0, atol=0)
    assert (st.link_delta[:, :, 2] != plain.link_delta[:, :, 2]).any()  # lifted toward the target
    assert env.reset_noise(3)[0].shape == (3, 6)


def _post_step_states(env, task, rng):
    """Batch-first ``(q, qd)`` for a step's outcome: the hand at rest, a
    moved hand, the task solved (door open; relocate's ball lifted, the
    target moved onto it below), and a diverged qd."""
    m = env.model
    q = np.tile(np.asarray(m.default_qpos, np.float32), (B, 1))
    qd = np.zeros((B, m.nv), np.float32)
    q[1, :24] += rng.uniform(-0.2, 0.2, 24).astype(np.float32)
    qd[1] = rng.uniform(-1, 1, m.nv)
    if task == "door":
        q[2, env._hinge] = 1.4
        q[2, -1] = 0.5
    else:
        q[2, env._jnt_q["OBJTz"]] = 0.1
    qd[3, 5] = 2e4
    return q, qd


@pytest.mark.parametrize("task", ["door", "relocate"])
def test_step_matches_reference(jax_envs, task):
    """One step each from given post-step states (both frame steppers
    stubbed): the 39-dim observation, the reward with its bonuses,
    ``terminated``, ``success`` and the blow-up guard."""
    env, jenv = make(f"adroit_{task}", device="cpu"), jax_envs[task]
    st, want_reset = _hold_resets(env, jenv, task)
    jst = [s for s, _ in want_reset]
    rng = np.random.default_rng(4)
    q2, qd2 = _post_step_states(env, task, rng)
    if task == "relocate":  # env 2's target next to its lifted ball
        ball = env._features(st._replace(q=torch.as_tensor(q2), qd=torch.as_tensor(qd2)))[1][2]
        target = ball + torch.tensor([0.01, 0.0, 0.0])
        jst[2] = jst[2]._replace(target=jnp.asarray(target.numpy()))
        st = st._replace(target=torch.stack([torch.tensor(np.asarray(s.target)) for s in jst]))
    action = rng.uniform(-1.5, 1.5, (B, env.model.nu)).astype(np.float32)
    want = []
    for i, s in enumerate(jst):
        jenv._frame_step = lambda *_, i=i: (jnp.asarray(q2[i]), jnp.asarray(qd2[i]))
        want.append(jenv.step(s, jnp.asarray(action[i])))
    env._frame_step = lambda *_: (torch.as_tensor(q2), torch.as_tensor(qd2))
    _, obs, rew, term, info = env.step(st, torch.as_tensor(action))
    np.testing.assert_allclose(obs.numpy(), np.stack([np.asarray(w[1]) for w in want]), **TOL_OBS)
    np.testing.assert_allclose(rew.numpy(), [float(w[2]) for w in want], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(term.numpy(), [bool(w[3]) for w in want])
    np.testing.assert_array_equal(info["success"].numpy(), [bool(w[4]["success"]) for w in want])
    success, rew = info["success"].numpy(), rew.numpy()
    assert success[2] and not success[[0, 1]].any() and term.numpy()[3] and rew[3] == 0.0
    assert rew[2] > (19.0 if task == "door" else 30.0)  # the bonuses


def test_envs_default_to_the_card():
    """Without ``device`` the envs ask for the card (where there is none,
    the first tensor raises)."""
    for task in ("door", "relocate", "hammer"):
        if torch.cuda.is_available():
            assert make(f"adroit_{task}").device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                make(f"adroit_{task}")
