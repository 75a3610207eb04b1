"""Parity of the port's Adroit hammer with the JAX package's: the model, the
nail's touch sensor (the contact wrench on the nail, from only the pairs
that touch it), the resets with the board's height and the nail
curriculum, and the step's 46-dim observation, reward and success.

Each reset takes the reference's own ``jax.random`` draws (the raw key for
the board, ``fold_in(key, 1)`` for the nail's depth); each step is held
against the JAX ``step`` with both frame steppers replaced by the same
post-step state. The sensor is clipped at 1 N, so its wrench is also held
unclipped, on states where the nail touches with under and over 1 N.
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
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import contact, engine, probe, soa
from mjrl_tpu_torch.physics.tables import pair_groups

torch.set_num_threads(1)

B = 4
TOL_OBS = dict(rtol=1e-5, atol=1e-5)
# the nail's wrench: the same f32 formulas per point, summed per kind in
# another order, over forces of up to ~10 N
TOL_WRENCH = dict(rtol=0, atol=1e-5)
GAIN_FIELDS = ("dof_limit_stiffness", "dof_limit_damping", "tendon_limit_stiffness",
               "tendon_limit_damping")


@pytest.fixture(scope="module")
def envs():
    return make("adroit_hammer", device="cpu"), jenvs.make("adroit_hammer")


def test_hammer_model_matches_reference(envs):
    """Every field after the env's settings (as pen's test holds it), the
    54 of 229 pairs that touch the nail, and the board's root link."""
    env, jenv = envs
    for f in dataclasses.fields(jenv.model):
        g, w = getattr(env.model, f.name), getattr(jenv.model, f.name)
        if w is None or isinstance(w, (str, int, float, tuple, dict)):
            assert g == w, f.name
        elif f.name in GAIN_FIELDS:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f.name)
    touching = {k: int(((t["li"] == env._nail) | (t["lj"] == env._nail)).sum())
                for k, t in contact._pairs_touching(env.model, (env._nail,))}
    assert touching == {"capsule_plane": 2, "capsule_box": 12, "capsule_capsule": 40}
    assert len(env.model.contact_pairs) == 229
    assert env._board_root == jenv._body_root_link("nail_board")
    assert env.spec.observation_dim == jenv.spec.observation_dim == 46


def _nail_depth(env, q, d, other=None):
    """Per env, the deepest contact point of a pair that touches the nail
    (and the link ``other``, if given)."""
    pos, quat = soa._fk(env.model, torch.as_tensor(q), torch.as_tensor(d))
    return torch.cat([c.depth for c in soa._contact_candidates(env.model, pos, quat)
                      if env._nail in (c.li, c.lj) and other in (None, c.li, c.lj)]
                     ).amax(dim=0).numpy()


def _nail_states(env, rng):
    """Batch-last ``(q, qd, link_delta)`` at the hand's default pose where
    the nail touches, in two sets: the board lowered until the nail's shaft
    is 0.1 to 2 mm into the table, and the hammer carried onto the nail (a
    capsule pair between them 1 to 9 mm closer than touching); qd uniform
    in +-0.05."""
    m = env.model
    rest = lambda n: np.tile(np.asarray(m.default_qpos, np.float32)[:, None], (1, n))  # noqa: E731
    q = rest(32)
    d = np.zeros((3 * m.nlink, 32), np.float32)
    table = env._link["table"]
    d[3 * env._board_root + 2] = -(rng.uniform(0.0001, 0.002, 32) - _nail_depth(env, q, d, table))
    tab = dict(pair_groups(m).kinds)["capsule_capsule"]
    hammer = ((tab["li"] == env._nail) & (tab["lj"] == env._obj)) | (
        (tab["lj"] == env._nail) & (tab["li"] == env._obj))
    qb = rest(256)
    db = probe._carried_onto(m, {k: v[hammer] for k, v in tab.items()}, qb, rng)
    depth = _nail_depth(env, qb, db)
    keep = (depth > 0) & (depth < 0.01)
    sets = []
    for q, d in ((q, d), (qb[:, keep], db[:, keep])):
        qd = rng.uniform(-0.05, 0.05, (m.nv, q.shape[1])).astype(np.float32)
        sets.append((q, qd, d))
    return sets


@pytest.fixture(scope="module")
def nail_states(envs):
    return _nail_states(envs[0], np.random.default_rng(0))


def test_nail_contact_row_matches_reference(envs, nail_states):
    """The nail's row of ``contact_forces(..., links=(nail,))``, which
    collides only the nail's pairs, equals the nail's row of the
    reference's whole ``contact_forces`` (box_plane and box_box included) on the
    post-step kinematics (with qd), at states where the nail touches the
    table or the hammer with a force under 1 N and over it; the sensor
    reads the clipped norm."""
    env, jenv = envs
    m, nail = env.model, env._nail
    picked = []
    for (q, qd, d), n_under, n_over in zip(nail_states, (4, 0), (2, 2)):
        n = q.shape[1]
        q, qd, d = q.T.copy(), qd.T.copy(), d.T.reshape(n, m.nlink, 3).copy()
        kin = engine.compute_kinematics(m, *map(torch.as_tensor, (q, qd, d)))
        force = torch.linalg.vector_norm(
            contact.contact_forces(m, kin, links=(nail,))[:, nail, 3:], dim=-1).numpy()
        under = np.flatnonzero((force > 0) & (force < 1.0))[:n_under]
        over = np.flatnonzero(force > 1.0)[:n_over]
        assert (under.size, over.size) == (n_under, n_over), force
        picked.append((under, over, q, qd, d))
    # 4 under 1 N (the table), then 2 over (the table) and 2 over (the hammer)
    q, qd, d = (np.concatenate([p[k][p[0]] for p in picked] + [p[k][p[1]] for p in picked])
                for k in (2, 3, 4))
    pick = np.arange(q.shape[0])
    kin = engine.compute_kinematics(m, *map(torch.as_tensor, (q, qd, d)))
    got = contact.contact_forces(m, kin, links=(nail,))[:, nail]
    jfn = lambda q, qd, d: jcontact.contact_forces(jenv.model, jengine.compute_kinematics(  # noqa: E731
        jenv.model, jengine.PhysicsState(q=q, qd=qd), link_pos_delta=d))[jenv._link["nail"]]
    # one env at a time, as the reference's observation calls it (its eager
    # ops then compile once for this test and the env's)
    want = np.stack([np.asarray(jfn(*(jnp.asarray(x[i]) for x in (q, qd, d))))
                     for i in range(len(pick))])
    np.testing.assert_allclose(got.numpy(), want, **TOL_WRENCH)
    norm = np.linalg.norm(want[:, 3:], axis=-1)
    assert (norm[:4] < 1.0).all() and (norm[4:] > 1.0).all() and (norm > 0).all()
    # the sensor: the clipped norm, as the reference's observation reads it
    st = env._rest_state(len(pick))._replace(q=torch.as_tensor(q), qd=torch.as_tensor(qd),
                                             link_delta=torch.as_tensor(d))
    impact = env._obs(st)[:, -1].numpy()
    np.testing.assert_allclose(impact, np.clip(norm, -1.0, 1.0), rtol=1e-5, atol=1e-6)


def _draws(key, nail_init_max=0.0):
    out = [jax.random.uniform(key, (), minval=0.1, maxval=0.25)]
    if nail_init_max > 0.0:
        out.append(jax.random.uniform(jax.random.fold_in(key, 1), (),
                                      maxval=nail_init_max * 0.081))
    return out


def _hold_resets(env, jenv, nail_init_max=0.0):
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    want = [jenv.reset(k) for k in keys]
    draws = torch.as_tensor(np.asarray([[float(x) for x in _draws(k, nail_init_max)]
                                        for k in keys], np.float32))
    st, obs = env.reset_from_noise(draws, draws.new_zeros(B, 0))
    np.testing.assert_allclose(obs.numpy(), np.stack([np.asarray(o) for _, o in want]),
                               **TOL_OBS)
    for name, got in (("link_delta", st.link_delta), ("target", st.target)):
        np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(getattr(s, name))
                                                          for s, _ in want]),
                                   rtol=0, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(st.q.numpy(), np.stack([np.asarray(s.ps.q) for s, _ in want]))
    assert st.link_delta.abs().amax() > 0.01  # the board moved
    return st, want


def test_reset_matches_reference(envs):
    """Four resets with the reference's board heights: the observation (the
    nail's sensor included) and the board's offset."""
    env, jenv = make("adroit_hammer", device="cpu"), envs[1]
    _hold_resets(env, jenv)


def test_nail_curriculum_reset_matches_reference(envs):
    """``nail_init_max=1``: the nail starts driven in by a depth drawn from
    ``fold_in(key, 1)``; the board's heights stay those of 0."""
    env, jenv = make("adroit_hammer", device="cpu", nail_init_max=1.0), envs[1]
    jenv.nail_init_max = 1.0
    try:
        st, _ = _hold_resets(env, jenv, nail_init_max=1.0)
    finally:
        jenv.nail_init_max = 0.0
    depth = st.q[:, env._jnt_q["nail_dir"]]
    assert bool((depth > 0).all()) and bool((depth < 0.081).all())
    assert env.reset_noise(3)[0].shape == (3, 2)


def test_step_matches_reference(envs, nail_states):
    """One step each from given post-step states (both frame steppers
    stubbed): the hand at rest, the hammer carried onto the nail (its
    offset in the state) with a moving hand, so the sensor reads a force,
    the nail driven home (success, both bonuses), and a diverged qd; the
    observation, the reward, ``terminated``, ``success`` and the blow-up
    guard."""
    env, jenv = make("adroit_hammer", device="cpu"), envs[1]
    st, want_reset = _hold_resets(env, jenv)
    jst = [s for s, _ in want_reset]
    m = env.model
    rng = np.random.default_rng(4)
    q2 = np.tile(np.asarray(m.default_qpos, np.float32), (B, 1))
    qd2 = np.zeros((B, m.nv), np.float32)
    hq, _, hd = nail_states[1]
    q2[1] = hq[:, 0]
    delta = torch.as_tensor(hd[:, 0].reshape(m.nlink, 3))
    st.link_delta[1] = delta
    jst[1] = jst[1]._replace(link_delta=jnp.asarray(delta.numpy()))
    qd2[1] = rng.uniform(-1.5, 1.5, m.nv)
    q2[2, env._jnt_q["nail_dir"]] = 0.085
    qd2[3, 5] = 2e4
    action = rng.uniform(-1.5, 1.5, (B, m.nu)).astype(np.float32)
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
    assert rew[2] > 90.0 and obs.numpy()[1, -1] > 0.0  # the bonuses; the sensor
