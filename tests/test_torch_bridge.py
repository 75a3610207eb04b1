"""The port's MuJoCo bridge (mjrl_tpu_torch/physics/bridge.py) against the
JAX package's, against the committed Adroit assets, and against MuJoCo.

- ``model_from_mujoco`` on the four Adroit XMLs of the installed
  Gymnasium-Robotics wheel, after the servo retuning
  (``envs/adroit.py::apply_gain_overrides``, the twin of
  ``AdroitEnv._apply_gain_overrides``), field by field against the JAX
  bridge's ``Model`` on the same ``MjModel``: integers equal and floats bit
  for bit, every field (both run the same numpy code on the same compiled
  arrays; no field is let off);
- the same ``Model`` against ``envs/assets/adroit_<task>.npz`` as
  ``load_model_npz`` reads it, which the env loads on the card;
- a small inline MJCF with a free body, a ball joint, a slide joint, an
  explicit ``<pair>`` with condim 1 and an ``<exclude>``: the branches the
  Adroit models do not reach, against the JAX bridge and against
  ``mujoco.mj_forward``'s body positions;
- the ports of ``tests/test_adroit.py``'s bridge tests on every Adroit
  task (the raw XML, no retuning, as there): the structure, the link and
  site positions and tendon lengths of the port's plain kinematics against
  ``mujoco.mj_forward`` (atol 5e-6), the contact- and limit-free ``qacc``
  of its plain dynamics against MuJoCo's (relative 5e-3) and the servos'
  joint forces against ``qfrc_actuator`` (atol 1e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")
pytest.importorskip("gymnasium_robotics")

from mjrl_tpu.envs.adroit import AdroitEnv, _adroit_asset
from mjrl_tpu.physics import bridge as jbridge
from mjrl_tpu_torch.envs.adroit import adroit_xml, apply_gain_overrides, compile_adroit_model
from mjrl_tpu_torch.physics import bridge, engine
from mjrl_tpu_torch.physics.model import BALL, FREE, SLIDE, load_model_npz, model_arrays

torch.set_num_threads(1)

TASKS = ("pen", "hammer", "door", "relocate")

# a free body, a ball joint under it, a slide joint on a second body, a
# geom pair that only an explicit frictionless <pair> adds (contype 0) and
# one that an <exclude> removes
INLINE_MJCF = """
<mujoco>
  <option timestep="0.005" density="1.2" viscosity="0.00002"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="torso" pos="0.1 -0.2 1.0" quat="0.9 0.1 0.3 -0.2">
      <freejoint/>
      <geom name="core" type="capsule" fromto="-0.2 0 0 0.2 0 0" size="0.07"/>
      <body name="arm" pos="0.25 0 0">
        <joint name="shoulder" type="ball" range="0 1.2" limited="true" damping="0.3"/>
        <geom name="upper" type="sphere" size="0.08" pos="0.1 0 0" contype="0"/>
        <body name="hand" pos="0.2 0 0">
          <joint name="wrist" type="hinge" axis="0 1 0" range="-1 1"/>
          <geom name="palm" type="box" size="0.05 0.03 0.02" pos="0.05 0 0"/>
        </body>
      </body>
    </body>
    <body name="slider" pos="1 0 0.3">
      <joint name="rail" type="slide" axis="1 0 0" range="-0.5 0.5" frictionloss="0.2"/>
      <geom name="block" type="box" size="0.1 0.1 0.1" friction="0.7 0.01 0.001"/>
    </body>
  </worldbody>
  <contact>
    <pair geom1="upper" geom2="block" condim="1"/>
    <exclude body1="slider" body2="hand"/>
  </contact>
  <actuator>
    <motor joint="wrist" gear="2" ctrlrange="-1 1" ctrllimited="true"/>
    <position joint="rail" kp="5"/>
  </actuator>
</mujoco>
"""


def assert_models_equal(got, want, what):
    """Every field of two ``Model``s (the port's and the JAX package's, or
    the port's and a loaded one): integers equal, floats bit for bit."""
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)], what
    a, b = model_arrays(got), model_arrays(want)
    assert sorted(a) == sorted(b), (what, set(a) ^ set(b))
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
        assert a[k].tobytes() == b[k].tobytes(), (what, k)


@pytest.fixture(scope="module")
def retuned():
    """Per task: the retuned ``MjModel`` and the port's ``Model`` of it."""
    out = {}
    for task in TASKS:
        mj = bridge.load_mj_model(adroit_xml(task))
        apply_gain_overrides(mj)
        out[task] = (mj, bridge.model_from_mujoco(mj))
    return out


@pytest.mark.parametrize("task", TASKS)
def test_bridge_matches_the_jax_bridge(retuned, task):
    assert adroit_xml(task) == _adroit_asset(task)
    mj, model = retuned[task]
    ref = jbridge.load_mj_model(_adroit_asset(task))
    AdroitEnv._apply_gain_overrides(ref)
    for name in ("actuator_gainprm", "actuator_biasprm"):  # the retuning's twin
        np.testing.assert_array_equal(getattr(mj, name), getattr(ref, name))
    assert_models_equal(model, jbridge.model_from_mujoco(ref), task)
    assert_models_equal(model, jbridge.model_from_mujoco(mj), task)


@pytest.mark.parametrize("task", TASKS)
def test_bridge_matches_the_committed_asset(retuned, task):
    from mjrl_tpu_torch.envs.adroit import ASSETS

    _, model = retuned[task]
    stored = load_model_npz(f"{ASSETS}/adroit_{task}.npz")
    assert_models_equal(model, stored, task)
    assert_models_equal(compile_adroit_model(task), stored, task)


def test_bridge_free_ball_slide_pair_exclude():
    mj = mujoco.MjModel.from_xml_string(INLINE_MJCF)
    model = bridge.model_from_mujoco(mj)
    assert_models_equal(model, jbridge.model_from_mujoco(mj), "inline")
    assert (model.nq, model.nv, model.nu) == (mj.nq, mj.nv, mj.nu) == (7 + 4 + 1 + 1, 6 + 3 + 2, 2)
    types = model.link_jnt_type
    assert types[model.link_name.index("torso")] == FREE
    assert types[model.link_name.index("arm")] == BALL
    assert types[model.link_name.index("slider")] == SLIDE
    # the free body's pose moves into qpos0; its link sits at the world origin
    torso = model.link_name.index("torso")
    np.testing.assert_array_equal(model.link_pos[torso], 0.0)
    np.testing.assert_array_equal(model.link_quat[torso], [1, 0, 0, 0])
    np.testing.assert_array_equal(
        model.qpos0[:7], np.concatenate([mj.body_pos[1], mj.body_quat[1]]).astype(np.float32))
    np.testing.assert_array_equal(model.qpos0, np.asarray(mj.qpos0, np.float32))
    # the explicit pair is frictionless with condim 1; the excluded pair is gone
    geom = {mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_GEOM, g): g for g in range(mj.ngeom)}
    upper, block = geom["upper"], geom["block"]
    assert model.pair_mu == {(upper, block): 0.0} and model.pair_condim == {(upper, block): 1}
    pairs = set(model.contact_pairs)
    assert (upper, block) in pairs
    assert (geom["palm"], geom["block"]) not in pairs and (geom["block"], geom["palm"]) not in pairs
    assert (geom["core"], geom["upper"]) not in pairs  # parent and child
    assert model.geom_condim[upper] == 3 and model.dof_frictionloss is not None
    # the port's kinematics against MuJoCo's at a random state
    rng = np.random.RandomState(5)
    q = np.asarray(mj.qpos0) + rng.uniform(-0.3, 0.3, mj.nq)
    for adr in (3, 7):  # the free and the ball joint's quaternions
        q[adr:adr + 4] /= np.linalg.norm(q[adr:adr + 4])
    d = mujoco.MjData(mj)
    d.qpos[:] = q
    mujoco.mj_forward(mj, d)
    kin = engine.compute_kinematics(model, torch.as_tensor(q[None], dtype=torch.float32),
                                    torch.zeros(1, mj.nv))
    for bi in range(1, mj.nbody):
        li = model.link_name.index(mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_BODY, bi))
        np.testing.assert_allclose(kin.pos[0, li].numpy(), d.xpos[bi], atol=5e-6)


@pytest.fixture(scope="module")
def raw():
    """Per task: the ``MjModel`` of the raw XML and the port's ``Model``."""
    out = {}
    for task in TASKS:
        mj = bridge.load_mj_model(adroit_xml(task))
        out[task] = (mj, bridge.model_from_mujoco(mj))
    return out


@pytest.mark.parametrize("task", TASKS)
def test_bridge_structure(raw, task):
    mj, model = raw[task]
    assert model.nq == mj.nq and model.nv == mj.nv and model.nu == mj.nu
    assert model.tendon_Jq.shape == (mj.ntendon, mj.nq)
    assert len(model.site_name) == mj.nsite
    assert np.isclose(model.link_mass.sum(), mj.body_mass.sum(), rtol=1e-6)


@pytest.mark.parametrize("task", TASKS)
def test_bridge_kinematics_sites_tendons(raw, task):
    mj, model = raw[task]
    d = mujoco.MjData(mj)
    rng = np.random.RandomState(3)
    q = np.asarray(mj.qpos0) + rng.uniform(-0.3, 0.3, mj.nq)
    qd = rng.uniform(-1, 1, mj.nv)
    d.qpos[:] = q
    d.qvel[:] = qd
    mujoco.mj_forward(mj, d)
    kin = engine.compute_kinematics(model, torch.as_tensor(q[None], dtype=torch.float32),
                                    torch.as_tensor(qd[None], dtype=torch.float32))
    for bi in range(1, mj.nbody):
        li = model.link_name.index(mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_BODY, bi))
        np.testing.assert_allclose(kin.pos[0, li].numpy(), d.xpos[bi], atol=5e-6)
    sites = engine.site_positions(model, kin.pos, kin.quat)[0].numpy()
    np.testing.assert_allclose(sites, d.site_xpos, atol=5e-6)
    np.testing.assert_allclose(model.tendon_Jq @ np.asarray(q, np.float32), d.ten_length,
                               atol=1e-6)


@pytest.mark.parametrize("task", TASKS)
def test_bridge_smooth_dynamics(task):
    """``qacc`` against MuJoCo with contacts and limits off on both sides
    (the penalty limits zeroed here, MuJoCo's disable flags there; dof
    frictionloss, a constraint row in MuJoCo, left out of both)."""
    model = bridge.model_from_mujoco(bridge.load_mj_model(adroit_xml(task)))
    model.limit_stiffness = 0.0
    model.limit_damping = 0.0
    model.dof_frictionloss = None
    m2 = bridge.load_mj_model(adroit_xml(task))
    m2.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_CONTACT | mujoco.mjtDisableBit.mjDSBL_LIMIT
    d = mujoco.MjData(m2)
    rng = np.random.RandomState(1)
    q = np.asarray(m2.qpos0) + rng.uniform(-0.05, 0.05, m2.nq)
    qd = rng.uniform(-0.5, 0.5, m2.nv)
    ctrl = rng.uniform(-0.3, 0.3, m2.nu)
    d.qpos[:] = q
    d.qvel[:] = qd
    d.ctrl[:] = ctrl
    mujoco.mj_forward(m2, d)
    full = np.zeros((m2.nv, m2.nv))
    mujoco.mj_fullM(m2, d, full)
    qacc_ref = np.linalg.solve(full, d.qfrc_actuator + d.qfrc_passive - d.qfrc_bias)
    state = engine.PhysicsState(q=torch.as_tensor(q[None], dtype=torch.float32),
                                qd=torch.as_tensor(qd[None], dtype=torch.float32))
    qdd = engine.forward_dynamics(model, state, torch.as_tensor(ctrl[None], dtype=torch.float32),
                                  dt=0.0)[0].numpy()
    rel = np.abs(qdd - qacc_ref) / (np.abs(qacc_ref) + 1.0)
    assert rel.max() < 5e-3, rel.max()


@pytest.mark.parametrize("task", TASKS)
def test_actuator_affine_servo(raw, task):
    mj, model = raw[task]
    d = mujoco.MjData(mj)
    rng = np.random.RandomState(7)
    q = np.asarray(mj.qpos0) + rng.uniform(-0.1, 0.1, mj.nq)
    qd = rng.uniform(-1, 1, mj.nv)
    ctrl = rng.uniform(-1, 1, mj.nu)
    d.qpos[:] = q
    d.qvel[:] = qd
    d.ctrl[:] = ctrl
    mujoco.mj_forward(mj, d)
    state = engine.PhysicsState(q=torch.as_tensor(q[None], dtype=torch.float32),
                                qd=torch.as_tensor(qd[None], dtype=torch.float32))
    tau = engine.actuation(model, torch.as_tensor(ctrl[None], dtype=torch.float32), state)
    np.testing.assert_allclose(tau[0].numpy(), d.qfrc_actuator, atol=1e-4)
