"""Parity of the per-env engine's Newton rows and solve (mjrl_tpu_torch.
physics.csolve) and of the box narrow phases (physics/contact.py) with the
JAX package's.

Hopper with the Newton solver: ``build_rows`` (limit rows, then contact
rows of every facet, between the floor and a link and between two moving
links) and ``forward_qacc`` on both of its surfaces (dt == 0, dt > 0)
against the live JAX versions under ``jax.jit(jax.vmap(...))``, on states
where half the batch is folded so a pair of links overlaps. The dt == 0
frictionloss divergence is pinned against MuJoCo as the reference's
``tests/test_csolve.py`` pins it. The box_plane and box_box kinds' depth,
normal and point against the JAX ``_collide_kind`` under
``jax.disable_jit()`` on pen's and hammer's ``probe.kind_states`` (every
kind touching, some through a link offset), as the reference's
``tests/test_soa_boxes.py`` holds its fast path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import envs as jenvs
from mjrl_tpu.physics import csolve as jcsolve
from mjrl_tpu.physics import engine as jengine
from mjrl_tpu.physics.contact import _collide_kind as j_collide_kind
from mjrl_tpu.physics.contact import _pair_groups as j_pair_groups
from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import csolve, engine, probe
from mjrl_tpu_torch.physics.contact import _collide_kind
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.tables import pair_groups

torch.set_num_threads(1)

B = 8
# rows and accelerations: the same f32 formulas, sums in another order
TOL_ROWS = dict(rtol=1e-5, atol=1e-5)
TOL_QACC = dict(rtol=1e-4, atol=1e-3)
# the narrow phase: tests/test_soa_boxes.py's tolerances
TOL_DEPTH = dict(rtol=1e-4, atol=1e-5)
TOL_NORMAL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def hopper():
    env = make("hopper", horizon=8, device="cpu", constraint_solver="newton")
    jenv = jenvs.make("hopper", horizon=8, constraint_solver="newton")
    rng = np.random.default_rng(0)
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    for _ in range(6):
        state, *_ = env.step(state, torch.as_tensor(rng.uniform(-1, 1, (B, 3)),
                                                    dtype=torch.float32))
    q, qd = state.q.numpy().copy(), state.qd.numpy().copy()
    fq, fqd = probe.overlapping_states(env.model, B - B // 2, rng)
    q[B // 2 :], qd[B // 2 :] = fq.T, fqd.T
    ctrl = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    return env.model, jenv.model, q, qd, ctrl


def test_build_rows_and_forward_qacc_match_reference(hopper):
    m, jm, q, qd, ctrl = hopper
    jcsolve.ensure_solver_params(jm)

    def one(q, qd, c):
        ps = jengine.PhysicsState(q, qd)
        kin = jengine.compute_kinematics(jm, ps)
        rows = jcsolve.build_rows(jm, kin, ps)
        return (rows.J, rows.aref, rows.D, jcsolve.forward_qacc(jm, ps, c),
                jcsolve.forward_qacc(jm, ps, c, dt=0.002))

    want = [np.asarray(x) for x in jax.jit(jax.vmap(one))(q, qd, ctrl)]
    tq, tqd, tc = map(torch.as_tensor, (q, qd, ctrl))
    ps = engine.PhysicsState(tq, tqd)
    rows = csolve.build_rows(m, engine.compute_kinematics(m, tq, tqd), ps)
    got = [x.numpy() for x in (*rows, csolve.forward_qacc(m, ps, tc),
                               csolve.forward_qacc(m, ps, tc, dt=0.002))]
    assert got[0].shape == want[0].shape  # the rows in the reference's order
    for name, g, w, tol in zip(("J", "aref", "D"), got, want, (TOL_ROWS,) * 3):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=tol["rtol"], atol=tol["atol"] * scale, err_msg=name)
    for name, g, w in zip(("qacc dt=0", "qacc dt>0"), got[3:], want[3:]):
        np.testing.assert_allclose(g, w, **TOL_QACC, err_msg=name)
    # rows held in margin, some between two moving links (the folded half)
    D = got[2]
    assert (D[: B // 2] > 0).any() and (D[B // 2 :] > 0).any()


def test_impedance_and_kb_match_reference():
    rng = np.random.default_rng(1)
    solimp = np.tile(np.asarray([0.9, 0.95, 0.001, 0.5, 2.0], np.float32), (7, 1))
    solimp[3:, 2] = [0.01, 0.05, 0.1, 0.2]
    solimp[5:, 4] = 3.0
    solref = np.tile(np.asarray([0.02, 1.0], np.float32), (7, 1))
    solref[5] = [-500.0, -20.0]
    pos = rng.uniform(-0.3, 0.05, (3, 7)).astype(np.float32)
    got = csolve._impedance(torch.as_tensor(solimp), torch.as_tensor(pos)).numpy()
    want = np.stack([np.asarray(jcsolve._impedance(jnp.asarray(solimp), jnp.asarray(p)))
                     for p in pos])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for g, w in zip(csolve._kb(torch.as_tensor(solref), torch.as_tensor(solimp)),
                    jcsolve._kb(jnp.asarray(solref), jnp.asarray(solimp))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


FRICTIONLOSS_XML = """
<mujoco><option timestep="0.002" gravity="0 0 0"/>
<worldbody>
<body name="arm" pos="0 0 1">
  <joint name="hinge" type="hinge" axis="0 1 0" frictionloss="{fl}"/>
  <geom type="capsule" fromto="0 0 0 0.5 0 0" size="0.04" mass="1"/>
</body>
</worldbody></mujoco>"""


def test_dt0_frictionloss_divergence_pinned(tmp_path):
    """The reference's documented dt == 0 surface (``mjrl_tpu/physics/
    csolve.py:443-470``), pinned as its ``tests/test_csolve.py`` pins it:
    MuJoCo reports frictionloss through constraint rows in ``d.qacc``, the
    dt == 0 surface drops it (qacc 0 where MuJoCo's is ``-fl / I``), a
    frictionless model matches MuJoCo there, and at dt > 0 the tanh force
    and its slope enter the solve."""
    mujoco = pytest.importorskip("mujoco")
    fl, out = 2.5, {}
    for f in (fl, 0.0):
        xml = FRICTIONLOSS_XML.format(fl=f)
        mj = mujoco.MjModel.from_xml_string(xml)
        d = mujoco.MjData(mj)
        d.qvel[0] = 1.0
        mujoco.mj_forward(mj, d)
        path = tmp_path / f"arm{f}.xml"
        path.write_text(xml)
        m = load_mjcf(str(path))
        m.constraint_solver = "newton"
        ps = engine.PhysicsState(torch.as_tensor(d.qpos.astype(np.float32))[None],
                                 torch.as_tensor(d.qvel.astype(np.float32))[None])
        ctrl = torch.zeros(1, m.nu)
        out[f] = (float(csolve.forward_qacc(m, ps, ctrl)[0, 0]), float(d.qacc[0]),
                  float(mj.dof_M0[0]), float(csolve.forward_qacc(m, ps, ctrl, dt=0.002)[0, 0]))
    ours, theirs, inertia, integrating = out[fl]
    assert abs(ours - theirs) > 0.5 * fl / inertia
    np.testing.assert_allclose(ours, 0.0, atol=1e-5)
    np.testing.assert_allclose(theirs, -fl / inertia, rtol=1e-3)
    assert integrating < -0.5 * fl / inertia  # the tanh friction, at qd = 1 past its v_eps
    ours0, theirs0, _, _ = out[0.0]
    np.testing.assert_allclose(ours0, theirs0, atol=1e-5)


@pytest.mark.parametrize("task", ["pen", "hammer"])
def test_box_kinds_match_reference_narrow_phase(task):
    """box_plane (8 corners) and box_box (two runs of 8 corners) depth,
    normal and point; contact.py's other kinds are held in
    tests/test_torch_adroit.py."""
    env = make(f"adroit_{task}", device="cpu")
    jenv = jenvs.make(f"adroit_{task}")
    m, jm = env.model, jenv.model
    q, _, delta = probe.kind_states(m, 2, np.random.default_rng(2))
    q, delta = q.T, delta.T.reshape(-1, m.nlink, 3)
    kinds = {k: t for k, t in pair_groups(m).kinds if k in ("box_plane", "box_box")}
    jkinds = {k: t for k, t in j_pair_groups(jm).kinds if k in kinds}
    assert sorted(kinds) == sorted(jkinds) == ["box_box", "box_plane"]

    def one(qi, di):
        pos, quat, _ = jengine.forward_kinematics(jm, qi, di)
        z = jnp.zeros(())
        kin = jengine.Kinematics(pos=pos, quat=quat, origin=pos[0], cdof=z, cvel=z, qd=z)
        return {k: j_collide_kind(jm, kin, k, t)[:3] for k, t in jkinds.items()}

    with jax.disable_jit():
        want = jax.vmap(one)(jnp.asarray(q), jnp.asarray(delta))
    tq = torch.as_tensor(q)
    pos, quat = engine.forward_kinematics(m, tq, torch.as_tensor(delta))
    kin = engine.Kinematics(pos=pos, quat=quat, origin=pos[:, 0], cdof=None, cvel=None, qd=None)
    touched = 0
    for kind, tab in kinds.items():
        depth, nrm, pts, li, lj, mu = _collide_kind(m, kin, kind, tab)
        wd, wn, wp = (np.asarray(x) for x in want[kind])
        np.testing.assert_allclose(depth.numpy(), wd, **TOL_DEPTH, err_msg=f"{kind} depth")
        active = wd > -1e-3
        np.testing.assert_allclose(nrm.numpy()[active], wn[active], **TOL_NORMAL,
                                   err_msg=f"{kind} normal")
        np.testing.assert_allclose(pts.numpy()[active], wp[active], **TOL_NORMAL,
                                   err_msg=f"{kind} point")
        assert len(li) == len(lj) == mu.shape[0] == depth.shape[1]
        touched += int((wd > 0).any())
    assert touched == 2  # both kinds touch in these states
