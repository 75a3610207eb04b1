"""Kernel K3's arithmetic on the CPU, and its wrapper's contract.

K3's warp body (``mjrl_tpu_torch/csrc/mj_warp_penalty.h`` with ``EXT`` on:
per-env link offsets, the box contact kinds, gain/bias servos, fixed
tendons, frictionloss) is compiled with g++ (no CUDA) into a ctypes
library through ``mj_host.cpp``'s ``mj_ext_host``, which runs it under the
emulated warp, and its control steps are held against the plain PyTorch
version (physics/soa.py): on Adroit pen in the Adroit size class
(``pkernel.size_flags(2)``), from warmed states with link offsets and from
states where each of pen's five contact kinds touches; and in the small
class on small models that exercise one stage each (a box on a hinge with
frictionloss over the floor, a ball over a block, the box with a servo and
a limited tendon).
The test marked ``cuda`` launches the real kernel and runs only where a
card is present.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, probe, soa, tables
from mjrl_tpu_torch.physics.mjcf import load_mjcf

torch.set_num_threads(1)

# host build vs plain, one control step from the same state: the same f32
# formulas, a few sums in another order (tests/test_torch_kernel_body.py)
TOL_Q = dict(rtol=1e-5, atol=1e-5)
TOL_QD = dict(rtol=1e-4, atol=1e-4)

_BOX_FRICTION = """
<mujoco model="box_friction">
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="box" pos="0 0 0.12">
      <joint name="hinge" type="hinge" axis="0 1 0" frictionloss="0.5"/>
      <geom name="box" type="box" size="0.1 0.05 0.1" mass="1"/>
    </body>
  </worldbody>
  <actuator><motor joint="hinge" gear="1"/></actuator>
</mujoco>
"""
_SPHERE_BOX = """
<mujoco model="sphere_box">
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <geom name="block" type="box" pos="0 0 0.2" size="0.3 0.2 0.1" euler="0 0 20"/>
    <body name="ball" pos="0 0 0.5">
      <joint name="root" type="free"/>
      <geom name="ball" type="sphere" size="0.08" mass="1"/>
    </body>
  </worldbody>
</mujoco>
"""


def _library(directory, size):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS,
                                                 *pkernel.size_flags(size)), directory)
    lib = ctypes.CDLL(str(path))
    lib.mj_ext_host.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mj_ext_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def lib_small(tmp_path_factory):
    return _library(tmp_path_factory.mktemp("k3_small"), 0)


@pytest.fixture(scope="module")
def lib_adroit(tmp_path_factory):
    return _library(tmp_path_factory.mktemp("k3_adroit"), 2)


def _host_runner(lib, model):
    """K3's host build for ``model``: ``run(q, qd, ctrl, delta, n_frames)``
    on batch-last numpy arrays (``delta`` may be None)."""
    mf, mi = pkernel.pack_tables(model, pkernel.read_layout(lib), ext=True)

    def run(q, qd, ctrl, delta, n_frames):
        q, qd, ctrl = (np.ascontiguousarray(x, np.float32) for x in (q, qd, ctrl))
        q_out, qd_out = np.empty_like(q), np.empty_like(qd)
        d = None if delta is None else np.ascontiguousarray(delta, np.float32)
        ptr = [a.ctypes.data for a in (mf, mi, q, qd, ctrl)] + [
            None if d is None else d.ctypes.data, q_out.ctypes.data, qd_out.ctypes.data]
        dt = float(np.float32(model.dt / model.n_substeps))
        assert lib.mj_ext_host(*ptr, q.shape[1], n_frames * model.n_substeps, dt) == 0
        return q_out, qd_out

    return run


def _plain(model, q, qd, ctrl, delta, n_frames):
    out = soa.multistep(model, *map(torch.as_tensor, (q, qd, ctrl)), n_frames,
                        link_delta=None if delta is None else torch.as_tensor(delta))
    return [x.numpy() for x in out]


@pytest.fixture(scope="module")
def pen():
    """The pen env and B=9 start states: 4 after 2 control steps of random
    actions from reset, their links offset by up to 5 mm; then one per
    contact kind where that kind touches (``probe.kind_states``)."""
    env = make("adroit_pen", device="cpu")
    rng = np.random.default_rng(0)
    state, _ = env.reset(4, torch.Generator().manual_seed(0))
    for _ in range(2):
        state, *_ = env.step(state, torch.as_tensor(rng.uniform(-1, 1, (4, 24)),
                                                    dtype=torch.float32))
    kq, kqd, kd = probe.kind_states(env.model, 1, rng)
    q = np.concatenate([state.q.T.numpy(), kq], axis=1)
    qd = np.concatenate([state.qd.T.numpy(), kqd], axis=1)
    delta = np.concatenate([rng.uniform(-0.005, 0.005, (3 * env.model.nlink, 4)), kd], axis=1)
    return env, q, qd, delta.astype(np.float32)


def test_k3_host_build_matches_plain_on_pen(pen, lib_adroit):
    """Two chained control steps (5 substeps each) of the host build, each
    held against the plain version from the same state with the same link
    offsets; every contact kind touches on the way, and the tendons' limits
    are hit."""
    env, q, qd, delta = pen
    run = _host_runner(lib_adroit, env.model)
    rng = np.random.default_rng(1)
    touched = dict.fromkeys(("box_plane", "capsule_plane", "capsule_box", "box_box",
                             "capsule_capsule"), 0)
    for _ in range(2):
        for kind, d in probe.kind_depth(env.model, torch.as_tensor(q),
                                        torch.as_tensor(delta)).items():
            touched[kind] += int((d > 0).sum())
        ctrl = env._scaled_ctrl(torch.as_tensor(rng.uniform(-1, 1, (q.shape[1], 24)),
                                                dtype=torch.float32)).T.numpy()
        got_q, got_qd = run(q, qd, ctrl, delta, env.frame_skip)
        want_q, want_qd = _plain(env.model, q, qd, ctrl, delta, env.frame_skip)
        np.testing.assert_allclose(got_q, want_q, **TOL_Q)
        np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
        q, qd = got_q, got_qd
    assert all(touched.values()), touched
    length = env.model.tendon_Jq @ q
    lo, hi = env.model.tendon_range.T
    assert ((length < lo[:, None]) | (length > hi[:, None])).any()


def _small_model(case, tmp_path):
    path = tmp_path / f"{case}.xml"
    path.write_text(_SPHERE_BOX if case == "sphere_box" else _BOX_FRICTION)
    model = load_mjcf(str(path))
    if case == "servo_tendon":
        # a position servo (kp 10, kv 1) and one limited spring tendon on
        # the hinge, set as the Adroit bridge sets them
        model.act_gainprm = np.array([[10.0, 0.0, 0.0]], np.float32)
        model.act_biasprm = np.array([[0.0, -10.0, -1.0]], np.float32)
        model.act_qadr = np.array([0], np.int32)
        model.tendon_Jq = model.tendon_Jv = np.array([[2.0]], np.float32)
        model.tendon_range = np.array([[-0.3, 0.3]], np.float32)
        model.tendon_limited = np.array([1.0], np.float32)
        model.tendon_stiffness = np.array([5.0], np.float32)
        model.tendon_damping = np.array([0.5], np.float32)
        model.tendon_springlength = np.array([0.1], np.float32)
    tables.scale_limit_penalties(model)
    soa.check_supported(model)
    return model


@pytest.mark.parametrize("case", ["box_friction", "sphere_box", "servo_tendon"])
def test_k3_host_build_matches_plain_on_small_models(case, lib_small, tmp_path):
    """Each of K1's remainder stages in the small size class: the box-plane
    kind and frictionloss (a box on a hinge, resting on its corners and
    edges), the sphere-box kind (a free ball against a rotated block, its
    centre in and out of it), and the servo with a limited tendon; four
    chained control steps of 5 frames."""
    model = _small_model(case, tmp_path)
    rng = np.random.default_rng(2)
    B = 8
    q = np.tile(np.asarray(model.default_qpos, np.float32)[:, None], (1, B))
    if case == "sphere_box":
        world = rng.uniform([-0.35, -0.25, 0.15], [0.35, 0.25, 0.4], (B, 3)).T
        q[:3] = world - np.asarray(model.link_pos[0], np.float32)[:, None]
    else:
        q[0] = rng.uniform(-1.0, 1.0, B)
    qd = rng.uniform(-1.0, 1.0, (model.nv, B)).astype(np.float32)
    run = _host_runner(lib_small, model)
    contact = 0
    for _ in range(4):
        depth = probe.kind_depth(model, torch.as_tensor(q))
        contact += sum(int((d > 0).sum()) for d in depth.values())
        ctrl = rng.uniform(-1, 1, (model.nu, B)).astype(np.float32)
        got = run(q, qd, ctrl, None, 5)
        want = _plain(model, q, qd, ctrl, None, 5)
        np.testing.assert_allclose(got[0], want[0], **TOL_Q)
        np.testing.assert_allclose(got[1], want[1], **TOL_QD)
        q, qd = got
    assert contact > 0


def test_k3_tables(pen, lib_adroit):
    """K3's tables: each box kind's rows carry the 3 half-sizes, the servo
    and frictionloss sections are filled, the tendon block holds Jq's and
    Jv's nonzeros in compressed rows; K1's packer refuses the model."""
    env, *_ = pen
    m = env.model
    L = pkernel.read_layout(lib_adroit)
    with pytest.raises(NotImplementedError, match="K3"):
        pkernel.pack_tables(m, L)
    mf, mi = pkernel.pack_tables(m, L, ext=True)
    npair = mi[L["I_NPAIR"]]
    kinds = mi[L["I_PAIR"] : L["I_PAIR"] + L["PAIR_I"] * npair].reshape(-1, L["PAIR_I"])[:, 0]
    rows = mf[L["F_PAIR"] : L["F_PAIR"] + L["PAIR_F"] * npair].reshape(-1, L["PAIR_F"])
    assert [int((kinds == k).sum()) for k in (5, 1, 7, 8, 2)] == [2, 1, 59, 10, 51]
    for kind, slots in ((5, (1,)), (7, (11,)), (8, (1, 11))):
        for slot in slots:
            assert (rows[kinds == kind, slot : slot + 3] > 0).all()
    assert mi[L["I_HAS_GAINBIAS"]] == 1 and mi[L["I_HAS_FRIC"]] == 1
    np.testing.assert_array_equal(mf[L["F_FRIC"] : L["F_FRIC"] + m.nv], m.dof_frictionloss)
    nt, ti, tf = mi[L["I_NTEN"]], mi[L["I_TEN_I"]], mi[L["I_TEN_F"]]
    assert nt == 44 and ti == mi.size - (1 + 2 * (nt + 1) + 2 * int(np.count_nonzero(m.tendon_Jq)))
    qptr = mi[ti + 1 : ti + 2 + nt]
    qidx = mi[ti + 2 + nt : ti + 2 + nt + qptr[-1]]
    qval = mf[tf + 8 * nt : tf + 8 * nt + qptr[-1]]
    dense = np.zeros_like(m.tendon_Jq)
    for t in range(nt):
        dense[t, qidx[qptr[t] : qptr[t + 1]]] = qval[qptr[t] : qptr[t + 1]]
    np.testing.assert_array_equal(dense, m.tendon_Jq)
    np.testing.assert_array_equal(mf[tf : tf + 8 * nt].reshape(nt, 8).T, soa.tendon_params(m)[2])


def test_k3_wrapper_contract(pen):
    """On CPU tensors K3 runs the plain version with the link offsets; it
    checks the offsets' shape; K1 refuses Adroit's stages; the frame
    stepper of an env built with link offsets calls K3."""
    env, q, qd, delta = pen
    m = env.model
    q, qd, delta = (torch.as_tensor(x[:, :3].copy()) for x in (q, qd, delta))
    ctrl = torch.zeros(m.nu, 3)
    kernel = pkernel.PhysicsKernel("penalty", True)
    got = kernel(m, q, qd, ctrl, 1, link_delta=delta)
    want = soa.multistep(m, q, qd, ctrl, 1, link_delta=delta)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and kernel.launches == 0
    with pytest.raises(ValueError, match="link_delta"):
        kernel(m, q, qd, ctrl, 1, link_delta=delta[:, :2].contiguous())
    with pytest.raises(ValueError, match="K3"):
        pkernel.PhysicsKernel("penalty", False)(m, q, qd, ctrl, 1)
    calls = []
    real = pkernel.PhysicsKernel.__call__
    try:
        pkernel.PhysicsKernel.__call__ = lambda self, *a, **k: calls.append((self, k)) or real(
            self, *a, **k)
        env._frame_step(q.T, qd.T, ctrl.T, delta.T.reshape(3, m.nlink, 3))
    finally:
        pkernel.PhysicsKernel.__call__ = real
    assert len(calls) == 1 and calls[0][0] is pkernel.K3
    assert calls[0][1]["link_delta"].shape == (3 * m.nlink, 3)


@pytest.mark.cuda
def test_cuda_k3_matches_plain_on_pen():
    """K3 on the card in the Adroit class: B=250 states in which each
    contact kind touches, with their link offsets, one control step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = make("adroit_pen")
    m, rng, dev = env.model, np.random.default_rng(0), torch.device("cuda")
    q, qd, d = (torch.as_tensor(x, device=dev) for x in probe.kind_states(m, 50, rng))
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (m.nu, 250)), dtype=torch.float32, device=dev)
    kernel = pkernel.PhysicsKernel("penalty", True)
    got_q, got_qd = kernel(m, q, qd, ctrl, env.frame_skip, link_delta=d)
    torch.cuda.synchronize()
    want_q, want_qd = soa.multistep(m, q, qd, ctrl, env.frame_skip, link_delta=d)
    assert kernel.launches == 1
    # chip_smoke.py's tolerance for K3 on pen
    torch.testing.assert_close(got_q, want_q, rtol=0, atol=1e-4)
    torch.testing.assert_close(got_qd, want_qd, rtol=0, atol=1e-2)
