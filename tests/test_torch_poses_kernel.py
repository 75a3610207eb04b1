"""The pose kernel's arithmetic on the CPU, the env's dispatch, and its symbol.

``mjrl_tpu_torch/csrc/mj_poses.h`` (every link's world pose and every
site's world position, one warp per env) is compiled with g++ (no CUDA)
into a ctypes library through ``mj_host.cpp``'s ``mj_poses_host``, in the
Adroit size class (``pkernel.size_flags(2)``), and held against the plain
version (physics/engine.py ``forward_kinematics`` + ``site_positions``) on
pen, relocate and door with random joint angles and link offsets, with
``q`` and the offsets given batch-first and as transposed views of
batch-last arrays (the env's ``q`` after a control step). The tests marked
``cuda`` launch the real kernel through the Adroit env and run only where
a card is present.
"""

import ctypes
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.envs.adroit import adroit_model
from mjrl_tpu_torch.physics import pkernel
from mjrl_tpu_torch.physics.engine import forward_kinematics, site_positions
from mjrl_tpu_torch.physics.model import HINGE, SLIDE
from mjrl_tpu_torch.utils import trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16
# the same f32 formulas link by link; the sum of a chain of 8 levels may
# round differently in the last bits
TOL = dict(rtol=0.0, atol=2e-6)
SEEDS = {"pen": 1, "relocate": 2, "door": 3}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS,
                                                 *pkernel.size_flags(2)),
                                 tmp_path_factory.mktemp("poses_host"))
    lib = ctypes.CDLL(str(path))
    lib.mj_poses_host.argtypes = pkernel.argtypes(pkernel.POSES_PARAMS[:-1])  # no stream
    lib.mj_poses_host.restype = ctypes.c_int
    return lib


def random_state(model, rng):
    """``(q (B, nq), link_delta (B, nlink, 3))``: each hinge and slide in
    its range (unlimited ones in [-1, 1]) and offsets of a few cm on every
    link."""
    q = np.tile(np.asarray(model.default_qpos, np.float32), (B, 1))
    for i, t in enumerate(model.link_jnt_type):
        if t in (HINGE, SLIDE):
            lo, hi = model.jnt_range[i] if model.jnt_limited[i] > 0 else (-1.0, 1.0)
            q[:, model.link_qadr[i]] = rng.uniform(lo, hi, B)
    delta = rng.normal(0.0, 0.03, (B, model.nlink, 3)).astype(np.float32)
    return q, delta


def host_poses(lib, model, q, delta=None):
    """The host build's outputs for numpy ``q`` (B, nq) and ``delta`` (B,
    nlink, 3) or None, any strides."""
    L = pkernel.read_layout(lib)
    mf, mi = pkernel.pack_tables(model, L, ext=True)
    site_pos, site_link = pkernel.pack_site_tables(model)
    nl, ns = model.nlink, len(model.site_link)
    pos, quat, sites = (np.empty((B, nl, 3), np.float32), np.empty((B, nl, 4), np.float32),
                        np.empty((B, ns, 3), np.float32))
    elems = lambda a: [s // a.itemsize for s in a.strides]  # noqa: E731
    d = (None, 0, 0, 0) if delta is None else (delta.ctypes.data, *elems(delta))
    assert lib.mj_poses_host(mf.ctypes.data, mi.ctypes.data, site_pos.ctypes.data,
                             site_link.ctypes.data, ns, q.ctypes.data, *elems(q), *d,
                             pos.ctypes.data, quat.ctypes.data, sites.ctypes.data, B) == 0
    return pos, quat, sites


@pytest.mark.parametrize("layout", ["batch_first", "transposed"])
@pytest.mark.parametrize("task", ["pen", "relocate", "door"])
def test_host_poses_match_plain(lib, task, layout):
    model = adroit_model(task, "newton")
    q, delta = random_state(model, np.random.default_rng(SEEDS[task]))
    if layout == "transposed":  # views of batch-last arrays, as after a control step
        q_in = np.ascontiguousarray(q.T).T
        delta_in = np.ascontiguousarray(delta.reshape(B, -1).T).T.reshape(B, model.nlink, 3)
        assert not q_in.flags.c_contiguous and not delta_in.flags.c_contiguous
    else:
        q_in, delta_in = q, delta
    pos, quat, sites = host_poses(lib, model, q_in, delta_in)
    ref_pos, ref_quat = forward_kinematics(model, torch.from_numpy(q), torch.from_numpy(delta))
    ref_sites = site_positions(model, ref_pos, ref_quat)
    np.testing.assert_allclose(pos, ref_pos.numpy(), **TOL)
    np.testing.assert_allclose(quat, ref_quat.numpy(), **TOL)
    np.testing.assert_allclose(sites, ref_sites.numpy(), **TOL)
    world = np.asarray(model.site_link) < 0
    np.testing.assert_array_equal(sites[:, world], ref_sites.numpy()[:, world])
    np.testing.assert_array_equal(sites[:, world],
                                  np.broadcast_to(model.site_pos[world], sites[:, world].shape))


def test_host_poses_without_offsets(lib):
    """A null ``delta``: the poses without link offsets."""
    model = adroit_model("pen", "newton")
    q, _ = random_state(model, np.random.default_rng(5))
    pos, quat, sites = host_poses(lib, model, q)
    ref_pos, ref_quat = forward_kinematics(model, torch.from_numpy(q))
    np.testing.assert_allclose(pos, ref_pos.numpy(), **TOL)
    np.testing.assert_allclose(quat, ref_quat.numpy(), **TOL)
    np.testing.assert_allclose(sites, site_positions(model, ref_pos, ref_quat).numpy(), **TOL)


def test_kernel_symbol_is_not_k3_or_k4s():
    """The benchmark's ``kernel_ms`` and ``K4_roofline`` match K3's and K4's
    device time by substring of ``gpubench/configs/pen.json``'s
    ``kernel_symbols``: the pose kernel's name must contain neither."""
    with open(os.path.join(ROOT, "gpubench", "configs", "pen.json")) as f:
        symbols = json.load(f)["kernel_symbols"]
    with open(os.path.join(ROOT, "mjrl_tpu_torch", "csrc", "mj_poses_kernel.cu")) as f:
        kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                             f.read())
    assert kernels == ["mj_poses_kernel"]
    for solver in ("newton", "penalty"):
        assert symbols[solver] not in kernels[0]
        assert symbols[solver] not in pkernel.POSES.name


def test_cpu_poses_take_the_plain_path():
    """On the CPU ``_poses`` is the plain version, through the wrapper's CPU
    path as K1-K4's, counted ``poses.plain``."""
    env = make("adroit_pen", device="cpu", constraint_solver="newton")
    assert env._poses_on_kernel
    st, _ = env.reset_from_angles(torch.tensor([0.3, -0.2]), torch.tensor([0.1, 0.5]))
    trace.reset()
    trace.enable()
    try:
        pos, quat, sites = env._poses(st)
        wrapped = pkernel.POSES(env.model, st.q, st.link_delta)
        counters = trace.take()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert counters == {"poses.plain": 2}
    ref_pos, ref_quat = forward_kinematics(env.model, st.q, st.link_delta)
    assert torch.equal(pos, ref_pos) and torch.equal(quat, ref_quat)
    assert torch.equal(sites, site_positions(env.model, ref_pos, ref_quat))
    for a, b in zip(wrapped, (pos, quat, sites)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no mj_poses path"):
        pkernel.POSES(env.model, st.q.to("meta"), st.link_delta.to("meta"))


def test_engine_path_poses_stay_plain(monkeypatch):
    """With ``use_soa=False`` the frame stepper runs the per-env engine and
    ``_poses`` the plain version, whatever the device: the wrapper is not
    called."""
    env = make("adroit_pen", device="cpu", constraint_solver="newton", use_soa=False)
    assert env._frame_step.path == "engine" and not env._poses_on_kernel

    def refuse(*args, **kwargs):
        raise AssertionError("the engine path called the pose kernel's wrapper")

    monkeypatch.setattr(pkernel.PoseKernel, "__call__", refuse)
    st, _ = env.reset_from_angles(torch.tensor([0.3]), torch.tensor([0.1]))
    pos, quat, sites = env._poses(st)
    ref_pos, ref_quat = forward_kinematics(env.model, st.q, st.link_delta)
    assert torch.equal(pos, ref_pos) and torch.equal(quat, ref_quat)
    assert torch.equal(sites, site_positions(env.model, ref_pos, ref_quat))


@pytest.mark.cuda
def test_cuda_pen_step_kernel_against_plain(monkeypatch):
    """Pen on K4 at B=64: a step on the kernel path and on the plain path
    from the same state and action give the same observation and reward
    within 1e-5; the kernel engages once per step (and per reset), the
    plain path never; and a sampler step dispatches at least 400 fewer
    ATen ops on the kernel path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from gpubench.harness import count_ops
    from mjrl_tpu_torch.models.gaussian_mlp import GaussianMLP
    from mjrl_tpu_torch.samplers import sample_episodes

    env = make("adroit_pen", constraint_solver="newton")
    assert env._poses_on_kernel and env._frame_step.path == "K4"
    gen = torch.Generator(device="cuda").manual_seed(0)
    st, _ = env.reset(64, gen)
    for _ in range(3):  # off the rest state
        st = env.step(st, torch.rand(64, env.model.nu, device="cuda", generator=gen) * 2 - 1)[0]
    action = torch.rand(64, env.model.nu, device="cuda", generator=gen) * 2 - 1
    trace.reset()
    trace.enable()
    try:
        _, obs_k, rew_k, _, _ = env.step(st, action)
        counters = trace.take()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert counters.get("poses.kernel") == 1 and "poses.plain" not in counters
    monkeypatch.setattr(env, "_poses_on_kernel", False)
    _, obs_p, rew_p, _, _ = env.step(st, action)
    torch.testing.assert_close(obs_k, obs_p, rtol=0.0, atol=1e-5)
    torch.testing.assert_close(rew_k, rew_p, rtol=0.0, atol=1e-5)

    policy = GaussianMLP(env.spec, hidden_sizes=(64, 64)).to("cuda")

    def per_step():
        """Traced: the ATen ops of a sampler step (2 steps less 1) and the
        counters of the two rollouts (3 and 2 calls of ``_poses``)."""
        def run(h):
            g = torch.Generator(device="cuda").manual_seed(1)
            return count_ops(lambda: sample_episodes(env, policy, 64, h, g))
        trace.enable()
        try:
            n = run(2) - run(1)
            return n, trace.take()["counters"]
        finally:
            trace.disable()
            trace.reset()

    plain, counters = per_step()
    assert counters.get("poses.plain") == 5 and "poses.kernel" not in counters, counters
    monkeypatch.setattr(env, "_poses_on_kernel", True)
    kernel, counters = per_step()
    assert counters.get("poses.kernel") == 5 and "poses.plain" not in counters, counters
    assert plain - kernel >= 400, (plain, kernel)
