"""Kernel K1's arithmetic on the CPU, and the wrapper's contract.

``mjrl_tpu_torch/csrc/mj_substep.h`` is compiled with g++ (no CUDA, no
torch headers) into a ctypes library, and its control steps are held
against the plain PyTorch version (physics/soa.py) on the same inputs.
This catches math and table-layout faults before the kernel ever runs on
a card. The tests marked ``cuda`` launch the real kernel and run only
where a card is present.
"""

import copy
import ctypes
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, soa

torch.set_num_threads(1)

B = 8


@pytest.fixture(scope="module")
def env():
    return make("ant", horizon=8)


@pytest.fixture(scope="module")
def host(env, tmp_path_factory):
    """The host build of the kernel body: ``run(q, qd, ctrl, n_frames)``
    on batch-last numpy arrays."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS),
                                 tmp_path_factory.mktemp("k1_host"))
    lib = ctypes.CDLL(str(path))
    lib.mj_multistep_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mj_multistep_host.restype = ctypes.c_int
    model = env.model
    mf, mi = pkernel.pack_tables(model, pkernel.read_layout(lib))

    def run(q, qd, ctrl, n_frames):
        q, qd, ctrl = (np.ascontiguousarray(x, np.float32) for x in (q, qd, ctrl))
        q_out, qd_out = np.empty_like(q), np.empty_like(qd)
        ptr = [a.ctypes.data for a in (mf, mi, q, qd, ctrl, q_out, qd_out)]
        dt = float(np.float32(model.dt / model.n_substeps))
        assert lib.mj_multistep_host(*ptr, q.shape[1], n_frames * model.n_substeps, dt) == 0
        return q_out, qd_out

    return run


@pytest.fixture(scope="module")
def warm(env, host):
    """B envs after 4 control steps of random actions (warmed through the
    host build, which is fast), and the next control."""
    rng = np.random.default_rng(0)
    state, _ = env.reset(B, torch.Generator().manual_seed(0))
    q, qd = state.q.T.numpy(), state.qd.T.numpy()
    for _ in range(4):
        q, qd = host(q, qd, rng.uniform(-1, 1, (8, B)), env.frame_skip)
    return q, qd, rng.uniform(-1, 1, (8, B)).astype(np.float32)


def _plain(env, q, qd, ctrl, n_frames):
    out = soa.multistep(env.model, torch.as_tensor(q), torch.as_tensor(qd), torch.as_tensor(ctrl), n_frames)
    return [x.numpy() for x in out]


# host build vs plain, one control step (5 frames x 4 substeps) from the
# same state: the same f32 formulas, a few sums in another order
TOL_Q = dict(rtol=1e-5, atol=1e-5)
TOL_QD = dict(rtol=1e-4, atol=1e-4)


def test_layout_is_the_packers(env, host, tmp_path):
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS), tmp_path)
    L = pkernel.read_layout(ctypes.CDLL(str(path)))
    offsets = sorted(v for k, v in L.items() if k.startswith("F_"))
    assert len(set(offsets)) == len(offsets)  # no two sections share an offset
    mf, mi = pkernel.pack_tables(env.model, L)
    assert mi[L["I_NLINK"]] == 13 and mi[L["I_NV"]] == 14 and mi[L["I_NPAIR"]] == 13
    assert mf.size == L["F_PAIR"] + 13 * L["PAIR_F"]


def test_kernel_body_matches_plain_one_step(env, host, warm):
    q, qd, ctrl = warm
    got_q, got_qd = host(q, qd, ctrl, env.frame_skip)
    want_q, want_qd = _plain(env, q, qd, ctrl, env.frame_skip)
    np.testing.assert_allclose(got_q, want_q, **TOL_Q)
    np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)


def test_kernel_body_matches_plain_along_a_chain(env, host, warm):
    """Ten chained control steps of the host build, each held against the
    plain version from the same state (free-running trajectories of two
    f32 engines diverge chaotically through the penalty contacts)."""
    q, qd, _ = warm
    rng = np.random.default_rng(1)
    for _ in range(10):
        ctrl = rng.uniform(-1, 1, (8, B)).astype(np.float32)
        got_q, got_qd = host(q, qd, ctrl, env.frame_skip)
        want_q, want_qd = _plain(env, q, qd, ctrl, env.frame_skip)
        np.testing.assert_allclose(got_q, want_q, **TOL_Q)
        np.testing.assert_allclose(got_qd, want_qd, **TOL_QD)
        q, qd = got_q, got_qd


def test_kernel_body_keeps_nonfinite_states(env, host, warm):
    q, qd, ctrl = (x.copy() for x in warm)
    qd[3, 2] = np.nan
    got_q, got_qd = host(q, qd, ctrl, env.frame_skip)
    want_q, want_qd = _plain(env, q, qd, ctrl, env.frame_skip)
    np.testing.assert_array_equal(np.isfinite(got_qd), np.isfinite(want_qd))
    np.testing.assert_array_equal(np.isfinite(got_q), np.isfinite(want_q))
    assert not np.isfinite(got_qd[:, 2]).all() and np.isfinite(got_qd[:, [0, 1, 3]]).all()


def test_pack_tables_refuses_unsupported(env):
    model = copy.copy(env.model)
    model.__dict__.pop("_k1_tables", None)
    model.constraint_solver = "newton"
    with pytest.raises(NotImplementedError):
        pkernel.pack_tables(model, {})


def test_wrapper_checks_inputs_and_runs_plain_on_cpu(env):
    m = env.model
    q = torch.as_tensor(np.tile(m.default_qpos[:, None], (1, 3)))
    qd, ctrl = torch.zeros(m.nv, 3), torch.zeros(m.nu, 3)
    kernel = pkernel.MultistepKernel()
    with pytest.raises(TypeError):
        kernel(m, q.double(), qd, ctrl)
    with pytest.raises(ValueError):
        kernel(m, q, qd[:, :2], ctrl)
    with pytest.raises(ValueError):
        kernel(m, q, qd, ctrl.T.contiguous().T)
    got = kernel(m, q, qd, ctrl, 1)
    want = soa.multistep(m, q, qd, ctrl, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel.launches == 0  # the CPU path never launches


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(env):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    state, _ = env.reset(1000, torch.Generator().manual_seed(0))
    dev = torch.device("cuda")
    q, qd = state.q.T.contiguous().to(dev), state.qd.T.contiguous().to(dev)
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (8, 1000)), dtype=torch.float32, device=dev)
    kernel = pkernel.MultistepKernel()
    got_q, got_qd = kernel(env.model, q, qd, ctrl, env.frame_skip)
    torch.cuda.synchronize()
    want_q, want_qd = soa.multistep(env.model, q, qd, ctrl, env.frame_skip)
    assert kernel.launches == 1
    # chip_smoke.py's tolerance: FMA contraction, grown through contacts
    torch.testing.assert_close(got_q, want_q, rtol=0, atol=1e-3)
    torch.testing.assert_close(got_qd, want_qd, rtol=0, atol=5e-2)
