"""Kernel K4's two tiers of held contact rows on the CPU, and its launch
shape.

``mjrl_tpu_torch/csrc/mj_warp_newton.h`` keeps an env-substep's first
``SHARED_HELD`` held rows in the warp's state (shared memory on the card)
and the rest, up to ``MAX_HELD``, in the env's slab (device memory on the
card, host memory in ``mj_host.cpp``'s build); every row is reached through
``mj_row``. A host build whose shared tier is forced down to 2 rows
(``-DMJ_SHARED_HELD=2``) must give the Adroit class's build (14) bit for
bit: ``q``, ``qd``, ``picks``, the overflow count and every counter but the
two of the slab, on pen, relocate, door and hammer states where each
contact kind touches (``probe.kind_states``: up to 50 rows, so that both
builds spill on some). The slab's counters (``spilled_rows``,
``spill_substeps``) of each build are what the plain version's held rows
imply. From the Adroit layout's bytes, K4's launch takes 4 envs a block
in one wave at B=512 and 8 in two waves at B=2048 on 132 SMs; the two
smaller classes (K2's) keep their layout.
"""

import ctypes
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, probe, soa

torch.set_num_threads(1)

TASKS = ("pen", "relocate", "door", "hammer")
SMALL_TIER = 2
# An H100 SM: 228 KB of shared memory, 1 KB of it reserved by each block;
# 2048 threads; 132 SMs on the card.
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES, SM_THREADS, SMS = 233472, 1024, 2048, 132
# The two smaller classes' shared bytes per warp before the tiers: kept.
SMALL_CLASS_BYTES = (25212, 29988)


def _library(directory, *flags):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS, *flags), directory)
    lib = ctypes.CDLL(str(path))
    lib.mj_ext_newton_stats_host.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [
        ctypes.c_float]
    lib.mj_ext_newton_stats_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The Adroit class's host build and the same with 2 rows in shared
    memory."""
    return (_library(tmp_path_factory.mktemp("k4tiers"), *pkernel.size_flags(2)),
            _library(tmp_path_factory.mktemp("k4small"), *pkernel.size_flags(2),
                     f"-DMJ_SHARED_HELD={SMALL_TIER}"))


def _ctrl(env, B):
    return np.tile(np.asarray(env._act_mean)[:, None], (1, B)).astype(np.float32)


def _run(lib, env, q, qd, delta, n_sub):
    """K4's host build with the stats buffer: ``(q, qd, picks, overflow,
    stats)``."""
    m = env.model
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    tables = (*pkernel.pack_tables(m, L, ext=True),
              *pkernel.pack_newton_tables(m, L, NL, ext=True))
    B = q.shape[1]
    out = [np.empty_like(q), np.empty_like(qd),
           np.full((n_sub * m.solver_iters, B), -1, np.int32), np.zeros(1, np.int32),
           np.zeros(len(pkernel.STAT_NAMES), np.int64)]
    ptr = [a.ctypes.data for a in (*tables, q, qd, _ctrl(env, B), delta, *out)]
    dt = float(np.float32(m.dt / m.n_substeps))
    assert lib.mj_ext_newton_stats_host(*ptr, B, n_sub, m.solver_iters, dt) == 0
    return out


def _slab_counts(held, shared, most):
    """The slab's counters that the rows held per env imply."""
    spilled = np.clip(np.minimum(held, most) - shared, 0, None)
    return [int(spilled.sum()), int((spilled > 0).sum())]


@pytest.mark.parametrize("task", TASKS)
def test_slab_changes_no_bit(libs, task):
    """One control step (5 substeps of 10 Newton iterations) from the
    task's kind states with their link offsets, on the build with 14 rows
    in shared memory and on the one with 2: the same bits of q, qd and
    picks, the same overflow count and counters but the slab's; over one
    substep, each build's slab counters are the plain version's held rows
    past its shared tier."""
    default, small = libs
    assert [pkernel.read_newton_layout(lib)["SHARED_HELD"] for lib in libs] == [
        pkernel.SHARED_HELD_CLASSES[2], SMALL_TIER]
    env = make(f"adroit_{task}", device="cpu", constraint_solver="newton")
    m = env.model
    q, qd, delta = probe.kind_states(m, 1, np.random.default_rng(3))
    spill = [pkernel.STAT_NAMES.index(n) for n in ("spilled_rows", "spill_substeps")]
    rest = [k for k in range(len(pkernel.STAT_NAMES)) if k not in spill]
    n_sub = env.frame_skip * m.n_substeps
    a, b = (_run(lib, env, q, qd, delta, n_sub) for lib in libs)
    for x, y in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[4][rest], b[4][rest])
    assert a[3][0] == 0 and b[4][spill[1]] > 0
    held = []
    soa.multistep(m, *map(torch.as_tensor, (q, qd, _ctrl(env, q.shape[1]))), 1, held=held,
                  link_delta=torch.as_tensor(delta))
    first = held[0].numpy()
    for lib, shared in ((default, pkernel.SHARED_HELD_CLASSES[2]), (small, SMALL_TIER)):
        stats = _run(lib, env, q, qd, delta, 1)[4]
        assert stats[spill].tolist() == _slab_counts(first, shared, pkernel.HELD_CLASSES[2])
        assert stats[pkernel.STAT_NAMES.index("held_rows")] == int(first.sum())


def _per_sm(bytes_per_warp, warps):
    """Blocks of ``warps`` envs an H100 SM holds by shared memory and
    threads."""
    block = warps * bytes_per_warp + BLOCK_RESERVED_BYTES
    return min(SM_SHARED_BYTES // block, SM_THREADS // (32 * warps))


@pytest.mark.parametrize("batch, warps, blocks, waves", [
    (512, 4, 128, 1),    # pen.newton: two blocks an SM; one wave (3 a block: 171 in 2)
    (2048, 8, 256, 2),   # relocate.newton: one block an SM; two waves (3 a block: 683 in 6)
    (256, 2, 128, 1),
])
def test_k4_launch_choice(libs, monkeypatch, batch, warps, blocks, waves):
    """K4's default warps a block (K1's rule: the fewest that spread the
    batch over 132 SMs in one wave, up to the 8 a block holds in the
    Adroit class) and the waves of such a launch, from the layout's shared
    bytes per warp."""
    wl = pkernel.read_warp_layout(libs[0])
    assert wl["MAX_WARPS"] == 8 and 8 * wl["BYTES"] <= pkernel.SHARED_BYTES_PER_BLOCK
    kernel = pkernel.PhysicsKernel("newton", True)
    monkeypatch.setattr(kernel, "build", lambda size: SimpleNamespace(warp_layout=wl))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=SMS))
    got = kernel.launch_warps(2, batch, torch.device("cpu"))
    assert got == warps
    per_sm = _per_sm(wl["BYTES"], got)
    assert pkernel.PhysicsKernel.launch_waves(batch, got, SMS, per_sm) == (blocks, waves)


@pytest.mark.parametrize("size", [0, 1])
def test_smaller_classes_keep_their_layout(tmp_path, monkeypatch, size):
    """The small and humanoid classes (K2's, and K4's for a model that fits
    them) keep every held row in shared memory: the same bytes per warp and
    warps per block as before the tiers, and no slab."""
    lib = _library(tmp_path, *pkernel.size_flags(size))
    wl, NL = pkernel.read_warp_layout(lib), pkernel.read_newton_layout(lib)
    assert (wl["BYTES"], wl["MAX_WARPS"]) == (SMALL_CLASS_BYTES[size], 4)
    assert NL["SHARED_HELD"] == NL["MAX_HELD"] == pkernel.HELD_CLASSES[size]
    kernel = pkernel.PhysicsKernel("newton", True)
    monkeypatch.setattr(kernel, "build", lambda size: SimpleNamespace(newton_layout=NL))
    assert kernel.slab(size, 512, torch.device("cpu")) == 0
