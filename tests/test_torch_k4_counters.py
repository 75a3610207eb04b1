"""Kernel K4's traced counters on the CPU: the stats buffer of its host
build and the wrapper's launch shape.

``mjrl_tpu_torch/csrc/mj_host.cpp``'s ``mj_ext_newton_stats_host`` runs
K4's warp body (``mj_warp_newton.h``) under the emulated warp with the
stats buffer the card's kernel adds to while tracing is on
(``pkernel.STAT_NAMES``: held rows, their largest, H's chain terms, Newton
iterations, line searches cut, at 0 and near ties). On relocate's states
(``probe.kind_states``: the ball on the table and in the hand, its link
offsets nonzero, one joint pushed past its limit) these tests hold: the
chain terms against the held rows' chains (``mj_ext_newton_rows_host``)
and the limit rows; the line-search counts against the ``picks`` output
of the same launch; the same bits of ``q``, ``qd`` and ``picks`` with the
buffer null and non-null; the wrapper's check folding the buffer into the
tracer's counters in its one read; and ``launch_waves`` / ``count_waves``
with a stubbed SM count and occupancy. Off, nothing is counted.
"""

import ctypes
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, probe
from mjrl_tpu_torch.utils import trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS,
                                                 *pkernel.size_flags(2)),
                                 tmp_path_factory.mktemp("k4stats"))
    lib = ctypes.CDLL(str(path))
    lib.mj_ext_newton_stats_host.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [
        ctypes.c_float]
    lib.mj_ext_newton_stats_host.restype = ctypes.c_int
    lib.mj_ext_newton_rows_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 4
    lib.mj_ext_newton_rows_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def relocate(lib):
    """Relocate on the Newton solver, its packed tables, and one state per
    contact kind (the ball on the table, the ball in the hand, ...) with
    their link offsets; the first state's first limited joint is 0.05 past
    its upper end, so that a limit row is held."""
    env = make("adroit_relocate", device="cpu", constraint_solver="newton")
    m = env.model
    q, qd, delta = probe.kind_states(m, 1, np.random.default_rng(4))
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    tables = (*pkernel.pack_tables(m, L, ext=True),
              *pkernel.pack_newton_tables(m, L, NL, ext=True))
    ni = tables[3]
    qadr = int(ni[NL["N_I_LIM"]])
    hi = float(tables[2][NL["N_F_LIM"] + NL["IMP_F"] + 1])
    q[qadr, 0] = np.float32(hi + 0.05)
    assert (delta != 0).any() and q.shape[1] >= 4
    return env, tables, NL, q, qd, delta


def _run(lib, env, tables, q, qd, delta, n_sub, counting):
    """K4's host build: ``(q, qd, picks, overflow, stats or None)``."""
    m = env.model
    B = q.shape[1]
    ctrl = np.tile(np.asarray(env._act_mean)[:, None], (1, B)).astype(np.float32)
    out = [np.empty_like(q), np.empty_like(qd),
           np.full((n_sub * m.solver_iters, B), -1, np.int32), np.zeros(1, np.int32)]
    stats = np.zeros(len(pkernel.STAT_NAMES), np.int64) if counting else None
    ptr = [a.ctypes.data for a in (*tables, q, qd, ctrl, delta, *out)]
    dt = float(np.float32(m.dt / m.n_substeps))
    assert lib.mj_ext_newton_stats_host(*ptr, None if stats is None else stats.ctypes.data, B,
                                        n_sub, m.solver_iters, dt) == 0
    return (*out, stats)


def _stat(stats, name):
    return int(stats[pkernel.STAT_NAMES.index(name)])


def test_stats_layout_is_the_builds(lib):
    assert pkernel.read_newton_layout(lib)["N_STATS"] == len(pkernel.STAT_NAMES) == 9


def test_chain_terms_are_the_held_rows_chains(lib, relocate):
    """One substep: the held rows' sum and largest are the rows each env
    holds, and the chain terms the sum over its held contact rows of n + n
    (n + 1) / 2 for a chain of n dofs, plus one per limit row."""
    env, tables, NL, q, qd, delta = relocate
    mf, mi, nf, ni = tables
    B, held_max = q.shape[1], NL["MAX_HELD"]
    stats = _run(lib, env, tables, q, qd, delta, 1, True)[4]
    rows = probe.held_rows(env.model, torch.as_tensor(q), torch.as_tensor(delta))
    pair = np.zeros(held_max, np.int32)
    scratch = [np.zeros(held_max, np.float32), np.zeros(held_max * 6, np.float32),
               np.zeros(held_max * 6 * NL["MAX_CHAIN"], np.float32)]
    held, terms = [], 0
    for env_i in range(B):
        n = lib.mj_ext_newton_rows_host(*(a.ctypes.data for a in (mf, mi, nf, ni, q, qd, delta)),
                                        B, env_i, pair.ctypes.data,
                                        *(a.ctypes.data for a in scratch))
        held.append(n)
        for p in pair[:min(n, held_max)]:
            c = int(ni[NL["N_I_PAIR"] + NL["NPAIR_I"] * p + 1])
            terms += c + c * (c + 1) // 2
    terms += int(rows["limits"].sum())
    assert held == rows["contacts"].tolist() and rows["limits"][0] >= 1
    assert _stat(stats, "held_rows") == sum(held) > 0
    assert _stat(stats, "held_rows_max") == max(held)
    assert _stat(stats, "chain_terms") == terms > sum(held)


def test_line_search_counts_are_the_picks(lib, relocate):
    """A control step (5 substeps of 10 iterations): the iterations, the
    line searches that took a fraction under 1 and those that took 0 are
    what ``picks`` holds for the same launch; near ties are some of the
    iterations."""
    env, tables, _, q, qd, delta = relocate
    _, _, picks, over, stats = _run(lib, env, tables, q, qd, delta, env.frame_skip, True)
    assert over[0] == 0 and (picks >= 0).all()
    assert _stat(stats, "newton_iters") == picks.size
    assert _stat(stats, "ls_cut") == int((picks != 0).sum()) > 0
    assert _stat(stats, "ls_zero") == int((picks == 4).sum())
    assert 0 <= _stat(stats, "ls_near_ties") <= _stat(stats, "newton_iters")


def test_stats_change_no_bit(lib, relocate):
    """Three chained control steps with the stats buffer null and non-null:
    ``q``, ``qd``, ``picks`` and the overflow count bit for bit."""
    env, tables, _, q, qd, delta = relocate
    a_q, a_qd, b_q, b_qd = q, qd, q, qd
    for _ in range(3):
        off = _run(lib, env, tables, a_q, a_qd, delta, env.frame_skip, False)
        on = _run(lib, env, tables, b_q, b_qd, delta, env.frame_skip, True)
        for x, y in zip(off[:4], on[:4]):
            np.testing.assert_array_equal(x, y)
        assert off[4] is None and _stat(on[4], "newton_iters") > 0
        a_q, a_qd, b_q, b_qd = off[0], off[1], on[0], on[1]


def test_check_folds_the_stats_in_one_read(lib, relocate):
    """The wrapper on the CPU: traced, ``stats()`` hands out its buffer,
    which the host build fills; ``check()`` reads it with the overflow
    count in one ``K4.check`` read into the counters (the largest held
    rows as a peak) and clears it. Off, ``stats()`` is null and ``check()``
    reads the overflow count alone and counts nothing."""
    env, tables, _, q, qd, delta = relocate
    kernel, dev = pkernel.PhysicsKernel("newton", True), torch.device("cpu")
    assert kernel.stats(dev) == 0
    kernel.check()
    trace.enable()
    ptr = kernel.stats(dev)
    assert ptr != 0
    m = env.model
    B = q.shape[1]
    ctrl = np.tile(np.asarray(env._act_mean)[:, None], (1, B)).astype(np.float32)
    out = [np.empty_like(q), np.empty_like(qd), np.zeros(1, np.int32)]
    args = [a.ctypes.data for a in (*tables, q, qd, ctrl, delta, out[0], out[1])]
    lib.mj_ext_newton_stats_host(*args, None, out[2].ctypes.data, ptr, B, 1, m.solver_iters,
                                 float(np.float32(m.dt / m.n_substeps)))
    want = kernel.counters(dev)[1].tolist()
    kernel.check()
    got = trace.take()
    assert got["reads"]["K4.check"]["count"] == 1
    for name, v in zip(pkernel.STAT_NAMES, want):
        if name == "held_rows_max":
            assert got["peaks"]["K4.held_rows_max"] == v > 0
        else:
            assert got["counters"][f"K4.{name}"] == v
    assert got["counters"]["K4.newton_iters"] == B * m.solver_iters
    assert kernel.counters(dev)[1].eq(0).all()
    trace.disable()
    kernel.check()
    assert trace.take()["counters"] == {}


@pytest.mark.parametrize("batch, warps, sms, per_sm, blocks, waves", [
    (512, 3, 132, 1, 171, 2),     # pen.newton: the second wave 30% full
    (2048, 3, 132, 1, 683, 6),    # relocate.newton: 5.2 waves' worth
    (256, 3, 132, 1, 86, 1),
    (396, 3, 132, 1, 132, 1),
    (397, 3, 132, 1, 133, 2),
    (2048, 3, 132, 2, 683, 3),
    (1, 3, 132, 1, 1, 1),
])
def test_launch_waves(batch, warps, sms, per_sm, blocks, waves):
    assert pkernel.PhysicsKernel.launch_waves(batch, warps, sms, per_sm) == (blocks, waves)


def test_count_waves_with_a_stubbed_card(monkeypatch):
    """Traced, a launch counts itself, its blocks and its waves from the
    SM count and the build's occupancy (asked once per size and warps);
    off, it counts nothing and asks nothing."""
    kernel = pkernel.PhysicsKernel("newton", True)
    asked = []
    monkeypatch.setattr(kernel, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernel, "build", lambda size: SimpleNamespace(lib=SimpleNamespace(
        mj_ext_newton_occupancy=lambda w: asked.append(w) or 1)))
    dev = torch.device("cpu")
    kernel.count_waves(2, 2048, 3, dev)
    assert asked == [] and trace.take()["counters"] == {}
    trace.enable()
    for _ in range(2):
        kernel.count_waves(2, 2048, 3, dev)
    kernel.count_waves(2, 512, 3, dev)
    got = trace.take()["counters"]
    assert got == {"K4.launches": 3, "K4.blocks": 2 * 683 + 171, "K4.waves": 2 * 6 + 2}
    assert asked == [3]


@pytest.mark.cuda
def test_cuda_k4_stats_change_no_bit_on_relocate():
    """K4 on the card at relocate's batch (2048 of its contact states with
    their link offsets), one control step with tracing off and on: the same
    bits; traced, the counters of ``STAT_NAMES``, the line searches' cuts
    and zeros as ``picks`` reads them, the rows held in the slab at most
    the held rows past the 14 in shared memory, and 256 blocks in 2 waves
    on a 132-SM card that holds one block of 8 envs an SM, in one read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = make("adroit_relocate", constraint_solver="newton")
    m, rng, dev = env.model, np.random.default_rng(0), torch.device("cuda")
    q, qd, d = probe.kind_states(m, 40, rng)
    cols = np.arange(2048) % q.shape[1]
    q, qd, d = (torch.as_tensor(np.ascontiguousarray(x[:, cols]), device=dev) for x in (q, qd, d))
    act = torch.as_tensor(rng.uniform(-1, 1, (2048, m.nu)), dtype=torch.float32, device=dev)
    ctrl = env._scaled_ctrl(act).T.contiguous()
    kernel = pkernel.PhysicsKernel("newton", True)
    picks = torch.full((env.frame_skip * m.solver_iters, 2048), -1, dtype=torch.int32,
                       device=dev)
    off = kernel(m, q, qd, ctrl, env.frame_skip, link_delta=d, picks=picks)
    kernel.check()
    trace.enable()
    on = kernel(m, q, qd, ctrl, env.frame_skip, link_delta=d)
    kernel.check()
    got = trace.take()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    c, p = got["counters"], picks.cpu()
    assert c["K4.newton_iters"] == p.numel()
    assert c["K4.ls_cut"] == int((p != 0).sum()) and c["K4.ls_zero"] == int((p == 4).sum())
    assert c["K4.chain_terms"] > c["K4.held_rows"] > 0 and c["K4.ls_near_ties"] >= 0
    assert 0 < c["K4.spill_substeps"] <= c["K4.spilled_rows"] < c["K4.held_rows"]
    assert got["reads"]["K4.check"]["count"] == 1
    if kernel.sm_count(dev) == 132 and kernel.occupancy(2, 8) == 1:
        assert (c["K4.launches"], c["K4.blocks"], c["K4.waves"]) == (1, 256, 2)
