"""Kernel K4's warp design on the CPU: the emulated warp and the rows and
line-search picks of its warp-decomposed body.

``mjrl_tpu_torch/csrc/mj_warp_newton.h`` spreads one env's Newton substep
over the 32 lanes of a warp (``mj_warp.h``). ``mj_host.cpp`` builds that
same code with g++ under the emulated warp, in the Adroit size class
(``pkernel.size_flags(2)``), and these tests hold it: the emulated warp's
strided loop, its compaction (the warp scan that places each lane's rows)
and its ordered sum across chunk boundaries; the contact rows one
env-substep holds (``mj_ext_newton_rows_host``) against the plain
version's rows inside their margin (physics/soa_newton.py
``_contact_rows``), in the same order, with none, fewer than 32, more
than 32 (across the lanes of the scan) and more than a ``-DMJ_MAX_HELD=4``
build holds; and the line-search picks against the plain version's at
every iteration whose five costs are not tied.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs import make
from mjrl_tpu_torch.physics import pkernel, probe, soa, soa_newton
from mjrl_tpu_torch.physics.tables import pair_groups, points_per_pair

torch.set_num_threads(1)

# host build vs plain: the same f32 formulas, some products in another
# order (tests/test_torch_adroit_newton_kernel.py)
TOL_ROW = dict(rtol=1e-5, atol=1e-5)
TOL_D = dict(rtol=1e-4, atol=0)
# aref holds k d pos with k ~ 2.8e3 / s^2 (pen's solref): one f32 ulp of a
# contact depth near half a metre (6e-8 m) moves it by ~1.5e-4
TOL_AREF = dict(rtol=1e-5, atol=5e-4)
# a line search's costs are tied where the best beats the next by less
# than this share of the largest
TIE = 1e-4


def _library(directory, *extra):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS,
                                                 *pkernel.size_flags(2), *extra), directory)
    lib = ctypes.CDLL(str(path))
    lib.mj_ext_newton_rows_host.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 4
    lib.mj_ext_newton_rows_host.restype = ctypes.c_int
    lib.mj_warp_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
    lib.mj_warp_probe.restype = ctypes.c_int
    lib.mj_ext_newton_host.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
        ctypes.c_float]
    lib.mj_ext_newton_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return _library(tmp_path_factory.mktemp("k4warp"))


@pytest.fixture(scope="module")
def pen():
    """The pen env on the Newton solver and states with no held row (at
    reset), with a few (one per contact kind, ``probe.kind_states``) and
    with 35 (box_box's state with its root link 2 cm lower)."""
    env = make("adroit_pen", device="cpu", constraint_solver="newton")
    m = env.model
    rng = np.random.default_rng(0)
    state, _ = env.reset(2, torch.Generator().manual_seed(0))
    kq, kqd, kd = probe.kind_states(m, 1, rng)
    deep = kd[:, 3:4].copy()
    deep[deep != 0] -= 0.02
    q = np.concatenate([state.q.T.numpy(), kq, kq[:, 3:4]], axis=1)
    qd = np.concatenate([rng.uniform(-0.1, 0.1, (m.nv, 2)).astype(np.float32), kqd,
                         kqd[:, 3:4]], axis=1)
    delta = np.concatenate([np.zeros((3 * m.nlink, 2), np.float32), kd, deep], axis=1)
    return env, *(np.ascontiguousarray(x, np.float32) for x in (q, qd, delta))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 406])
def test_emulated_warp_loop_scan_and_sum(lib, n):
    """w.each visits every index once; the compaction gives each item with
    a count the slots before it, chunk after chunk of 32; w.sum adds in
    index order, bit for bit a sequential f32 sum."""
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 4, n).astype(np.int32)
    counts[::5] = 0
    values = rng.standard_normal(n).astype(np.float32) * 10.0 ** rng.integers(-4, 4, n)
    values = values.astype(np.float32)
    visits, offsets = np.zeros(max(n, 1), np.int32), np.zeros(max(n, 1), np.int32)
    out = np.zeros(1, np.float32)
    total = lib.mj_warp_probe(n, counts.ctypes.data, values.ctypes.data, visits.ctypes.data,
                              offsets.ctypes.data, out.ctypes.data)
    assert total == counts.sum()
    np.testing.assert_array_equal(visits[:n], 1)
    want = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32) if n else counts
    np.testing.assert_array_equal(offsets[:n], np.where(counts > 0, want, -1))
    s = np.float32(0.0)
    for v in values:
        s = np.float32(s + v)
    assert out[0] == s


def _plain_rows(model, q, qd, delta):
    """Per env, the plain version's contact rows inside their margin in
    narrow-phase order: (pair index, D, aref (k,), J {dof: (k,)})."""
    q, qd, delta = (torch.as_tensor(x) for x in (q, qd, delta))
    pos, quat = soa._fk(model, q, delta)
    cdof = soa._cdofs(model, pos, quat, pos[0])
    cands = soa._contact_candidates(model, pos, quat)
    rows = soa_newton._contact_rows(model, pos, cdof, qd, cands)
    pair, first = [], 0  # each candidate's pair, in K1's pair order
    for kind, tab in pair_groups(model).kinds:
        pair += [first + p for p in range(len(tab["gi"])) for _ in range(points_per_pair(kind))]
        first += len(tab["gi"])
    margin = [np.float32(soa_newton.contact_params(model, c.gi, c.gj, c.mu)[2]) for c in cands]
    out = []
    for e in range(q.shape[1]):
        held = [k for k, c in enumerate(cands) if float(-c.depth[0, e] - margin[k]) < 0.0]
        out.append([(pair[k], float(rows[k].D[0, e]), rows[k].aref[:, e].numpy(),
                     {j: J[:, e].numpy() for j, J in rows[k].J.items()}) for k in held])
    return out


def _kernel_rows(lib, model, q, qd, delta):
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    mf, mi = pkernel.pack_tables(model, L, ext=True)
    nf, ni = pkernel.pack_newton_tables(model, L, NL, ext=True)
    H, F, C = NL["MAX_HELD"], NL["MAX_FACET"], NL["MAX_CHAIN"]
    out = []
    for e in range(q.shape[1]):
        pair, D = np.zeros(H, np.int32), np.zeros(H, np.float32)
        aref, J = np.zeros((H, F), np.float32), np.zeros((H, F, C), np.float32)
        n = lib.mj_ext_newton_rows_host(*(a.ctypes.data for a in (mf, mi, nf, ni, q, qd, delta)),
                                        q.shape[1], e, *(a.ctypes.data for a in (pair, D, aref, J)))
        out.append((n, pair, D, aref, J))
    return out, ni, NL


@pytest.mark.parametrize("case", ["none", "under_32", "over_32", "over_cap"])
def test_held_rows_are_the_plain_rows_in_margin_in_order(pen, lib, tmp_path, case):
    """The rows of one env-substep against the plain version's rows inside
    their margin: the same count, pair indices, D, aref and J (over the
    pair's chain; the plain J is 0 on every other dof), in the same order.
    ``over_cap``: a build holding 4 rows counts them all and holds the
    first 4."""
    env, q, qd, delta = pen
    m = env.model
    cols = {"none": [0, 1], "under_32": [2, 3, 4, 5, 6], "over_32": [7], "over_cap": [2, 3, 5]}
    c = cols[case]
    q, qd, delta = (np.ascontiguousarray(x[:, c]) for x in (q, qd, delta))
    build = _library(tmp_path, "-DMJ_MAX_HELD=4") if case == "over_cap" else lib
    got, ni, NL = _kernel_rows(build, m, q, qd, delta)
    want = _plain_rows(m, q, qd, delta)
    counts = [len(w) for w in want]
    assert [g[0] for g in got] == counts
    bounds = {"none": (0, 0), "under_32": (1, 31), "over_32": (33, NL["MAX_HELD"]),
              "over_cap": (NL["MAX_HELD"] + 1, 1000)}[case]
    assert all(bounds[0] <= n <= bounds[1] for n in counts), counts
    for (n, pair, D, aref, J), rows in zip(got, want):
        for r, (p, d, a, Jp) in enumerate(rows[: NL["MAX_HELD"]]):
            assert pair[r] == p
            np.testing.assert_allclose(D[r], d, **TOL_D)
            k = len(a)
            o = NL["N_I_PAIR"] + NL["NPAIR_I"] * p
            assert ni[o] == k
            chain = ni[o + 2 : o + 2 + ni[o + 1]]
            np.testing.assert_allclose(aref[r, :k], a, **TOL_AREF)
            for b, j in enumerate(chain):
                np.testing.assert_allclose(J[r, :k, b], Jp[j], **TOL_ROW)
            for j in set(Jp) - set(chain.tolist()):
                assert not Jp[j].any()


def test_picks_match_plain_where_the_costs_are_not_tied(pen, lib):
    """One substep of 10 Newton iterations from the states with rows: at
    every iteration where the plain version's best of the five line-search
    costs beats the next by more than TIE of the largest, the host build
    picks the same fraction; the first iteration of every env with a row
    is such an iteration."""
    env, q, qd, delta = pen
    m = env.model
    q, qd, delta = (np.ascontiguousarray(x[:, 2:]) for x in (q, qd, delta))
    B, iters = q.shape[1], int(m.solver_iters)
    L, NL = pkernel.read_layout(lib), pkernel.read_newton_layout(lib)
    mf, mi = pkernel.pack_tables(m, L, ext=True)
    nf, ni = pkernel.pack_newton_tables(m, L, NL, ext=True)
    ctrl = np.ascontiguousarray(np.tile(np.asarray(env._act_mean, np.float32)[:, None], (1, B)))
    q_out, qd_out = np.empty_like(q), np.empty_like(qd)
    picks, over = np.full((iters, B), -1, np.int32), np.zeros(1, np.int32)
    assert lib.mj_ext_newton_host(*(a.ctypes.data for a in (mf, mi, nf, ni, q, qd, ctrl, delta,
                                                            q_out, qd_out, picks, over)),
                                  B, 1, iters, float(np.float32(m.dt))) == 0
    want, costs = [], []
    soa.substep(m, *map(torch.as_tensor, (q, qd, ctrl)), float(np.float32(m.dt)), picks=want,
                link_delta=torch.as_tensor(delta), costs=costs)
    want = torch.cat(want).numpy()
    costs = torch.stack(costs).numpy()  # (iters, 5, B)
    ordered = np.sort(costs, axis=1)
    untied = ordered[:, 1] - ordered[:, 0] > TIE * np.abs(costs).max(axis=1)
    assert untied[0].all()
    np.testing.assert_array_equal(picks[untied], want[untied])
    assert int(untied.sum()) > B
