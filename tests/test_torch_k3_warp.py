"""Kernel K3's warp design on the CPU: its contact stage in rounds, its body
against the plain version, and the packers' point caps.

``mjrl_tpu_torch/csrc/mj_warp_penalty.h`` with ``EXT`` on spreads one
env's penalty substep with Adroit's stages over the 32 lanes of a warp:
lanes take the contact pairs in rounds of 32, a warp scan places each
round's non-zero point wrenches (up to 16 a pair: box_box) in slots in
narrow-phase order, and each link's lane adds them to its running sum
before the next round, so a model may have any number of contact points.
``mj_host.cpp`` builds that same code with g++ under the emulated warp in
the Adroit size class (``pkernel.size_flags(2)``), and these tests hold
it: each link's wrench after the contact stage (``mj_ext_contacts_host``)
bit for bit against a sequential f32 sum, in point order, of every point's
wrench computed alone, on pen with no point in contact, fewer than 32
(``probe.kind_states``: link offsets lower the hand or the pen onto the
table or the floor so that box_plane and box_box touch) and more than 32
(the hand pressed into the table), and on hammer (671 points, more than
K1's 512 slots), door (760 points in 278 pairs, 9 rounds) and relocate
(the sphere kinds against the hand and the table, the fullest size class);
one control step of the body (``mj_ext_host``) against the plain version
(physics/soa.py) on all four with link offsets; and the packers: K3's
takes hammer and door, K1's still refuses a model over its slots. The test
marked ``cuda`` holds the kernel itself against the plain version on door
and relocate, where a card is present.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs.adroit import adroit_model
from mjrl_tpu_torch.physics import pkernel, probe, soa
from mjrl_tpu_torch.physics.tables import num_contact_candidates

torch.set_num_threads(1)

B = 4
# tests/test_torch_adroit_kernel.py's tolerances for K3's body against
# plain: the same f32 formulas, a few sums in another order
TOL_Q = dict(rtol=1e-5, atol=1e-5)
TOL_QD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The host build of the Adroit size class."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    path = pkernel.build_library("mj_host.cpp", ("g++", *pkernel.GXX_FLAGS,
                                                 *pkernel.size_flags(2)),
                                 tmp_path_factory.mktemp("k3warp"))
    lib = ctypes.CDLL(str(path))
    P = ctypes.c_void_p
    lib.mj_ext_host.argtypes = [P] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.mj_ext_host.restype = ctypes.c_int
    lib.mj_ext_contacts_host.argtypes = [P] * 5 + [ctypes.c_int] * 2 + [P] * 4
    lib.mj_ext_contacts_host.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def models():
    return {task: adroit_model(task) for task in ("pen", "hammer", "door", "relocate")}


def _layout(lib, fn):
    buf = (ctypes.c_int * len(pkernel.WARP_LAYOUT_NAMES))()
    assert getattr(lib, fn)(buf) == len(pkernel.WARP_LAYOUT_NAMES)
    return dict(zip(pkernel.WARP_LAYOUT_NAMES, buf))


def _in_contact(model, q, delta):
    pos, quat = soa._fk(model, torch.as_tensor(q), torch.as_tensor(delta))
    depth = torch.cat([c.depth for c in soa._contact_candidates(model, pos, quat)])
    return (depth > 0).sum(dim=0).numpy()


def _pressed_pens(model, n, rng, lo, hi):
    """``(q, qd, delta)`` of ``n`` pens whose hand (the root link with the
    most links below it) is lowered 16 to 22 cm into the table, their
    limited hinges drawn in range, each with ``lo`` to ``hi`` contact
    points at depth > 0."""
    draws = 64
    below = [sum(1 for j in range(model.nlink) if _root(model, j) == i) for i in range(model.nlink)]
    hand = int(np.argmax([below[i] if model.link_parent[i] < 0 else -1
                          for i in range(model.nlink)]))
    q = np.tile(np.asarray(model.default_qpos, np.float32)[:, None], (1, draws))
    for i in range(model.nlink):
        if model.link_jnt_type[i] == probe.HINGE and model.jnt_limited[i] > 0:
            q[model.link_qadr[i]] = rng.uniform(*model.jnt_range[i], draws)
    delta = np.zeros((3 * model.nlink, draws), np.float32)
    delta[3 * hand + 2] = rng.uniform(-0.22, -0.16, draws)
    touching = _in_contact(model, q, delta)
    keep = np.flatnonzero((touching >= lo) & (touching <= hi))[:n]
    assert keep.size == n, touching
    qd = rng.uniform(-0.1, 0.1, (model.nv, n)).astype(np.float32)
    return np.ascontiguousarray(q[:, keep]), qd, np.ascontiguousarray(delta[:, keep])


def _root(model, link):
    while model.link_parent[link] >= 0:
        link = model.link_parent[link]
    return link


def _states(models, case, rng):
    """``(model, q, qd, delta, (lo, hi, most))``: pens at their default pose with
    no point in contact (``none``); pens from ``probe.kind_states``, a few
    points of one kind in contact each (``under_32``); pens pressed into
    the table (``over_32``); hammers, doors and relocates from
    ``probe.kind_states`` (each kind in contact in one env); the bounds on
    each env's slots filled (its points with a non-zero wrench), and the
    fewest the most filled env must reach."""
    if case in ("hammer", "door", "relocate"):
        m = models[case]
        q, qd, d = probe.kind_states(m, 1, rng)
        return m, q, qd, d, (0, num_contact_candidates(m), 33 if case == "hammer" else 1)
    m = models["pen"]
    if case == "over_32":
        return (m, *_pressed_pens(m, B, rng, 40, 1000), (33, 1000, 33))
    if case == "under_32":
        q, qd, d = probe.kind_states(m, 1, rng)
        return m, q, qd, d, (0, 31, 1)
    q = np.tile(np.asarray(m.default_qpos, np.float32)[:, None], (1, B))
    qd = rng.uniform(-0.1, 0.1, (m.nv, B)).astype(np.float32)
    return m, q, qd, np.zeros((3 * m.nlink, B), np.float32), (0, 0, 0)


@pytest.mark.parametrize("case", ["none", "under_32", "over_32", "hammer", "door", "relocate"])
def test_contact_stage_sums_point_wrenches_in_order(lib, models, case):
    """Each link's wrench after K3's contact stage is, bit for bit, the
    sequential f32 sum in narrow-phase order of every contact point's
    wrench (+ on its link li, - on lj), over all rounds of 32 pairs: each
    round's compaction keeps the non-zero ones in order, and the zeros it
    drops change no sum."""
    rng = np.random.default_rng(0)
    m, q, qd, d, (lo, hi, most) = _states(models, case, rng)
    mf, mi = pkernel.pack_tables(m, pkernel.read_layout(lib), ext=True)
    n_cand = num_contact_candidates(m)
    touching, filled = _in_contact(m, q, d), []
    for e in range(q.shape[1]):
        points = np.zeros((n_cand, 6), np.float32)
        links = np.zeros((n_cand, 2), np.int32)
        f_ext = np.zeros((m.nlink, 6), np.float32)
        slots = np.zeros(1, np.int32)
        n = lib.mj_ext_contacts_host(*(a.ctypes.data for a in (mf, mi, q, qd, d)), q.shape[1], e,
                                     *(a.ctypes.data for a in (points, links, f_ext, slots)))
        assert n == n_cand
        assert lo <= int(slots[0]) <= hi, int(slots[0])
        # a point at depth > 0 may push with no force (separating fast)
        assert int(slots[0]) == int((points != 0).any(axis=1).sum()) <= touching[e]
        filled.append(int(slots[0]))
        want = np.zeros((m.nlink, 6), np.float32)
        for p in range(n):
            li, lj = links[p]
            if li >= 0:
                want[li] = want[li] + points[p]
            if lj >= 0:
                want[lj] = want[lj] - points[p]
        np.testing.assert_array_equal(f_ext.view(np.uint32), want.view(np.uint32))
    assert max(filled) >= most, filled


@pytest.mark.parametrize("task", ["pen", "hammer", "door", "relocate"])
def test_warp_body_matches_plain_one_control_step(lib, models, task):
    """One control step (5 substeps) of K3's warp body against the plain
    version from the same state, with every link offset: states from
    ``probe.kind_states`` (a kind in contact in each env, some through a
    lowered link) with a draw uniform in +-5 mm added to every offset."""
    m = models[task]
    rng = np.random.default_rng(1)
    q, qd, d = (np.ascontiguousarray(x[:, :B]) for x in probe.kind_states(m, 1, rng))
    d = np.ascontiguousarray(d + rng.uniform(-0.005, 0.005, d.shape).astype(np.float32))
    lo, hi = np.asarray(m.act_ctrlrange, np.float32).T
    ctrl = np.ascontiguousarray(rng.uniform(lo[:, None], hi[:, None], (m.nu, B)), np.float32)
    mf, mi = pkernel.pack_tables(m, pkernel.read_layout(lib), ext=True)
    q_out, qd_out = np.empty_like(q), np.empty_like(qd)
    frames = 5
    dt = float(np.float32(m.dt / m.n_substeps))
    assert lib.mj_ext_host(*(a.ctypes.data for a in (mf, mi, q, qd, ctrl, d, q_out, qd_out)), B,
                           frames * m.n_substeps, dt) == 0
    want_q, want_qd = soa.multistep(m, *(torch.as_tensor(x) for x in (q, qd, ctrl)), frames,
                                    link_delta=torch.as_tensor(d))
    assert (_in_contact(m, q, d) > 0).all()
    np.testing.assert_allclose(q_out, want_q.numpy(), **TOL_Q)
    np.testing.assert_allclose(qd_out, want_qd.numpy(), **TOL_QD)


def test_packers_take_any_points_for_k3_and_cap_k1(lib, models):
    """K3's warp layout has no point cap (``MAX_POINTS`` 0), holds the
    Adroit models' 44 tendons and fits a block; its packer takes hammer
    (671 contact points) and door (760), more than K1's 512 slots in the
    class, which K1's packer refuses, and relocate, which fills the class's
    sizes exactly; a model with more tendons than the scratch holds is
    refused."""
    wl = _layout(lib, "mj_penalty_ext_warp_layout")
    assert wl["MAX_POINTS"] == 0 and wl["MAX_TEN"] >= 44
    assert 1 <= wl["MAX_WARPS"] and wl["BYTES"] * wl["MAX_WARPS"] <= pkernel.SHARED_BYTES_PER_BLOCK
    k1 = _layout(lib, "mj_penalty_warp_layout")
    assert k1["MAX_POINTS"] == pkernel.POINT_CLASSES[2]
    L = pkernel.read_layout(lib)
    relocate = models["relocate"]
    assert (relocate.nlink, relocate.nq, relocate.nv, relocate.nu) == pkernel.SIZE_CLASSES[2]
    mf, mi = pkernel.pack_tables(relocate, L, ext=True)
    assert mi[L["I_NPAIR"]] == len(relocate.contact_pairs) and pkernel.size_class(relocate) == 2
    for m, points in ((models["hammer"], 671), (models["door"], 760)):
        assert num_contact_candidates(m) == points > k1["MAX_POINTS"]
        mf, mi = pkernel.pack_tables(m, L, ext=True)
        assert mi[L["I_NPAIR"]] == len(m.contact_pairs)
        pkernel.check_tendons(m, wl)
        with pytest.raises(NotImplementedError, match="contact points exceed"):
            pkernel.pack_tables(m, L, ext=True, max_points=k1["MAX_POINTS"])
    with pytest.raises(NotImplementedError, match="tendons exceed"):
        pkernel.check_tendons(models["pen"], {**wl, "MAX_TEN": 43})


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["door", "relocate"])
def test_cuda_k3_matches_plain(models, task):
    """K3 on the card against the plain version on door and relocate: one
    control step from ``probe.kind_states`` (each kind in contact in some
    env) with a draw uniform in +-5 mm added to every link offset, to
    chip_smoke.py's tolerance for the model."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import chip_smoke

    m, rng, dev = models[task], np.random.default_rng(2), torch.device("cuda")
    q, qd, d = probe.kind_states(m, 8, rng)
    d = d + rng.uniform(-0.005, 0.005, d.shape).astype(np.float32)
    q, qd, d = (torch.as_tensor(x, device=dev).contiguous() for x in (q, qd, d))
    lo, hi = np.asarray(m.act_ctrlrange, np.float32).T
    ctrl = torch.as_tensor(rng.uniform(lo[:, None], hi[:, None], (m.nu, q.shape[1])),
                           dtype=torch.float32, device=dev)
    kernel = pkernel.PhysicsKernel("penalty", True)
    got_q, got_qd = kernel(m, q, qd, ctrl, 5, link_delta=d)
    want_q, want_qd = soa.multistep(m, q, qd, ctrl, 5, link_delta=d)
    assert kernel.launches == 1
    tol = chip_smoke.TOL[f"K3 {task}"]
    torch.testing.assert_close(got_q, want_q, rtol=0, atol=tol["q"])
    torch.testing.assert_close(got_qd, want_qd, rtol=0, atol=tol["qd"])
