"""States that reach the contacts between two moving links, for checks.

A random policy rarely folds a hopper far enough for its capsule-capsule
pairs (thigh, leg and foot against each other) to touch, nor a humanoid
for its sphere-sphere and sphere-capsule pairs (feet, hands and head), so
the kernel checks (the CPU tests and ``chip_smoke.py``) add states drawn
here: the root at its default pose and each limited hinge uniform in its
range, kept where some pair between two links overlaps by less than a
centimetre. ``kind_depth`` reads the deepest point of each contact kind;
``held_contact_rows`` and ``held_rows`` count the Newton rows held.

Some of Adroit pen's kinds cannot touch at any joint angle: the thumb's
boxes never reach the floor, the hand never reaches the table, the pen
floats above the floor. ``kind_states`` draws states for each kind all
the same, with a per-env link offset (``link_delta``, the randomised
scenes' input) that lowers the moving geom's root link onto the static
geom: a contact the kernels must get right whatever the scene.

``ball_chain_model`` and ``link_plane_model`` are two small models outside
the kernels' set, which the frame stepper sends to the per-env engine (a
chain of ball joints; planes on a moving link); ``engine_states`` draws
their states. Each takes the ``ModelBuilder`` class to build with, so a
test can build the JAX package's twin of the same model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mjrl_tpu_torch.physics import soa, soa_newton
from mjrl_tpu_torch.physics.csolve import ensure_solver_params
from mjrl_tpu_torch.physics.model import (
    BALL,
    BOX,
    CAPSULE,
    FREE,
    HINGE,
    PLANE,
    SLIDE,
    SPHERE,
    Model,
    ModelBuilder,
)
from mjrl_tpu_torch.physics.tables import pair_groups, points_per_pair


def link_pair_depth(model: Model, q: torch.Tensor) -> torch.Tensor:
    """Per env (``q`` is ``(nq, B)``), the deepest contact candidate between
    two moving links; ``-inf`` where the model has no such pair."""
    pos, quat = soa._fk(model, q)
    depths = [c.depth for c in soa._contact_candidates(model, pos, quat) if c.lj >= 0]
    if not depths:
        return torch.full((q.shape[1],), -float("inf"), device=q.device)
    return torch.cat(depths).amax(dim=0)


def kind_depth(model: Model, q: torch.Tensor, link_delta=None) -> Dict[str, torch.Tensor]:
    """Per contact kind, the deepest of its candidates in each env (``q``
    is ``(nq, B)``, ``link_delta`` ``(3 nlink, B)`` or None): a ``(B,)``
    tensor per kind, in the reference's kind order."""
    cands = soa._contact_candidates(model, *soa._fk(model, q, link_delta))
    out, k = {}, 0
    for kind, tab in pair_groups(model).kinds:
        n = len(tab["gi"]) * points_per_pair(kind)
        out[kind] = torch.cat([c.depth for c in cands[k : k + n]]).amax(dim=0)
        k += n
    return out


def held_contact_rows(model: Model, q: torch.Tensor, between_links: bool = False,
                      link_delta=None) -> torch.Tensor:
    """Per env (``q`` is ``(nq, B)``, ``link_delta`` ``(3 nlink, B)`` or
    None), the contact candidates inside their margin: the rows the Newton
    solver holds for them (``-depth - margin < 0``, as
    physics/soa_newton.py decides); with ``between_links``, only those
    between two moving links."""
    return held_rows(model, q, link_delta)["between_links" if between_links else "contacts"]


def held_rows(model: Model, q: torch.Tensor, link_delta=None) -> Dict[str, torch.Tensor]:
    """Per env (``q`` is ``(nq, B)``, ``link_delta`` ``(3 nlink, B)`` or
    None), the Newton rows held at these states, each a ``(B,)`` int
    tensor: ``contacts`` (candidates inside their margin), ``limits``
    (limited joints out of their range), ``between_links`` (contacts
    between two moving links), one entry per contact kind, and
    ``facets_1``, ``facets_4``, ``facets_6``: the contact rows with that
    many pyramid facets (condim 1, 3, 4)."""
    ensure_solver_params(model)
    cands = soa._contact_candidates(model, *soa._fk(model, q, link_delta))
    zero = torch.zeros(q.shape[1], dtype=torch.int64, device=q.device)
    out = {k: zero.clone() for k in ("contacts", "limits", "between_links", "facets_1",
                                     "facets_4", "facets_6")}
    k = 0
    for kind, tab in pair_groups(model).kinds:
        out[kind] = zero.clone()
        for c in cands[k : k + len(tab["gi"]) * points_per_pair(kind)]:
            _, _, margin, _, condim = soa_newton.contact_params(model, c.gi, c.gj, c.mu)
            held = (-c.depth - float(np.float32(margin)) < 0.0)[0].long()
            nfacet = 1 if condim == 1 else (6 if condim >= 4 else 4)
            for key in ("contacts", kind, f"facets_{nfacet}") + (("between_links",)
                                                                  if c.lj >= 0 else ()):
                out[key] += held
        k += len(tab["gi"]) * points_per_pair(kind)
    for i in range(model.nlink):
        if model.link_jnt_type[i] in (HINGE, SLIDE) and model.jnt_limited[i] > 0:
            lo, hi = model.jnt_range[i]
            qi = q[model.link_qadr[i]]
            out["limits"] += ((qi < float(np.float32(lo))) | (qi > float(np.float32(hi)))).long()
    return out


def overlapping_states(model: Model, n: int, rng: np.random.Generator):
    """``(q (nq, n), qd (nv, n))`` float32 numpy: states with a link pair
    overlapping by 0 to 1 cm, and qd uniform in +-0.1."""
    draws = 4096
    hinges = [i for i in range(model.nlink)
              if model.link_jnt_type[i] == HINGE and model.jnt_limited[i] > 0]
    kept = []
    for _ in range(64):
        q = np.tile(np.asarray(model.default_qpos, np.float32)[:, None], (1, draws))
        for i in hinges:
            lo, hi = model.jnt_range[i]
            q[model.link_qadr[i]] = rng.uniform(lo, hi, draws)
        depth = link_pair_depth(model, torch.as_tensor(q)).numpy()
        kept.append(q[:, (depth > 0) & (depth < 0.01)])
        if sum(k.shape[1] for k in kept) >= n:
            q = np.ascontiguousarray(np.concatenate(kept, axis=1)[:, :n])
            return q, rng.uniform(-0.1, 0.1, (model.nv, n)).astype(np.float32)
    raise ValueError("no overlapping link pairs found")


def _root(model: Model, link: int) -> int:
    while model.link_parent[link] >= 0:
        link = model.link_parent[link]
    return link


def _static(model: Model, link: int) -> bool:
    """True for the world (-1) and for a link with no joint on its chain."""
    while link >= 0:
        if model.link_jnt_type[link] != -1:
            return False
        link = model.link_parent[link]
    return True


def _random_hinges(model: Model, draws: int, rng: np.random.Generator) -> np.ndarray:
    q = np.tile(np.asarray(model.default_qpos, np.float32)[:, None], (1, draws))
    for i in range(model.nlink):
        if model.link_jnt_type[i] == HINGE and model.jnt_limited[i] > 0:
            lo, hi = model.jnt_range[i]
            q[model.link_qadr[i]] = rng.uniform(lo, hi, draws)
    return q


def _carried_onto(model: Model, tab, q: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Link offsets ``(3 nlink, draws)`` that carry, in each draw of ``q``,
    the tree of geom i of a random pair of ``tab`` between two trees so
    that geom i's centre lies 1 to 9 mm closer to geom j's than the sum of
    their radii, in a random direction."""
    pairs = [p for p in range(len(tab["gi"]))
             if min(tab["li"][p], tab["lj"][p]) >= 0
             and _root(model, int(tab["li"][p])) != _root(model, int(tab["lj"][p]))]
    if not pairs:
        raise ValueError("no pair between two trees to carry together")
    pos, quat = soa._fk(model, torch.as_tensor(q))
    centres = {}

    def centre(g):
        if g not in centres:
            l = model.geom_link[g]
            gp = torch.as_tensor(np.asarray(model.geom_pos[g], np.float32))[:, None]
            centres[g] = (pos[l] + soa._qrot(quat[l], gp)).numpy()
        return centres[g]

    draws = q.shape[1]
    delta = np.zeros((3 * model.nlink, draws), np.float32)
    size = np.asarray(model.geom_size, np.float32)
    for e, p in enumerate(rng.choice(pairs, draws)):
        gi, gj = int(tab["gi"][p]), int(tab["gj"][p])
        v = rng.normal(size=3)
        reach = size[gi, 0] + size[gj, 0] - rng.uniform(0.001, 0.009)
        root = _root(model, int(tab["li"][p]))
        delta[3 * root : 3 * root + 3, e] = (centre(gj)[:, e] + reach * v / np.linalg.norm(v)
                                             - centre(gi)[:, e])
    return delta


def kind_states(model: Model, n: int, rng: np.random.Generator):
    """``(q (nq, N), qd (nv, N), link_delta (3 nlink, N))`` float32 numpy
    with ``n`` states per contact kind, in which that kind touches 0 to 1 cm
    deep; qd uniform in +-0.1. Each kind's states come from
    random limited hinges where some touch; where none does, the root link
    of the moving geom of the kind's pairs against a static geom (the world,
    or a body with no joint on its chain) is lowered (its offset in the
    world z) so that those pairs' deepest point lands 1 to 9 mm deep; where
    every pair of the kind is between two moving trees, one tree is carried
    onto the other (``_carried_onto``). Raises if a kind can be reached in
    none of these ways."""
    draws = max(256, 4 * n)
    qs, deltas = [], []
    cands_per_kind = []
    for kind, tab in pair_groups(model).kinds:
        cands_per_kind.append((kind, tab))
    for kind, tab in cands_per_kind:
        q = _random_hinges(model, draws, rng)
        delta = np.zeros((3 * model.nlink, draws), np.float32)
        d = kind_depth(model, torch.as_tensor(q))[kind].numpy()
        keep = (d > 0) & (d < 0.01)
        if keep.sum() < n:
            # lower the moving side of the pairs against a static geom
            roots = {}
            for p in range(len(tab["gi"])):
                li, lj = int(tab["li"][p]), int(tab["lj"][p])
                si, sj = _static(model, li), _static(model, lj)
                if si != sj:
                    root = _root(model, lj if si else li)
                    fixed = li if si else lj
                    if fixed < 0 or _root(model, fixed) != root:  # not carried along
                        roots.setdefault(root, []).append(p)
            if not roots:
                # every pair is between two moving trees (relocate's ball
                # against the hand): carry geom i's tree onto geom j
                delta = _carried_onto(model, tab, q, rng)
                d = kind_depth(model, torch.as_tensor(q), torch.as_tensor(delta))[kind].numpy()
                keep = (d > 0) & (d < 0.01)
                if keep.sum() < n:
                    raise ValueError(f"{kind}: {keep.sum()} of {draws} carried states touch")
                qs.append(q[:, keep][:, :n])
                deltas.append(delta[:, keep][:, :n])
                continue
            root, pairs = max(roots.items(), key=lambda kv: len(kv[1]))
            pts = points_per_pair(kind)
            first = sum(len(t["gi"]) * points_per_pair(k) for k, t in cands_per_kind[
                : [k for k, _ in cands_per_kind].index(kind)])

            def pushed_depth(d):
                cands = soa._contact_candidates(model, *soa._fk(model, torch.as_tensor(q), d))
                return torch.cat([cands[first + p * pts + c].depth for p in pairs
                                  for c in range(pts)]).amax(dim=0).numpy()

            delta[3 * root + 2] = -(rng.uniform(0.001, 0.009, draws) - pushed_depth(None))
            d = pushed_depth(torch.as_tensor(delta))
            keep = (d > 0) & (d < 0.01)
            if keep.sum() < n:
                raise ValueError(f"{kind}: {keep.sum()} of {draws} lowered states touch")
        qs.append(q[:, keep][:, :n])
        deltas.append(delta[:, keep][:, :n])
    q = np.ascontiguousarray(np.concatenate(qs, axis=1))
    delta = np.ascontiguousarray(np.concatenate(deltas, axis=1))
    return q, rng.uniform(-0.1, 0.1, (model.nv, q.shape[1])).astype(np.float32), delta


def ball_chain_model(builder=ModelBuilder) -> Model:
    """Two links on ball joints hanging from the world at 1 m, a capsule on
    the first and a sphere at the end of the second over the world plane
    (which the sphere reaches when the chain hangs straight), a motor on
    each joint's first dof: nq 8, nv 6, nu 2."""
    b = builder(dt=0.002)
    b.add_geom(None, PLANE, size=(0, 0, 0))
    inertia = np.eye(3) * 0.01
    b.add_body("l1", joints=[dict(type=BALL)], pos=(0, 0, 1.0), mass=1.0, com=(0, 0, -0.25),
               inertia_com=inertia)
    b.add_geom("l1", CAPSULE, size=(0.05, 0.25, 0), pos=(0, 0, -0.25))
    b.add_body("l2", parent="l1", joints=[dict(type=BALL)], pos=(0, 0, -0.5), mass=1.0,
               com=(0, 0, -0.25), inertia_com=inertia)
    b.add_geom("l2", SPHERE, size=(0.08, 0, 0), pos=(0, 0, -0.5))
    b.add_motor("l1", gear=1.0, ctrlrange=(-1.0, 1.0))
    b.add_motor("l2", gear=1.0, ctrlrange=(-1.0, 1.0))
    return b.finalize(contact_pairs="ground")


def link_plane_model(builder=ModelBuilder) -> Model:
    """A tray on a damped hinge about x, 30 cm up, whose plane carries a
    free sphere and a free box 1 cm above it, over the world plane, with a
    motor on the hinge: sphere_plane and box_plane against a plane on a
    moving link (and the world's). nq 15, nv 13, nu 1."""
    b = builder(dt=0.002)
    b.add_geom(None, PLANE, size=(0, 0, 0))
    b.add_body("tray", joints=[dict(type=HINGE, axis=(1, 0, 0), damping=0.5)], pos=(0, 0, 0.3),
               mass=2.0, inertia_com=np.eye(3) * 0.05)
    b.add_geom("tray", PLANE, size=(0, 0, 0))
    b.add_body("ball", joints=[dict(type=FREE)], pos=(0.1, 0, 0.36), mass=0.5,
               inertia_com=np.eye(3) * 5e-4)
    b.add_geom("ball", SPHERE, size=(0.05, 0, 0))
    b.add_body("brick", joints=[dict(type=FREE)], pos=(-0.1, 0, 0.33), mass=0.5,
               inertia_com=np.eye(3) * 5e-4)
    b.add_geom("brick", BOX, size=(0.04, 0.03, 0.02))
    b.add_motor("tray", gear=1.0, ctrlrange=(-1.0, 1.0))
    return b.finalize(contact_pairs="ground")


def engine_states(model: Model, n: int, rng: np.random.Generator, scale: float = 0.3):
    """``(q (n, nq), qd (n, nv), ctrl (n, nu))`` float32 numpy, batch-first:
    the default pose with each hinge and slide moved and each ball and free
    joint turned by a draw uniform in +-``scale`` (radians, metres for a
    free joint's position, by a tenth of it), qd normal times ``scale``,
    ctrl uniform in +-1."""
    q = np.tile(np.asarray(model.default_qpos, np.float32), (n, 1))
    for i in range(model.nlink):
        t, adr = model.link_jnt_type[i], int(model.link_qadr[i])
        if t in (HINGE, SLIDE):
            q[:, adr] += rng.uniform(-scale, scale, n)
        elif t in (BALL, FREE):
            a = adr if t == BALL else adr + 3
            if t == FREE:
                q[:, adr : adr + 3] += rng.uniform(-0.1 * scale, 0.1 * scale, (n, 3))
            v = rng.uniform(-scale, scale, (n, 3))
            angle = np.linalg.norm(v, axis=1, keepdims=True)
            dq = np.concatenate([np.cos(angle / 2), np.sin(angle / 2) * v / angle], axis=1)
            w1, x1, y1, z1 = q[:, a : a + 4].T
            w2, x2, y2, z2 = dq.T
            q[:, a : a + 4] = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=1)
    qd = (scale * rng.standard_normal((n, model.nv))).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (n, model.nu)).astype(np.float32)
    return q.astype(np.float32), qd, ctrl
