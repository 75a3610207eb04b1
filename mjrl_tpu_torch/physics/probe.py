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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mjrl_tpu_torch.physics import soa, soa_newton
from mjrl_tpu_torch.physics.csolve import ensure_solver_params
from mjrl_tpu_torch.physics.model import HINGE, SLIDE, Model
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
