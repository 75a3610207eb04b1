"""Link poses and site positions of an env batch, batch-first: the part of
the port's per-env engine (``mjrl_tpu_torch/physics/engine.py``) that the
Adroit reference envs read for their observations and rewards. The joint
poses are batched by joint type and the tree composed one depth level per
step, in one world-aligned frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gpubench.reference.physics import math3d as m3
from gpubench.reference.physics.model import BALL, FREE, HINGE, SLIDE, Model


class _FKTables(NamedTuple):
    levels: Tuple[np.ndarray, ...]  # link indices per tree depth
    level_parents: Tuple[np.ndarray, ...]
    hinge_links: np.ndarray
    slide_links: np.ndarray
    ball_links: np.ndarray
    free_links: np.ndarray


def _fk_tables(model: Model) -> _FKTables:
    cached = getattr(model, "_fk_tables", None)
    if cached is not None:
        return cached
    nlink = model.nlink
    depth = np.zeros(nlink, np.int32)
    for i in range(nlink):
        p = model.link_parent[i]
        depth[i] = 0 if p < 0 else depth[p] + 1
    levels = tuple(np.flatnonzero(depth == d) for d in range(int(depth.max()) + 1))
    of = lambda t: np.asarray([i for i in range(nlink) if model.link_jnt_type[i] == t], np.int64)
    tables = _FKTables(levels=levels,
                       level_parents=tuple(np.asarray(model.link_parent)[lv] for lv in levels),
                       hinge_links=of(HINGE), slide_links=of(SLIDE), ball_links=of(BALL),
                       free_links=of(FREE))
    model._fk_tables = tables
    return tables


def const(model: Model, name: str, value, device: torch.device,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A static model array on ``device`` (f32, or an index array as
    int64), memoized on the model: a step on the card copies nothing from
    the host."""
    cache = model.__dict__.setdefault("_engine_consts", {})
    key = (name, str(device))
    t = cache.get(key)
    if t is None:
        np_dtype = np.int64 if dtype == torch.int64 else np.float32
        t = torch.as_tensor(np.asarray(value, np_dtype), device=device)
        cache[key] = t
    return t


def forward_kinematics(model: Model, q: torch.Tensor, link_pos_delta=None):
    """World link poses ``(pos (B, nlink, 3), quat (B, nlink, 4))``.
    ``link_pos_delta`` (``(B, nlink, 3)``): per-env offsets of each link's
    position in its parent's frame (Adroit's randomised scenes)."""
    tab = _fk_tables(model)
    dev, B, nlink = q.device, q.shape[0], model.nlink
    qadr = np.asarray(model.link_qadr)
    jp = q.new_zeros(B, nlink, 3)
    jq = q.new_zeros(B, nlink, 4)
    jq[..., 0] = 1.0
    H = tab.hinge_links
    if H.size:
        angles = (q[:, const(model, "qadr_h", qadr[H], dev, torch.int64)]
                  - const(model, "ref_h", model.jnt_ref[H], dev))
        Hi = const(model, "hinge_links", H, dev, torch.int64)
        anchors = const(model, "anchor_h", model.jnt_anchor[H], dev)
        quats = m3.quat_from_axis_angle(const(model, "axis_h", model.jnt_axis[H], dev), angles)
        jq[:, Hi] = quats
        jp[:, Hi] = anchors - m3.quat_rotate(quats, anchors)
    S = tab.slide_links
    if S.size:
        disp = (q[:, const(model, "qadr_s", qadr[S], dev, torch.int64)]
                - const(model, "ref_s", model.jnt_ref[S], dev))
        jp[:, const(model, "slide_links", S, dev, torch.int64)] = (
            const(model, "axis_s", model.jnt_axis[S], dev) * disp[..., None])
    Bl = tab.ball_links
    if Bl.size:
        quats = m3.quat_normalize(q[:, const(model, "qadr_b", qadr[Bl, None] + np.arange(4), dev,
                                             torch.int64)])
        anchors = const(model, "anchor_b", model.jnt_anchor[Bl], dev)
        Bi = const(model, "ball_links", Bl, dev, torch.int64)
        jq[:, Bi] = quats
        jp[:, Bi] = anchors - m3.quat_rotate(quats, anchors)
    for i in tab.free_links:
        adr = int(qadr[i])
        jp[:, i] = q[:, adr : adr + 3]
        jq[:, i] = m3.quat_normalize(q[:, adr + 3 : adr + 7])
    off_q = const(model, "link_quat", model.link_quat, dev)
    off_p = const(model, "link_pos", model.link_pos, dev)
    if link_pos_delta is not None:
        off_p = off_p + link_pos_delta
    rel_p = off_p + m3.quat_rotate(off_q, jp)
    rel_q = m3.quat_mul(off_q, jq)
    pos, quat = rel_p.clone(), rel_q.clone()
    for d in range(1, len(tab.levels)):
        lvl = const(model, f"level{d}", tab.levels[d], dev, torch.int64)
        parents = const(model, f"level_parents{d}", tab.level_parents[d], dev, torch.int64)
        pos[:, lvl] = pos[:, parents] + m3.quat_rotate(quat[:, parents], rel_p[:, lvl])
        quat[:, lvl] = m3.quat_mul(quat[:, parents], rel_q[:, lvl])
    return pos, quat


def site_positions(model: Model, pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """World positions of all sites ``(B, nsite, 3)`` from the link poses;
    a world site (link -1) stays where it is."""
    dev = pos.device
    links = np.asarray(model.site_link, np.int64)
    ix = const(model, "site_ix", np.where(links < 0, model.nlink, links), dev, torch.int64)
    pos_all = torch.cat([pos, pos.new_zeros(pos.shape[0], 1, 3)], dim=1)
    ident = quat.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(quat.shape[0], 1, 4)
    quat_all = torch.cat([quat, ident], dim=1)
    return pos_all[:, ix] + m3.quat_rotate(quat_all[:, ix], const(model, "site_pos", model.site_pos, dev))
