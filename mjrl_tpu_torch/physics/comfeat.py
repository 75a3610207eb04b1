"""Com-based body features: MuJoCo's ``cinert``, ``cvel``,
``qfrc_actuator`` and ``cfrc_ext``, batch-first.

Twin of ``mjrl_tpu/physics/comfeat.py``. Gym's Humanoid observes these
four mjData arrays besides qpos and qvel; computed here from the port's
kinematics (physics/engine.py) and penalty contact wrenches
(physics/contact.py), in mjData's layout:

- the reference point is the centre of mass of the whole robot, world axes;
- ``cinert`` rows are ``[Ixx Iyy Izz Ixy Ixz Iyz, m d (3), m]``, ``I`` the
  body's rotational inertia about that point and ``d = com - subtree_com``;
- ``cvel`` rows are ``[omega (3), v of the point at subtree_com (3)]``;
- ``cfrc_ext`` rows are ``[torque about subtree_com (3), force (3)]``;
- row 0 is the world body (zeros).

MuJoCo's bodies are the model's named links: the loader splits a body with
several joints into massless ``__stage`` links ending in the named one,
which carries the body's mass, geoms and frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mjrl_tpu_torch.physics import math3d as m3
from mjrl_tpu_torch.physics.engine import Kinematics, actuation, const
from mjrl_tpu_torch.physics.model import Model


def body_links(model: Model) -> np.ndarray:
    """The link of each MuJoCo body (the world excluded), in body order."""
    return np.asarray([i for i, n in enumerate(model.link_name) if "__stage" not in n], np.int64)


def com_features(model: Model, kin: Kinematics, ctrl: Optional[torch.Tensor] = None,
                 f_ext_world: Optional[torch.Tensor] = None):
    """``(cinert (B, nb+1, 10), cvel (B, nb+1, 6), qfrc_actuator (B, nv),
    cfrc_ext (B, nb+1, 6))`` with the world row first; ``qfrc_actuator`` is
    0 without ``ctrl``, ``cfrc_ext`` 0 without ``f_ext_world`` (``(B,
    nlink, 6)`` wrenches about ``kin.origin``)."""
    dev, B = kin.pos.device, kin.pos.shape[0]
    links_np = body_links(model)
    links = const(model, "body_links", links_np, dev, torch.int64)
    R = m3.quat_to_mat(kin.quat)  # (B, nlink, 3, 3)
    mass = const(model, "link_mass", model.link_mass, dev)
    com_abs = kin.pos + torch.einsum("blij,lj->bli", R, const(model, "link_com", model.link_com, dev))
    subtree_com = torch.sum(mass[:, None] * com_abs, dim=1) / torch.sum(mass)  # (B, 3)

    mb = mass[links]
    d = com_abs[:, links] - subtree_com[:, None]  # (B, nb, 3)
    Rb = R[:, links]
    i_com = const(model, "inertia_com_bodies", np.asarray(model.link_inertia_com)[links_np], dev)
    i_com_w = torch.einsum("blij,ljk,blmk->blim", Rb, i_com, Rb)
    dd = torch.sum(d * d, dim=-1)
    eye = torch.eye(3, dtype=d.dtype, device=dev)
    I = i_com_w + mb[:, None, None] * (dd[..., None, None] * eye - d[..., :, None] * d[..., None, :])
    cinert = torch.cat([
        I[..., 0, 0:1], I[..., 1, 1:2], I[..., 2, 2:3],
        I[..., 0, 1:2], I[..., 0, 2:3], I[..., 1, 2:3],
        mb[:, None] * d, mb[:, None].expand(B, -1, 1),
    ], dim=-1)

    # spatial velocity about the subtree com: v_c = v_o + w x (c - o)
    c_rel = (subtree_com - kin.origin)[:, None, :]
    w = kin.cvel[:, links, :3]
    cvel = torch.cat([w, kin.cvel[:, links, 3:] + m3.cross(w, c_rel)], dim=-1)

    qfrc_act = actuation(model, ctrl) if ctrl is not None else kin.qd.new_zeros(B, model.nv)

    if f_ext_world is not None:
        # wrench about the origin -> about the subtree com: n_c = n_o - c_rel x F
        F = f_ext_world[:, links, 3:]
        cfrc = torch.cat([f_ext_world[:, links, :3] - m3.cross(c_rel, F), F], dim=-1)
    else:
        cfrc = kin.pos.new_zeros(B, links_np.size, 6)

    pad = lambda x: torch.cat([x.new_zeros(B, 1, x.shape[-1]), x], dim=1)
    return pad(cinert), pad(cvel), qfrc_act, pad(cfrc)
