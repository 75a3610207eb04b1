// Link poses and site positions of one env over the 32 lanes of a warp:
// the observation's kinematics of the Adroit envs (envs/adroit.py _poses).
//
// The same operations per link as the plain version
// (physics/engine.py forward_kinematics: the joint's relative pose with the
// env's link offset, then the world pose from the parent's, parents before
// children) through mj_warp_stages.h's mj_link_rel and mj_link_world, on
// the tables K3 and K4 read (pkernel.pack_tables with ext): the relative
// poses over lanes, the world poses down the tree level by level
// (mj_warp_levels), as K3's and K4's kinematics does. Then each site's
// world position over lanes (site_positions: its link's position plus the
// site's offset rotated by its link's orientation; a site on link -1 keeps
// the model's position). The sites come in a table of their own: site_pos
// (nsite, 3) and site_link (nsite).
//
// The env's q and link offsets are read through strides, so that the
// batch-first views the env holds (after a control step the transposed
// view of the kernel's batch-last output) need no copy; the outputs are
// batch-first and contiguous, each env's block written by consecutive
// lanes.
#pragma once

#include "mj_warp_stages.h"

// One env's state: its kinematics (only pos and quat are written), its q,
// its link offsets, each link's relative pose and its depth in the tree.
// The whole MjKin, because mj_link_world, which K3 and K4 share, writes
// into one; at 4 warps a block (~5.9 KB each in the Adroit class) B=512
// envs are one block per SM all the same.
struct MjPoseEnv {
  MjKin k;
  float q[MJ_MAX_NQ];
  float delta[3 * MJ_MAX_LINK];
  float rel_p[MJ_MAX_LINK][3], rel_q[MJ_MAX_LINK][4];
  unsigned char depth[MJ_MAX_LINK];
};

// Env env's poses: q (B, nq) with strides sq (row, column); delta (B,
// nlink, 3) with strides sd, or null; pos (B, nlink, 3), quat (B, nlink,
// 4) and sites (B, nsite, 3) contiguous.
template <class W>
MJ_WD void mj_warp_poses(W& w, MjPoseEnv& S, const float* mf, const int* mi,
                         const float* site_pos, const int* site_link, int nsite,
                         const float* q, const long long* sq, const float* delta,
                         const long long* sd, int env, float* pos, float* quat,
                         float* sites) {
  const int nlink = mi[MJ_I_NLINK], nq = mi[MJ_I_NQ];
  const int* parent = mi + MJ_I_PARENT;
  w.each(nq + (delta ? 3 * nlink : 0), [&](int e) {
    if (e < nq) {
      S.q[e] = q[env * sq[0] + e * sq[1]];
    } else {
      const int i = (e - nq) / 3, c = (e - nq) % 3;
      S.delta[e - nq] = delta[env * sd[0] + i * sd[1] + c * sd[2]];
    }
  });
  const int maxd = mj_warp_depths(w, S, mi);
  w.each(nlink, [&](int i) {
    mj_link_rel(mf, mi, S.q, i, delta ? S.delta : nullptr, S.rel_p[i], S.rel_q[i]);
  });
  mj_warp_levels(w, S, nlink, maxd,
                 [&](int i) { mj_link_world(S.k, i, parent[i], S.rel_p[i], S.rel_q[i]); });
  float* p = pos + (long long)env * nlink * 3;
  float* o = quat + (long long)env * nlink * 4;
  w.each(3 * nlink, [&](int e) { p[e] = S.k.pos[e / 3][e % 3]; });
  w.each(4 * nlink, [&](int e) { o[e] = S.k.quat[e / 4][e % 4]; });
  float* x = sites + (long long)env * nsite * 3;
  w.each(nsite, [&](int s) {
    const int l = site_link[s];
    const float* v = site_pos + 3 * s;
    if (l < 0) {
      for (int c = 0; c < 3; ++c) x[3 * s + c] = v[c];
    } else {
      float r[3];
      mj_qrot(S.k.quat[l], v, r);
      for (int c = 0; c < 3; ++c) x[3 * s + c] = S.k.pos[l][c] + r[c];
    }
  });
}
