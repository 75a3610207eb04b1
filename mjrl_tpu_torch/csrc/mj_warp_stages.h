// The stages every warp body shares: one env's rigid-body pipeline spread
// over the 32 lanes of a warp (mj_warp.h), the env's state in memory the
// lanes share (shared memory on the card).
//
// Kernels K1 and K3 (mj_warp_penalty.h, EXT off and on), K2 and K4
// (mj_warp_newton.h, EXT off and on) run one env per warp. Their substeps
// differ in the contact stage and the constraint solve; the rest of the
// pipeline is here, each stage a template on the warp type W and on the
// env's state type Env, whose members carry the same names in every body
// (q, qd, ctrl, k, depth, M, qdd0, bias and the scratch union s; the
// Newton bodies add Mf and fdiag, the penalty bodies the limit diagonal
// ldiag, the EXT bodies delta and the tendons' scratch s.ften):
//
// - loads and stores of the env's column of the batch-last (rows, B)
//   state;
// - each link's depth in the tree, and f(i) over the links level by level;
// - the kinematics: each link's relative pose, motion subspaces and
//   inertia over lanes, world poses and velocities down the tree level by
//   level (mj_substep.h's mj_kinematics, link by link);
// - the fluid drag of a link (the plain version's, link by link);
// - the RNE bias: accelerations down the tree level by level, link forces
//   over lanes, the backward sum on one lane, the bias over dofs;
// - the applied forces per dof: motors (EXT: the affine servos) in
//   actuator order, the joint's spring, with LIMITS its limit penalty (the
//   damper half into ldiag), EXT the tendon forces in tendon order, minus
//   the bias and the damping;
// - the composite inertias (backward sum on one lane) and the tree-sparse
//   mass matrix over dofs; with METRIC the Newton metric beside it; with
//   EXT frictionloss (its diagonal onto the metric, or without METRIC onto
//   ldiag);
// - the sparse L^T D L factorization and solve (mj_ltdl_solve) over lanes:
//   per column k, lanes over k's ancestors, each updating its row of the
//   factor; the back substitution dof by dof, lanes over its ancestors;
//   the forward one level by level of the dof tree (K1 and K3; K2 and K4
//   keep mj_ltdl_solve on one lane).
//
// Each output has one lane at a time, and its terms are added in the order
// of the scalar pipeline (the plain version's, which the thread bodies of
// the first port ran as scalar code), so the host build (mj_host.cpp,
// under the emulated warp) reproduces their arithmetic bit for bit. The
// integration stays on one lane (mj_integrate).
#pragma once

#include "mj_warp.h"

#define MJ_LD (MJ_MAX_NV + 1)  // a shared matrix's row, padded by one float
#ifndef MJ_MAX_TEN
#define MJ_MAX_TEN 64  // fixed tendons (Adroit's models: 44)
#endif

// Stages of a substep, for the cycle counts of a MJ_STAGE_CLOCKS build
// (K1 has no Newton stages: its contact wrenches count as its rows).
enum {
  MJ_ST_KIN,    // loads, kinematics
  MJ_ST_ROWS,   // limit and contact rows (K1: the contact wrenches, fluid)
  MJ_ST_RNE,    // fluid drag, RNE bias
  MJ_ST_FORCE,  // servos, springs, limits, tendons, damping
  MJ_ST_CRB,    // composite inertias, mass matrix, metric, frictionloss
  MJ_ST_LTDL,   // the unconstrained L^T D L solve
  MJ_ST_GRAD,   // residuals, M d0, gradient
  MJ_ST_HESS,   // H's lower triangle
  MJ_ST_CHOL,   // its Cholesky factor
  MJ_ST_TRI,    // the two triangular solves
  MJ_ST_LINE,   // line search, step
  MJ_ST_INT,    // integration, stores
  MJ_N_STAGES
};
static_assert(MJ_N_STAGES <= MJ_MAX_STAGES, "stage count");
#ifdef MJ_STAGE_CLOCKS
#define MJ_STAMP(w, s) (w).stamp(s)
#else
#define MJ_STAMP(w, s)
#endif

// ---- per-link pieces of mj_kinematics (the same operations in the same
// order per link) --------------------------------------------------------

// Link i's pose relative to its parent (rel_p, rel_q): its joint at q
// and, with delta (or nullptr: this env's offsets of each link's position
// in its parent's frame, 3 per link), its offset.
MJ_HD void mj_link_rel(const float* mf, const int* mi, const float* q, int i,
                       const float* delta, float* rel_p, float* rel_q) {
  const int* type = mi + MJ_I_TYPE;
  const int* qadr = mi + MJ_I_QADR;
  const float* lp = mf + MJ_F_LPOS + 3 * i;
  const float* lq = mf + MJ_F_LQUAT + 4 * i;
  float lpd[3];
  if (delta) {
    for (int c = 0; c < 3; ++c) lpd[c] = lp[c] + delta[3 * i + c];
    lp = lpd;
  }
  const int t = type[i];
  if (t == MJ_SLIDE) {  // a translation along the axis, no rotation
    const float* ax = mf + MJ_F_AXIS + 3 * i;
    const float x = q[qadr[i]] - mf[MJ_F_REF + i];
    float jp[3], r[3];
    for (int c = 0; c < 3; ++c) jp[c] = ax[c] * x;
    mj_qrot(lq, jp, r);
    for (int c = 0; c < 3; ++c) rel_p[c] = lp[c] + r[c];
    for (int c = 0; c < 4; ++c) rel_q[c] = lq[c];
  } else if (t == MJ_HINGE || t == MJ_FREE) {
    float jp[3], jq[4];
    const int adr = qadr[i];
    if (t == MJ_HINGE) {
      const float* ax = mf + MJ_F_AXIS + 3 * i;
      const float* an = mf + MJ_F_ANCHOR + 3 * i;
      float half = 0.5f * (q[adr] - mf[MJ_F_REF + i]);
      float s = sinf(half);
      jq[0] = cosf(half);
      jq[1] = ax[0] * s;
      jq[2] = ax[1] * s;
      jq[3] = ax[2] * s;
      float r[3];
      mj_qrot(jq, an, r);
      for (int c = 0; c < 3; ++c) jp[c] = an[c] - r[c];
    } else {
      for (int c = 0; c < 3; ++c) jp[c] = q[adr + c];
      for (int c = 0; c < 4; ++c) jq[c] = q[adr + 3 + c];
      mj_qnorm(jq);
    }
    float r[3];
    mj_qrot(lq, jp, r);
    for (int c = 0; c < 3; ++c) rel_p[c] = lp[c] + r[c];
    mj_qmul(lq, jq, rel_q);
  } else {
    for (int c = 0; c < 3; ++c) rel_p[c] = lp[c];
    for (int c = 0; c < 4; ++c) rel_q[c] = lq[c];
  }
}

// Link i's world pose from its parent p's (p < 0: the world) and its pose
// relative to it.
MJ_HD void mj_link_world(MjKin& k, int i, int p, const float* rel_p,
                         const float* rel_q) {
  if (p < 0) {
    for (int c = 0; c < 3; ++c) k.pos[i][c] = rel_p[c];
    for (int c = 0; c < 4; ++c) k.quat[i][c] = rel_q[c];
  } else {
    float r[3];
    mj_qrot(k.quat[p], rel_p, r);
    for (int c = 0; c < 3; ++c) k.pos[i][c] = k.pos[p][c] + r[c];
    mj_qmul(k.quat[p], rel_q, k.quat[i]);
  }
}

// Link i's motion subspaces about the origin (its dofs' cdof rows).
MJ_HD void mj_link_cdof(const float* mf, const int* mi, MjKin& k, int i) {
  const int* type = mi + MJ_I_TYPE;
  const int v = mi[MJ_I_VADR + i];
  float(*cdof)[6] = k.cdof;
  if (type[i] == MJ_HINGE) {
    float axis_w[3], r[3], anchor_w[3];
    mj_qrot(k.quat[i], mf + MJ_F_AXIS + 3 * i, axis_w);
    mj_qrot(k.quat[i], mf + MJ_F_ANCHOR + 3 * i, r);
    for (int c = 0; c < 3; ++c) anchor_w[c] = k.pos[i][c] - k.origin[c] + r[c];
    for (int c = 0; c < 3; ++c) cdof[v][c] = axis_w[c];
    mj_cross(anchor_w, axis_w, cdof[v] + 3);
  } else if (type[i] == MJ_SLIDE) {
    mj_qrot(k.quat[i], mf + MJ_F_AXIS + 3 * i, cdof[v] + 3);
    for (int c = 0; c < 3; ++c) cdof[v][c] = 0.0f;
  } else if (type[i] == MJ_FREE) {
    float p_rel[3];
    for (int c = 0; c < 3; ++c) p_rel[c] = k.pos[i][c] - k.origin[c];
    for (int a = 0; a < 3; ++a) {
      float e[3] = {0.0f, 0.0f, 0.0f}, ew[3];
      e[a] = 1.0f;
      mj_qrot(k.quat[i], e, ew);
      for (int c = 0; c < 3; ++c) {
        cdof[v + a][c] = ew[c];
        cdof[v + 3 + a][c] = 0.0f;
        cdof[v + 3 + a][3 + c] = ew[c];
      }
      mj_cross(p_rel, ew, cdof[v + a] + 3);
    }
  }
}

// Link i's velocity from its parent p's (p < 0: at rest) and its dofs'.
MJ_HD void mj_link_cvel(const int* mi, MjKin& k, const float* qd, int i, int p) {
  const int v = mi[MJ_I_VADR + i];
  for (int c = 0; c < 6; ++c) k.cvel[i][c] = p < 0 ? 0.0f : k.cvel[p][c];
  const int nd = mj_jnt_nv(mi[MJ_I_TYPE + i]);
  for (int d = 0; d < nd; ++d)
    for (int c = 0; c < 6; ++c) k.cvel[i][c] += k.cdof[v + d][c] * qd[v + d];
}

// Link i's world inertia about the origin.
MJ_HD void mj_link_inertia(const float* mf, MjKin& k, int i) {
  const float m = mf[MJ_F_MASS + i];
  float com_w[3], r[3];
  mj_qrot(k.quat[i], mf + MJ_F_COM + 3 * i, r);
  for (int c = 0; c < 3; ++c) com_w[c] = k.pos[i][c] - k.origin[c] + r[c];
  float cols[3][3];
  const float* d = mf + MJ_F_EIGD + 3 * i;
  for (int c = 0; c < 3; ++c)
    if (d[c] != 0.0f) mj_qrot(k.quat[i], mf + MJ_F_EIGQ + 9 * i + 3 * c, cols[c]);
  const float cc = mj_dot3(com_w, com_w);
  int s = 0;
  for (int a = 0; a < 3; ++a)
    for (int b = a; b < 3; ++b, ++s) {
      float val = 0.0f;
      for (int c = 0; c < 3; ++c)
        if (d[c] != 0.0f) val += d[c] * cols[c][a] * cols[c][b];
      if (m != 0.0f) val += m * ((a == b ? cc : 0.0f) - com_w[a] * com_w[b]);
      k.iI[i][s] = val;
    }
  for (int c = 0; c < 3; ++c) k.ih[i][c] = m * com_w[c];
}

// Link i's fluid drag added to f_ext[i]: MuJoCo's legacy inertia-box
// model (soa.py _fluid_forces), from its centre of mass velocity and its
// angular velocity in its principal inertia frame, as a world wrench about
// the origin; nothing for a link without mass.
MJ_HD void mj_link_fluid(const float* mf, const MjKin& k, int i, float (*f_ext)[6]) {
  if (mf[MJ_F_MASS + i] <= 0.0f) return;
  const float* cf = mf + MJ_F_FLUID + MJ_FLUID_F * i;
  float q_wp[4], com_w[3], r[3];
  mj_qmul(k.quat[i], mf + MJ_F_IQUAT + 4 * i, q_wp);
  mj_qrot(k.quat[i], mf + MJ_F_COM + 3 * i, r);
  for (int c = 0; c < 3; ++c) com_w[c] = k.pos[i][c] - k.origin[c] + r[c];
  const float* omega = k.cvel[i];
  float v_com[3], w_p[3], v_p[3];
  mj_cross(omega, com_w, r);
  for (int c = 0; c < 3; ++c) v_com[c] = k.cvel[i][3 + c] + r[c];
  mj_qrot_inv(q_wp, omega, w_p);
  mj_qrot_inv(q_wp, v_com, v_p);
  float force[3], torque[3], f_w[3], t_w[3];
  for (int c = 0; c < 3; ++c) {
    force[c] = cf[0] * v_p[c] - cf[2 + c] * fabsf(v_p[c]) * v_p[c];
    torque[c] = cf[1] * w_p[c] - cf[5 + c] * fabsf(w_p[c]) * w_p[c];
  }
  mj_qrot(q_wp, force, f_w);
  mj_qrot(q_wp, torque, t_w);
  mj_cross(com_w, f_w, r);
  for (int c = 0; c < 3; ++c) {
    f_ext[i][c] += r[c] + t_w[c];
    f_ext[i][3 + c] += f_w[c];
  }
}

// ---- the stages ---------------------------------------------------------

// Loads env's columns of the batch-last (rows, B) inputs into S, and the
// link offsets into delta when delta_in is given.
template <class W, class Env>
MJ_WD void mj_warp_load(W& w, Env& S, const int* mi, int env, int B, const float* q_in,
                        const float* qd_in, const float* ctrl_in, const float* delta_in,
                        float* delta) {
  const int nq = mi[MJ_I_NQ], nv = mi[MJ_I_NV], nu = mi[MJ_I_NU];
  const int nd = delta_in ? 3 * mi[MJ_I_NLINK] : 0;
  w.each(nq + nv + nu + nd, [&](int e) {
    if (e < nq)
      S.q[e] = q_in[(long)e * B + env];
    else if (e < nq + nv)
      S.qd[e - nq] = qd_in[(long)(e - nq) * B + env];
    else if (e < nq + nv + nu)
      S.ctrl[e - nq - nv] = ctrl_in[(long)(e - nq - nv) * B + env];
    else
      delta[e - nq - nv - nu] = delta_in[(long)(e - nq - nv - nu) * B + env];
  });
}

// Stores S's q and qd into env's columns of the outputs.
template <class W, class Env>
MJ_WD void mj_warp_store(W& w, const Env& S, const int* mi, int env, int B, float* q_out,
                         float* qd_out) {
  const int nq = mi[MJ_I_NQ], nv = mi[MJ_I_NV];
  w.each(nq + nv, [&](int e) {
    if (e < nq)
      q_out[(long)e * B + env] = S.q[e];
    else
      qd_out[(long)(e - nq) * B + env] = S.qd[e - nq];
  });
}

// Each link's depth in S.depth; returns the deepest.
template <class W, class Env>
MJ_WD int mj_warp_depths(W& w, Env& S, const int* mi) {
  const int nlink = mi[MJ_I_NLINK];
  const int* parent = mi + MJ_I_PARENT;
  w.each(nlink, [&](int i) {
    int d = 0;
    for (int p = parent[i]; p >= 0; p = parent[p]) ++d;
    S.depth[i] = (unsigned char)d;
  });
  int maxd = 0;
  for (int i = 0; i < nlink; ++i) maxd = S.depth[i] > maxd ? S.depth[i] : maxd;
  return maxd;
}

// f(i) for every link i, parents before children: one phase per depth of
// the tree (maxd: the deepest), lanes over the links at that depth.
template <class W, class Env, class F>
MJ_WD void mj_warp_levels(W& w, const Env& S, int nlink, int maxd, F&& f) {
  for (int d = 0; d <= maxd; ++d)
    w.each(nlink, [&](int i) {
      if (S.depth[i] == d) f(i);
    });
}

// The kinematic state of S.q, S.qd in S.k, as mj_kinematics computes it:
// each link's relative pose, its motion subspaces and its inertia over
// lanes; world poses and velocities down the tree level by level.
template <class W, class Env>
MJ_WD void mj_warp_kinematics(W& w, Env& S, const float* mf, const int* mi,
                              const float* delta, int maxd) {
  const int nlink = mi[MJ_I_NLINK];
  const int* parent = mi + MJ_I_PARENT;
  auto& T = S.s.kin;
  w.each(nlink, [&](int i) { mj_link_rel(mf, mi, S.q, i, delta, T.rel_p[i], T.rel_q[i]); });
  mj_warp_levels(w, S, nlink, maxd,
                 [&](int i) { mj_link_world(S.k, i, parent[i], T.rel_p[i], T.rel_q[i]); });
  w.each(3, [&](int c) { S.k.origin[c] = S.k.pos[0][c]; });
  w.each(nlink, [&](int i) {
    mj_link_cdof(mf, mi, S.k, i);
    mj_link_inertia(mf, S.k, i);
  });
  mj_warp_levels(w, S, nlink, maxd, [&](int i) { mj_link_cvel(mi, S.k, S.qd, i, parent[i]); });
}

// The RNE bias with gravity into S.bias (soa.py _bias_forces); with fext,
// minus the external link wrenches in S.s.rne.f_ext.
template <class W, class Env>
MJ_WD void mj_warp_bias(W& w, Env& S, const float* mf, const int* mi, int maxd, bool fext) {
  const int nlink = mi[MJ_I_NLINK], nv = mi[MJ_I_NV];
  const int* parent = mi + MJ_I_PARENT;
  const int* type = mi + MJ_I_TYPE;
  const int* vadr = mi + MJ_I_VADR;
  const int* dof_link = mi + MJ_I_DOFLINK;
  const MjKin& k = S.k;
  auto& R = S.s.rne;
  mj_warp_levels(w, S, nlink, maxd, [&](int i) {
    const int p = parent[i];
    for (int c = 0; c < 6; ++c)
      R.cacc[i][c] = p >= 0 ? R.cacc[p][c] : (c < 3 ? 0.0f : -mf[MJ_F_GRAV + c - 3]);
    const int nd = mj_jnt_nv(type[i]);
    for (int d = 0; d < nd; ++d) {
      float cr[6];
      mj_crm(k.cvel[i], k.cdof[vadr[i] + d], cr);
      for (int c = 0; c < 6; ++c) R.cacc[i][c] += cr[c] * S.qd[vadr[i] + d];
    }
  });
  w.each(nlink, [&](int i) {
    const float m = mf[MJ_F_MASS + i];
    float Iv[6], Ia[6], cr[6];
    mj_inertia_mul(m, k.ih[i], k.iI[i], k.cvel[i], Iv);
    mj_inertia_mul(m, k.ih[i], k.iI[i], R.cacc[i], Ia);
    mj_crf(k.cvel[i], Iv, cr);
    if (fext)
      for (int c = 0; c < 6; ++c) R.facc[i][c] = Ia[c] + cr[c] - R.f_ext[i][c];
    else
      for (int c = 0; c < 6; ++c) R.facc[i][c] = Ia[c] + cr[c];
  });
  w.one([&] {
    for (int i = nlink - 1; i >= 0; --i) {
      const int p = parent[i];
      if (p >= 0)
        for (int c = 0; c < 6; ++c) R.facc[p][c] += R.facc[i][c];
    }
  });
  w.each(nv, [&](int j) { S.bias[j] = mj_dot6(R.facc[dof_link[j]], k.cdof[j]); });
}

// Per dof, into S.qdd0: its motors (EXT: the affine servos, force = g0
// ctrl + b0 + b1 (gear q) + b2 (gear qd)) in actuator order and its
// joint's spring and, with LIMITS, its limit penalty (the penalty's damper
// half into S.ldiag), then (EXT) the fixed tendons' forces Jv^T f summed
// in tendon order from 0 (soa.py _tendon_forces: a spring and damper on
// each tendon's length Jq q and velocity Jv qd, plus its limit penalty),
// minus the bias and the damping.
template <bool LIMITS, bool EXT, class W, class Env>
MJ_WD void mj_warp_forces(W& w, Env& S, const float* mf, const int* mi) {
  const int nlink = mi[MJ_I_NLINK], nv = mi[MJ_I_NV], nu = mi[MJ_I_NU];
  const int* type = mi + MJ_I_TYPE;
  const int* qadr = mi + MJ_I_QADR;
  const int* vadr = mi + MJ_I_VADR;
  const bool gainbias = EXT && mi[MJ_I_HAS_GAINBIAS] != 0;
  const int nt = EXT ? mi[MJ_I_NTEN] : 0;
  const int* ti = mi + mi[MJ_I_TEN_I];
  const float* tf = mf + mi[MJ_I_TEN_F];
  const int* qptr = ti + 1;
  const int* qidx = qptr + nt + 1;
  const int* vptr = qidx + qptr[nt];
  const int* vidx = vptr + nt + 1;
  const float* qval = tf + 8 * nt;
  const float* vval = qval + qptr[nt];
  if constexpr (EXT) {
    w.each(nt, [&](int t) {
      const float* P = tf + 8 * t;
      float len = 0.0f, vel = 0.0f;
      for (int e = qptr[t]; e < qptr[t + 1]; ++e) len += qval[e] * S.q[qidx[e]];
      for (int e = vptr[t]; e < vptr[t + 1]; ++e) vel += vval[e] * S.qd[vidx[e]];
      float f = -P[0] * (len - P[1]) - P[2] * vel;
      const float viol = mj_min(len - P[3], 0.0f) + mj_max(len - P[4], 0.0f);
      const float f_lim = -P[5] * viol - (fabsf(viol) > 0.0f ? P[6] * vel : 0.0f);
      S.s.ften[t] = f + P[7] * f_lim;
    });
  }
  w.each(nv, [&](int j) {
    float rhs = 0.0f;
    if constexpr (LIMITS) S.ldiag[j] = 0.0f;
    for (int u = 0; u < nu; ++u) {
      const int v = mi[MJ_I_ACTV + u];
      if (v != j) continue;
      float cu = S.ctrl[u];
      if (mi[MJ_I_ACTLIM + u]) cu = mj_min(mj_max(cu, mf[MJ_F_CLO + u]), mf[MJ_F_CHI + u]);
      const float gear = mf[MJ_F_GEAR + u];
      if (gainbias) {
        const float* b = mf + MJ_F_BIAS + 3 * u;
        cu = mf[MJ_F_GAIN + u] * cu + b[0] + b[1] * (gear * S.q[mi[MJ_I_ACTQ + u]]) +
             b[2] * (gear * S.qd[v]);
      }
      rhs += gear * cu;
    }
    for (int i = 0; i < nlink; ++i) {
      if ((type[i] != MJ_HINGE && type[i] != MJ_SLIDE) || vadr[i] != j) continue;
      const float qi = S.q[qadr[i]];
      const float stiff = mf[MJ_F_STIFF + i];
      if (stiff != 0.0f) rhs += -stiff * (qi - mf[MJ_F_SPRINGREF + i]);
      if constexpr (LIMITS) {
        if (mi[MJ_I_LIMITED + i]) {
          const float viol = mj_limit_viol(mf, i, qi);
          const bool active = fabsf(viol) > 0.0f;
          rhs += -mf[MJ_F_LIMK + j] * viol - (active ? mf[MJ_F_LIMC + j] * S.qd[j] : 0.0f);
          if (active) S.ldiag[j] = mf[MJ_F_LIMDTC + j];
        }
      }
    }
    if constexpr (EXT) {
      if (nt) {
        float tau = 0.0f;
        for (int t = 0; t < nt; ++t)
          for (int e = vptr[t]; e < vptr[t + 1]; ++e)
            if (vidx[e] == j) tau += vval[e] * S.s.ften[t];
        rhs = rhs + tau;
      }
    }
    S.qdd0[j] = rhs - S.bias[j] - mf[MJ_F_DAMP + j] * S.qd[j];
  });
}

// The tree-sparse mass matrix S.M from the composite inertias; with
// METRIC the Newton metric M + diag(armature + dt damping) in S.Mf; with
// EXT frictionloss (engine.py friction_terms): its force -fl tanh(qd /
// v_eps) into S.qdd0 and its dt-scaled Jacobian dt (fl / v_eps) (1 -
// tanh^2), with METRIC into S.fdiag and onto the metric, without it onto
// the implicit diagonal S.ldiag (after the limit damper).
template <bool METRIC, bool EXT, class W, class Env>
MJ_WD void mj_warp_crb(W& w, Env& S, const float* mf, const int* mi, float dt) {
  const int nlink = mi[MJ_I_NLINK], nv = mi[MJ_I_NV];
  const int* parent = mi + MJ_I_PARENT;
  const int* dof_link = mi + MJ_I_DOFLINK;
  const int* lam = mi + MJ_I_LAM;
  const MjKin& k = S.k;
  auto& C = S.s.crb;
  w.each(nlink, [&](int i) {
    for (int c = 0; c < 3; ++c) C.ch[i][c] = k.ih[i][c];
    for (int c = 0; c < 6; ++c) C.cI[i][c] = k.iI[i][c];
  });
  w.one([&] {
    for (int i = nlink - 1; i >= 0; --i) {
      const int p = parent[i];
      if (p < 0) continue;
      for (int c = 0; c < 3; ++c) C.ch[p][c] += C.ch[i][c];
      for (int c = 0; c < 6; ++c) C.cI[p][c] += C.cI[i][c];
    }
  });
  w.each(nv, [&](int j) {
    const int l = dof_link[j];
    mj_inertia_mul(mf[MJ_F_CMASS + l], C.ch[l], C.cI[l], k.cdof[j], C.F[j]);
  });
  w.each(nv, [&](int i) {
    for (int j = i; j >= 0; j = lam[j]) S.M[i][j] = mj_dot6(C.F[i], k.cdof[j]);
    if constexpr (METRIC) {
      for (int j = 0; j <= i; ++j) S.Mf[i][j] = 0.0f;
      for (int j = i; j >= 0; j = lam[j]) S.Mf[i][j] = S.M[i][j];
      S.Mf[i][i] = S.Mf[i][i] + mf[MJ_F_EXTRA + i];
      if (EXT && mi[MJ_I_HAS_FRIC] != 0) {
        const float fl = mf[MJ_F_FRIC + i], v_eps = mf[MJ_F_FVEPS];
        const float t = tanhf(S.qd[i] / v_eps);
        S.qdd0[i] = S.qdd0[i] + -fl * t;
        S.fdiag[i] = dt * ((fl / v_eps) * (1.0f - t * t));
        S.Mf[i][i] = S.Mf[i][i] + S.fdiag[i];
      }
    } else if constexpr (EXT) {
      if (mi[MJ_I_HAS_FRIC] != 0) {
        const float fl = mf[MJ_F_FRIC + i], v_eps = mf[MJ_F_FVEPS];
        const float t = tanhf(S.qd[i] / v_eps);
        S.qdd0[i] = S.qdd0[i] + -fl * t;
        S.ldiag[i] = S.ldiag[i] + dt * ((fl / v_eps) * (1.0f - t * t));
      }
    }
  });
}

// Each dof's ancestors on the dof tree (its lam chain, parent first) in
// S.anc[k][0 .. S.nanc[k]); returns the most any dof has.
template <class W, class Env>
MJ_WD int mj_warp_chains(W& w, Env& S, const int* mi) {
  const int nv = mi[MJ_I_NV];
  const int* lam = mi + MJ_I_LAM;
  w.each(nv, [&](int k) {
    int n = 0;
    for (int j = lam[k]; j >= 0; j = lam[j]) S.anc[k][n++] = (unsigned char)j;
    S.nanc[k] = (unsigned char)n;
  });
  int most = 0;
  for (int k = 0; k < nv; ++k) most = S.nanc[k] > most ? S.nanc[k] : most;
  return most;
}

// mj_ltdl_solve of S.M + diag(armature + dt damping + lim_diag) with x in
// place, over lanes; each entry of the factor and of x takes the same
// operations in the same order (maxa: mj_warp_chains' most ancestors).
// Column k (from the last): d = H[k][k]; lane p takes k's p-th ancestor
// i, and H[i][j] -= (H[k][i] / d) H[k][j] for j = i and i's ancestors;
// the next phase overwrites H[k][i] with H[k][i] / d (no lane of column k
// reads it after), together with column k - 1's updates, which touch
// neither row k nor what column k's division reads.
template <class W, class Env>
MJ_WD void mj_warp_ltdl(W& w, Env& S, const float* mf, const int* mi, const float* lim_diag,
                        float* x, int maxa) {
  const int nv = mi[MJ_I_NV];
  auto& H = S.M;
  w.each(nv, [&](int k) { H[k][k] = H[k][k] + mf[MJ_F_EXTRA + k] + lim_diag[k]; });
  for (int k = nv - 1; k >= -1; --k) {
    const int nk = k >= 0 ? S.nanc[k] : 0, nd = k + 1 < nv ? S.nanc[k + 1] : 0;
    w.each(nk > nd ? nk : nd, [&](int p) {
      if (p < nd) {  // column k + 1's division
        const int d = k + 1, i = S.anc[d][p];
        const float inv_d = 1.0f / H[d][d];
        H[d][i] = H[d][i] * inv_d;
      }
      if (p < nk) {  // column k's updates of ancestor p's row
        const int i = S.anc[k][p];
        const float inv_d = 1.0f / H[k][k];
        const float a = H[k][i] * inv_d;
        for (int q = p; q < nk; ++q) {
          const int j = S.anc[k][q];
          H[i][j] -= a * H[k][j];
        }
      }
    });
  }
  for (int i = nv - 1; i >= 0; --i)
    w.each(S.nanc[i], [&](int p) {
      const int j = S.anc[i][p];
      x[j] -= H[i][j] * x[i];
    });
  w.each(nv, [&](int i) { x[i] = x[i] / H[i][i]; });
  for (int d = 1; d <= maxa; ++d)
    w.each(nv, [&](int i) {
      if (S.nanc[i] != d) return;
      for (int p = 0; p < d; ++p) x[i] -= H[i][S.anc[i][p]] * x[S.anc[i][p]];
    });
}
