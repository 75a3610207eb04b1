// The table-driven layout, helpers and scalar stages every kernel body
// builds on.
//
// Kernels K1 and K3 (mj_warp_penalty.h), K2 and K4 (mj_warp_newton.h) run
// one env per warp on mj_warp_stages.h's stages. They take from here the
// model's packed layout, the scalar helpers, the narrow phase (per pair,
// with the box kinds as its EXT branch), and the one-lane stages
// mj_ltdl_solve (K2's and K4's unconstrained solve) and mj_integrate;
// mj_kinematics (the whole tree on one thread, the order of operations the
// warp bodies keep link by link) serves the host exports (mj_host.cpp).
//
// Every function is MJ_HD: __host__ __device__ under nvcc, plain inline
// under a host compiler, so the same source builds into the CUDA library
// and into a host library that the CPU tests check against the plain
// PyTorch version (mjrl_tpu_torch/physics/soa.py).
//
// The model arrives as two packed buffers (mf: f32, mi: i32) that
// physics/pkernel.py fills; the offsets below are the layout, exported by
// mj_layout() so the packer reads them instead of repeating them. Per-env
// arrays are sized by the compile-time maxima; the packer refuses a model
// that exceeds them or uses a feature a body does not have.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define MJ_HD __host__ __device__ __forceinline__
#else
#define MJ_HD inline
#endif

// The compile-time maxima size every per-env array. The defaults are the
// small size class (ant, the planar walkers, swimmer); physics/pkernel.py
// builds a larger class with -DMJ_MAX_LINK=... etc. for bigger models
// (humanoid) and picks the smallest class a model fits, so the small
// models keep their stack.
#ifndef MJ_MAX_LINK
#define MJ_MAX_LINK 16
#endif
#ifndef MJ_MAX_NV
#define MJ_MAX_NV 16
#endif
#ifndef MJ_MAX_NQ
#define MJ_MAX_NQ 24
#endif
#ifndef MJ_MAX_NU
#define MJ_MAX_NU 16
#endif

#define MJ_FREE 0
#define MJ_HINGE 2
#define MJ_SLIDE 3
#define MJ_KIND_SPHERE_PLANE 0
#define MJ_KIND_CAPSULE_PLANE 1
#define MJ_KIND_CAPSULE_CAPSULE 2
#define MJ_KIND_SPHERE_SPHERE 3
#define MJ_KIND_SPHERE_CAPSULE 4  // geom i the sphere, geom j the capsule
// The box kinds, EXT only; geom j is the box (box_plane: geom i).
#define MJ_KIND_BOX_PLANE 5
#define MJ_KIND_SPHERE_BOX 6
#define MJ_KIND_CAPSULE_BOX 7
#define MJ_KIND_BOX_BOX 8

// ---- int table --------------------------------------------------------
#define MJ_I_NLINK 0
#define MJ_I_NQ 1
#define MJ_I_NV 2
#define MJ_I_NU 3
#define MJ_I_NPAIR 4
#define MJ_I_HAS_FCAP 5
#define MJ_I_HAS_FLUID 6  // density or viscosity != 0: the fluid drag
// EXT: affine gain/bias actuators, frictionloss, and the fixed tendons,
// whose block starts at mi[MJ_I_TEN_I] and mf[MJ_I_TEN_F] (after the pairs)
#define MJ_I_HAS_GAINBIAS 7
#define MJ_I_HAS_FRIC 8
#define MJ_I_NTEN 9
#define MJ_I_TEN_I 10
#define MJ_I_TEN_F 11
#define MJ_I_PARENT 16
#define MJ_I_TYPE (MJ_I_PARENT + MJ_MAX_LINK)
#define MJ_I_QADR (MJ_I_TYPE + MJ_MAX_LINK)
#define MJ_I_VADR (MJ_I_QADR + MJ_MAX_LINK)
#define MJ_I_LIMITED (MJ_I_VADR + MJ_MAX_LINK)
#define MJ_I_DOFLINK (MJ_I_LIMITED + MJ_MAX_LINK)
#define MJ_I_LAM (MJ_I_DOFLINK + MJ_MAX_NV)
#define MJ_I_ACTV (MJ_I_LAM + MJ_MAX_NV)
#define MJ_I_ACTLIM (MJ_I_ACTV + MJ_MAX_NU)
#define MJ_I_ACTQ (MJ_I_ACTLIM + MJ_MAX_NU)  // EXT: qpos address of a servo
#define MJ_I_PAIR (MJ_I_ACTQ + MJ_MAX_NU)
#define MJ_PAIR_I 4  // kind, li, lj, unused

// ---- float table ------------------------------------------------------
#define MJ_F_GRAV 0
#define MJ_F_KS 3
#define MJ_F_KD 4
#define MJ_F_CAP 5
#define MJ_F_FCAP 6
#define MJ_F_VREG 7
#define MJ_F_LPOS 8
#define MJ_F_LQUAT (MJ_F_LPOS + 3 * MJ_MAX_LINK)
#define MJ_F_AXIS (MJ_F_LQUAT + 4 * MJ_MAX_LINK)
#define MJ_F_ANCHOR (MJ_F_AXIS + 3 * MJ_MAX_LINK)
#define MJ_F_REF (MJ_F_ANCHOR + 3 * MJ_MAX_LINK)
#define MJ_F_RANGE (MJ_F_REF + MJ_MAX_LINK)
#define MJ_F_STIFF (MJ_F_RANGE + 2 * MJ_MAX_LINK)
#define MJ_F_SPRINGREF (MJ_F_STIFF + MJ_MAX_LINK)
#define MJ_F_MASS (MJ_F_SPRINGREF + MJ_MAX_LINK)
#define MJ_F_COM (MJ_F_MASS + MJ_MAX_LINK)
#define MJ_F_EIGD (MJ_F_COM + 3 * MJ_MAX_LINK)
#define MJ_F_EIGQ (MJ_F_EIGD + 3 * MJ_MAX_LINK)  // link i, column k: 9 i + 3 k
#define MJ_F_CMASS (MJ_F_EIGQ + 9 * MJ_MAX_LINK)
#define MJ_F_DAMP (MJ_F_CMASS + MJ_MAX_LINK)
#define MJ_F_EXTRA (MJ_F_DAMP + MJ_MAX_NV)  // armature + dt * damping
#define MJ_F_LIMK (MJ_F_EXTRA + MJ_MAX_NV)
#define MJ_F_LIMC (MJ_F_LIMK + MJ_MAX_NV)
#define MJ_F_LIMDTC (MJ_F_LIMC + MJ_MAX_NV)  // dt * limit damping
#define MJ_F_GEAR (MJ_F_LIMDTC + MJ_MAX_NV)
#define MJ_F_CLO (MJ_F_GEAR + MJ_MAX_NU)
#define MJ_F_CHI (MJ_F_CLO + MJ_MAX_NU)
// Fluid model, per link: the quaternion of its principal inertia frame
// (link_iquat), then 8 drag constants lin, ang, quad_f[3], quad_t[3]
// (physics/soa.py fluid_coefficients: folded on the host from link_ibox,
// density and viscosity as the plain version folds them).
#define MJ_F_IQUAT (MJ_F_CHI + MJ_MAX_NU)
#define MJ_F_FLUID (MJ_F_IQUAT + 4 * MJ_MAX_LINK)
#define MJ_FLUID_F 8
// EXT: servo gain g0 and bias b0, b1, b2 per actuator; frictionloss per
// dof and its velocity scale v_eps
#define MJ_F_GAIN (MJ_F_FLUID + MJ_FLUID_F * MJ_MAX_LINK)
#define MJ_F_BIAS (MJ_F_GAIN + MJ_MAX_NU)
#define MJ_F_FRIC (MJ_F_BIAS + 3 * MJ_MAX_NU)
#define MJ_F_FVEPS (MJ_F_FRIC + MJ_MAX_NV)
#define MJ_F_PAIR (MJ_F_FVEPS + 4)
// A pair row: mu, then geom i's size[3] (radius, half length or the box's
// half-sizes), local pos[3] and quat[4] (slots 1-10), then geom j from
// slot 11: a plane's world normal[3] and point[3], or its size[3], local
// pos[3], quat[4].
#define MJ_PAIR_F 21
#define MJ_PAIR_GJ 11
// The tendon block (EXT), compressed rows of Jq and Jv:
//   ints   nt qptr[nt + 1] qidx[nnz_q] vptr[nt + 1] vidx[nnz_v]
//   floats P[nt][8] qval[nnz_q] vval[nnz_v]
// P per tendon: stiffness, spring length, damping, range lo, range hi,
// limit stiffness, limit damping, limited.

// The layout as the packer reads it, in this order.
#define MJ_LAYOUT_LEN 65
#define MJ_LAYOUT_VALUES                                                     \
  MJ_MAX_LINK, MJ_MAX_NV, MJ_MAX_NQ, MJ_MAX_NU, MJ_PAIR_I, MJ_PAIR_F,        \
      MJ_PAIR_GJ,                                                            \
      MJ_I_NLINK, MJ_I_NQ, MJ_I_NV, MJ_I_NU, MJ_I_NPAIR, MJ_I_HAS_FCAP,      \
      MJ_I_PARENT, MJ_I_TYPE, MJ_I_QADR, MJ_I_VADR, MJ_I_LIMITED,            \
      MJ_I_DOFLINK, MJ_I_LAM, MJ_I_ACTV, MJ_I_ACTLIM, MJ_I_PAIR, MJ_F_GRAV,  \
      MJ_F_KS, MJ_F_KD, MJ_F_CAP, MJ_F_FCAP, MJ_F_VREG, MJ_F_LPOS,           \
      MJ_F_LQUAT, MJ_F_AXIS, MJ_F_ANCHOR, MJ_F_REF, MJ_F_RANGE, MJ_F_STIFF,  \
      MJ_F_SPRINGREF, MJ_F_MASS, MJ_F_COM, MJ_F_EIGD, MJ_F_EIGQ, MJ_F_CMASS, \
      MJ_F_DAMP, MJ_F_EXTRA, MJ_F_LIMK, MJ_F_LIMC, MJ_F_LIMDTC, MJ_F_GEAR,   \
      MJ_F_CLO, MJ_F_CHI, MJ_F_PAIR, MJ_I_HAS_FLUID, MJ_F_IQUAT, MJ_F_FLUID,  \
      MJ_FLUID_F, MJ_I_HAS_GAINBIAS, MJ_I_HAS_FRIC, MJ_I_NTEN, MJ_I_TEN_I,   \
      MJ_I_TEN_F, MJ_I_ACTQ, MJ_F_GAIN, MJ_F_BIAS, MJ_F_FRIC, MJ_F_FVEPS

// ---- scalar helpers ---------------------------------------------------

// dofs of a joint type (fixed links: none)
MJ_HD int mj_jnt_nv(int type) {
  return type == MJ_FREE ? 6 : ((type == MJ_HINGE || type == MJ_SLIDE) ? 1 : 0);
}

// min/max that pass NaN through, like torch.clamp and jnp.minimum: the
// env's blow-up guard has to see non-finite states.
MJ_HD float mj_max(float a, float b) { return (a != a || a > b) ? a : b; }
MJ_HD float mj_min(float a, float b) { return (a != a || a < b) ? a : b; }

MJ_HD void mj_cross(const float* a, const float* b, float* out) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  out[0] = x;
  out[1] = y;
  out[2] = z;
}

MJ_HD float mj_dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

MJ_HD float mj_dot6(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] + a[4] * b[4] +
         a[5] * b[5];
}

MJ_HD void mj_qmul(const float* a, const float* b, float* out) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  out[0] = w;
  out[1] = x;
  out[2] = y;
  out[3] = z;
}

// v + w t + qv x t with t = 2 qv x v
MJ_HD void mj_qrot(const float* q, const float* v, float* out) {
  float t[3], c[3];
  mj_cross(q + 1, v, t);
  t[0] *= 2.0f;
  t[1] *= 2.0f;
  t[2] *= 2.0f;
  mj_cross(q + 1, t, c);
  for (int k = 0; k < 3; ++k) out[k] = v[k] + q[0] * t[k] + c[k];
}

// Rotation by the conjugate of q (world -> body axes).
MJ_HD void mj_qrot_inv(const float* q, const float* v, float* out) {
  const float qc[4] = {q[0], -q[1], -q[2], -q[3]};
  mj_qrot(qc, v, out);
}

MJ_HD void mj_qnorm(float* q) {
  float s = 1.0f / sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] +
                         1e-12f);
  for (int k = 0; k < 4; ++k) q[k] *= s;
}

// Spatial inertia (mass, h = m com, I symmetric as 00 01 02 11 12 22)
// times a motion vector [w, v] -> force vector [n, f].
MJ_HD void mj_inertia_mul(float mass, const float* h, const float* I,
                          const float* m, float* out) {
  const float* w = m;
  const float* lin = m + 3;
  float hl[3], hw[3];
  mj_cross(h, lin, hl);
  mj_cross(h, w, hw);
  out[0] = I[0] * w[0] + I[1] * w[1] + I[2] * w[2] + hl[0];
  out[1] = I[1] * w[0] + I[3] * w[1] + I[4] * w[2] + hl[1];
  out[2] = I[2] * w[0] + I[4] * w[1] + I[5] * w[2] + hl[2];
  for (int k = 0; k < 3; ++k) out[3 + k] = mass * lin[k] - hw[k];
}

// crm(v) m: motion x motion
MJ_HD void mj_crm(const float* v, const float* m, float* out) {
  float a[3], b[3], c[3];
  mj_cross(v, m, a);
  mj_cross(v, m + 3, b);
  mj_cross(v + 3, m, c);
  for (int k = 0; k < 3; ++k) {
    out[k] = a[k];
    out[3 + k] = b[k] + c[k];
  }
}

// crf(v) f: motion x force
MJ_HD void mj_crf(const float* v, const float* f, float* out) {
  float a[3], b[3], c[3];
  mj_cross(v, f, a);
  mj_cross(v + 3, f + 3, b);
  mj_cross(v, f + 3, c);
  for (int k = 0; k < 3; ++k) {
    out[k] = a[k] + b[k];
    out[3 + k] = c[k];
  }
}

MJ_HD float mj_limit_viol(const float* mf, int i, float qi) {
  return mj_min(qi - mf[MJ_F_RANGE + 2 * i], 0.0f) +
         mj_max(qi - mf[MJ_F_RANGE + 2 * i + 1], 0.0f);
}

// ---- pipeline stages ------------------------------------------------------

// Kinematic state of one env in one substep: world link poses, the origin
// (link 0's position), motion subspaces and velocities about it, and the
// world inertias (h = m com, I as 00 01 02 11 12 22).
struct MjKin {
  float pos[MJ_MAX_LINK][3], quat[MJ_MAX_LINK][4], origin[3];
  float cdof[MJ_MAX_NV][6], cvel[MJ_MAX_LINK][6];
  float ih[MJ_MAX_LINK][3], iI[MJ_MAX_LINK][6];
};

// delta (EXT, or nullptr): this env's offsets of each link's position in
// its parent's frame, 3 per link.
MJ_HD void mj_kinematics(const float* mf, const int* mi, const float* q,
                         const float* qd, MjKin& k,
                         const float* delta = nullptr) {
  const int nlink = mi[MJ_I_NLINK];
  const int* parent = mi + MJ_I_PARENT;
  const int* type = mi + MJ_I_TYPE;
  const int* qadr = mi + MJ_I_QADR;
  const int* vadr = mi + MJ_I_VADR;
  float(*pos)[3] = k.pos;
  float(*quat)[4] = k.quat;

  // world link poses
  for (int i = 0; i < nlink; ++i) {
    const float* lp = mf + MJ_F_LPOS + 3 * i;
    const float* lq = mf + MJ_F_LQUAT + 4 * i;
    float lpd[3];
    if (delta) {
      for (int c = 0; c < 3; ++c) lpd[c] = lp[c] + delta[3 * i + c];
      lp = lpd;
    }
    float rel_p[3], rel_q[4];
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
    const int p = parent[i];
    if (p < 0) {
      for (int c = 0; c < 3; ++c) pos[i][c] = rel_p[c];
      for (int c = 0; c < 4; ++c) quat[i][c] = rel_q[c];
    } else {
      float r[3];
      mj_qrot(quat[p], rel_p, r);
      for (int c = 0; c < 3; ++c) pos[i][c] = pos[p][c] + r[c];
      mj_qmul(quat[p], rel_q, quat[i]);
    }
  }
  for (int c = 0; c < 3; ++c) k.origin[c] = pos[0][c];
  const float* origin = k.origin;

  // motion subspaces about the origin, and link velocities
  float(*cdof)[6] = k.cdof;
  for (int i = 0; i < nlink; ++i) {
    const int v = vadr[i];
    if (type[i] == MJ_HINGE) {
      float axis_w[3], r[3], anchor_w[3];
      mj_qrot(quat[i], mf + MJ_F_AXIS + 3 * i, axis_w);
      mj_qrot(quat[i], mf + MJ_F_ANCHOR + 3 * i, r);
      for (int c = 0; c < 3; ++c) anchor_w[c] = pos[i][c] - origin[c] + r[c];
      for (int c = 0; c < 3; ++c) cdof[v][c] = axis_w[c];
      mj_cross(anchor_w, axis_w, cdof[v] + 3);
    } else if (type[i] == MJ_SLIDE) {
      mj_qrot(quat[i], mf + MJ_F_AXIS + 3 * i, cdof[v] + 3);
      for (int c = 0; c < 3; ++c) cdof[v][c] = 0.0f;
    } else if (type[i] == MJ_FREE) {
      float p_rel[3];
      for (int c = 0; c < 3; ++c) p_rel[c] = pos[i][c] - origin[c];
      for (int a = 0; a < 3; ++a) {
        float e[3] = {0.0f, 0.0f, 0.0f}, ew[3];
        e[a] = 1.0f;
        mj_qrot(quat[i], e, ew);
        for (int c = 0; c < 3; ++c) {
          cdof[v + a][c] = ew[c];
          cdof[v + 3 + a][c] = 0.0f;
          cdof[v + 3 + a][3 + c] = ew[c];
        }
        mj_cross(p_rel, ew, cdof[v + a] + 3);
      }
    }
  }
  float(*cvel)[6] = k.cvel;
  for (int i = 0; i < nlink; ++i) {
    const int p = parent[i];
    for (int c = 0; c < 6; ++c) cvel[i][c] = p < 0 ? 0.0f : cvel[p][c];
    const int nd = mj_jnt_nv(type[i]);
    for (int d = 0; d < nd; ++d)
      for (int c = 0; c < 6; ++c) cvel[i][c] += cdof[vadr[i] + d][c] * qd[vadr[i] + d];
  }

  // world inertias about the origin
  for (int i = 0; i < nlink; ++i) {
    const float m = mf[MJ_F_MASS + i];
    float com_w[3], r[3];
    mj_qrot(quat[i], mf + MJ_F_COM + 3 * i, r);
    for (int c = 0; c < 3; ++c) com_w[c] = pos[i][c] - origin[c] + r[c];
    float cols[3][3];
    const float* d = mf + MJ_F_EIGD + 3 * i;
    for (int c = 0; c < 3; ++c)
      if (d[c] != 0.0f) mj_qrot(quat[i], mf + MJ_F_EIGQ + 9 * i + 3 * c, cols[c]);
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
}

// World pose of a geom on link l (world geom for l < 0) from its local
// pos (3) and quat (4).
MJ_HD void mj_geom_pose(const MjKin& k, int l, const float* lp, const float* lq,
                        float* gp, float* gq) {
  if (l < 0) {
    for (int c = 0; c < 3; ++c) gp[c] = lp[c];
    for (int c = 0; c < 4; ++c) gq[c] = lq[c];
  } else {
    float rr[3];
    mj_qrot(k.quat[l], lp, rr);
    for (int c = 0; c < 3; ++c) gp[c] = k.pos[l][c] + rr[c];
    mj_qmul(k.quat[l], lq, gq);
  }
}

MJ_HD float mj_clamp01(float x) { return mj_min(mj_max(x, 0.0f), 1.0f); }

// Capsule axis segment: start p = c - hl * axis and direction d = 2 hl axis.
MJ_HD void mj_capsule_segment(const float* gp, const float* gq, float hl,
                              float* p, float* d) {
  const float z[3] = {0.0f, 0.0f, 1.0f};
  float axis[3];
  mj_qrot(gq, z, axis);
  const float two_hl = 2.0f * hl;
  for (int c = 0; c < 3; ++c) {
    p[c] = gp[c] - hl * axis[c];
    d[c] = two_hl * axis[c];
  }
}

// Sphere-sphere contact between centres c1 (radius r1, geom i) and c2
// (r2, geom j): depth, the normal from j to i, and the point inside the
// overlap (soa.py sphere_sphere). The capsule kinds end in it.
template <class Sink>
MJ_HD void mj_sphere_sphere(int pi, int li, int lj, float mu, const float* c1,
                            float r1, const float* c2, float r2, Sink& sink) {
  float d[3];
  for (int c = 0; c < 3; ++c) d[c] = c1[c] - c2[c];
  const float dist = sqrtf(mj_dot3(d, d)) + 1e-12f;
  float n[3], pt[3];
  for (int c = 0; c < 3; ++c) n[c] = d[c] / dist;
  const float depth = (r1 + r2) - dist;
  const float back = r2 - 0.5f * mj_max(depth, 0.0f);
  for (int c = 0; c < 3; ++c) pt[c] = c2[c] + n[c] * back;
  sink(pi, li, lj, mu, depth, n, pt);
}

// Sphere-capsule: the sphere (geom i) against the closest point of the
// capsule's axis segment, t clamped to [0, 1] (soa.py sphere_capsule).
template <class Sink>
MJ_HD void mj_sphere_capsule(int pi, int li, int lj, float mu, const float* c1,
                             float r1, const float* gp2, const float* gq2,
                             float r2, float hl2, Sink& sink) {
  float a[3], d[3], ca[3], c2[3];
  mj_capsule_segment(gp2, gq2, hl2, a, d);
  for (int c = 0; c < 3; ++c) ca[c] = c1[c] - a[c];
  const float t = mj_clamp01(mj_dot3(ca, d) / (mj_dot3(d, d) + 1e-12f));
  for (int c = 0; c < 3; ++c) c2[c] = a[c] + t * d[c];
  mj_sphere_sphere(pi, li, lj, mu, c1, r1, c2, r2, sink);
}

// Capsule-capsule: the closest points of the two axis segments (the
// reference's clamps, soa.py capsule_capsule), then a sphere-sphere contact
// between them with the normal from j to i.
template <class Sink>
MJ_HD void mj_capsule_capsule(int pi, int li, int lj, float mu, const float* gp1,
                              const float* gq1, float r1, float hl1,
                              const float* gp2, const float* gq2, float r2,
                              float hl2, Sink& sink) {
  float p1[3], d1[3], p2[3], d2[3], rr[3];
  mj_capsule_segment(gp1, gq1, hl1, p1, d1);
  mj_capsule_segment(gp2, gq2, hl2, p2, d2);
  for (int c = 0; c < 3; ++c) rr[c] = p1[c] - p2[c];
  const float a = mj_dot3(d1, d1) + 1e-12f;
  const float e = mj_dot3(d2, d2) + 1e-12f;
  const float b = mj_dot3(d1, d2);
  const float cc = mj_dot3(d1, rr);
  const float f = mj_dot3(d2, rr);
  const float denom = a * e - b * b;
  float s = fabsf(denom) > 1e-9f ? (b * f - cc * e) / (denom + 1e-12f) : 0.0f;
  s = mj_clamp01(s);
  const float t = mj_clamp01((b * s + f) / e);
  s = mj_clamp01((b * t - cc) / a);
  float c1[3], c2[3];
  for (int c = 0; c < 3; ++c) {
    c1[c] = p1[c] + s * d1[c];
    c2[c] = p2[c] + t * d2[c];
  }
  mj_sphere_sphere(pi, li, lj, mu, c1, r1, c2, r2, sink);
}

// ---- the box kinds (EXT) ------------------------------------------------

// One-hot of the smallest of three gaps, the first on a tie (soa.py
// min_axis_onehot).
MJ_HD void mj_min_axis_onehot(const float* gap, float* o) {
  o[0] = (gap[0] <= gap[1] && gap[0] <= gap[2]) ? 1.0f : 0.0f;
  o[1] = (1.0f - o[0]) * (gap[1] <= gap[2] ? 1.0f : 0.0f);
  o[2] = 1.0f - o[0] - o[1];
}

// Sphere centre c (radius r) against the box at pb, qb with half-sizes sb:
// depth, the normal from the box (world) and the point (soa.py sphere_box).
MJ_HD void mj_sphere_box(const float* c, float r, const float* pb,
                         const float* qb, const float* sb, float& depth,
                         float* n, float* pt) {
  float d[3], p[3], clamped[3], delta[3], gap[3], o[3], nb[3];
  for (int a = 0; a < 3; ++a) d[a] = c[a] - pb[a];
  mj_qrot_inv(qb, d, p);
  for (int a = 0; a < 3; ++a) {
    clamped[a] = mj_min(mj_max(p[a], -sb[a]), sb[a]);
    delta[a] = p[a] - clamped[a];
    gap[a] = sb[a] - fabsf(p[a]);
  }
  const float d_out = sqrtf(mj_dot3(delta, delta));
  const bool inside = d_out < 1e-9f;
  mj_min_axis_onehot(gap, o);
  const float gmin = mj_min(mj_min(gap[0], gap[1]), gap[2]);
  for (int a = 0; a < 3; ++a)
    nb[a] = inside ? o[a] * (p[a] >= 0.0f ? 1.0f : -1.0f)
                   : delta[a] / (d_out + 1e-12f);
  depth = inside ? r + gmin : r - d_out;
  mj_qrot(qb, nb, n);
  float w[3];
  mj_qrot(qb, clamped, w);
  for (int a = 0; a < 3; ++a) pt[a] = pb[a] + w[a];
}

// The corners of box a (pa, qa, half-sizes sa) against box b, in the
// reference's corner order, each with the normal from b times sign (soa.py
// box_corners_in_box; box_box's second pass negates it).
template <class Sink>
MJ_HD void mj_box_corners(int pi, int li, int lj, float mu, const float* pa,
                          const float* qa, const float* sa, const float* pb,
                          const float* qb, const float* sb, float sign,
                          Sink& sink) {
  for (int c = 0; c < 8; ++c) {
    const float loc[3] = {(c & 4) ? sa[0] : -sa[0], (c & 2) ? sa[1] : -sa[1],
                          (c & 1) ? sa[2] : -sa[2]};
    float corner[3], d[3], p[3], gap[3], o[3], nb[3], n[3];
    mj_qrot(qa, loc, corner);
    for (int a = 0; a < 3; ++a) {
      corner[a] = pa[a] + corner[a];
      d[a] = corner[a] - pb[a];
    }
    mj_qrot_inv(qb, d, p);
    for (int a = 0; a < 3; ++a) gap[a] = sb[a] - fabsf(p[a]);
    mj_min_axis_onehot(gap, o);
    for (int a = 0; a < 3; ++a) nb[a] = o[a] * (p[a] >= 0.0f ? 1.0f : -1.0f);
    mj_qrot(qb, nb, n);
    for (int a = 0; a < 3; ++a) n[a] = sign * n[a];
    sink(pi, li, lj, mu, mj_min(mj_min(gap[0], gap[1]), gap[2]), n, corner);
  }
}

// A box kind's contact points: box_plane (8 corners against the plane),
// sphere_box, capsule_box (3 spheres along the axis) and box_box (16
// corners). gp, gq, si: geom i's pose and size; gj: geom j's row.
template <class Sink>
MJ_HD void mj_box_kinds(const MjKin& k, int kind, int pi, int li, int lj,
                        float mu, const float* gp, const float* gq,
                        const float* si, const float* gj, Sink& sink) {
  if (kind == MJ_KIND_BOX_PLANE) {
    const float* n = gj;
    const float* pp = gj + 3;
    for (int c = 0; c < 8; ++c) {
      const float loc[3] = {(c & 4) ? si[0] : -si[0], (c & 2) ? si[1] : -si[1],
                            (c & 1) ? si[2] : -si[2]};
      float corner[3], d[3];
      mj_qrot(gq, loc, corner);
      for (int a = 0; a < 3; ++a) {
        corner[a] = gp[a] + corner[a];
        d[a] = corner[a] - pp[a];
      }
      sink(pi, li, lj, mu, -mj_dot3(d, n), n, corner);
    }
    return;
  }
  float gp2[3], gq2[4];
  mj_geom_pose(k, lj, gj + 3, gj + 6, gp2, gq2);
  if (kind == MJ_KIND_BOX_BOX) {
    mj_box_corners(pi, li, lj, mu, gp, gq, si, gp2, gq2, gj, 1.0f, sink);
    mj_box_corners(pi, li, lj, mu, gp2, gq2, gj, gp, gq, si, -1.0f, sink);
    return;
  }
  const float z[3] = {0.0f, 0.0f, 1.0f};
  float axis[3];
  mj_qrot(gq, z, axis);
  const int ns = kind == MJ_KIND_CAPSULE_BOX ? 3 : 1;
  for (int e = 0; e < ns; ++e) {
    // capsule_box: centres at -hl, 0, +hl along the axis
    const float off = ns == 1 ? 0.0f : (e == 0 ? -si[1] : (e == 1 ? 0.0f : si[1]));
    float c[3], n[3], pt[3], depth;
    for (int a = 0; a < 3; ++a) c[a] = gp[a] + off * axis[a];
    mj_sphere_box(ns == 1 ? gp : c, si[0], gp2, gq2, gj, depth, n, pt);
    sink(pi, li, lj, mu, depth, n, pt);
  }
}

// The contact points of pair pi, in the reference's sub-point order,
// handed to sink(pair, li, lj, mu, depth, n, pt). EXT adds the box kinds.
template <bool EXT = false, class Sink>
MJ_HD void mj_narrow_pair(const float* mf, const int* mi, const MjKin& k,
                          int pi, Sink& sink) {
  const int* pt_i = mi + MJ_I_PAIR + MJ_PAIR_I * pi;
  const float* pt_f = mf + MJ_F_PAIR + MJ_PAIR_F * pi;
  const int kind = pt_i[0], li = pt_i[1], lj = pt_i[2];
  const float mu = pt_f[0], r = pt_f[1], hl = pt_f[2];
  const float* gj = pt_f + MJ_PAIR_GJ;
  const float* n = gj;
  const float* pp = gj + 3;
  float gp[3], gq[4];
  mj_geom_pose(k, li, pt_f + 4, pt_f + 7, gp, gq);
  if (EXT && kind >= MJ_KIND_BOX_PLANE) {
    mj_box_kinds(k, kind, pi, li, lj, mu, gp, gq, pt_f + 1, gj, sink);
  } else if (kind >= MJ_KIND_CAPSULE_CAPSULE) {  // geom j on a link
    float gp2[3], gq2[4];
    mj_geom_pose(k, lj, gj + 3, gj + 6, gp2, gq2);
    if (kind == MJ_KIND_CAPSULE_CAPSULE)
      mj_capsule_capsule(pi, li, lj, mu, gp, gq, r, hl, gp2, gq2, gj[0],
                         gj[1], sink);
    else if (kind == MJ_KIND_SPHERE_SPHERE)
      mj_sphere_sphere(pi, li, lj, mu, gp, r, gp2, gj[0], sink);
    else
      mj_sphere_capsule(pi, li, lj, mu, gp, r, gp2, gq2, gj[0], gj[1], sink);
  } else if (kind == MJ_KIND_SPHERE_PLANE) {
    float d[3], pt[3];
    for (int c = 0; c < 3; ++c) d[c] = gp[c] - pp[c];
    const float depth = -(mj_dot3(d, n) - r);
    for (int c = 0; c < 3; ++c) pt[c] = gp[c] - n[c] * r;
    sink(pi, li, lj, mu, depth, n, pt);
  } else {  // MJ_KIND_CAPSULE_PLANE: both segment ends
    const float z[3] = {0.0f, 0.0f, 1.0f};
    float axis[3];
    mj_qrot(gq, z, axis);
    for (int e = 0; e < 2; ++e) {
      const float off = e == 0 ? -hl : hl;
      float end[3], d[3], pt[3];
      for (int c = 0; c < 3; ++c) end[c] = gp[c] + off * axis[c];
      for (int c = 0; c < 3; ++c) d[c] = end[c] - pp[c];
      const float depth = -(mj_dot3(d, n) - r);
      for (int c = 0; c < 3; ++c) pt[c] = end[c] - n[c] * r;
      sink(pi, li, lj, mu, depth, n, pt);
    }
  }
}

// Narrow phase: every contact point of every pair, in the reference's
// pair / sub-point order (mj_narrow_pair).
template <bool EXT = false, class Sink>
MJ_HD void mj_narrow_phase(const float* mf, const int* mi, const MjKin& k,
                           Sink& sink) {
  const int npair = mi[MJ_I_NPAIR];
  for (int pi = 0; pi < npair; ++pi) mj_narrow_pair<EXT>(mf, mi, k, pi, sink);
}

// Sparse L^T D L factorization (Featherstone RBDA 6.5) of
// M + diag(armature + dt*damping [+ lim_diag]) and solve, x in place (rhs
// in, solution out); L overwrites the strict lower part of H (rows of LD
// floats), D stays on its diagonal.
template <int LD>
MJ_HD void mj_ltdl_solve(const float* mf, const int* mi, float (*H)[LD],
                         const float* lim_diag, float* x) {
  const int nv = mi[MJ_I_NV];
  const int* lam = mi + MJ_I_LAM;
  if (lim_diag)
    for (int k = 0; k < nv; ++k) H[k][k] = H[k][k] + mf[MJ_F_EXTRA + k] + lim_diag[k];
  else
    for (int k = 0; k < nv; ++k) H[k][k] = H[k][k] + mf[MJ_F_EXTRA + k];
  for (int k = nv - 1; k >= 0; --k) {
    const float inv_d = 1.0f / H[k][k];
    for (int i = lam[k]; i >= 0; i = lam[i]) {
      const float a = H[k][i] * inv_d;
      for (int j = i; j >= 0; j = lam[j]) H[i][j] -= a * H[k][j];
      H[k][i] = a;
    }
  }
  for (int i = nv - 1; i >= 0; --i)
    for (int j = lam[i]; j >= 0; j = lam[j]) x[j] -= H[i][j] * x[i];
  for (int i = 0; i < nv; ++i) x[i] = x[i] / H[i][i];
  for (int i = 0; i < nv; ++i)
    for (int j = lam[i]; j >= 0; j = lam[j]) x[i] -= H[i][j] * x[j];
}

// Semi-implicit Euler; the free joint's quaternion by the exponential map.
MJ_HD void mj_integrate(const int* mi, float* q, float* qd, const float* qdd,
                        float dt) {
  const int nlink = mi[MJ_I_NLINK];
  const int nv = mi[MJ_I_NV];
  const int* type = mi + MJ_I_TYPE;
  const int* qadr = mi + MJ_I_QADR;
  const int* vadr = mi + MJ_I_VADR;
  for (int j = 0; j < nv; ++j) qd[j] = qd[j] + dt * qdd[j];
  for (int i = 0; i < nlink; ++i) {
    const int adr = qadr[i], v = vadr[i];
    if (type[i] == MJ_HINGE || type[i] == MJ_SLIDE) {
      q[adr] = q[adr] + dt * qd[v];
    } else if (type[i] == MJ_FREE) {
      float* p = q + adr;
      float* qu = q + adr + 3;
      const float* omega = qd + v;
      float r[3];
      mj_qrot(qu, qd + v + 3, r);
      for (int c = 0; c < 3; ++c) p[c] = p[c] + dt * r[c];
      const float angle = sqrtf(mj_dot3(omega, omega));
      float dq[4] = {1.0f, 0.0f, 0.0f, 0.0f};
      if (!(angle < 1e-9f)) {
        const float half = 0.5f * angle * dt;
        const float s = sinf(half);
        dq[0] = cosf(half);
        for (int c = 0; c < 3; ++c) dq[1 + c] = omega[c] / angle * s;
      }
      float nq[4];
      mj_qmul(qu, dq, nq);
      mj_qnorm(nq);
      for (int c = 0; c < 4; ++c) qu[c] = nq[c];
    }
  }
}
