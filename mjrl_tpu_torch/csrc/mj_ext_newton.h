// Kernel K4's body: Newton soft-constraint substeps of Adroit's models for
// one env, spread over the 32 lanes of a warp (mj_warp.h), the env's state
// in memory the lanes share (one MjWarpEnv per warp, in shared memory on
// the card).
//
// Replaces mjrl_tpu/physics/pkernel.py::_kernel_body_ext run with
// constraint_solver="newton" (soa_newton.constrained_qdd with fric_diag,
// mjrl_tpu/physics/soa.py:1056-1072, soa_newton.py:338). It computes what
// mjrl_tpu_torch/physics/soa.py::multistep computes for such a model: K3's
// stages (mj_substep.h with EXT: per-env link offsets, the box kinds,
// gain/bias servos, fixed tendons, frictionloss, whose dt-scaled diagonal
// joins both the L^T D L solve and the Newton metric) and K2's rows and
// Newton iterations (mj_newton.h), arranged over lanes:
//
// - rows: lanes over the limited joints, then over the contact pairs 32 at
//   a time; each lane counts its pair's points inside their margin, a warp
//   scan places them, and the lane runs its pair again to write them. So
//   the rows held are the first MJ_MAX_HELD inside their margin, in
//   narrow-phase order, as the plain version orders them; an env-substep
//   with more adds one to *overflow (the wrapper raises on it);
// - per link or per dof: the kinematics' relative poses, motion subspaces
//   and inertias, the RNE's link forces, the bias, the servos and springs,
//   the tendons (lanes over tendons, then each dof's sum in tendon order),
//   the mass matrix's columns, frictionloss; the forward tree walks (world
//   poses, velocities, the RNE's accelerations) level by level, lanes over
//   the links of a level; the backward sums (the RNE's forces, the
//   composite inertias) and the sparse L^T D L solve on one lane;
// - each Newton iteration: lanes over the facets' residuals; over dofs
//   for M d0 and the rows of M; then held row after held row, its gradient
//   and H terms (lanes over the row's chain dofs and the pairs of them); a
//   left-looking Cholesky, per column lanes over the pivot's row and the
//   rows below; the two triangular solves by columns, each
//   row in a lane's registers and each solved value broadcast by shuffle
//   (w.lower_solve, w.upper_solve); lanes over rows for the line search's
//   five costs,
//   summed in row order (w.sum). Each output has one lane at a time, and
//   its terms are added in the order of K2's scalar body (the backward
//   solve's in the reverse column order; w.sum's products rounded before
//   the add, as the plain version rounds them), so the sums that decide a
//   branch (the active set jar < 0, the first strict minimum of the
//   costs) are formed as K2's body forms them.
//
// The host build (mj_host.cpp) runs this same code under the emulated warp
// (MjWarpHost), one env after another.
#pragma once

#include "mj_newton.h"
#include "mj_warp.h"

#ifndef MJ_MAX_TEN
#define MJ_MAX_TEN 64  // fixed tendons (Adroit's models: 44)
#endif
#define MJ_MAX_WARPS 4  // warps (envs) per block at most
#define MJ_LD (MJ_MAX_NV + 1)  // a shared matrix's row

static_assert(MJ_MAX_NV <= 2 * MJ_WARP, "a lane holds two rows of a triangular solve");

// Stages of a substep, for the cycle counts of a MJ_STAGE_CLOCKS build.
enum {
  MJ_ST_KIN,    // loads, kinematics
  MJ_ST_ROWS,   // limit and contact rows
  MJ_ST_RNE,    // fluid drag, RNE bias
  MJ_ST_FORCE,  // servos, springs, tendons, damping
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

// One env's state for its control step, shared by the warp's lanes.
struct MjWarpEnv {
  float q[MJ_MAX_NQ], qd[MJ_MAX_NV], ctrl[MJ_MAX_NU], delta[3 * MJ_MAX_LINK];
  MjKin k;
  // the mass matrix, then its L^T D L factor, then each Newton
  // iteration's H and its Cholesky factor (lower triangles); rows padded
  // by one float, so that the lanes reading a column hit distinct banks
  float M[MJ_MAX_NV][MJ_LD];
  float Mf[MJ_MAX_NV][MJ_LD];  // the Newton metric
  float qdd0[MJ_MAX_NV], x[MJ_MAX_NV], d0[MJ_MAX_NV], Md0[MJ_MAX_NV],
      g[MJ_MAX_NV], dx[MJ_MAX_NV], Mdx[MJ_MAX_NV], dinv[MJ_MAX_NV],
      fdiag[MJ_MAX_NV], bias[MJ_MAX_NV];
  unsigned char depth[MJ_MAX_LINK];  // each link's depth in the tree
  union {  // one stage's scratch at a time
    struct {
      float rel_p[MJ_MAX_LINK][3], rel_q[MJ_MAX_LINK][4];
    } kin;
    struct {
      float f_ext[MJ_MAX_LINK][6], cacc[MJ_MAX_LINK][6], facc[MJ_MAX_LINK][6];
    } rne;
    float ften[MJ_MAX_TEN];
    struct {
      float ch[MJ_MAX_LINK][3], cI[MJ_MAX_LINK][6], F[MJ_MAX_NV][6];
    } crb;
  } s;
  // limit rows
  int lv[MJ_MAX_NV];
  float ls[MJ_MAX_NV], laref[MJ_MAX_NV], lD[MJ_MAX_NV], ljar[MJ_MAX_NV];
  // contact rows: pair, facets, the chain's dofs
  int pair[MJ_MAX_HELD], nfacet[MJ_MAX_HELD], nchain[MJ_MAX_HELD];
  unsigned char chain[MJ_MAX_HELD][MJ_MAX_CHAIN];
  float D[MJ_MAX_HELD], aref[MJ_MAX_HELD][MJ_MAX_FACET],
      jar[MJ_MAX_HELD][MJ_MAX_FACET], jd[MJ_MAX_HELD][MJ_MAX_FACET];
  float J[MJ_MAX_HELD][MJ_MAX_FACET][MJ_MAX_CHAIN];
  int cnt[MJ_WARP], off[MJ_WARP];  // the compaction's counts and slots
};

// The layout as the wrapper reads it (mj_warp_layout()): bytes of shared
// memory per warp, tendons, warps per block and stages at most.
#define MJ_WARP_LAYOUT_LEN 4
#define MJ_WARP_LAYOUT_VALUES \
  (int)sizeof(MjWarpEnv), MJ_MAX_TEN, MJ_MAX_WARPS, MJ_N_STAGES

// One count on the device-side counter *c (the held-row overflow).
MJ_HD void mj_count(int* c) {
#ifdef __CUDA_ARCH__
  atomicAdd(c, 1);
#else
  ++*c;
#endif
}

// (a, b), b <= a, of entry e of a lower triangle stored row by row.
MJ_HD void mj_tri(int e, int& a, int& b) {
  const float r = 8.0f * (float)e + 1.0f;
  a = (int)((r * mj_rsqrt(r) - 1.0f) * 0.5f);  // within one of the root
  while (a * (a + 1) / 2 > e) --a;
  while ((a + 1) * (a + 2) / 2 <= e) ++a;
  b = e - a * (a + 1) / 2;
}

// The line search's fractions 1, 1/2, 1/4, 1/16, 0.
MJ_HD float mj_alpha(int a) {
  return a == 0 ? 1.0f : (a == 1 ? 0.5f : (a == 2 ? 0.25f : (a == 3 ? 0.0625f : 0.0f)));
}

// Not inlined on the card: the narrow phase's passes and the row writer,
// whose inlined copies (one per contact point of every kind) would
// multiply the kernel's code, which the card's warps fetch as they go.
#ifdef __CUDACC__
#define MJ_NOINLINE __host__ __device__ __noinline__
#else
#define MJ_NOINLINE inline
#endif

// Counts a pair's points inside their margin (the narrow phase's first
// pass).
struct MjCountSink {
  const float* nf;
  int n;
  MJ_HD void operator()(int pi, int, int, float, float depth, const float*,
                        const float*) {
    const float pos = -depth - nf[MJ_N_F_PAIR + MJ_NPAIR_F * pi + MJ_IMP_F];
    if (!(pos >= 0.0f)) ++n;
  }
};

// Held row c: contact pair pi's point (mj_contact_row).
MJ_NOINLINE void mj_held_row(const float* nf, const int* ni, MjWarpEnv& S, int c, int pi,
                             float mu, float depth, float pos, const float* n,
                             const float* pt) {
  S.pair[c] = pi;
  mj_contact_row(nf, ni, S.k, S.qd, pi, mu, depth, pos, n, pt, S.J[c], S.aref[c], &S.D[c]);
}

// Writes a pair's rows inside their margin from slot on (the second pass);
// the slots past MJ_MAX_HELD are not held.
struct MjWarpRowSink {
  const float* nf;
  const int* ni;
  MjWarpEnv* S;
  int slot;
  MJ_HD void operator()(int pi, int, int, float mu, float depth,
                        const float* n, const float* pt) {
    const float pos = -depth - nf[MJ_N_F_PAIR + MJ_NPAIR_F * pi + MJ_IMP_F];
    if (pos >= 0.0f) return;
    const int c = slot++;
    if (c < MJ_MAX_HELD) mj_held_row(nf, ni, *S, c, pi, mu, depth, pos, n, pt);
  }
};

MJ_NOINLINE int mj_count_pair(const float* mf, const int* mi, const float* nf,
                              const MjKin& k, int pi) {
  MjCountSink sink{nf, 0};
  mj_narrow_pair<true>(mf, mi, k, pi, sink);
  return sink.n;
}

MJ_NOINLINE void mj_write_pair(const float* mf, const int* mi, const float* nf,
                               const int* ni, MjWarpEnv& S, int pi, int slot) {
  MjWarpRowSink sink{nf, ni, &S, slot};
  mj_narrow_pair<true>(mf, mi, S.k, pi, sink);
}

// mj_substep.h's mj_kinematics, link by link, for the warp's lanes (K1's
// and K3's builds keep their own loops, and so their code): the same
// operations in the same order per link.

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

// f(i) for every link i, parents before children: one phase per depth of
// the tree (maxd: the deepest), lanes over the links at that depth.
template <class W, class F>
MJ_WD void mj_warp_levels(W& w, const MjWarpEnv& S, int nlink, int maxd, F&& f) {
  for (int d = 0; d <= maxd; ++d)
    w.each(nlink, [&](int i) {
      if (S.depth[i] == d) f(i);
    });
}

// The kinematic state of S.q, S.qd in S.k, as mj_kinematics computes it:
// each link's relative pose, its motion subspaces and its inertia over
// lanes; world poses and velocities down the tree level by level.
template <class W>
MJ_WD void mj_warp_kinematics(W& w, MjWarpEnv& S, const float* mf, const int* mi,
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

// The rows of the substep's entry state (S.q, S.qd, S.k): nl limit rows,
// then the contact rows inside their margin; returns how many of those
// there are (more than MJ_MAX_HELD: only the first are held).
template <class W>
MJ_WD int mj_warp_rows(W& w, MjWarpEnv& S, const float* mf, const int* mi,
                       const float* nf, const int* ni, int& nl) {
  nl = mj_warp_compact(
      w, S.cnt, S.off, ni[MJ_N_I_NLIM],
      [&](int l) {
        int lv;
        float ls, laref, lD;
        return mj_limit_row(nf, ni, S.q, S.qd, l, &lv, &ls, &laref, &lD) ? 1 : 0;
      },
      [&](int l, int r) {
        mj_limit_row(nf, ni, S.q, S.qd, l, &S.lv[r], &S.ls[r], &S.laref[r], &S.lD[r]);
      });
  const int held = mj_warp_compact(
      w, S.cnt, S.off, mi[MJ_I_NPAIR],
      [&](int pi) { return mj_count_pair(mf, mi, nf, S.k, pi); },
      [&](int pi, int slot) { mj_write_pair(mf, mi, nf, ni, S, pi, slot); });
  w.each(held < MJ_MAX_HELD ? held : MJ_MAX_HELD, [&](int c) {
    const int* pi_ = ni + MJ_N_I_PAIR + MJ_NPAIR_I * S.pair[c];
    S.nfacet[c] = pi_[0];
    S.nchain[c] = pi_[1];
    for (int b = 0; b < pi_[1]; ++b) S.chain[c][b] = (unsigned char)pi_[2 + b];
  });
  return held;
}

// The unconstrained qdd0 (S.qdd0) and the Newton metric (S.Mf) of the
// substep's entry state, as K2's substep computes them with K3's stages.
template <class W>
MJ_WD void mj_warp_qdd0(W& w, MjWarpEnv& S, const float* mf, const int* mi, float dt,
                        int maxd) {
  const int nlink = mi[MJ_I_NLINK], nv = mi[MJ_I_NV], nu = mi[MJ_I_NU];
  const int* parent = mi + MJ_I_PARENT;
  const int* type = mi + MJ_I_TYPE;
  const int* qadr = mi + MJ_I_QADR;
  const int* vadr = mi + MJ_I_VADR;
  const int* dof_link = mi + MJ_I_DOFLINK;
  const int* lam = mi + MJ_I_LAM;
  const MjKin& k = S.k;

  // fluid drag, the only external wrench of a Newton substep, and the RNE
  // bias (mj_bias)
  const bool fluid = mi[MJ_I_HAS_FLUID] != 0;
  auto& R = S.s.rne;
  if (fluid) {
    w.each(6 * nlink, [&](int e) { R.f_ext[e / 6][e % 6] = 0.0f; });
    w.one([&] { mj_fluid(mf, mi, k, R.f_ext); });
  }
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
    if (fluid)
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
  MJ_STAMP(w, MJ_ST_RNE);

  // per dof: its servos in actuator order and its joint's spring
  // (mj_applied<false, true>), the tendon forces in tendon order
  // (mj_tendons), minus the bias and the damping
  const bool gainbias = mi[MJ_I_HAS_GAINBIAS] != 0;
  const int nt = mi[MJ_I_NTEN];
  const int* ti = mi + mi[MJ_I_TEN_I];
  const float* tf = mf + mi[MJ_I_TEN_F];
  const int* qptr = ti + 1;
  const int* qidx = qptr + nt + 1;
  const int* vptr = qidx + qptr[nt];
  const int* vidx = vptr + nt + 1;
  const float* qval = tf + 8 * nt;
  const float* vval = qval + qptr[nt];
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
  w.each(nv, [&](int j) {
    float rhs = 0.0f;
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
      const float stiff = mf[MJ_F_STIFF + i];
      if (stiff != 0.0f) rhs += -stiff * (S.q[qadr[i]] - mf[MJ_F_SPRINGREF + i]);
    }
    if (nt) {
      float tau = 0.0f;
      for (int t = 0; t < nt; ++t)
        for (int e = vptr[t]; e < vptr[t + 1]; ++e)
          if (vidx[e] == j) tau += vval[e] * S.s.ften[t];
      rhs = rhs + tau;
    }
    S.qdd0[j] = rhs - S.bias[j] - mf[MJ_F_DAMP + j] * S.qd[j];
  });
  MJ_STAMP(w, MJ_ST_FORCE);

  // the mass matrix from the composite inertias (mj_mass_matrix); the
  // metric M + diag(armature + dt damping) beside it
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
  // frictionloss: its force into qdd0's right-hand side, its dt-scaled
  // diagonal into the L^T D L solve and onto the metric (mj_friction)
  const bool fric = mi[MJ_I_HAS_FRIC] != 0;
  w.each(nv, [&](int i) {
    for (int j = i; j >= 0; j = lam[j]) S.M[i][j] = mj_dot6(C.F[i], k.cdof[j]);
    for (int j = 0; j <= i; ++j) S.Mf[i][j] = 0.0f;
    for (int j = i; j >= 0; j = lam[j]) S.Mf[i][j] = S.M[i][j];
    S.Mf[i][i] = S.Mf[i][i] + mf[MJ_F_EXTRA + i];
    if (fric) {
      const float fl = mf[MJ_F_FRIC + i], v_eps = mf[MJ_F_FVEPS];
      const float t = tanhf(S.qd[i] / v_eps);
      S.qdd0[i] = S.qdd0[i] + -fl * t;
      S.fdiag[i] = dt * ((fl / v_eps) * (1.0f - t * t));
      S.Mf[i][i] = S.Mf[i][i] + S.fdiag[i];
    }
  });
  MJ_STAMP(w, MJ_ST_CRB);
  w.one([&] { mj_ltdl_solve(mf, mi, S.M, fric ? S.fdiag : nullptr, S.qdd0); });
  MJ_STAMP(w, MJ_ST_LTDL);
}

// solver_iters Newton iterations from x = qdd0 over the held rows (nl
// limit rows, nc contact rows), as mj_newton.h's mj_newton_solve; picks
// (or null) receives each iteration's fraction index at picks[it * stride].
template <class W>
MJ_WD void mj_warp_newton(W& w, MjWarpEnv& S, const int* mi, int nl, int nc, int iters,
                          int* picks, long stride) {
  const int nv = mi[MJ_I_NV];
  const int nfe = nc * MJ_MAX_FACET;
  const auto wl = [&](int r) { return S.ljar[r] < 0.0f ? S.lD[r] : 0.0f; };
  const auto wc = [&](int c, int f) { return S.jar[c][f] < 0.0f ? S.D[c] : 0.0f; };
  // J x (or J dx) of one facet over its row's chain
  const auto jdot = [&](int c, int f, const float* v) {
    const float* J = S.J[c][f];
    const unsigned char* chain = S.chain[c];
    float s = J[0] * v[chain[0]];
    for (int b = 1; b < S.nchain[c]; ++b) s += J[b] * v[chain[b]];
    return s;
  };
  // row k of the symmetric metric times v, in mj_sym_mul's order
  const auto metric_row = [&](int k, const float* v) {
    float s = 0.0f;
    for (int j = 0; j <= k; ++j) s += S.Mf[k][j] * v[j];
    for (int i = k + 1; i < nv; ++i) s += S.Mf[i][k] * v[i];
    return s;
  };
  for (int it = 0; it < iters; ++it) {
    // residuals of every facet and limit row; d0 = x - qdd0
    w.each(nv + nfe + nl, [&](int e) {
      if (e < nv) {
        S.d0[e] = S.x[e] - S.qdd0[e];
      } else if (e < nv + nfe) {
        const int c = (e - nv) / MJ_MAX_FACET, f = (e - nv) % MJ_MAX_FACET;
        if (f < S.nfacet[c]) S.jar[c][f] = jdot(c, f, S.x) - S.aref[c][f];
      } else {
        const int r = e - nv - nfe;
        S.ljar[r] = S.ls[r] * S.x[S.lv[r]] - S.laref[r];
      }
    });
    // the gradient M d0 + J^T (w jar) and H = M + J^T diag(w) J + 1e-8 I
    // (lower triangle): M first, then the rows' terms row after row in
    // row order (the limit rows have a dof each, so they go in one phase),
    // then the 1e-8
    w.each(nv, [&](int k) {
      S.Md0[k] = S.g[k] = metric_row(k, S.d0);
      for (int j = 0; j <= k; ++j) S.M[k][j] = S.Mf[k][j];
    });
    w.each(nl, [&](int r) {
      const int v = S.lv[r];
      S.g[v] = S.g[v] + S.ls[r] * (wl(r) * S.ljar[r]);
      S.M[v][v] = S.M[v][v] + (wl(r) * S.ls[r]) * S.ls[r];
    });
    MJ_STAMP(w, MJ_ST_GRAD);
    for (int c = 0; c < nc; ++c) {  // lanes over the row's chain dofs, then pairs
      const int n = S.nchain[c], nfacet = S.nfacet[c];
      const unsigned char* chain = S.chain[c];
      w.each(n + n * (n + 1) / 2, [&](int e) {
        if (e < n) {
          float s = S.J[c][0][e] * (wc(c, 0) * S.jar[c][0]);
          for (int f = 1; f < nfacet; ++f) s += S.J[c][f][e] * (wc(c, f) * S.jar[c][f]);
          S.g[chain[e]] = S.g[chain[e]] + s;
        } else {
          int a, b;
          mj_tri(e - n, a, b);
          float h = (wc(c, 0) * S.J[c][0][a]) * S.J[c][0][b];
          for (int f = 1; f < nfacet; ++f) h += (wc(c, f) * S.J[c][f][a]) * S.J[c][f][b];
          S.M[chain[a]][chain[b]] = S.M[chain[a]][chain[b]] + h;
        }
      });
    }
    w.each(nv, [&](int j) { S.M[j][j] = S.M[j][j] + 1e-8f; });
    MJ_STAMP(w, MJ_ST_HESS);
    // Cholesky, left-looking: per column, every lane forms the pivot and
    // one row below it, each dot product in q order
    for (int j = 0; j < nv; ++j)
      w.each(nv - j, [&](int e) {
        const int i = j + e;
        float s = S.M[j][j], t = S.M[i][j];
        for (int q = 0; q < j; ++q) {
          s -= S.M[j][q] * S.M[j][q];
          t -= S.M[i][q] * S.M[j][q];
        }
        const float inv = mj_rsqrt(mj_max(s, MJ_MINVAL));
        if (e == 0)
          S.dinv[j] = inv;
        else
          S.M[i][j] = t * inv;
      });
    MJ_STAMP(w, MJ_ST_CHOL);
    // dx = -H^-1 g = H^-1 (-g) (the same bits: every step is odd in its
    // right-hand side): forward, then backward substitution over lanes
    w.each(nv, [&](int j) { S.g[j] = -S.g[j]; });
    w.lower_solve(nv, S.M, S.dinv, S.g, S.g);
    w.upper_solve(nv, S.M, S.dinv, S.g, S.dx);
    MJ_STAMP(w, MJ_ST_TRI);
    // exact line search: M dx and J dx, the smooth term in closed form,
    // then each row's five costs, summed in row order
    w.each(nv + nfe, [&](int e) {
      if (e < nv) {
        S.Mdx[e] = metric_row(e, S.dx);
      } else {
        const int c = (e - nv) / MJ_MAX_FACET, f = (e - nv) % MJ_MAX_FACET;
        if (f < S.nfacet[c]) S.jd[c][f] = jdot(c, f, S.dx);
      }
    });
    const MjVec<3> cc = w.sum(nv, MjVec<3>{}, [&](int j) {
      return MjVec<3>{{S.d0[j] * S.Md0[j], S.d0[j] * S.Mdx[j], S.dx[j] * S.Mdx[j]}};
    });
    MjVec<5> cost;
    for (int a = 0; a < 5; ++a) {
      const float al = mj_alpha(a);
      cost.v[a] = 0.5f * (cc.v[0] + (2.0f * al) * cc.v[1] + (al * al) * cc.v[2]);
    }
    cost = w.sum(nl + nc, cost, [&](int r) {
      MjVec<5> t;
      if (r < nl) {
        const float jd = S.ls[r] * S.dx[S.lv[r]];
        for (int a = 0; a < 5; ++a) {
          const float ja = S.ljar[r] + mj_alpha(a) * jd;
          t.v[a] = 0.5f * (ja < 0.0f ? S.lD[r] : 0.0f) * ja * ja;
        }
      } else {
        const int c = r - nl;
        for (int a = 0; a < 5; ++a) {
          float s = 0.0f;
          for (int f = 0; f < S.nfacet[c]; ++f) {
            const float ja = S.jar[c][f] + mj_alpha(a) * S.jd[c][f];
            s += 0.5f * (ja < 0.0f ? S.D[c] : 0.0f) * ja * ja;
          }
          t.v[a] = s;
        }
      }
      return t;
    });
    int best = 0;
    float best_cost = cost.v[0];
    for (int a = 1; a < 5; ++a)
      if (cost.v[a] < best_cost) {
        best = a;
        best_cost = cost.v[a];
      }
    const float al = mj_alpha(best);
    w.each(nv, [&](int j) {
      S.x[j] = S.x[j] + al * S.dx[j];
      if (j == 0 && picks) picks[it * stride] = best;
    });
    MJ_STAMP(w, MJ_ST_LINE);
  }
}

// Advances the env in S (q, qd, with ctrl held) by one Newton substep of
// length dt; delta (S.delta or null): the link offsets; *overflow counts
// the substep if it has more contact rows inside their margin than
// MJ_MAX_HELD; maxd: the tree's depth (mj_warp_depths).
template <class W>
MJ_WD void mj_warp_substep(W& w, MjWarpEnv& S, const float* mf, const int* mi,
                           const float* nf, const int* ni, float dt, int iters,
                           int* picks, long stride, const float* delta, int* overflow,
                           int maxd) {
  const int nv = mi[MJ_I_NV];
  mj_warp_kinematics(w, S, mf, mi, delta, maxd);
  MJ_STAMP(w, MJ_ST_KIN);
  int nl;
  const int held = mj_warp_rows(w, S, mf, mi, nf, ni, nl);
  if (held > MJ_MAX_HELD) w.one([&] { mj_count(overflow); });
  MJ_STAMP(w, MJ_ST_ROWS);
  mj_warp_qdd0(w, S, mf, mi, dt, maxd);
  w.each(nv, [&](int j) { S.x[j] = S.qdd0[j]; });
  mj_warp_newton(w, S, mi, nl, held < MJ_MAX_HELD ? held : MJ_MAX_HELD, iters, picks, stride);
  w.one([&] { mj_integrate(mi, S.q, S.qd, S.x, dt); });
  MJ_STAMP(w, MJ_ST_INT);
}

// Loads env's columns of the batch-last (rows, B) inputs into S (the link
// offsets when delta_in is given).
template <class W>
MJ_WD void mj_warp_load(W& w, MjWarpEnv& S, const int* mi, int env, int B,
                        const float* q_in, const float* qd_in, const float* ctrl_in,
                        const float* delta_in) {
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
      S.delta[e - nq - nv - nu] = delta_in[(long)(e - nq - nv - nu) * B + env];
  });
}

// Each link's depth in S.depth; returns the deepest.
template <class W>
MJ_WD int mj_warp_depths(W& w, MjWarpEnv& S, const int* mi) {
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

// Kernel K4's env: n_sub substeps with ctrl (and the link offsets) held;
// picks (or null) is (n_sub * iters, B) int.
template <class W>
MJ_WD void mj_warp_env_multistep(W& w, MjWarpEnv& S, const float* mf, const int* mi,
                                 const float* nf, const int* ni, int env, int B,
                                 const float* q_in, const float* qd_in,
                                 const float* ctrl_in, const float* delta_in,
                                 float* q_out, float* qd_out, int* picks, int* overflow,
                                 int n_sub, int iters, float dt) {
  const int nq = mi[MJ_I_NQ], nv = mi[MJ_I_NV];
  mj_warp_load(w, S, mi, env, B, q_in, qd_in, ctrl_in, delta_in);
  const int maxd = mj_warp_depths(w, S, mi);
  for (int s = 0; s < n_sub; ++s)
    mj_warp_substep(w, S, mf, mi, nf, ni, dt, iters,
                    picks ? picks + (long)s * iters * B + env : nullptr, B,
                    delta_in ? S.delta : nullptr, overflow, maxd);
  w.each(nq + nv, [&](int e) {
    if (e < nq)
      q_out[(long)e * B + env] = S.q[e];
    else
      qd_out[(long)(e - nq) * B + env] = S.qd[e - nq];
  });
}
