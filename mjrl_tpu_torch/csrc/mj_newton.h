// Newton soft-constraint rows for one env, table-driven: the row builders
// and the tables' layout of kernels K2 and K4 (mj_warp_newton.h, one warp
// per env).
//
// Kernel K2 replaces the TPU kernel mjrl_tpu/physics/pkernel.py::
// multistep_pallas run with constraint_solver="newton"
// (soa_newton.constrained_qdd, mjrl_tpu/physics/soa_newton.py:338) on its
// body _kernel_body, K4 the same on _kernel_body_ext. Both hold the rows of
// one substep, built once from its entry state, across its Newton
// iterations, each contact's J over its pair's chain only: the dofs on one
// of its two links' chains and not on the other's, each with its sign (+1
// on li's side, -1 on lj's; a dof on both chains has a column of exactly
// zero in the plain version, see pkernel.pack_newton_tables). Against a
// world plane that is the moving link's chain (free root plus the hinges
// below: <= 8 dofs for ant); for hopper's pairs between two links, <= 3
// dofs. A row outside its margin (pos >= 0) has D = 0 and adds exactly
// nothing to the gradient, H or the cost, so only rows inside it are held
// (a non-finite pos is held too, with D = 0, so NaN reaches the result as
// in the plain version). The static per-row constants (k and b from
// solref, the solimp spline, margin, invweight, friction, facets, chain)
// are packed on the host from the model after ensure_solver_params; the
// offsets and maxima below are exported by mj_newton_layout() so the
// packer reads them instead of repeating them. The bodies hold at most
// MJ_MAX_HELD contact rows inside their margin per env-substep: the first
// MJ_HELD_SHARED in the warp's shared state, the rest (MJ_SPILL_ROWS) in a
// slab of the env's own in device memory (mj_warp_newton.h's mj_row).
#pragma once

#include "mj_substep.h"

#ifndef MJ_MAX_HELD
#define MJ_MAX_HELD 64  // contact rows held per env-substep
#endif
#define MJ_MAX_FACET 6  // pyramid facets per contact (condim 4)
#ifndef MJ_MAX_CHAIN
#define MJ_MAX_CHAIN 8  // dofs on a contact pair's chain (a size class's)
#endif
// Held rows in shared memory (a size class's MJ_SHARED_HELD, at most
// MJ_MAX_HELD) and in the env's slab after them.
#if defined(MJ_SHARED_HELD) && MJ_SHARED_HELD < MJ_MAX_HELD
#define MJ_HELD_SHARED MJ_SHARED_HELD
#else
#define MJ_HELD_SHARED MJ_MAX_HELD
#endif
#define MJ_SPILL_ROWS (MJ_MAX_HELD - MJ_HELD_SHARED)

// One held contact row: its facets' J over the pair's chain, their aref,
// and the Newton iterations' residuals (jar) and J dx (jd); D; the pair,
// its facets, and its chain's dofs.
struct MjHeldRow {
  float J[MJ_MAX_FACET][MJ_MAX_CHAIN];
  float aref[MJ_MAX_FACET], jar[MJ_MAX_FACET], jd[MJ_MAX_FACET];
  float D;
  int pair, nfacet, nchain;
  unsigned char chain[MJ_MAX_CHAIN];
};

// ---- Newton int table (ni) ---------------------------------------------
#define MJ_N_I_NLIM 0  // number of limited 1-dof joints
#define MJ_N_I_LIM 4   // per limit row: qadr, vadr
#define MJ_LIM_I 2
#define MJ_N_I_PAIR (MJ_N_I_LIM + MJ_LIM_I * MJ_MAX_NV)
// nfacet, nchain, chain dofs[MJ_MAX_CHAIN], their signs[MJ_MAX_CHAIN]
#define MJ_NPAIR_I (2 + 2 * MJ_MAX_CHAIN)

// ---- Newton float table (nf) -------------------------------------------
// impedance block, first in every row's constants: k, b, dmin, dmax,
// width, mid, power, 1/mid^(power-1), 1/(1-mid)^(power-1), dmax - dmin
#define MJ_IMP_F 10
#define MJ_N_F_LIM 0
#define MJ_LIM_F (MJ_IMP_F + 3)  // + lo, hi, max(invweight, 0)
#define MJ_N_F_PAIR (MJ_N_F_LIM + MJ_LIM_F * MJ_MAX_NV)
// + margin, max(invweight, 0), mu, torsional mu, R scale (2 mu^2 (1 + mu^2)
// for the pyramid, 1 for condim 1)
#define MJ_NPAIR_F (MJ_IMP_F + 5)

// The counters a traced launch of K2 or K4 adds up, MJ_N_STATS long longs
// on the device (mj_warp_newton.h's mj_count_stats): per env-substep its
// contact rows inside their margin (their sum, and the largest) and the
// terms of H's assembly over its held rows; per Newton iteration the
// iteration, and whether its line search took a fraction under 1, took 0,
// or was a near tie (mj_near_tie).
enum {
  MJ_STAT_HELD,
  MJ_STAT_HELD_MAX,
  MJ_STAT_CHAIN_TERMS,
  MJ_STAT_ITERS,
  MJ_STAT_LS_CUT,
  MJ_STAT_LS_ZERO,
  MJ_STAT_LS_TIES,
  MJ_STAT_SPILLED,
  MJ_STAT_SPILL_SUBSTEPS,
  MJ_N_STATS
};

#define MJ_NEWTON_LAYOUT_LEN 16
#define MJ_NEWTON_LAYOUT_VALUES                                             \
  MJ_MAX_FACET, MJ_MAX_CHAIN, MJ_IMP_F, MJ_LIM_I, MJ_LIM_F, MJ_NPAIR_I, \
      MJ_NPAIR_F, MJ_N_I_NLIM, MJ_N_I_LIM, MJ_N_I_PAIR, MJ_N_F_LIM,         \
      MJ_N_F_PAIR, MJ_MAX_HELD, MJ_N_STATS, MJ_HELD_SHARED, (int)sizeof(MjHeldRow)

#define MJ_MINVAL 1e-10f

MJ_HD float mj_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// MuJoCo's impedance spline d(|pos| / width) over an impedance block.
MJ_HD float mj_impedance(const float* p, float pos) {
  const float x = fabsf(pos) / p[4];
  float xp, rpp;
  if (p[6] == 2.0f) {
    xp = x * x;
    const float rp = mj_max(1.0f - x, 0.0f);
    rpp = rp * rp;
  } else {
    xp = powf(x, p[6]);
    rpp = powf(mj_max(1.0f - x, 0.0f), p[6]);
  }
  const float a = p[7] * xp;
  const float b = 1.0f - p[8] * rpp;
  const float y = x < p[5] ? a : b;
  const float d = mj_min(mj_max(p[2] + y * p[9], p[2]), p[3]);
  return x >= 1.0f ? p[3] : d;
}

// D of a row at pos (0 outside the margin), and k d pos for its aref.
MJ_HD float mj_row_D(const float* p, float pos, float invw, float scale,
                     float* kdp) {
  const float d = mj_impedance(p, pos);
  *kdp = p[0] * d * pos;
  const float R = (1.0f - d) / mj_max(d, MJ_MINVAL) * invw * scale;
  return pos < 0.0f ? 1.0f / mj_max(R, MJ_MINVAL) : 0.0f;
}

// Limit row l (a limited 1-dof joint against its nearer bound): false
// inside the range (D = 0, not held); else its dof, sign, aref and D.
MJ_HD bool mj_limit_row(const float* nf, const int* ni, const float* q,
                        const float* qd, int l, int* lv, float* ls,
                        float* laref, float* lD) {
  const int* li = ni + MJ_N_I_LIM + MJ_LIM_I * l;
  const float* lf = nf + MJ_N_F_LIM + MJ_LIM_F * l;
  const float qi = q[li[0]];
  const float d_lo = qi - lf[MJ_IMP_F];
  const float d_hi = lf[MJ_IMP_F + 1] - qi;
  const bool use_lo = d_lo <= d_hi;
  const float dist = use_lo ? d_lo : d_hi;
  if (dist >= 0.0f) return false;  // inside the range: D = 0
  const float sign = use_lo ? 1.0f : -1.0f;
  const float vel = sign * qd[li[1]];
  float kdp;
  const float D = mj_row_D(lf, dist, lf[MJ_IMP_F + 2], 1.0f, &kdp);
  *lv = li[1];
  *ls = sign;
  *laref = -lf[1] * vel - kdp;
  *lD = D;
  return true;
}

// A contact point's row inside its margin (pos < 0 or non-finite), pair
// pi: its pyramid facets' J over the pair's chain, aref and D.
MJ_HD void mj_contact_row(const float* nf, const int* ni, const MjKin& k,
                          const float* qd, int pi, float mu, float depth,
                          float pos, const float* n, const float* pt,
                          float (*J)[MJ_MAX_CHAIN], float* aref, float* D) {
  const int* pi_ = ni + MJ_N_I_PAIR + MJ_NPAIR_I * pi;
  const float* pf = nf + MJ_N_F_PAIR + MJ_NPAIR_F * pi;
  const int nfacet = pi_[0], nchain = pi_[1];
  const int* chain = pi_ + 2;
  const int* sign = chain + MJ_MAX_CHAIN;
  // the middle of the penetration interval, about the origin
  const float half = 0.5f * mj_max(depth, 0.0f);
  float r[3];
  for (int a = 0; a < 3; ++a) r[a] = (pt[a] + half * n[a]) - k.origin[a];
  // tangent frame from the normal
  const bool near_z = fabsf(n[2]) < 0.99f;
  const float ref[3] = {near_z ? 0.0f : 1.0f, 0.0f, near_z ? 1.0f : 0.0f};
  float t1[3], t2[3];
  mj_cross(ref, n, t1);
  const float s = mj_rsqrt(mj_dot3(t1, t1) + 1e-12f);
  for (int a = 0; a < 3; ++a) t1[a] = t1[a] * s;
  mj_cross(n, t1, t2);
  const float mu_tor = pf[MJ_IMP_F + 3];
  float vel[MJ_MAX_FACET];
  for (int f = 0; f < nfacet; ++f) vel[f] = 0.0f;
  for (int b = 0; b < nchain; ++b) {
    const float* cd = k.cdof[chain[b]];
    const float sg = (float)sign[b];
    float jp[3];
    mj_cross(cd, r, jp);
    for (int a = 0; a < 3; ++a) jp[a] = sg * (cd[3 + a] + jp[a]);
    const float jn = mj_dot3(n, jp);
    float* col[MJ_MAX_FACET];
    for (int f = 0; f < nfacet; ++f) col[f] = &J[f][b];
    if (nfacet == 1) {
      *col[0] = jn;
    } else {
      const float jt1 = mj_dot3(t1, jp), jt2 = mj_dot3(t2, jp);
      *col[0] = jn + mu * jt1;
      *col[1] = jn - mu * jt1;
      *col[2] = jn + mu * jt2;
      *col[3] = jn - mu * jt2;
      if (nfacet == 6) {
        const float jt = sg * mj_dot3(n, cd);
        *col[4] = jn + mu_tor * jt;
        *col[5] = jn - mu_tor * jt;
      }
    }
    for (int f = 0; f < nfacet; ++f) vel[f] += *col[f] * qd[chain[b]];
  }
  float kdp;
  *D = mj_row_D(pf, pos, pf[MJ_IMP_F + 1], pf[MJ_IMP_F + 4], &kdp);
  for (int f = 0; f < nfacet; ++f) aref[f] = -pf[1] * vel[f] - kdp;
}
