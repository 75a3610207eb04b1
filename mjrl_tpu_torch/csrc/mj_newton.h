// Newton soft-constraint substep for one env, table-driven: the body of
// kernel K2 (mj_newton_kernel.cu).
//
// Replaces the TPU kernel mjrl_tpu/physics/pkernel.py::multistep_pallas run
// with constraint_solver="newton" (soa_newton.constrained_qdd,
// mjrl_tpu/physics/soa_newton.py:338). It computes what
// mjrl_tpu_torch/physics/soa.py::multistep computes for a Newton model, for
// one env as scalar code: the pipeline of mj_substep.h without penalty
// contacts or limit springs gives the unconstrained qdd0 by the sparse
// L^T D L solve; then solver_iters primal Newton iterations on the soft
// contact and limit rows (physics/soa_newton.py):
//
//   residuals jar = J x - aref, active weights w = D where jar < 0;
//   gradient g = M (x - qdd0) + J^T (w jar);
//   H = M + diag(armature + dt damping) + J^T diag(w) J + 1e-8 I, dense
//   Cholesky with rsqrt(max(s, 1e-10)), dx = -H^-1 g;
//   the closed-form cost at the fractions 1, 1/2, 1/4, 1/16, 0, the first
//   strict minimum in that order, x += a dx.
//
// Held rows: the rows of one substep are built once from its entry state
// and held in per-thread arrays across the iterations, each contact's J
// over its link's dof chain only (free root plus the hinges below: <= 8
// dofs for ant). A row outside its margin (pos >= 0) has D = 0 and adds
// exactly nothing to the gradient, H or the cost, so only rows inside it
// are held (a non-finite pos is held too, with D = 0, so NaN reaches the
// result as in the plain version). The static per-row constants (k and b
// from solref, the solimp spline, margin, invweight, friction, facets,
// chain) are packed on the host from the model after
// ensure_solver_params; the offsets and maxima below are exported by
// mj_newton_layout() so the packer reads them instead of repeating them.
#pragma once

#include "mj_substep.h"

#define MJ_MAX_CAND 32  // contact points of a model (rows held per substep)
#define MJ_MAX_FACET 6  // pyramid facets per contact (condim 4)
#define MJ_MAX_CHAIN 8  // dofs on a contact link's chain

// ---- Newton int table (ni) ---------------------------------------------
#define MJ_N_I_NLIM 0  // number of limited 1-dof joints
#define MJ_N_I_LIM 4   // per limit row: qadr, vadr
#define MJ_LIM_I 2
#define MJ_N_I_PAIR (MJ_N_I_LIM + MJ_LIM_I * MJ_MAX_NV)
#define MJ_NPAIR_I (2 + MJ_MAX_CHAIN)  // nfacet, nchain, chain dofs

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

#define MJ_NEWTON_LAYOUT_LEN 13
#define MJ_NEWTON_LAYOUT_VALUES                                             \
  MJ_MAX_CAND, MJ_MAX_FACET, MJ_MAX_CHAIN, MJ_IMP_F, MJ_LIM_I, MJ_LIM_F,    \
      MJ_NPAIR_I, MJ_NPAIR_F, MJ_N_I_NLIM, MJ_N_I_LIM, MJ_N_I_PAIR,         \
      MJ_N_F_LIM, MJ_N_F_PAIR

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

// The rows held for one substep: limit rows, then contact candidates in
// narrow-phase order.
struct MjRows {
  int nl;
  int lv[MJ_MAX_NV];
  float ls[MJ_MAX_NV], laref[MJ_MAX_NV], lD[MJ_MAX_NV];
  int nc;
  int pair[MJ_MAX_CAND];
  float D[MJ_MAX_CAND];
  float aref[MJ_MAX_CAND][MJ_MAX_FACET];
  float J[MJ_MAX_CAND][MJ_MAX_FACET][MJ_MAX_CHAIN];
};

MJ_HD void mj_limit_rows(const float* nf, const int* ni, const float* q,
                         const float* qd, MjRows& rows) {
  rows.nl = 0;
  const int nlim = ni[MJ_N_I_NLIM];
  for (int l = 0; l < nlim; ++l) {
    const int* li = ni + MJ_N_I_LIM + MJ_LIM_I * l;
    const float* lf = nf + MJ_N_F_LIM + MJ_LIM_F * l;
    const float qi = q[li[0]];
    const float d_lo = qi - lf[MJ_IMP_F];
    const float d_hi = lf[MJ_IMP_F + 1] - qi;
    const bool use_lo = d_lo <= d_hi;
    const float dist = use_lo ? d_lo : d_hi;
    if (dist >= 0.0f) continue;  // inside the range: D = 0
    const float sign = use_lo ? 1.0f : -1.0f;
    const float vel = sign * qd[li[1]];
    float kdp;
    const float D = mj_row_D(lf, dist, lf[MJ_IMP_F + 2], 1.0f, &kdp);
    const int r = rows.nl++;
    rows.lv[r] = li[1];
    rows.ls[r] = sign;
    rows.laref[r] = -lf[1] * vel - kdp;
    rows.lD[r] = D;
  }
}

// One contact point's pyramid facet rows (the narrow phase's sink).
struct MjNewtonSink {
  const float* nf;
  const int* ni;
  const MjKin* k;
  const float* qd;
  MjRows* rows;
  MJ_HD void operator()(int pi, int, int, float mu, float depth,
                        const float* n, const float* pt) {
    const int* pi_ = ni + MJ_N_I_PAIR + MJ_NPAIR_I * pi;
    const float* pf = nf + MJ_N_F_PAIR + MJ_NPAIR_F * pi;
    const float pos = -depth - pf[MJ_IMP_F];
    if (pos >= 0.0f || rows->nc >= MJ_MAX_CAND) return;  // D = 0
    const int c = rows->nc++;
    const int nfacet = pi_[0], nchain = pi_[1];
    const int* chain = pi_ + 2;
    // the middle of the penetration interval, about the origin
    const float half = 0.5f * mj_max(depth, 0.0f);
    float r[3];
    for (int a = 0; a < 3; ++a) r[a] = (pt[a] + half * n[a]) - k->origin[a];
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
      const float* cd = k->cdof[chain[b]];
      float jp[3];
      mj_cross(cd, r, jp);
      for (int a = 0; a < 3; ++a) jp[a] = cd[3 + a] + jp[a];
      const float jn = mj_dot3(n, jp);
      float* col[MJ_MAX_FACET];
      for (int f = 0; f < nfacet; ++f) col[f] = &rows->J[c][f][b];
      if (nfacet == 1) {
        *col[0] = jn;
      } else {
        const float jt1 = mj_dot3(t1, jp), jt2 = mj_dot3(t2, jp);
        *col[0] = jn + mu * jt1;
        *col[1] = jn - mu * jt1;
        *col[2] = jn + mu * jt2;
        *col[3] = jn - mu * jt2;
        if (nfacet == 6) {
          const float jt = mj_dot3(n, cd);
          *col[4] = jn + mu_tor * jt;
          *col[5] = jn - mu_tor * jt;
        }
      }
      for (int f = 0; f < nfacet; ++f) vel[f] += *col[f] * qd[chain[b]];
    }
    float kdp;
    rows->pair[c] = pi;
    rows->D[c] = mj_row_D(pf, pos, pf[MJ_IMP_F + 1], pf[MJ_IMP_F + 4], &kdp);
    for (int f = 0; f < nfacet; ++f) rows->aref[c][f] = -pf[1] * vel[f] - kdp;
  }
};

// Symmetric product with the lower triangle of M (zeros off the tree).
MJ_HD void mj_sym_mul(const float (*M)[MJ_MAX_NV], const float* x, float* out,
                      int nv) {
  for (int i = 0; i < nv; ++i) out[i] = 0.0f;
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j <= i; ++j) {
      out[i] += M[i][j] * x[j];
      if (i != j) out[j] += M[i][j] * x[i];
    }
}

// The Newton solve: x = qdd0 in, the constrained qdd out. picks (or null)
// receives each iteration's fraction index at picks[it * stride].
MJ_HD void mj_newton_solve(const int* mi, const int* ni,
                           const float (*Mf)[MJ_MAX_NV], const float* qdd0,
                           const MjRows& rows, int iters, float* x, int* picks,
                           long stride) {
  const int nv = mi[MJ_I_NV];
  const float alphas[5] = {1.0f, 0.5f, 0.25f, 0.0625f, 0.0f};
  float jar_l[MJ_MAX_NV], jd_l[MJ_MAX_NV];
  float jar[MJ_MAX_CAND][MJ_MAX_FACET], jd[MJ_MAX_CAND][MJ_MAX_FACET];
  for (int it = 0; it < iters; ++it) {
    float d0[MJ_MAX_NV], Md0[MJ_MAX_NV], g[MJ_MAX_NV];
    for (int j = 0; j < nv; ++j) d0[j] = x[j] - qdd0[j];
    mj_sym_mul(Mf, d0, Md0, nv);
    for (int j = 0; j < nv; ++j) g[j] = Md0[j];
    // residuals, active weights and the gradient
    for (int r = 0; r < rows.nl; ++r) {
      const int v = rows.lv[r];
      jar_l[r] = rows.ls[r] * x[v] - rows.laref[r];
      const float w = jar_l[r] < 0.0f ? rows.lD[r] : 0.0f;
      g[v] = g[v] + rows.ls[r] * (w * jar_l[r]);
    }
    for (int c = 0; c < rows.nc; ++c) {
      const int* pi_ = ni + MJ_N_I_PAIR + MJ_NPAIR_I * rows.pair[c];
      const int nfacet = pi_[0], nchain = pi_[1];
      const int* chain = pi_ + 2;
      float wj[MJ_MAX_FACET];
      for (int f = 0; f < nfacet; ++f) {
        float s = rows.J[c][f][0] * x[chain[0]];
        for (int b = 1; b < nchain; ++b) s += rows.J[c][f][b] * x[chain[b]];
        jar[c][f] = s - rows.aref[c][f];
        wj[f] = (jar[c][f] < 0.0f ? rows.D[c] : 0.0f) * jar[c][f];
      }
      for (int b = 0; b < nchain; ++b) {
        float s = rows.J[c][0][b] * wj[0];
        for (int f = 1; f < nfacet; ++f) s += rows.J[c][f][b] * wj[f];
        g[chain[b]] = g[chain[b]] + s;
      }
    }
    // H = M + J^T diag(w) J + 1e-8 I, lower triangle; then Cholesky in place
    float H[MJ_MAX_NV][MJ_MAX_NV];
    for (int i = 0; i < nv; ++i)
      for (int j = 0; j <= i; ++j) H[i][j] = Mf[i][j];
    for (int r = 0; r < rows.nl; ++r) {
      const int v = rows.lv[r];
      const float w = jar_l[r] < 0.0f ? rows.lD[r] : 0.0f;
      H[v][v] = H[v][v] + (w * rows.ls[r]) * rows.ls[r];
    }
    for (int c = 0; c < rows.nc; ++c) {
      const int* pi_ = ni + MJ_N_I_PAIR + MJ_NPAIR_I * rows.pair[c];
      const int nfacet = pi_[0], nchain = pi_[1];
      const int* chain = pi_ + 2;
      float w[MJ_MAX_FACET];
      for (int f = 0; f < nfacet; ++f) w[f] = jar[c][f] < 0.0f ? rows.D[c] : 0.0f;
      for (int a = 0; a < nchain; ++a)
        for (int b = 0; b <= a; ++b) {
          float s = (w[0] * rows.J[c][0][a]) * rows.J[c][0][b];
          for (int f = 1; f < nfacet; ++f) s += (w[f] * rows.J[c][f][a]) * rows.J[c][f][b];
          H[chain[a]][chain[b]] = H[chain[a]][chain[b]] + s;
        }
    }
    for (int j = 0; j < nv; ++j) H[j][j] = H[j][j] + 1e-8f;
    float dinv[MJ_MAX_NV];
    for (int j = 0; j < nv; ++j) {
      float s = H[j][j];
      for (int q = 0; q < j; ++q) s -= H[j][q] * H[j][q];
      const float inv = mj_rsqrt(mj_max(s, MJ_MINVAL));
      dinv[j] = inv;
      for (int i = j + 1; i < nv; ++i) {
        float t = H[i][j];
        for (int q = 0; q < j; ++q) t -= H[i][q] * H[j][q];
        H[i][j] = t * inv;
      }
    }
    float dx[MJ_MAX_NV];
    for (int i = 0; i < nv; ++i) {
      float s = g[i];
      for (int q = 0; q < i; ++q) s -= H[i][q] * dx[q];
      dx[i] = s * dinv[i];
    }
    for (int i = nv - 1; i >= 0; --i) {
      float s = dx[i];
      for (int q = i + 1; q < nv; ++q) s -= H[q][i] * dx[q];
      dx[i] = s * dinv[i];
    }
    for (int i = 0; i < nv; ++i) dx[i] = -dx[i];
    // exact line search, the smooth term 1/2 (c0 + 2 a c1 + a^2 c2)
    float Mdx[MJ_MAX_NV];
    mj_sym_mul(Mf, dx, Mdx, nv);
    float c0 = d0[0] * Md0[0], c1 = d0[0] * Mdx[0], c2 = dx[0] * Mdx[0];
    for (int j = 1; j < nv; ++j) {
      c0 += d0[j] * Md0[j];
      c1 += d0[j] * Mdx[j];
      c2 += dx[j] * Mdx[j];
    }
    float cost[5];
    for (int a = 0; a < 5; ++a) {
      const float al = alphas[a];
      cost[a] = 0.5f * (c0 + (2.0f * al) * c1 + (al * al) * c2);
    }
    for (int r = 0; r < rows.nl; ++r) {
      jd_l[r] = rows.ls[r] * dx[rows.lv[r]];
      for (int a = 0; a < 5; ++a) {
        const float ja = jar_l[r] + alphas[a] * jd_l[r];
        cost[a] = cost[a] + 0.5f * (ja < 0.0f ? rows.lD[r] : 0.0f) * ja * ja;
      }
    }
    for (int c = 0; c < rows.nc; ++c) {
      const int* pi_ = ni + MJ_N_I_PAIR + MJ_NPAIR_I * rows.pair[c];
      const int nfacet = pi_[0], nchain = pi_[1];
      const int* chain = pi_ + 2;
      for (int f = 0; f < nfacet; ++f) {
        float s = rows.J[c][f][0] * dx[chain[0]];
        for (int b = 1; b < nchain; ++b) s += rows.J[c][f][b] * dx[chain[b]];
        jd[c][f] = s;
      }
      for (int a = 0; a < 5; ++a) {
        float s = 0.0f;
        for (int f = 0; f < nfacet; ++f) {
          const float ja = jar[c][f] + alphas[a] * jd[c][f];
          s += 0.5f * (ja < 0.0f ? rows.D[c] : 0.0f) * ja * ja;
        }
        cost[a] = cost[a] + s;
      }
    }
    int best = 0;
    for (int a = 1; a < 5; ++a)
      if (cost[a] < cost[best]) best = a;
    if (picks) picks[it * stride] = best;
    for (int j = 0; j < nv; ++j) x[j] = x[j] + alphas[best] * dx[j];
  }
}

// Advances one env's q (nq), qd (nv) by one Newton substep of length dt.
MJ_HD void mj_newton_substep(const float* mf, const int* mi, const float* nf,
                             const int* ni, float* q, float* qd,
                             const float* ctrl, float dt, int iters,
                             int* picks, long stride) {
  const int nv = mi[MJ_I_NV];
  const int* lam = mi + MJ_I_LAM;
  MjKin k;
  mj_kinematics(mf, mi, q, qd, k);

  // the rows, from the substep's entry state
  MjRows rows;
  mj_limit_rows(nf, ni, q, qd, rows);
  rows.nc = 0;
  MjNewtonSink sink{nf, ni, &k, qd, &rows};
  mj_narrow_phase(mf, mi, k, sink);

  // unconstrained qdd0; the metric M + diag(armature + dt damping) kept
  // beside the factorization
  float H[MJ_MAX_NV][MJ_MAX_NV], Mf[MJ_MAX_NV][MJ_MAX_NV];
  mj_mass_matrix(mf, mi, k, H);
  for (int i = 0; i < nv; ++i) {
    for (int j = 0; j <= i; ++j) Mf[i][j] = 0.0f;
    for (int j = i; j >= 0; j = lam[j]) Mf[i][j] = H[i][j];
    Mf[i][i] = Mf[i][i] + mf[MJ_F_EXTRA + i];
  }
  float bias[MJ_MAX_NV], qdd0[MJ_MAX_NV];
  mj_bias(mf, mi, k, qd, nullptr, bias);
  mj_applied<false>(mf, mi, q, qd, ctrl, qdd0, nullptr);
  for (int j = 0; j < nv; ++j) qdd0[j] = qdd0[j] - bias[j] - mf[MJ_F_DAMP + j] * qd[j];
  mj_ltdl_solve(mf, mi, H, nullptr, qdd0);

  float x[MJ_MAX_NV];
  for (int j = 0; j < nv; ++j) x[j] = qdd0[j];
  mj_newton_solve(mi, ni, Mf, qdd0, rows, iters, x, picks, stride);
  mj_integrate(mi, q, qd, x, dt);
}

// One env of a batch-last (rows, B) launch, as mj_env_multistep; picks (or
// null) is (n_sub * iters, B) int.
MJ_HD void mj_newton_env_multistep(const float* mf, const int* mi,
                                   const float* nf, const int* ni, int env,
                                   int B, const float* q_in,
                                   const float* qd_in, const float* ctrl_in,
                                   float* q_out, float* qd_out, int* picks,
                                   int n_sub, int iters, float dt) {
  const int nq = mi[MJ_I_NQ], nv = mi[MJ_I_NV], nu = mi[MJ_I_NU];
  float q[MJ_MAX_NQ], qd[MJ_MAX_NV], ctrl[MJ_MAX_NU];
  for (int r = 0; r < nq; ++r) q[r] = q_in[(long)r * B + env];
  for (int r = 0; r < nv; ++r) qd[r] = qd_in[(long)r * B + env];
  for (int r = 0; r < nu; ++r) ctrl[r] = ctrl_in[(long)r * B + env];
  for (int s = 0; s < n_sub; ++s)
    mj_newton_substep(mf, mi, nf, ni, q, qd, ctrl, dt, iters,
                      picks ? picks + (long)s * iters * B + env : nullptr, B);
  for (int r = 0; r < nq; ++r) q_out[(long)r * B + env] = q[r];
  for (int r = 0; r < nv; ++r) qd_out[(long)r * B + env] = qd[r];
}
