// The Newton bodies of kernels K2 and K4: Newton soft-constraint substeps
// for one env, spread over the 32 lanes of a warp (mj_warp.h), the env's
// state in memory the lanes share (one MjWarpEnv per warp, in shared
// memory on the card).
//
// K2 (mj_newton_kernel.cu, EXT = false) replaces
// mjrl_tpu/physics/pkernel.py::multistep_pallas's body _kernel_body run
// with constraint_solver="newton" (soa_newton.constrained_qdd,
// mjrl_tpu/physics/soa_newton.py:338); K4 (mj_ext_newton_kernel.cu, EXT =
// true) its body _kernel_body_ext with that solver (with fric_diag,
// mjrl_tpu/physics/soa.py:1056-1072). Each computes what
// mjrl_tpu_torch/physics/soa.py::multistep computes for such a model: the
// pipeline of mj_warp_stages.h (EXT: per-env link offsets, the box kinds,
// gain/bias servos, fixed tendons, frictionloss, whose dt-scaled diagonal
// joins both the L^T D L solve and the Newton metric) without penalty
// contacts or limit springs (fluid drag stays) gives the unconstrained
// qdd0; then solver_iters primal Newton iterations on the soft contact and
// limit rows (physics/soa_newton.py):
//
//   residuals jar = J x - aref, active weights w = D where jar < 0;
//   gradient g = M (x - qdd0) + J^T (w jar);
//   H = M + diag(armature + dt damping) + J^T diag(w) J + 1e-8 I, dense
//   Cholesky with rsqrt(max(s, 1e-10)), dx = -H^-1 g;
//   the closed-form cost at the fractions 1, 1/2, 1/4, 1/16, 0, the first
//   strict minimum in that order, x += a dx.
//
// Arranged over lanes:
//
// - rows: lanes over the limited joints, then over the contact pairs 32 at
//   a time; each lane counts its pair's points inside their margin, a warp
//   scan places them, and the lane runs its pair again to write them
//   (mj_newton.h's row builders). So the rows held are the first
//   MJ_MAX_HELD inside their margin, in narrow-phase order, as the plain
//   version orders them; an env-substep with more adds one to *overflow
//   (the wrapper raises on it; the packer refuses a K2 model whose points
//   and limited joints could exceed it). Rows c < MJ_HELD_SHARED sit in
//   the warp's MjWarpEnv, the rest in the env's slab in device memory
//   (mj_row, the one way to a row): a size class that holds few rows an
//   env-substep on average but must hold many in the worst case (Adroit:
//   ~2 of 96) keeps its block's envs in shared memory without reserving
//   that worst case for each;
// - the pipeline's stages as mj_warp_stages.h spreads them;
// - each Newton iteration: lanes over the facets' residuals; over dofs
//   for M d0 and the rows of M; then held row after held row, its gradient
//   and H terms (lanes over the row's chain dofs and the pairs of them); a
//   left-looking Cholesky, per column lanes over the pivot's row and the
//   rows below; the two triangular solves by columns, each
//   row in a lane's registers and each solved value broadcast by shuffle
//   (w.lower_solve, w.upper_solve); lanes over rows for the line search's
//   five costs,
//   summed in row order (w.sum). Each output has one lane at a time, and
//   its terms are added in the order of the scalar Newton solve (the
//   backward solve's in the reverse column order; w.sum's products
//   rounded before the add, as the plain version rounds them), so the sums
//   that decide a branch (the active set jar < 0, the first strict minimum
//   of the costs) are formed in one fixed order.
//
// The host build (mj_host.cpp) runs this same code under the emulated warp
// (MjWarpHost), one env after another.
#pragma once

#include "mj_newton.h"
#include "mj_warp_stages.h"

static_assert(MJ_MAX_NV <= 2 * MJ_WARP, "a lane holds two rows of a triangular solve");

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
  MjHeldRow row[MJ_HELD_SHARED];  // the first contact rows (mj_row)
  int cnt[MJ_WARP], off[MJ_WARP];  // the compaction's counts and slots
#if MJ_SPILL_ROWS
  MjHeldRow* slab;  // the env's MJ_SPILL_ROWS rows after them
#endif
};

// Held contact row c's storage, in whichever tier holds it.
MJ_HD MjHeldRow& mj_row(MjWarpEnv& S, int c) {
#if MJ_SPILL_ROWS
  if (c >= MJ_HELD_SHARED) return S.slab[c - MJ_HELD_SHARED];
#endif
  return S.row[c];
}

// Points S at env's rows of slab (null: a build without one), before the
// first substep.
template <class W>
MJ_WD void mj_warp_slab(W& w, MjWarpEnv& S, MjHeldRow* slab, int env) {
#if MJ_SPILL_ROWS
  w.one([&] { S.slab = slab + (long)env * MJ_SPILL_ROWS; });
#endif
}

// K4's warps (envs) per block at most: MJ_WARPS_CAP, or as many as fit
// the 227 KB of shared memory a block may use. The cap is 4, and 8 in a
// build that keeps some held rows in the slab (the Adroit class: 14 of its
// 96 rows in shared memory, 28840 bytes per warp), so that each of an
// SM's four schedulers has two envs' warps to switch between.
#define MJ_WARPS_CAP (MJ_SPILL_ROWS ? 8 : 4)
#define MJ_MAX_WARPS                                       \
  (MJ_WARPS_CAP * sizeof(MjWarpEnv) <= 232448 ? MJ_WARPS_CAP \
                                              : (int)(232448 / sizeof(MjWarpEnv)))

// The layout as the wrapper reads it (mj_warp_layout()): bytes of shared
// memory per warp, tendons, warps per block and stages at most, and
// contact points at most (K1's; a Newton body holds rows instead: 0).
#define MJ_WARP_LAYOUT_LEN 5
#define MJ_NEWTON_WARP_LAYOUT_VALUES(warps) \
  (int)sizeof(MjWarpEnv), MJ_MAX_TEN, (warps), MJ_N_STAGES, 0

// One count on the device-side counter *c (the held-row overflow).
MJ_HD void mj_count(int* c) {
#ifdef __CUDA_ARCH__
  atomicAdd(c, 1);
#else
  ++*c;
#endif
}

// An env-substep's line searches, as a traced launch counts them
// (mj_warp_newton): its iterations, those that took a fraction under 1,
// those that took 0, and the near ties (mj_near_tie).
struct MjLineCounts {
  int iters, cut, zero, ties;
};

// An env-substep's counts into the device-side stats (mj_newton.h's
// MJ_STAT_*): its contact rows inside their margin (held), added and kept
// if the largest; the terms of H's assembly over its held rows (terms);
// its line searches; and the rows it holds in its slab, and whether any.
MJ_HD void mj_count_stats(long long* stats, int held, long long terms, const MjLineCounts& c) {
  const int kept = held < MJ_MAX_HELD ? held : MJ_MAX_HELD;
  const int spilled = kept > MJ_HELD_SHARED ? kept - MJ_HELD_SHARED : 0;
  const long long add[MJ_N_STATS] = {held,   0,      terms,   c.iters,    c.cut,
                                     c.zero, c.ties, spilled, spilled > 0};
#ifdef __CUDA_ARCH__
  for (int k = 0; k < MJ_N_STATS; ++k)
    if (k != MJ_STAT_HELD_MAX && add[k])
      atomicAdd(reinterpret_cast<unsigned long long*>(stats + k),
                static_cast<unsigned long long>(add[k]));
  atomicMax(stats + MJ_STAT_HELD_MAX, (long long)held);
#else
  for (int k = 0; k < MJ_N_STATS; ++k) stats[k] += add[k];
  if (held > stats[MJ_STAT_HELD_MAX]) stats[MJ_STAT_HELD_MAX] = held;
#endif
}

// The terms of H's assembly over the held rows (mj_warp_newton): n + n (n
// + 1) / 2 for a contact row whose chain has n dofs (its gradient's and
// H's lower triangle's entries), 1 for a limit row.
MJ_HD long long mj_chain_terms(MjWarpEnv& S, int nl, int nc) {
  long long terms = nl;
  for (int c = 0; c < nc; ++c) {
    const int n = mj_row(S, c).nchain;
    terms += n + n * (n + 1) / 2;
  }
  return terms;
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

// A near tie of a line search: a fraction other than the chosen one whose
// cost is within MJ_TIE_REL of the largest of the five costs' magnitudes
// above the best, and whose step would move some velocity of the substep
// (dt a dx) by more than MJ_TIE_STEP against the chosen step's. Where two
// costs lie that close, float32 round-off in another order of the sums
// (a fused multiply-add, the plain version's order) can pick the other
// fraction; 1e-5 is ~170 float32 ulps of the largest cost, above the
// round-off of the few hundred terms a cost sums. The step's threshold
// (1e-4 in m/s or rad/s, the size of the check's velocity quantile)
// keeps converged iterations out: there dx is ~0 and the five costs
// agree, and either pick gives the same velocities.
#define MJ_TIE_REL 1e-5f
#define MJ_TIE_STEP 1e-4f

MJ_HD bool mj_near_tie(const float* cost, int best, float dx_max, float dt) {
  float big = 0.0f;
  for (int a = 0; a < 5; ++a) big = mj_max(big, fabsf(cost[a]));
  for (int a = 0; a < 5; ++a)
    if (a != best && cost[a] - cost[best] <= MJ_TIE_REL * big &&
        dt * fabsf(mj_alpha(a) - mj_alpha(best)) * dx_max > MJ_TIE_STEP)
      return true;
  return false;
}

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
  MjHeldRow& R = mj_row(S, c);
  R.pair = pi;
  mj_contact_row(nf, ni, S.k, S.qd, pi, mu, depth, pos, n, pt, R.J, R.aref, &R.D);
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

template <bool EXT>
MJ_NOINLINE int mj_count_pair(const float* mf, const int* mi, const float* nf,
                              const MjKin& k, int pi) {
  MjCountSink sink{nf, 0};
  mj_narrow_pair<EXT>(mf, mi, k, pi, sink);
  return sink.n;
}

template <bool EXT>
MJ_NOINLINE void mj_write_pair(const float* mf, const int* mi, const float* nf,
                               const int* ni, MjWarpEnv& S, int pi, int slot) {
  MjWarpRowSink sink{nf, ni, &S, slot};
  mj_narrow_pair<EXT>(mf, mi, S.k, pi, sink);
}

// The rows of the substep's entry state (S.q, S.qd, S.k): nl limit rows,
// then the contact rows inside their margin; returns how many of those
// there are (more than MJ_MAX_HELD: only the first are held). EXT: the
// box kinds.
template <bool EXT, class W>
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
      [&](int pi) { return mj_count_pair<EXT>(mf, mi, nf, S.k, pi); },
      [&](int pi, int slot) { mj_write_pair<EXT>(mf, mi, nf, ni, S, pi, slot); });
  w.each(held < MJ_MAX_HELD ? held : MJ_MAX_HELD, [&](int c) {
    MjHeldRow& R = mj_row(S, c);
    const int* pi_ = ni + MJ_N_I_PAIR + MJ_NPAIR_I * R.pair;
    R.nfacet = pi_[0];
    R.nchain = pi_[1];
    for (int b = 0; b < pi_[1]; ++b) R.chain[b] = (unsigned char)pi_[2 + b];
  });
  return held;
}

// The unconstrained qdd0 (S.qdd0) and the Newton metric (S.Mf) of the
// substep's entry state, by mj_warp_stages.h's stages: fluid drag (the
// only external wrench of a Newton substep) over links, the RNE bias, the
// applied forces without limit penalties, the mass matrix and the metric
// (EXT: frictionloss), and the L^T D L solve on one lane.
template <bool EXT, class W>
MJ_WD void mj_warp_qdd0(W& w, MjWarpEnv& S, const float* mf, const int* mi, float dt,
                        int maxd) {
  const bool fluid = mi[MJ_I_HAS_FLUID] != 0;
  if (fluid)
    w.each(mi[MJ_I_NLINK], [&](int i) {
      for (int c = 0; c < 6; ++c) S.s.rne.f_ext[i][c] = 0.0f;
      mj_link_fluid(mf, S.k, i, S.s.rne.f_ext);
    });
  mj_warp_bias(w, S, mf, mi, maxd, fluid);
  MJ_STAMP(w, MJ_ST_RNE);
  mj_warp_forces<false, EXT>(w, S, mf, mi);
  MJ_STAMP(w, MJ_ST_FORCE);
  mj_warp_crb<true, EXT>(w, S, mf, mi, dt);
  MJ_STAMP(w, MJ_ST_CRB);
  const bool fric = EXT && mi[MJ_I_HAS_FRIC] != 0;
  w.one([&] { mj_ltdl_solve(mf, mi, S.M, fric ? S.fdiag : nullptr, S.qdd0); });
  MJ_STAMP(w, MJ_ST_LTDL);
}

// solver_iters Newton iterations from x = qdd0 over the held rows (nl
// limit rows, nc contact rows); picks (or null) receives each iteration's
// fraction index at picks[it * stride]; counts (or null: a launch that
// counts nothing) adds up the line searches of the substep of length dt.
template <class W>
MJ_WD void mj_warp_newton(W& w, MjWarpEnv& S, const int* mi, int nl, int nc, int iters,
                          int* picks, long stride, MjLineCounts* counts, float dt) {
  const int nv = mi[MJ_I_NV];
  const int nfe = nc * MJ_MAX_FACET;
  const auto wl = [&](int r) { return S.ljar[r] < 0.0f ? S.lD[r] : 0.0f; };
  const auto wc = [&](const MjHeldRow& R, int f) { return R.jar[f] < 0.0f ? R.D : 0.0f; };
  // J x (or J dx) of one facet over its row's chain
  const auto jdot = [&](const MjHeldRow& R, int f, const float* v) {
    const float* J = R.J[f];
    const unsigned char* chain = R.chain;
    float s = J[0] * v[chain[0]];
    for (int b = 1; b < R.nchain; ++b) s += J[b] * v[chain[b]];
    return s;
  };
  // row k of the symmetric metric times v: the lower triangle's row k,
  // then its column k below the diagonal
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
        MjHeldRow& R = mj_row(S, c);
        if (f < R.nfacet) R.jar[f] = jdot(R, f, S.x) - R.aref[f];
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
      const MjHeldRow& R = mj_row(S, c);
      const int n = R.nchain, nfacet = R.nfacet;
      const unsigned char* chain = R.chain;
      w.each(n + n * (n + 1) / 2, [&](int e) {
        if (e < n) {
          float s = R.J[0][e] * (wc(R, 0) * R.jar[0]);
          for (int f = 1; f < nfacet; ++f) s += R.J[f][e] * (wc(R, f) * R.jar[f]);
          S.g[chain[e]] = S.g[chain[e]] + s;
        } else {
          int a, b;
          mj_tri(e - n, a, b);
          float h = (wc(R, 0) * R.J[0][a]) * R.J[0][b];
          for (int f = 1; f < nfacet; ++f) h += (wc(R, f) * R.J[f][a]) * R.J[f][b];
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
        MjHeldRow& R = mj_row(S, c);
        if (f < R.nfacet) R.jd[f] = jdot(R, f, S.dx);
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
        const MjHeldRow& R = mj_row(S, r - nl);
        for (int a = 0; a < 5; ++a) {
          float s = 0.0f;
          for (int f = 0; f < R.nfacet; ++f) {
            const float ja = R.jar[f] + mj_alpha(a) * R.jd[f];
            s += 0.5f * (ja < 0.0f ? R.D : 0.0f) * ja * ja;
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
    if (counts)
      w.one([&] {
        float dx_max = 0.0f;
        for (int j = 0; j < nv; ++j) dx_max = mj_max(dx_max, fabsf(S.dx[j]));
        ++counts->iters;
        counts->cut += best != 0;
        counts->zero += best == 4;
        counts->ties += mj_near_tie(cost.v, best, dx_max, dt);
      });
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
// MJ_MAX_HELD; stats (or null) takes the substep's counts
// (mj_count_stats); maxd: the tree's depth (mj_warp_depths). With stats
// null nothing is counted, and with it non-null the same bits come out.
template <bool EXT, class W>
MJ_WD void mj_warp_substep(W& w, MjWarpEnv& S, const float* mf, const int* mi,
                           const float* nf, const int* ni, float dt, int iters,
                           int* picks, long stride, const float* delta, int* overflow,
                           long long* stats, int maxd) {
  const int nv = mi[MJ_I_NV];
  mj_warp_kinematics(w, S, mf, mi, delta, maxd);
  MJ_STAMP(w, MJ_ST_KIN);
  int nl;
  const int held = mj_warp_rows<EXT>(w, S, mf, mi, nf, ni, nl);
  if (held > MJ_MAX_HELD) w.one([&] { mj_count(overflow); });
  MJ_STAMP(w, MJ_ST_ROWS);
  mj_warp_qdd0<EXT>(w, S, mf, mi, dt, maxd);
  w.each(nv, [&](int j) { S.x[j] = S.qdd0[j]; });
  const int nc = held < MJ_MAX_HELD ? held : MJ_MAX_HELD;
  MjLineCounts counts{0, 0, 0, 0};
  mj_warp_newton(w, S, mi, nl, nc, iters, picks, stride, stats ? &counts : nullptr, dt);
  if (stats) w.one([&] { mj_count_stats(stats, held, mj_chain_terms(S, nl, nc), counts); });
  w.one([&] { mj_integrate(mi, S.q, S.qd, S.x, dt); });
  MJ_STAMP(w, MJ_ST_INT);
}

// Kernel K2's (EXT = false) or K4's (EXT = true) env: n_sub substeps with
// ctrl (and, with delta_in, K4's link offsets) held; picks (or null) is
// (n_sub * iters, B) int; stats (or null) as mj_warp_substep's; slab: B
// envs' MJ_SPILL_ROWS rows each (null where the build has none).
template <bool EXT, class W>
MJ_WD void mj_warp_env_multistep(W& w, MjWarpEnv& S, const float* mf, const int* mi,
                                 const float* nf, const int* ni, int env, int B,
                                 const float* q_in, const float* qd_in,
                                 const float* ctrl_in, const float* delta_in,
                                 float* q_out, float* qd_out, int* picks, int* overflow,
                                 long long* stats, MjHeldRow* slab, int n_sub, int iters,
                                 float dt) {
  mj_warp_slab(w, S, slab, env);
  mj_warp_load(w, S, mi, env, B, q_in, qd_in, ctrl_in, delta_in, S.delta);
  const int maxd = mj_warp_depths(w, S, mi);
  for (int s = 0; s < n_sub; ++s)
    mj_warp_substep<EXT>(w, S, mf, mi, nf, ni, dt, iters,
                         picks ? picks + (long)s * iters * B + env : nullptr, B,
                         delta_in ? S.delta : nullptr, overflow, stats, maxd);
  mj_warp_store(w, S, mi, env, B, q_out, qd_out);
}
