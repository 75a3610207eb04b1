// The penalty bodies of kernels K1 and K3: penalty-contact substeps for
// one env, spread over the 32 lanes of a warp (mj_warp.h), the env's state
// in memory the lanes share (one MjPenaltyEnv, or with EXT one
// MjPenaltyExtEnv, per warp, in shared memory on the card).
//
// K1 (mj_kernel.cu, EXT = false) replaces
// mjrl_tpu/physics/pkernel.py::multistep_pallas's body _kernel_body under
// the penalty solver (mjrl_tpu/physics/soa.py:1013 substep); K3
// (mj_ext_kernel.cu, EXT = true) its body _kernel_body_ext, which adds
// Adroit's stages: per-env link offsets in the kinematics, the box contact
// kinds, gain/bias servos, fixed tendons and frictionloss. Each computes
// what mjrl_tpu_torch/physics/soa.py::multistep computes for such a model,
// in the order of the scalar substep: kinematics, contacts, fluid drag,
// RNE bias, applied forces with the limit penalties (EXT: the servos, then
// the tendon forces), damping, (EXT) frictionloss, mass matrix, the sparse
// L^T D L solve (with the limits' implicit damper diagonal and EXT
// frictionloss's) and the integration, n_sub times with ctrl held. Every
// stage but the contacts is mj_warp_stages.h's, the L^T D L solve over
// lanes (mj_warp_ltdl).
//
// The contacts: lanes take the pairs 32 at a time, one pair a lane. Each
// lane runs its pair's narrow phase (at most MJ_PAIR_POINTS points in K1:
// capsule_plane's two ends; MJ_EXT_PAIR_POINTS in K3: box_box's 16
// corners) and computes each point's penalty wrench about the origin; it
// keeps the wrenches with a component other than zero, which are the only
// ones that change a sum, with their links li and lj. A warp scan places
// them (mj_warp_compact) in narrow-phase order in the env's slots. Then
// each link's lane adds, in slot order, +f where it is li and -f where it
// is lj: the scalar sum, point after point, bit for bit. K1 places every
// pair's in one pass (at most MJ_MAX_POINTS slots: every contact point of
// the model, which the packer checks). K3 takes the pairs in rounds of 32:
// each round's wrenches are placed in slots (at most 32 x 16) and added to
// each link's running sum before the next round, so a model may have any
// number of contact points (pen 406, hammer 671, door 760). A model with
// fluid drag adds each link's next, over lanes (mj_link_fluid).
//
// The host build (mj_host.cpp) runs this same code under the emulated warp
// (MjWarpHost), one env after another.
#pragma once

#include "mj_warp_stages.h"

#ifndef MJ_MAX_POINTS
#define MJ_MAX_POINTS 32  // contact points of a model (the small class's)
#endif
#define MJ_PAIR_POINTS 2  // contact points of a pair without the box kinds
#define MJ_EXT_PAIR_POINTS 16  // with them (box_box)
#define MJ_PENALTY_WARPS 8  // K1's (and K3's) warps (envs) per block at most
#define MJ_SHARED_PER_BLOCK 232448  // the shared memory a block may use (227 KB)

// One env's state for its control step, shared by the warp's lanes.
struct MjPenaltyEnv {
  float q[MJ_MAX_NQ], qd[MJ_MAX_NV], ctrl[MJ_MAX_NU];
  MjKin k;
  float M[MJ_MAX_NV][MJ_LD];  // the mass matrix, then its L^T D L factor
  float qdd0[MJ_MAX_NV], bias[MJ_MAX_NV], ldiag[MJ_MAX_NV];
  unsigned char depth[MJ_MAX_LINK];  // each link's depth in the tree
  unsigned char anc[MJ_MAX_NV][MJ_MAX_NV], nanc[MJ_MAX_NV];  // each dof's ancestors
  union {  // one stage's scratch at a time
    struct {
      float rel_p[MJ_MAX_LINK][3], rel_q[MJ_MAX_LINK][4];
    } kin;
    struct {  // each lane's pair's wrenches before the scan places them
      float f[MJ_WARP][MJ_PAIR_POINTS][6];
      signed char l[MJ_WARP][MJ_PAIR_POINTS][2];
    } pend;
    struct {
      float f_ext[MJ_MAX_LINK][6], cacc[MJ_MAX_LINK][6], facc[MJ_MAX_LINK][6];
    } rne;
    struct {
      float ch[MJ_MAX_LINK][3], cI[MJ_MAX_LINK][6], F[MJ_MAX_NV][6];
    } crb;
  } s;
  // the substep's non-zero contact wrenches in narrow-phase order, and
  // their links li, lj (-1: the world)
  float wf[MJ_MAX_POINTS][6];
  signed char wl[MJ_MAX_POINTS][2];
  int cnt[MJ_WARP], off[MJ_WARP];  // the compaction's counts and slots
};

// K3's env: K1's with the link offsets, the tendons' scratch, and room for
// one round of 32 pairs' wrenches (at most MJ_EXT_PAIR_POINTS a pair).
struct MjPenaltyExtEnv {
  float q[MJ_MAX_NQ], qd[MJ_MAX_NV], ctrl[MJ_MAX_NU], delta[3 * MJ_MAX_LINK];
  MjKin k;
  float M[MJ_MAX_NV][MJ_LD];  // the mass matrix, then its L^T D L factor
  float qdd0[MJ_MAX_NV], bias[MJ_MAX_NV], ldiag[MJ_MAX_NV];
  unsigned char depth[MJ_MAX_LINK];  // each link's depth in the tree
  unsigned char anc[MJ_MAX_NV][MJ_MAX_NV], nanc[MJ_MAX_NV];  // each dof's ancestors
  union {  // one stage's scratch at a time
    struct {
      float rel_p[MJ_MAX_LINK][3], rel_q[MJ_MAX_LINK][4];
    } kin;
    struct {  // f_ext (rne's first member) carries each link's running sum
              // across the rounds; each lane's pair's wrenches of a round
              // wait behind it for the scan
      float f_ext[MJ_MAX_LINK][6];
      float f[MJ_WARP][MJ_EXT_PAIR_POINTS][6];
      signed char l[MJ_WARP][MJ_EXT_PAIR_POINTS][2];
    } pend;
    struct {
      float f_ext[MJ_MAX_LINK][6], cacc[MJ_MAX_LINK][6], facc[MJ_MAX_LINK][6];
    } rne;
    float ften[MJ_MAX_TEN];
    struct {
      float ch[MJ_MAX_LINK][3], cI[MJ_MAX_LINK][6], F[MJ_MAX_NV][6];
    } crb;
  } s;
  // a round's non-zero contact wrenches in narrow-phase order, and their
  // links li, lj (-1: the world)
  float wf[MJ_WARP * MJ_EXT_PAIR_POINTS][6];
  signed char wl[MJ_WARP * MJ_EXT_PAIR_POINTS][2];
  int cnt[MJ_WARP], off[MJ_WARP];  // the compaction's counts and slots
};

// K3's warps per block at most: as many envs as a block's shared memory
// holds, up to K1's.
#define MJ_PENALTY_EXT_WARPS                                             \
  ((int)(MJ_SHARED_PER_BLOCK / sizeof(MjPenaltyExtEnv)) < MJ_PENALTY_WARPS \
       ? (int)(MJ_SHARED_PER_BLOCK / sizeof(MjPenaltyExtEnv))              \
       : MJ_PENALTY_WARPS)

// The layout as the wrapper reads it (mj_warp_layout()): bytes of shared
// memory per warp, tendons, warps per block and stages at most, and
// contact points at most (K3: 0, no cap).
#define MJ_PENALTY_WARP_LAYOUT_VALUES \
  (int)sizeof(MjPenaltyEnv), 0, MJ_PENALTY_WARPS, MJ_N_STAGES, MJ_MAX_POINTS
#define MJ_PENALTY_EXT_WARP_LAYOUT_VALUES \
  (int)sizeof(MjPenaltyExtEnv), MJ_MAX_TEN, MJ_PENALTY_EXT_WARPS, MJ_N_STAGES, 0

// One contact point's penalty wrench about the origin into f (the plain
// version's _contact_forces for one point, before its sum into f_ext).
MJ_HD void mj_point_wrench(const float* mf, int li, int lj, float mu, float depth,
                           const float* n, const float* pt, const MjKin& k, int has_fcap,
                           float* f) {
  float p_rel[3], v_rel[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) p_rel[c] = pt[c] - k.origin[c];
  if (li >= 0) {
    float c3[3];
    mj_cross(k.cvel[li], p_rel, c3);
    for (int c = 0; c < 3; ++c) v_rel[c] = k.cvel[li][3 + c] + c3[c];
  }
  if (lj >= 0) {
    float c3[3];
    mj_cross(k.cvel[lj], p_rel, c3);
    for (int c = 0; c < 3; ++c) v_rel[c] -= k.cvel[lj][3 + c] + c3[c];
  }
  float v_n = mj_dot3(v_rel, n);
  float v_t[3];
  for (int c = 0; c < 3; ++c) v_t[c] = v_rel[c] - v_n * n[c];
  float fn = mj_max(mf[MJ_F_KS] * mj_min(depth, mf[MJ_F_CAP]) - mf[MJ_F_KD] * v_n, 0.0f);
  fn = depth > 0.0f ? fn : 0.0f;
  if (has_fcap) fn = mj_min(fn, mf[MJ_F_FCAP]);
  float denom = sqrtf(mj_dot3(v_t, v_t)) + mf[MJ_F_VREG];
  for (int c = 0; c < 3; ++c) f[3 + c] = fn * n[c] - mu * fn * v_t[c] / denom;
  mj_cross(p_rel, f + 3, f);
}

// Whether adding f to a sum can change it: a component other than zero
// (NaN included). A sum that starts at +0 never becomes -0, so adding a
// wrench of zeros of either sign leaves it as it is.
MJ_HD bool mj_changes_sum(const float* f) {
  for (int c = 0; c < 6; ++c)
    if (f[c] != 0.0f) return true;
  return false;
}

// A pair's points' wrenches, the non-zero ones kept in order (at most N).
template <int N>
struct MjWrenchSink {
  const float* mf;
  const MjKin* k;
  int has_fcap;
  float (*f)[6];
  signed char (*l)[2];
  int n;
  MJ_HD void operator()(int, int li, int lj, float mu, float depth, const float* nrm,
                        const float* pt) {
    float w[6];
    mj_point_wrench(mf, li, lj, mu, depth, nrm, pt, *k, has_fcap, w);
    if (!mj_changes_sum(w) || n >= N) return;
    for (int c = 0; c < 6; ++c) f[n][c] = w[c];
    l[n][0] = (signed char)li;
    l[n][1] = (signed char)lj;
    ++n;
  }
};

// The contact stage: every link's penalty wrench in S.s.rne.f_ext, summed
// point after point in narrow-phase order; returns the slots filled (the
// points with a non-zero wrench).
template <class W>
MJ_WD int mj_warp_contacts(W& w, MjPenaltyEnv& S, const float* mf, const int* mi) {
  auto& P = S.s.pend;
  const int has_fcap = mi[MJ_I_HAS_FCAP];
  const int n = mj_warp_compact(
      w, S.cnt, S.off, mi[MJ_I_NPAIR],
      [&](int pi) {
        const int l = pi % MJ_WARP;
        MjWrenchSink<MJ_PAIR_POINTS> sink{mf, &S.k, has_fcap, P.f[l], P.l[l], 0};
        mj_narrow_pair<false>(mf, mi, S.k, pi, sink);
        return sink.n;
      },
      [&](int pi, int slot) {
        const int l = pi % MJ_WARP;
        for (int p = 0; p < S.cnt[l] && slot + p < MJ_MAX_POINTS; ++p) {
          for (int c = 0; c < 6; ++c) S.wf[slot + p][c] = P.f[l][p][c];
          S.wl[slot + p][0] = P.l[l][p][0];
          S.wl[slot + p][1] = P.l[l][p][1];
        }
      });
  const int slots = n < MJ_MAX_POINTS ? n : MJ_MAX_POINTS;
  auto& R = S.s.rne;
  w.each(mi[MJ_I_NLINK], [&](int i) {
    float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < slots; ++s) {
      if (S.wl[s][0] == i)
        for (int c = 0; c < 6; ++c) a[c] += S.wf[s][c];
      if (S.wl[s][1] == i)
        for (int c = 0; c < 6; ++c) a[c] -= S.wf[s][c];
    }
    for (int c = 0; c < 6; ++c) R.f_ext[i][c] = a[c];
  });
  return n;
}

// Pair pi's points' non-zero wrenches with the box kinds into f, l;
// returns how many.
MJ_NOINLINE int mj_pair_wrenches(const float* mf, const int* mi, const MjKin& k, int pi,
                                 float (*f)[6], signed char (*l)[2]) {
  MjWrenchSink<MJ_EXT_PAIR_POINTS> sink{mf, &k, mi[MJ_I_HAS_FCAP], f, l, 0};
  mj_narrow_pair<true>(mf, mi, k, pi, sink);
  return sink.n;
}

// K3's contact stage: every link's penalty wrench in S.s.rne.f_ext, summed
// point after point in narrow-phase order, the pairs in rounds of 32 (one
// a lane): a round's non-zero wrenches are placed by the warp scan in
// slots, and each link's lane adds them in slot order to its running sum
// before the next round. Returns the slots filled over all rounds (the
// points with a non-zero wrench).
template <class W>
MJ_WD int mj_warp_contacts_ext(W& w, MjPenaltyExtEnv& S, const float* mf, const int* mi) {
  auto& P = S.s.pend;
  const int nlink = mi[MJ_I_NLINK], npair = mi[MJ_I_NPAIR];
  w.each(nlink, [&](int i) {
    for (int c = 0; c < 6; ++c) P.f_ext[i][c] = 0.0f;
  });
  int total = 0;
  for (int base = 0; base < npair; base += MJ_WARP) {
    const int n = mj_warp_compact(
        w, S.cnt, S.off, npair - base < MJ_WARP ? npair - base : MJ_WARP,
        [&](int l) { return mj_pair_wrenches(mf, mi, S.k, base + l, P.f[l], P.l[l]); },
        [&](int l, int slot) {
          for (int p = 0; p < S.cnt[l]; ++p) {
            for (int c = 0; c < 6; ++c) S.wf[slot + p][c] = P.f[l][p][c];
            S.wl[slot + p][0] = P.l[l][p][0];
            S.wl[slot + p][1] = P.l[l][p][1];
          }
        });
    if (n == 0) continue;
    w.each(nlink, [&](int i) {
      float a[6];
      for (int c = 0; c < 6; ++c) a[c] = P.f_ext[i][c];
      for (int s = 0; s < n; ++s) {
        if (S.wl[s][0] == i)
          for (int c = 0; c < 6; ++c) a[c] += S.wf[s][c];
        if (S.wl[s][1] == i)
          for (int c = 0; c < 6; ++c) a[c] -= S.wf[s][c];
      }
      for (int c = 0; c < 6; ++c) P.f_ext[i][c] = a[c];
    });
    total += n;
  }
  return total;
}

// Advances the env in S (q, qd, with ctrl held) by one penalty substep of
// length dt; maxd: the tree's depth (mj_warp_depths), maxa: the most
// ancestors of a dof (mj_warp_chains); EXT (K3): Adroit's stages, delta
// (S.delta or null) the link offsets.
template <bool EXT, class W, class Env>
MJ_WD void mj_warp_penalty_substep(W& w, Env& S, const float* mf, const int* mi, float dt,
                                   int maxd, int maxa, const float* delta) {
  mj_warp_kinematics(w, S, mf, mi, EXT ? delta : nullptr, maxd);
  MJ_STAMP(w, MJ_ST_KIN);
  if constexpr (EXT)
    mj_warp_contacts_ext(w, S, mf, mi);
  else
    mj_warp_contacts(w, S, mf, mi);
  if (mi[MJ_I_HAS_FLUID])
    w.each(mi[MJ_I_NLINK], [&](int i) { mj_link_fluid(mf, S.k, i, S.s.rne.f_ext); });
  MJ_STAMP(w, MJ_ST_ROWS);
  mj_warp_bias(w, S, mf, mi, maxd, true);
  MJ_STAMP(w, MJ_ST_RNE);
  mj_warp_forces<true, EXT>(w, S, mf, mi);
  MJ_STAMP(w, MJ_ST_FORCE);
  mj_warp_crb<false, EXT>(w, S, mf, mi, dt);
  MJ_STAMP(w, MJ_ST_CRB);
  mj_warp_ltdl(w, S, mf, mi, S.ldiag, S.qdd0, maxa);
  MJ_STAMP(w, MJ_ST_LTDL);
  w.one([&] { mj_integrate(mi, S.q, S.qd, S.qdd0, dt); });
  MJ_STAMP(w, MJ_ST_INT);
}

// Kernel K1's (EXT = false) or K3's (EXT = true) env: n_sub substeps with
// ctrl (and, with delta_in (3 nlink, B), K3's link offsets) held.
template <bool EXT, class W, class Env>
MJ_WD void mj_warp_penalty_multistep(W& w, Env& S, const float* mf, const int* mi, int env,
                                     int B, const float* q_in, const float* qd_in,
                                     const float* ctrl_in, const float* delta_in,
                                     float* q_out, float* qd_out, int n_sub, float dt) {
  const float* delta = nullptr;
  if constexpr (EXT) {
    mj_warp_load(w, S, mi, env, B, q_in, qd_in, ctrl_in, delta_in, S.delta);
    if (delta_in) delta = S.delta;
  } else {
    mj_warp_load(w, S, mi, env, B, q_in, qd_in, ctrl_in, nullptr, nullptr);
  }
  const int maxd = mj_warp_depths(w, S, mi), maxa = mj_warp_chains(w, S, mi);
  for (int s = 0; s < n_sub; ++s)
    mj_warp_penalty_substep<EXT>(w, S, mf, mi, dt, maxd, maxa, delta);
  mj_warp_store(w, S, mi, env, B, q_out, qd_out);
}
