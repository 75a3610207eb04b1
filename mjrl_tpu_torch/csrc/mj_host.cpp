// Host build of the K1, K2, K3 and K4 bodies (mj_warp_penalty.h with EXT
// off and on, mj_warp_newton.h with EXT off and on) for the CPU tests: the
// same warp-decomposed code as the CUDA kernels under the emulated warp
// (mj_warp.h's MjWarpHost), one env after another, each on a fresh state;
// and the pose kernel's warp body (mj_poses.h) the same way.
#include <string.h>

#include <vector>

#include "mj_poses.h"
#include "mj_warp_newton.h"
#include "mj_warp_penalty.h"

namespace {

// A fresh env state for a warp body: every float NaN and every int -1, so
// that a stage that reads what no earlier phase wrote shows in the result.
template <class Env>
Env* mj_fresh_env() {
  static Env S;
  memset(&S, 0xff, sizeof S);
  return &S;
}

// The Newton bodies' slab of held rows for B envs (MJ_SPILL_ROWS each; the
// card's is in device memory), fresh as an env state is.
struct MjHostSlab {
  std::vector<MjHeldRow> rows;
  explicit MjHostSlab(int B) : rows((size_t)B * MJ_SPILL_ROWS) {
    if (!rows.empty()) memset(rows.data(), 0xff, rows.size() * sizeof(MjHeldRow));
  }
  MjHeldRow* data() { return rows.data(); }
};

// Records every contact point's penalty wrench and links, in narrow-phase
// order.
struct MjRecordSink {
  const float* mf;
  const MjKin* k;
  int has_fcap;
  float* f;
  int* links;
  int n;
  void operator()(int, int li, int lj, float mu, float depth, const float* nrm,
                  const float* pt) {
    mj_point_wrench(mf, li, lj, mu, depth, nrm, pt, *k, has_fcap, f + 6 * n);
    links[2 * n] = li;
    links[2 * n + 1] = lj;
    ++n;
  }
};

}  // namespace

extern "C" {

int mj_layout(int* out) {
  const int values[MJ_LAYOUT_LEN] = {MJ_LAYOUT_VALUES};
  for (int k = 0; k < MJ_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_LAYOUT_LEN;
}

int mj_newton_layout(int* out) {
  const int values[MJ_NEWTON_LAYOUT_LEN] = {MJ_NEWTON_LAYOUT_VALUES};
  for (int k = 0; k < MJ_NEWTON_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_NEWTON_LAYOUT_LEN;
}

// The Newton bodies' warp layout (K4's warps per block).
int mj_warp_layout(int* out) {
  const int values[MJ_WARP_LAYOUT_LEN] = {MJ_NEWTON_WARP_LAYOUT_VALUES(MJ_MAX_WARPS)};
  for (int k = 0; k < MJ_WARP_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_WARP_LAYOUT_LEN;
}

// K1's warp layout.
int mj_penalty_warp_layout(int* out) {
  const int values[MJ_WARP_LAYOUT_LEN] = {MJ_PENALTY_WARP_LAYOUT_VALUES};
  for (int k = 0; k < MJ_WARP_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_WARP_LAYOUT_LEN;
}

// K3's warp layout.
int mj_penalty_ext_warp_layout(int* out) {
  const int values[MJ_WARP_LAYOUT_LEN] = {MJ_PENALTY_EXT_WARP_LAYOUT_VALUES};
  for (int k = 0; k < MJ_WARP_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_WARP_LAYOUT_LEN;
}

// K1's body.
int mj_multistep_host(const float* mf, const int* mi, const float* q,
                      const float* qd, const float* ctrl, float* q_out,
                      float* qd_out, int B, int n_sub, float dt) {
  MjWarpHost w;
  for (int env = 0; env < B; ++env)
    mj_warp_penalty_multistep<false>(w, *mj_fresh_env<MjPenaltyEnv>(), mf, mi, env, B, q, qd,
                                     ctrl, nullptr, q_out, qd_out, n_sub, dt);
  return 0;
}

// K3's body; delta may be null (no link offsets).
int mj_ext_host(const float* mf, const int* mi, const float* q, const float* qd,
                const float* ctrl, const float* delta, float* q_out,
                float* qd_out, int B, int n_sub, float dt) {
  MjWarpHost w;
  for (int env = 0; env < B; ++env)
    mj_warp_penalty_multistep<true>(w, *mj_fresh_env<MjPenaltyExtEnv>(), mf, mi, env, B, q, qd,
                                    ctrl, delta, q_out, qd_out, n_sub, dt);
  return 0;
}

// K2's body, each env-substep's counts added to stats (MJ_N_STATS long
// longs, or null: the kernel's counters, mj_newton.h's MJ_STAT_*);
// returns the env-substeps with more contact rows inside their margin than
// MJ_MAX_HELD (0: every row held).
int mj_newton_stats_host(const float* mf, const int* mi, const float* nf,
                         const int* ni, const float* q, const float* qd,
                         const float* ctrl, float* q_out, float* qd_out, int* picks,
                         long long* stats, int B, int n_sub, int iters, float dt) {
  MjWarpHost w;
  MjHostSlab slab(B);
  int overflow = 0;
  for (int env = 0; env < B; ++env)
    mj_warp_env_multistep<false>(w, *mj_fresh_env<MjWarpEnv>(), mf, mi, nf, ni, env, B, q,
                                 qd, ctrl, nullptr, q_out, qd_out, picks, &overflow, stats,
                                 slab.data(), n_sub, iters, dt);
  return overflow;
}

// K2's body without the counters.
int mj_newton_host(const float* mf, const int* mi, const float* nf,
                   const int* ni, const float* q, const float* qd,
                   const float* ctrl, float* q_out, float* qd_out, int* picks,
                   int B, int n_sub, int iters, float dt) {
  return mj_newton_stats_host(mf, mi, nf, ni, q, qd, ctrl, q_out, qd_out, picks, nullptr, B,
                              n_sub, iters, dt);
}

// K4's body; *overflow counts the env-substeps with more contact rows
// inside their margin than MJ_MAX_HELD; stats as mj_newton_stats_host's;
// the rows past MJ_HELD_SHARED in a slab in host memory.
int mj_ext_newton_stats_host(const float* mf, const int* mi, const float* nf,
                             const int* ni, const float* q, const float* qd,
                             const float* ctrl, const float* delta, float* q_out,
                             float* qd_out, int* picks, int* overflow, long long* stats,
                             int B, int n_sub, int iters, float dt) {
  MjWarpHost w;
  MjHostSlab slab(B);
  for (int env = 0; env < B; ++env)
    mj_warp_env_multistep<true>(w, *mj_fresh_env<MjWarpEnv>(), mf, mi, nf, ni, env, B, q,
                                qd, ctrl, delta, q_out, qd_out, picks, overflow, stats,
                                slab.data(), n_sub, iters, dt);
  return 0;
}

// K4's body without the counters.
int mj_ext_newton_host(const float* mf, const int* mi, const float* nf,
                       const int* ni, const float* q, const float* qd,
                       const float* ctrl, const float* delta, float* q_out,
                       float* qd_out, int* picks, int* overflow, int B, int n_sub,
                       int iters, float dt) {
  return mj_ext_newton_stats_host(mf, mi, nf, ni, q, qd, ctrl, delta, q_out, qd_out, picks,
                                  overflow, nullptr, B, n_sub, iters, dt);
}

// The pose kernel's body (mj_poses_kernel.cu's mj_poses_launch, the same
// arguments without the stream).
int mj_poses_host(const float* mf, const int* mi, const float* site_pos, const int* site_link,
                  int nsite, const float* q, long long sq0, long long sq1, const float* delta,
                  long long sd0, long long sd1, long long sd2, float* pos, float* quat,
                  float* sites, int B) {
  MjWarpHost w;
  const long long sq[2] = {sq0, sq1}, sd[3] = {sd0, sd1, sd2};
  for (int env = 0; env < B; ++env)
    mj_warp_poses(w, *mj_fresh_env<MjPoseEnv>(), mf, mi, site_pos, site_link, nsite, q, sq,
                  delta, sd, env, pos, quat, sites);
  return 0;
}

// The contact rows K4 holds for env's substep from the batch-last state
// (q, qd, delta or null): pair (MJ_MAX_HELD), D (MJ_MAX_HELD), aref
// (MJ_MAX_HELD, MJ_MAX_FACET) and J (MJ_MAX_HELD, MJ_MAX_FACET,
// MJ_MAX_CHAIN) in held order, the first min(n, MJ_MAX_HELD) filled;
// returns n, the rows inside their margin.
int mj_ext_newton_rows_host(const float* mf, const int* mi, const float* nf,
                            const int* ni, const float* q, const float* qd,
                            const float* delta, int B, int env, int* pair, float* D,
                            float* aref, float* J) {
  MjWarpHost w;
  MjWarpEnv& S = *mj_fresh_env<MjWarpEnv>();
  MjHostSlab slab(1);
  mj_warp_slab(w, S, slab.data(), 0);
  for (int r = 0; r < mi[MJ_I_NQ]; ++r) S.q[r] = q[(long)r * B + env];
  for (int r = 0; r < mi[MJ_I_NV]; ++r) S.qd[r] = qd[(long)r * B + env];
  for (int r = 0; delta && r < 3 * mi[MJ_I_NLINK]; ++r) S.delta[r] = delta[(long)r * B + env];
  mj_kinematics(mf, mi, S.q, S.qd, S.k, delta ? S.delta : nullptr);
  int nl;
  const int n = mj_warp_rows<true>(w, S, mf, mi, nf, ni, nl);
  const int held = n < MJ_MAX_HELD ? n : MJ_MAX_HELD;
  for (int c = 0; c < held; ++c) {
    const MjHeldRow& R = mj_row(S, c);
    pair[c] = R.pair;
    D[c] = R.D;
    memcpy(aref + c * MJ_MAX_FACET, R.aref, sizeof R.aref);
    memcpy(J + c * MJ_MAX_FACET * MJ_MAX_CHAIN, R.J, sizeof R.J);
  }
  return n;
}

// K1's contact stage for env's substep from the batch-last state (q, qd):
// every contact point's penalty wrench (points, 6) and links li, lj
// (points, 2) in narrow-phase order, computed alone; and f_ext (nlink, 6),
// each link's wrench after the warp body's contact stage. *slots receives
// the slots that stage filled (the points with a non-zero wrench). Returns
// the number of points.
int mj_penalty_contacts_host(const float* mf, const int* mi, const float* q,
                             const float* qd, int B, int env, float* points, int* links,
                             float* f_ext, int* slots) {
  MjWarpHost w;
  MjPenaltyEnv& S = *mj_fresh_env<MjPenaltyEnv>();
  for (int r = 0; r < mi[MJ_I_NQ]; ++r) S.q[r] = q[(long)r * B + env];
  for (int r = 0; r < mi[MJ_I_NV]; ++r) S.qd[r] = qd[(long)r * B + env];
  const int maxd = mj_warp_depths(w, S, mi);
  mj_warp_kinematics(w, S, mf, mi, nullptr, maxd);
  MjRecordSink sink{mf, &S.k, mi[MJ_I_HAS_FCAP], points, links, 0};
  mj_narrow_phase(mf, mi, S.k, sink);
  *slots = mj_warp_contacts(w, S, mf, mi);
  memcpy(f_ext, S.s.rne.f_ext, mi[MJ_I_NLINK] * sizeof S.s.rne.f_ext[0]);
  return sink.n;
}

// K3's contact stage for env's substep from the batch-last state (q, qd,
// delta or null), as mj_penalty_contacts_host for K1: every contact
// point's penalty wrench (points, 6) and links (points, 2) in narrow-phase
// order with the box kinds, computed alone; f_ext (nlink, 6) after the
// warp body's rounds; *slots the slots they filled over all rounds.
// Returns the number of points.
int mj_ext_contacts_host(const float* mf, const int* mi, const float* q, const float* qd,
                         const float* delta, int B, int env, float* points, int* links,
                         float* f_ext, int* slots) {
  MjWarpHost w;
  MjPenaltyExtEnv& S = *mj_fresh_env<MjPenaltyExtEnv>();
  for (int r = 0; r < mi[MJ_I_NQ]; ++r) S.q[r] = q[(long)r * B + env];
  for (int r = 0; r < mi[MJ_I_NV]; ++r) S.qd[r] = qd[(long)r * B + env];
  for (int r = 0; delta && r < 3 * mi[MJ_I_NLINK]; ++r) S.delta[r] = delta[(long)r * B + env];
  const int maxd = mj_warp_depths(w, S, mi);
  mj_warp_kinematics(w, S, mf, mi, delta ? S.delta : nullptr, maxd);
  MjRecordSink sink{mf, &S.k, mi[MJ_I_HAS_FCAP], points, links, 0};
  mj_narrow_phase<true>(mf, mi, S.k, sink);
  *slots = mj_warp_contacts_ext(w, S, mf, mi);
  memcpy(f_ext, S.s.rne.f_ext, mi[MJ_I_NLINK] * sizeof S.s.rne.f_ext[0]);
  return sink.n;
}

// The emulated warp's primitives on n items: visits[i] counts each's
// visits by w.each; offsets[i] is the slot mj_warp_compact gives item i
// when it brings counts[i] slots (-1 for an item without one); *sum is
// w.sum of values in index order. Returns the compaction's total.
int mj_warp_probe(int n, const int* counts, const float* values, int* visits,
                  int* offsets, float* sum) {
  MjWarpHost w;
  int cnt[MJ_WARP], off[MJ_WARP];
  for (int i = 0; i < n; ++i) visits[i] = 0, offsets[i] = -1;
  w.each(n, [&](int i) { ++visits[i]; });
  *sum = w.sum(n, 0.0f, [&](int i) { return values[i]; });
  return mj_warp_compact(
      w, cnt, off, n, [&](int i) { return counts[i]; },
      [&](int i, int slot) { offsets[i] = slot; });
}

}  // extern "C"
