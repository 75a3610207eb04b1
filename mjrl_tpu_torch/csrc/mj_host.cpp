// Host build of the K1, K2, K3 and K4 bodies (mj_substep.h, mj_newton.h,
// mj_ext_newton.h) for the CPU tests: the same arithmetic as the CUDA
// kernels, one env after another; K4's warp-decomposed body runs under the
// emulated warp (mj_warp.h's MjWarpHost).
#include <string.h>

#include "mj_ext_newton.h"

namespace {

// A fresh env state for K4's host body: every float NaN and every int -1,
// so that a stage that reads what no earlier phase wrote shows in the
// result.
MjWarpEnv* mj_fresh_env() {
  static MjWarpEnv S;
  memset(&S, 0xff, sizeof S);
  return &S;
}

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

int mj_warp_layout(int* out) {
  const int values[MJ_WARP_LAYOUT_LEN] = {MJ_WARP_LAYOUT_VALUES};
  for (int k = 0; k < MJ_WARP_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_WARP_LAYOUT_LEN;
}

int mj_multistep_host(const float* mf, const int* mi, const float* q,
                      const float* qd, const float* ctrl, float* q_out,
                      float* qd_out, int B, int n_sub, float dt) {
  for (int env = 0; env < B; ++env)
    mj_env_multistep(mf, mi, env, B, q, qd, ctrl, q_out, qd_out, n_sub, dt);
  return 0;
}

int mj_ext_host(const float* mf, const int* mi, const float* q, const float* qd,
                const float* ctrl, const float* delta, float* q_out,
                float* qd_out, int B, int n_sub, float dt) {
  for (int env = 0; env < B; ++env)
    mj_ext_env_multistep(mf, mi, env, B, q, qd, ctrl, delta, q_out, qd_out,
                         n_sub, dt);
  return 0;
}

int mj_newton_host(const float* mf, const int* mi, const float* nf,
                   const int* ni, const float* q, const float* qd,
                   const float* ctrl, float* q_out, float* qd_out, int* picks,
                   int B, int n_sub, int iters, float dt) {
  for (int env = 0; env < B; ++env)
    mj_newton_env_multistep(mf, mi, nf, ni, env, B, q, qd, ctrl, q_out, qd_out,
                            picks, n_sub, iters, dt);
  return 0;
}

// K4's body; *overflow counts the env-substeps with more contact rows
// inside their margin than MJ_MAX_HELD.
int mj_ext_newton_host(const float* mf, const int* mi, const float* nf,
                       const int* ni, const float* q, const float* qd,
                       const float* ctrl, const float* delta, float* q_out,
                       float* qd_out, int* picks, int* overflow, int B, int n_sub,
                       int iters, float dt) {
  MjWarpHost w;
  for (int env = 0; env < B; ++env)
    mj_warp_env_multistep(w, *mj_fresh_env(), mf, mi, nf, ni, env, B, q, qd, ctrl,
                          delta, q_out, qd_out, picks, overflow, n_sub, iters, dt);
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
  MjWarpEnv& S = *mj_fresh_env();
  for (int r = 0; r < mi[MJ_I_NQ]; ++r) S.q[r] = q[(long)r * B + env];
  for (int r = 0; r < mi[MJ_I_NV]; ++r) S.qd[r] = qd[(long)r * B + env];
  for (int r = 0; delta && r < 3 * mi[MJ_I_NLINK]; ++r) S.delta[r] = delta[(long)r * B + env];
  mj_kinematics(mf, mi, S.q, S.qd, S.k, delta ? S.delta : nullptr);
  int nl;
  const int n = mj_warp_rows(w, S, mf, mi, nf, ni, nl);
  const int held = n < MJ_MAX_HELD ? n : MJ_MAX_HELD;
  memcpy(pair, S.pair, held * sizeof(int));
  memcpy(D, S.D, held * sizeof(float));
  memcpy(aref, S.aref, held * sizeof S.aref[0]);
  memcpy(J, S.J, held * sizeof S.J[0]);
  return n;
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
