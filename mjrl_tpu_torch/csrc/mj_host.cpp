// Host build of the K1 and K2 bodies (mj_substep.h, mj_newton.h) for the
// CPU tests: the same arithmetic as the CUDA kernels, one env after
// another.
#include "mj_newton.h"

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

int mj_multistep_host(const float* mf, const int* mi, const float* q,
                      const float* qd, const float* ctrl, float* q_out,
                      float* qd_out, int B, int n_sub, float dt) {
  for (int env = 0; env < B; ++env)
    mj_env_multistep(mf, mi, env, B, q, qd, ctrl, q_out, qd_out, n_sub, dt);
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

}  // extern "C"
