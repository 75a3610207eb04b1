// Host build of the K1 body (mj_substep.h) for the CPU tests: the same
// arithmetic as the CUDA kernel, one env after another.
#include "mj_substep.h"

extern "C" {

int mj_layout(int* out) {
  const int values[MJ_LAYOUT_LEN] = {MJ_LAYOUT_VALUES};
  for (int k = 0; k < MJ_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_LAYOUT_LEN;
}

int mj_multistep_host(const float* mf, const int* mi, const float* q,
                      const float* qd, const float* ctrl, float* q_out,
                      float* qd_out, int B, int n_sub, float dt) {
  for (int env = 0; env < B; ++env)
    mj_env_multistep(mf, mi, env, B, q, qd, ctrl, q_out, qd_out, n_sub, dt);
  return 0;
}

}  // extern "C"
