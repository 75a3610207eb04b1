// Kernel K3: one full control step of penalty-contact rigid-body physics
// with Adroit's stages, per launch, one thread per env.
//
// Replaces mjrl_tpu/physics/pkernel.py::_kernel_body_ext (the Pallas TPU
// mega-kernel's body for models with fixed tendons and per-env scene
// offsets, which every Adroit env takes). It runs mj_substep.h's substep
// with EXT = true: the link offsets (delta, (3 nlink, B), optional) in the
// kinematics, the box contact kinds, gain/bias servos, fixed tendons and
// frictionloss, besides everything K1 runs. The tendon tables travel in
// the model buffers (mf, mi) after the contact pairs.
//
// What bounds it on an H100: per-thread latency, as K1. Pen's control step
// (5 substeps, 406 contact points each, a 30-dof tree) moves ~0.8 KB per
// env but runs hundreds of thousands of dependent f32 operations in one
// thread, with the per-env arrays (the dense 36 x 36 H alone is 5 KB) in
// local memory. The design keeps the whole control step in the thread and
// leaves occupancy and splitting an env across a warp to later work.
//
// Build: as K1 (mj_kernel.cu), in the size class pen fits.
#include <cuda_runtime.h>

#include "mj_substep.h"

#define MJ_THREADS 128

__global__ void __launch_bounds__(MJ_THREADS)
    mj_ext_kernel(const float* __restrict__ mf, const int* __restrict__ mi,
                  const float* __restrict__ q, const float* __restrict__ qd,
                  const float* __restrict__ ctrl,
                  const float* __restrict__ delta, float* __restrict__ q_out,
                  float* __restrict__ qd_out, int B, int n_sub, float dt) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  mj_ext_env_multistep(mf, mi, env, B, q, qd, ctrl, delta, q_out, qd_out,
                       n_sub, dt);
}

extern "C" {

int mj_layout(int* out) {
  const int values[MJ_LAYOUT_LEN] = {MJ_LAYOUT_VALUES};
  for (int k = 0; k < MJ_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_LAYOUT_LEN;
}

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// delta may be null (no link offsets).
int mj_ext_launch(const float* mf, const int* mi, const float* q,
                  const float* qd, const float* ctrl, const float* delta,
                  float* q_out, float* qd_out, int B, int n_sub, float dt,
                  void* stream) {
  const int blocks = (B + MJ_THREADS - 1) / MJ_THREADS;
  mj_ext_kernel<<<blocks, MJ_THREADS, 0, (cudaStream_t)stream>>>(
      mf, mi, q, qd, ctrl, delta, q_out, qd_out, B, n_sub, dt);
  return (int)cudaGetLastError();
}

}  // extern "C"
