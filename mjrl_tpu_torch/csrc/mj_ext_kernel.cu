// Kernel K3: one full control step of penalty-contact rigid-body physics
// with Adroit's stages, per launch, one warp per env.
//
// Replaces mjrl_tpu/physics/pkernel.py::_kernel_body_ext (the Pallas TPU
// mega-kernel's body for models with fixed tendons and per-env scene
// offsets, which every Adroit env takes). Each warp takes one env: its
// lanes load the env's column of the batch-last (rows, B) state and link
// offsets (delta, (3 nlink, B), optional) into the warp's MjPenaltyExtEnv
// in shared memory, run n_sub substeps of mj_warp_penalty.h with EXT on
// (the link offsets in the kinematics, the box contact kinds, gain/bias
// servos, fixed tendons and frictionloss, besides everything K1 runs) and
// ctrl held, the work of each stage spread over the lanes, and store once.
// The tendon tables travel in the model buffers (mf, mi) after the contact
// pairs.
//
// What bounds it on an H100: the latency of one warp's dependent
// operations and phases, not bytes. Pen's control step (5 substeps, 406
// contact points in 123 pairs each, a 30-dof tree, 44 tendons) moves ~0.8
// KB per env but runs ~120k f32 operations per substep. The design puts
// one env on 32 lanes instead of one thread, as K1 does: the per-link and
// per-dof stages, the tendons and the contact pairs (32 at a time, one a
// lane) run over lanes, and the tree walks level by level. The env's state
// (the Adroit class's mj_warp_layout(): its kinematics, mass matrix and a
// round's 32 x 16 contact wrenches) sits in shared memory instead of a
// thread's local memory, and the wrapper picks the warps per block (at
// most MJ_PENALTY_EXT_WARPS, as many as fit) so that B envs spread over
// the SMs in one wave (B=512: 4 warps in each of 128 blocks). A build with
// -DMJ_STAGE_CLOCKS (tools/torch_warp_stages.py) adds a clocks output
// (MJ_N_STAGES, B) of cycles per stage.
//
// Build: as K1 (mj_kernel.cu), in the size class the model fits.
#include <cuda_runtime.h>

#include "mj_warp_penalty.h"

static_assert(MJ_PENALTY_EXT_WARPS >= 1 &&
                  MJ_PENALTY_EXT_WARPS * sizeof(MjPenaltyExtEnv) <= MJ_SHARED_PER_BLOCK,
              "a block's warps must fit the 227 KB of shared memory a block may use");

#ifdef MJ_STAGE_CLOCKS
#define MJ_CLOCKS_PARAM , long long* __restrict__ clocks
#define MJ_CLOCKS_ARG , clocks
#else
#define MJ_CLOCKS_PARAM
#define MJ_CLOCKS_ARG
#endif

extern __shared__ __align__(16) unsigned char mj_smem[];

__global__ void __launch_bounds__(MJ_WARP * MJ_PENALTY_EXT_WARPS)
    mj_ext_kernel(const float* __restrict__ mf, const int* __restrict__ mi,
                  const float* __restrict__ q, const float* __restrict__ qd,
                  const float* __restrict__ ctrl, const float* __restrict__ delta,
                  float* __restrict__ q_out, float* __restrict__ qd_out, int B, int n_sub,
                  float dt MJ_CLOCKS_PARAM) {
  const int warp = threadIdx.x / MJ_WARP;
  const int env = blockIdx.x * (blockDim.x / MJ_WARP) + warp;
  if (env >= B) return;  // the whole warp: no lane of another env waits on it
  MjWarpDev w;
  w.lane = threadIdx.x % MJ_WARP;
  MjPenaltyExtEnv& S = reinterpret_cast<MjPenaltyExtEnv*>(mj_smem)[warp];
#ifdef MJ_STAGE_CLOCKS
  for (int s = 0; s < MJ_MAX_STAGES; ++s) w.clocks[s] = 0;
  w.last = clock64();
#endif
  mj_warp_penalty_multistep<true>(w, S, mf, mi, env, B, q, qd, ctrl, delta, q_out, qd_out,
                                  n_sub, dt);
#ifdef MJ_STAGE_CLOCKS
  if (w.lane == 0)
    for (int s = 0; s < MJ_N_STAGES; ++s) clocks[(long)s * B + env] = w.clocks[s];
#endif
}

extern "C" {

int mj_layout(int* out) {
  const int values[MJ_LAYOUT_LEN] = {MJ_LAYOUT_VALUES};
  for (int k = 0; k < MJ_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_LAYOUT_LEN;
}

int mj_warp_layout(int* out) {
  const int values[] = {MJ_PENALTY_EXT_WARP_LAYOUT_VALUES};
  const int n = (int)(sizeof values / sizeof values[0]);
  for (int k = 0; k < n; ++k) out[k] = values[k];
  return n;
}

// Launches on `stream` with `warps` envs per block (1 to
// MJ_PENALTY_EXT_WARPS) and returns the first CUDA error (0 means
// launched). delta may be null (no link offsets).
int mj_ext_launch(const float* mf, const int* mi, const float* q, const float* qd,
                  const float* ctrl, const float* delta, float* q_out, float* qd_out, int B,
                  int n_sub, float dt, int warps, void* stream MJ_CLOCKS_PARAM) {
  if (warps < 1 || warps > MJ_PENALTY_EXT_WARPS) return (int)cudaErrorInvalidValue;
  const int bytes = warps * (int)sizeof(MjPenaltyExtEnv);
  cudaError_t err = cudaFuncSetAttribute(
      mj_ext_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + warps - 1) / warps;
  mj_ext_kernel<<<blocks, MJ_WARP * warps, bytes, (cudaStream_t)stream>>>(
      mf, mi, q, qd, ctrl, delta, q_out, qd_out, B, n_sub, dt MJ_CLOCKS_ARG);
  return (int)cudaGetLastError();
}

}  // extern "C"
