// Kernel K1: one full control step of penalty-contact rigid-body physics
// per launch, one warp per env.
//
// Replaces mjrl_tpu/physics/pkernel.py::multistep_pallas (the Pallas TPU
// mega-kernel) on its body _kernel_body under the penalty solver. Each
// warp takes one env: its lanes load the env's column of the batch-last
// (rows, B) state into the warp's MjPenaltyEnv in shared memory, run n_sub
// substeps of mj_warp_penalty.h with ctrl held, the work of each stage
// spread over the lanes, and store once.
//
// What bounds it on an H100: the latency of one warp's dependent
// operations and phases, not bytes. A control step reads and writes ~260
// bytes per env but runs tens of thousands of dependent f32 operations.
// The design puts one env on 32 lanes instead of one thread: the
// per-link and per-dof stages (poses, subspaces, inertias, link forces,
// applied forces, the mass matrix's columns), the narrow phase and the
// contact wrenches (one pair per lane) run over lanes, and the tree
// walks level by level; the backward sums, the sparse L^T D L solve and
// the integration stay on one lane. The env's state (a few KB: the size
// class's mj_warp_layout()) sits in shared memory instead of a thread's
// local memory, and the wrapper picks the warps per block (at most
// MJ_PENALTY_WARPS) so that B envs spread over the SMs in one wave where
// the block's shared memory allows it (B=1024: 8 warps in each of 128
// blocks; B=256: 2). With few warps on a scheduler, each phase's latency
// (a shared round trip, the reconvergence of its lanes, the sync) is what
// a stage costs; a build with -DMJ_STAGE_CLOCKS
// (tools/torch_warp_stages.py) adds a clocks output (MJ_N_STAGES, B) of
// cycles per stage.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the parity tolerances assume IEEE
// sinf/cosf/sqrtf and division), in the size class the model fits. Bound
// to PyTorch with ctypes by mjrl_tpu_torch/physics/pkernel.py.
#include <cuda_runtime.h>

#include "mj_warp_penalty.h"

static_assert(MJ_PENALTY_WARPS * sizeof(MjPenaltyEnv) <= MJ_SHARED_PER_BLOCK,
              "a block's warps must fit the 227 KB of shared memory a block may use");

#ifdef MJ_STAGE_CLOCKS
#define MJ_CLOCKS_PARAM , long long* __restrict__ clocks
#define MJ_CLOCKS_ARG , clocks
#else
#define MJ_CLOCKS_PARAM
#define MJ_CLOCKS_ARG
#endif

extern __shared__ __align__(16) unsigned char mj_smem[];

__global__ void __launch_bounds__(MJ_WARP * MJ_PENALTY_WARPS)
    mj_multistep_kernel(const float* __restrict__ mf, const int* __restrict__ mi,
                        const float* __restrict__ q, const float* __restrict__ qd,
                        const float* __restrict__ ctrl, float* __restrict__ q_out,
                        float* __restrict__ qd_out, int B, int n_sub,
                        float dt MJ_CLOCKS_PARAM) {
  const int warp = threadIdx.x / MJ_WARP;
  const int env = blockIdx.x * (blockDim.x / MJ_WARP) + warp;
  if (env >= B) return;  // the whole warp: no lane of another env waits on it
  MjWarpDev w;
  w.lane = threadIdx.x % MJ_WARP;
  MjPenaltyEnv& S = reinterpret_cast<MjPenaltyEnv*>(mj_smem)[warp];
#ifdef MJ_STAGE_CLOCKS
  for (int s = 0; s < MJ_MAX_STAGES; ++s) w.clocks[s] = 0;
  w.last = clock64();
#endif
  mj_warp_penalty_multistep<false>(w, S, mf, mi, env, B, q, qd, ctrl, nullptr, q_out, qd_out,
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
  const int values[] = {MJ_PENALTY_WARP_LAYOUT_VALUES};
  const int n = (int)(sizeof values / sizeof values[0]);
  for (int k = 0; k < n; ++k) out[k] = values[k];
  return n;
}

// Launches on `stream` with `warps` envs per block (1 to MJ_PENALTY_WARPS)
// and returns the first CUDA error (0 means launched).
int mj_multistep_launch(const float* mf, const int* mi, const float* q,
                        const float* qd, const float* ctrl, float* q_out,
                        float* qd_out, int B, int n_sub, float dt, int warps,
                        void* stream MJ_CLOCKS_PARAM) {
  if (warps < 1 || warps > MJ_PENALTY_WARPS) return (int)cudaErrorInvalidValue;
  const int bytes = warps * (int)sizeof(MjPenaltyEnv);
  cudaError_t err = cudaFuncSetAttribute(
      mj_multistep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + warps - 1) / warps;
  mj_multistep_kernel<<<blocks, MJ_WARP * warps, bytes, (cudaStream_t)stream>>>(
      mf, mi, q, qd, ctrl, q_out, qd_out, B, n_sub, dt MJ_CLOCKS_ARG);
  return (int)cudaGetLastError();
}

}  // extern "C"
