// Kernel K2: one full control step of Newton soft-constraint rigid-body
// physics per launch, one warp per env.
//
// Replaces mjrl_tpu/physics/pkernel.py::multistep_pallas run with
// constraint_solver="newton" (soa_newton.constrained_qdd,
// mjrl_tpu/physics/soa_newton.py:338) on its body _kernel_body. Each warp
// takes one env: its lanes load the env's column of the batch-last (rows,
// B) state into the warp's MjWarpEnv in shared memory, run n_sub substeps
// of mj_warp_newton.h with EXT off (K4's warp body without Adroit's
// stages) and ctrl held, the work of each stage spread over the lanes, and
// store once.
//
// What bounds it on an H100: the latency of one warp's dependent
// operations and phases, not bytes (~260 bytes per env per control step).
// Each substep runs the rigid-body pipeline and then solver_iters Newton
// iterations over the held rows (J over <= 8 chain dofs per facet), a
// dense 14x14 Cholesky and five line-search costs. The design puts one
// env on 32 lanes instead of one thread, so a warp no longer waits for the
// env among 32 with the most rows, and the work of each stage is spread
// over the lanes; the env's state (rows, H, the metric, the kinematics:
// the size class's mj_warp_layout(), ~25 KB) sits in shared memory instead
// of local memory, and the wrapper picks the warps per block (at most
// MJ_NEWTON_WARPS) so that B envs spread over the SMs in one wave (B=1024:
// 8 warps in each of 128 blocks; B=256: 2). At most MJ_MAX_HELD contact
// rows inside their margin per env-substep, which the packer checks for
// every K2 model (its points and limited joints); an env-substep with more
// would add one to the overflow counter, which the wrapper reads and
// raises on. A build with -DMJ_STAGE_CLOCKS (tools/torch_warp_stages.py)
// adds a clocks output (MJ_N_STAGES, B) of cycles per stage.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the parity tolerances assume IEEE
// sinf/cosf/sqrtf and division), in the small size class. Bound to
// PyTorch with ctypes by mjrl_tpu_torch/physics/pkernel.py.
#include <cuda_runtime.h>

#include "mj_warp_newton.h"

#define MJ_NEWTON_WARPS 8  // K2's warps (envs) per block at most

static_assert(MJ_NEWTON_WARPS * sizeof(MjWarpEnv) <= 232448,
              "a block's warps must fit the 227 KB of shared memory a block may use");

#ifdef MJ_STAGE_CLOCKS
#define MJ_CLOCKS_PARAM , long long* __restrict__ clocks
#define MJ_CLOCKS_ARG , clocks
#else
#define MJ_CLOCKS_PARAM
#define MJ_CLOCKS_ARG
#endif

extern __shared__ __align__(16) unsigned char mj_smem[];

__global__ void __launch_bounds__(MJ_WARP * MJ_NEWTON_WARPS)
    mj_newton_kernel(const float* __restrict__ mf, const int* __restrict__ mi,
                     const float* __restrict__ nf, const int* __restrict__ ni,
                     const float* __restrict__ q, const float* __restrict__ qd,
                     const float* __restrict__ ctrl, float* __restrict__ q_out,
                     float* __restrict__ qd_out, int* __restrict__ picks,
                     int* __restrict__ overflow, long long* __restrict__ stats,
                     int B, int n_sub, int iters, float dt MJ_CLOCKS_PARAM) {
  const int warp = threadIdx.x / MJ_WARP;
  const int env = blockIdx.x * (blockDim.x / MJ_WARP) + warp;
  if (env >= B) return;  // the whole warp: no lane of another env waits on it
  MjWarpDev w;
  w.lane = threadIdx.x % MJ_WARP;
  MjWarpEnv& S = reinterpret_cast<MjWarpEnv*>(mj_smem)[warp];
#ifdef MJ_STAGE_CLOCKS
  for (int s = 0; s < MJ_MAX_STAGES; ++s) w.clocks[s] = 0;
  w.last = clock64();
#endif
  mj_warp_env_multistep<false>(w, S, mf, mi, nf, ni, env, B, q, qd, ctrl, nullptr, q_out,
                               qd_out, picks, overflow, stats, nullptr, n_sub, iters, dt);
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

int mj_newton_layout(int* out) {
  const int values[MJ_NEWTON_LAYOUT_LEN] = {MJ_NEWTON_LAYOUT_VALUES};
  for (int k = 0; k < MJ_NEWTON_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_NEWTON_LAYOUT_LEN;
}

int mj_warp_layout(int* out) {
  const int values[MJ_WARP_LAYOUT_LEN] = {MJ_NEWTON_WARP_LAYOUT_VALUES(MJ_NEWTON_WARPS)};
  for (int k = 0; k < MJ_WARP_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_WARP_LAYOUT_LEN;
}

// Launches on `stream` with `warps` envs per block (1 to MJ_NEWTON_WARPS)
// and returns the first CUDA error (0 means launched). picks may be null;
// else it receives (n_sub * iters, B) fraction indices. overflow (one int
// on the device) is added to, never cleared; stats (MJ_N_STATS long longs
// on the device, or null: nothing counted) is added to as mj_newton.h's
// MJ_STAT_* say: each env-substep's rows inside their margin (their sum,
// their largest), H's terms over its held rows, its Newton iterations and
// their line searches' cuts, zeros and near ties.
int mj_newton_launch(const float* mf, const int* mi, const float* nf,
                     const int* ni, const float* q, const float* qd,
                     const float* ctrl, float* q_out, float* qd_out, int* picks,
                     int* overflow, long long* stats, int B, int n_sub, int iters, float dt,
                     int warps, void* stream MJ_CLOCKS_PARAM) {
  if (warps < 1 || warps > MJ_NEWTON_WARPS) return (int)cudaErrorInvalidValue;
  const int bytes = warps * (int)sizeof(MjWarpEnv);
  cudaError_t err = cudaFuncSetAttribute(
      mj_newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + warps - 1) / warps;
  mj_newton_kernel<<<blocks, MJ_WARP * warps, bytes, (cudaStream_t)stream>>>(
      mf, mi, nf, ni, q, qd, ctrl, q_out, qd_out, picks, overflow, stats, B, n_sub,
      iters, dt MJ_CLOCKS_ARG);
  return (int)cudaGetLastError();
}

// The blocks of `warps` envs each that one SM holds at once at a launch's
// shared bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the
// built kernel), or minus a CUDA error: the wrapper's count of a launch's
// waves.
int mj_newton_occupancy(int warps) {
  if (warps < 1 || warps > MJ_NEWTON_WARPS) return -(int)cudaErrorInvalidValue;
  const int bytes = warps * (int)sizeof(MjWarpEnv);
  cudaError_t err = cudaFuncSetAttribute(
      mj_newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mj_newton_kernel, MJ_WARP * warps,
                                                      bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"
