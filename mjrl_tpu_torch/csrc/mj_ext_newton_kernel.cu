// Kernel K4: one full control step of Newton soft-constraint rigid-body
// physics with Adroit's stages, per launch, one warp per env.
//
// Replaces mjrl_tpu/physics/pkernel.py::_kernel_body_ext (the Pallas TPU
// mega-kernel's body for models with fixed tendons and per-env scene
// offsets) run with constraint_solver="newton" (soa_newton.constrained_qdd
// with fric_diag, mjrl_tpu/physics/soa.py:1056-1072). Each warp takes one
// env: its lanes load the env's column of the batch-last (rows, B) state
// and link offsets into the warp's MjWarpEnv in shared memory, run n_sub
// substeps of mj_warp_newton.h with EXT on and ctrl held, the work of each
// stage spread over the lanes, and store once.
//
// What bounds it on an H100: the latency of one warp's dependent
// operations and phases, not bytes (~0.8 KB per env per control step).
// Pen's substep runs K3's pipeline (406 contact points, a 30-dof tree)
// and then solver_iters Newton iterations over the held rows (J over
// chains of up to 19 dofs, six facets) with a dense 30x30 Cholesky. The
// design puts one env on 32 lanes instead of one thread, so a warp no
// longer waits for the env among 32 with the most rows, and the work of
// each stage is spread over the lanes; the env's state (H, the metric,
// the kinematics and its first MJ_HELD_SHARED held rows: 28840 bytes in
// the Adroit class, 14 of its 96 rows) sits in shared memory instead of
// local memory, and its rows past those in the env's slab in device memory
// (slab: B x MJ_SPILL_ROWS rows, which the wrapper allocates; Adroit's
// training states hold ~2 rows an env-substep, its fullest probe states
// 75). At most MJ_MAX_WARPS warps share a block (8 in the Adroit class,
// ~225 KB of dynamic shared memory), and the wrapper takes the fewest that
// spread B over the SMs in one wave (B=512: 4, two blocks an SM; B=2048:
// 8, in two waves), so that each of an SM's four schedulers has one or two
// envs' warps. The latency of each phase (a shared round trip, the
// reconvergence of its lanes, the sync) is what a stage costs; a build
// with -DMJ_STAGE_CLOCKS (tools/torch_warp_stages.py) adds a clocks output
// (MJ_N_STAGES, B) of cycles per stage.
//
// Build: as K3 (mj_ext_kernel.cu), in the size class the model fits.
#include <cuda_runtime.h>

#include "mj_warp_newton.h"

static_assert(MJ_MAX_WARPS * sizeof(MjWarpEnv) <= 232448,
              "a block's warps must fit the 227 KB of shared memory a block may use");

#ifdef MJ_STAGE_CLOCKS
#define MJ_CLOCKS_PARAM , long long* __restrict__ clocks
#define MJ_CLOCKS_ARG , clocks
#else
#define MJ_CLOCKS_PARAM
#define MJ_CLOCKS_ARG
#endif

extern __shared__ __align__(16) unsigned char mj_smem[];

__global__ void __launch_bounds__(MJ_WARP * MJ_MAX_WARPS, 1)
    mj_ext_newton_kernel(const float* __restrict__ mf, const int* __restrict__ mi,
                         const float* __restrict__ nf, const int* __restrict__ ni,
                         const float* __restrict__ q, const float* __restrict__ qd,
                         const float* __restrict__ ctrl,
                         const float* __restrict__ delta, float* __restrict__ q_out,
                         float* __restrict__ qd_out, int* __restrict__ picks,
                         int* __restrict__ overflow, long long* __restrict__ stats,
                         MjHeldRow* __restrict__ slab, int B, int n_sub, int iters,
                         float dt MJ_CLOCKS_PARAM) {
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
  mj_warp_env_multistep<true>(w, S, mf, mi, nf, ni, env, B, q, qd, ctrl, delta, q_out,
                              qd_out, picks, overflow, stats, slab, n_sub, iters, dt);
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
  const int values[MJ_WARP_LAYOUT_LEN] = {MJ_NEWTON_WARP_LAYOUT_VALUES(MJ_MAX_WARPS)};
  for (int k = 0; k < MJ_WARP_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_WARP_LAYOUT_LEN;
}

// Launches on `stream` with `warps` envs per block (1 to MJ_MAX_WARPS) and
// returns the first CUDA error (0 means launched). delta and picks may be
// null; overflow (one int on the device) is added to, never cleared;
// stats (or null) as mj_newton_launch's; slab: B x MJ_SPILL_ROWS held rows
// on the device (the newton layout's (MAX_HELD - SHARED_HELD) x ROW_BYTES
// bytes an env), null only where the build keeps every row in shared
// memory.
int mj_ext_newton_launch(const float* mf, const int* mi, const float* nf,
                         const int* ni, const float* q, const float* qd,
                         const float* ctrl, const float* delta, float* q_out,
                         float* qd_out, int* picks, int* overflow, long long* stats,
                         void* slab, int B, int n_sub, int iters, float dt, int warps,
                         void* stream MJ_CLOCKS_PARAM) {
  if (warps < 1 || warps > MJ_MAX_WARPS) return (int)cudaErrorInvalidValue;
  if (MJ_SPILL_ROWS && !slab) return (int)cudaErrorInvalidValue;
  const int bytes = warps * (int)sizeof(MjWarpEnv);
  cudaError_t err = cudaFuncSetAttribute(
      mj_ext_newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + warps - 1) / warps;
  mj_ext_newton_kernel<<<blocks, MJ_WARP * warps, bytes, (cudaStream_t)stream>>>(
      mf, mi, nf, ni, q, qd, ctrl, delta, q_out, qd_out, picks, overflow, stats,
      static_cast<MjHeldRow*>(slab), B, n_sub, iters, dt MJ_CLOCKS_ARG);
  return (int)cudaGetLastError();
}

// The blocks of `warps` envs each that one SM holds at once at a launch's
// shared bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the
// built kernel), or minus a CUDA error: the wrapper's count of a launch's
// waves.
int mj_ext_newton_occupancy(int warps) {
  if (warps < 1 || warps > MJ_MAX_WARPS) return -(int)cudaErrorInvalidValue;
  const int bytes = warps * (int)sizeof(MjWarpEnv);
  cudaError_t err = cudaFuncSetAttribute(
      mj_ext_newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mj_ext_newton_kernel, MJ_WARP * warps,
                                                      bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // extern "C"
