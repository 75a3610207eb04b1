// Kernel K4: one full control step of Newton soft-constraint rigid-body
// physics with Adroit's stages, per launch, one thread per env.
//
// Replaces mjrl_tpu/physics/pkernel.py::_kernel_body_ext (the Pallas TPU
// mega-kernel's body for models with fixed tendons and per-env scene
// offsets) run with constraint_solver="newton" (soa_newton.constrained_qdd
// with fric_diag, mjrl_tpu/physics/soa.py:1056-1072). It runs
// mj_newton.h's substep with EXT = true: K2's soft contact and limit rows
// and Newton iterations on K3's stages (link offsets, box kinds, servos,
// tendons, frictionloss). Each thread loads its env's column of the
// batch-last (rows, B) state and link offsets, runs n_sub substeps with
// ctrl held, and stores once.
//
// What bounds it on an H100: per-thread latency over local memory, as K2
// and K3. Pen's control step moves ~0.8 KB per env but runs K3's pipeline
// (406 contact points, a 30-dof tree) and then solver_iters Newton
// iterations over the held rows (J over chains of up to 19 dofs, six
// facets) with a dense 30x30 Cholesky, all in one thread, with the rows,
// H and the metric in local memory. The design holds only the rows inside
// their margin, at most MJ_MAX_HELD per env-substep (a few on pen), and
// counts an env-substep that has more in *overflow instead of dropping a
// row silently; the wrapper raises on it. Blocks of 32 threads put one warp
// on each of B/32 SMs (16 at B=512) instead of four on a quarter as many.
// Spreading an env over a warp is later work.
//
// Build: as K3 (mj_ext_kernel.cu), in the size class the model fits.
#include <cuda_runtime.h>

#include "mj_newton.h"

#define MJ_THREADS 32

__global__ void __launch_bounds__(MJ_THREADS)
    mj_ext_newton_kernel(const float* __restrict__ mf, const int* __restrict__ mi,
                         const float* __restrict__ nf, const int* __restrict__ ni,
                         const float* __restrict__ q, const float* __restrict__ qd,
                         const float* __restrict__ ctrl,
                         const float* __restrict__ delta, float* __restrict__ q_out,
                         float* __restrict__ qd_out, int* __restrict__ picks,
                         int* __restrict__ overflow, int B, int n_sub, int iters,
                         float dt) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  mj_ext_newton_env_multistep(mf, mi, nf, ni, env, B, q, qd, ctrl, delta, q_out,
                              qd_out, picks, overflow, n_sub, iters, dt);
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

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// delta and picks may be null; overflow (one int on the device) is added
// to, never cleared.
int mj_ext_newton_launch(const float* mf, const int* mi, const float* nf,
                         const int* ni, const float* q, const float* qd,
                         const float* ctrl, const float* delta, float* q_out,
                         float* qd_out, int* picks, int* overflow, int B,
                         int n_sub, int iters, float dt, void* stream) {
  const int blocks = (B + MJ_THREADS - 1) / MJ_THREADS;
  mj_ext_newton_kernel<<<blocks, MJ_THREADS, 0, (cudaStream_t)stream>>>(
      mf, mi, nf, ni, q, qd, ctrl, delta, q_out, qd_out, picks, overflow, B,
      n_sub, iters, dt);
  return (int)cudaGetLastError();
}

}  // extern "C"
