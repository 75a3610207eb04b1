// Kernel K2: one full control step of Newton soft-constraint rigid-body
// physics per launch, one thread per env.
//
// Replaces mjrl_tpu/physics/pkernel.py::multistep_pallas run with
// constraint_solver="newton" (soa_newton.constrained_qdd,
// mjrl_tpu/physics/soa_newton.py:338). Each thread loads its env's column
// of the batch-last (rows, B) state, runs n_sub substeps of mj_newton.h
// with ctrl held and the state and the substep's held constraint rows in
// per-thread arrays, and stores once.
//
// What bounds it on an H100: per-thread dependent f32 operations over
// local memory, not bytes. A control step reads and writes ~260 bytes per
// env, but each substep runs the whole rigid-body pipeline and then
// solver_iters Newton iterations, each a pass over the held rows (J over
// <= 8 chain dofs per facet), a 14x14 dense Cholesky and five line-search
// costs: tens of thousands of dependent operations per substep, with the
// rows, H and the pipeline's arrays in local memory (L1/L2), at one thread
// per env (1024 threads, 8 blocks of 128 on 132 SMs). The design does the
// least work per thread it can without changing the result: rows outside
// their margin are never held (their D is 0), the J columns cover each
// contact's chain only, and the five costs share one pass over the rows.
// Spreading an env over a warp (rows over lanes, H in shared memory) is
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the parity tolerances assume IEEE
// sinf/cosf/sqrtf and division). Bound to PyTorch with ctypes by
// mjrl_tpu_torch/physics/pkernel.py.
#include <cuda_runtime.h>

#include "mj_newton.h"

#define MJ_THREADS 128

__global__ void __launch_bounds__(MJ_THREADS)
    mj_newton_kernel(const float* __restrict__ mf, const int* __restrict__ mi,
                     const float* __restrict__ nf, const int* __restrict__ ni,
                     const float* __restrict__ q, const float* __restrict__ qd,
                     const float* __restrict__ ctrl, float* __restrict__ q_out,
                     float* __restrict__ qd_out, int* __restrict__ picks, int B,
                     int n_sub, int iters, float dt) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  mj_newton_env_multistep(mf, mi, nf, ni, env, B, q, qd, ctrl, q_out, qd_out,
                          picks, n_sub, iters, dt);
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
// picks may be null; else it receives (n_sub * iters, B) fraction indices.
int mj_newton_launch(const float* mf, const int* mi, const float* nf,
                     const int* ni, const float* q, const float* qd,
                     const float* ctrl, float* q_out, float* qd_out, int* picks,
                     int B, int n_sub, int iters, float dt, void* stream) {
  const int blocks = (B + MJ_THREADS - 1) / MJ_THREADS;
  mj_newton_kernel<<<blocks, MJ_THREADS, 0, (cudaStream_t)stream>>>(
      mf, mi, nf, ni, q, qd, ctrl, q_out, qd_out, picks, B, n_sub, iters, dt);
  return (int)cudaGetLastError();
}

}  // extern "C"
