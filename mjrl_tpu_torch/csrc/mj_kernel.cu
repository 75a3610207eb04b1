// Kernel K1: one full control step of penalty-contact rigid-body physics
// per launch, one thread per env.
//
// Replaces mjrl_tpu/physics/pkernel.py::multistep_pallas (the Pallas TPU
// mega-kernel). Each thread loads its env's column of the batch-last
// (rows, B) state, so neighbouring threads touch neighbouring addresses,
// runs n_sub substeps of mj_substep.h with ctrl held and the state in
// per-thread arrays, and stores once.
//
// What bounds it on an H100: per-thread latency, not bytes. A control step
// reads and writes ~260 bytes per env (q, qd, ctrl in; q, qd out) but runs
// tens of thousands of dependent f32 operations; the per-thread arrays live
// in local memory (ptxas: 64 registers, 5392-byte stack frame), and one
// thread per env gives 1024 threads (8 blocks of 128 on 132 SMs) at the
// bench's batch. This first version takes that occupancy as it is;
// splitting an env across a warp is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (no --use_fast_math: the parity tolerances assume IEEE
// sinf/cosf/sqrtf and division). Bound to PyTorch with ctypes by
// mjrl_tpu_torch/physics/pkernel.py.
#include <cuda_runtime.h>

#include "mj_substep.h"

#define MJ_THREADS 128

__global__ void __launch_bounds__(MJ_THREADS)
    mj_multistep_kernel(const float* __restrict__ mf, const int* __restrict__ mi,
                        const float* __restrict__ q, const float* __restrict__ qd,
                        const float* __restrict__ ctrl, float* __restrict__ q_out,
                        float* __restrict__ qd_out, int B, int n_sub, float dt) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  mj_env_multistep(mf, mi, env, B, q, qd, ctrl, q_out, qd_out, n_sub, dt);
}

extern "C" {

int mj_layout(int* out) {
  const int values[MJ_LAYOUT_LEN] = {MJ_LAYOUT_VALUES};
  for (int k = 0; k < MJ_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_LAYOUT_LEN;
}

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
int mj_multistep_launch(const float* mf, const int* mi, const float* q,
                        const float* qd, const float* ctrl, float* q_out,
                        float* qd_out, int B, int n_sub, float dt, void* stream) {
  const int blocks = (B + MJ_THREADS - 1) / MJ_THREADS;
  mj_multistep_kernel<<<blocks, MJ_THREADS, 0, (cudaStream_t)stream>>>(
      mf, mi, q, qd, ctrl, q_out, qd_out, B, n_sub, dt);
  return (int)cudaGetLastError();
}

}  // extern "C"
