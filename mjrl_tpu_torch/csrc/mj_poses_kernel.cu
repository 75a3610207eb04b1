// The pose kernel: every link's world pose and every site's world position
// of B envs in one launch, one warp per env (mj_poses.h).
//
// Replaces, on the card, the plain version the Adroit envs run for their
// observation and reward at every control step and reset
// (physics/engine.py forward_kinematics + site_positions: pen's 34 links
// in 8 tree levels and 32 sites take ~420 small PyTorch ops, each a
// launch from the host).
//
// What bounds it on an H100: the latency of one env's dependent chain
// down the tree (~4k f32 operations and ~2 KB of output per env). One
// thread per env would run the links and sites one after another (~40 us
// at B=512); a warp per env takes each link's relative pose and each site
// on its own lane and walks the tree level by level, as K3's and K4's
// kinematics does. Each warp keeps its env's MjPoseEnv in shared memory
// (~5.9 KB in the Adroit class), MJ_POSE_WARPS envs to a block, so that
// B=512 envs spread over 128 SMs in one wave; the model's tables are read
// by every lane of a phase from L1.
//
// Build: as K3 (mj_ext_kernel.cu), in the size class the model fits.
#include <cuda_runtime.h>

#include "mj_poses.h"

#define MJ_POSE_WARPS 4

static_assert(MJ_POSE_WARPS * sizeof(MjPoseEnv) <= 232448,
              "a block's warps must fit the 227 KB of shared memory a block may use");

extern __shared__ __align__(16) unsigned char mj_smem[];

__global__ void __launch_bounds__(MJ_WARP * MJ_POSE_WARPS)
    mj_poses_kernel(const float* __restrict__ mf, const int* __restrict__ mi,
                    const float* __restrict__ site_pos, const int* __restrict__ site_link,
                    int nsite, const float* __restrict__ q, long long sq0, long long sq1,
                    const float* __restrict__ delta, long long sd0, long long sd1,
                    long long sd2, float* __restrict__ pos, float* __restrict__ quat,
                    float* __restrict__ sites, int B) {
  const int warp = threadIdx.x / MJ_WARP;
  const int env = blockIdx.x * MJ_POSE_WARPS + warp;
  if (env >= B) return;  // the whole warp: no lane of another env waits on it
  MjWarpDev w;
  w.lane = threadIdx.x % MJ_WARP;
  MjPoseEnv& S = reinterpret_cast<MjPoseEnv*>(mj_smem)[warp];
  const long long sq[2] = {sq0, sq1}, sd[3] = {sd0, sd1, sd2};
  mj_warp_poses(w, S, mf, mi, site_pos, site_link, nsite, q, sq, delta, sd, env, pos, quat,
                sites);
}

extern "C" {

int mj_layout(int* out) {
  const int values[MJ_LAYOUT_LEN] = {MJ_LAYOUT_VALUES};
  for (int k = 0; k < MJ_LAYOUT_LEN; ++k) out[k] = values[k];
  return MJ_LAYOUT_LEN;
}

// Launches on `stream` and returns the first CUDA error (0 means
// launched). q (B, nq) and delta (B, nlink, 3, or null: no link offsets)
// are read through their strides (elements); pos, quat and sites are
// contiguous (B, nlink, 3), (B, nlink, 4) and (B, nsite, 3).
int mj_poses_launch(const float* mf, const int* mi, const float* site_pos,
                    const int* site_link, int nsite, const float* q, long long sq0,
                    long long sq1, const float* delta, long long sd0, long long sd1,
                    long long sd2, float* pos, float* quat, float* sites, int B,
                    void* stream) {
  const int bytes = MJ_POSE_WARPS * (int)sizeof(MjPoseEnv);
  cudaError_t err = cudaFuncSetAttribute(
      mj_poses_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + MJ_POSE_WARPS - 1) / MJ_POSE_WARPS;
  mj_poses_kernel<<<blocks, MJ_WARP * MJ_POSE_WARPS, bytes, (cudaStream_t)stream>>>(
      mf, mi, site_pos, site_link, nsite, q, sq0, sq1, delta, sd0, sd1, sd2, pos, quat,
      sites, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
