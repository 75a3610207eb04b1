// Warp primitives: one env spread over the 32 lanes of a warp, written
// once for two targets.
//
// A body written against them (a template on the warp type W) is a
// sequence of cooperative phases over one env's state in memory that all
// lanes share (shared memory on the card). Code outside a phase runs on
// every lane alike and only reads that state; a phase writes it:
//
//   w.lanes(f)      f(lane) on every lane;
//   w.each(n, f)    f(i) for i < n, lane i % 32 taking i (a strided loop);
//   w.one(f)        f() on lane 0;
//   w.any32(v)      whether v[lane] != 0 on any lane (a ballot);
//   w.scan32(c, o)  o[lane] = c[0] + ... + c[lane - 1], the exclusive scan
//                   of 32 counts; returns their total on every lane;
//   w.sum(n, s, f)  s + f(0) + f(1) + ... + f(n - 1), added in that order
//                   (the terms computed over lanes), on every lane;
//   w.lower_solve(n, L, dinv, b, x), w.upper_solve(n, L, dinv, y, x)
//                   forward and backward substitution with the lower
//                   triangle L and the reciprocal diagonal dinv (n <= 64):
//                   x[i] = (b[i] - L[i][q] x[q] for q = 0, ..., i - 1)
//                   dinv[i], and x[i] = (y[i] - L[q][i] x[q] for q = n - 1,
//                   ..., i + 1) dinv[i], the terms subtracted in that
//                   order; lane k holds rows k and k + 32, and each x[q] is
//                   broadcast from its row's lane as soon as it is known.
//
// A phase ends with __syncwarp() on the card, so the next one reads what
// it wrote. MjWarpDev is the card's warp (lane = threadIdx.x & 31; the
// scan by __shfl_up_sync, the sum's terms broadcast by __shfl_sync);
// MjWarpHost emulates it with plain C++: each phase runs for lane 0, 1,
// ..., 31 in turn before the next one starts, and the scan and the sum
// are computed in the same fixed order. So the host build of a body is the
// same warp-decomposed code as the card's; what it cannot show is a
// missing __syncwarp(), which only the card's results can (chip_smoke.py
// holds them bit for bit across launches and block shapes).
#pragma once

#include "mj_substep.h"

#define MJ_WARP 32
#define MJ_MAX_STAGES 16  // stage cycle counts of a MJ_STAGE_CLOCKS build

// Functions templated on the warp type: device code under nvcc (only the
// card's warp is instantiated there), plain inline under a host compiler.
#ifdef __CUDACC__
#define MJ_WD __device__ __forceinline__
#else
#define MJ_WD inline
#endif

// Not inlined on the card: the narrow phase's passes and the writers of
// their points, whose inlined copies (one per contact point of every kind)
// would multiply the kernel's code, which the card's warps fetch as they
// go.
#ifdef __CUDACC__
#define MJ_NOINLINE __host__ __device__ __noinline__
#else
#define MJ_NOINLINE inline
#endif

// A few floats summed together (the line search's five costs).
template <int N>
struct MjVec {
  float v[N];
};

template <int N>
MJ_HD MjVec<N> operator+(MjVec<N> a, const MjVec<N>& b) {
  for (int k = 0; k < N; ++k) a.v[k] = a.v[k] + b.v[k];
  return a;
}

#ifdef __CUDACC__
MJ_WD float mj_shfl(float x, int src) { return __shfl_sync(0xffffffffu, x, src); }

template <int N>
MJ_WD MjVec<N> mj_shfl(const MjVec<N>& x, int src) {
  MjVec<N> out;
  for (int k = 0; k < N; ++k) out.v[k] = __shfl_sync(0xffffffffu, x.v[k], src);
  return out;
}

struct MjWarpDev {
  int lane;
#ifdef MJ_STAGE_CLOCKS
  long long last, clocks[MJ_MAX_STAGES];
  // lane 0 adds the cycles since the last stamp to stage s's count
  MJ_WD void stamp(int s) {
    if (lane == 0) {
      const long long t = clock64();
      clocks[s] += t - last;
      last = t;
    }
  }
#endif
  template <class F>
  MJ_WD void lanes(F&& f) {
    f(lane);
    __syncwarp();
  }
  template <class F>
  MJ_WD void each(int n, F&& f) {
    for (int i = lane; i < n; i += MJ_WARP) f(i);
    __syncwarp();
  }
  template <class F>
  MJ_WD void one(F&& f) {
    if (lane == 0) f();
    __syncwarp();
  }
  MJ_WD bool any32(const int* v) { return __any_sync(0xffffffffu, v[lane] != 0); }
  MJ_WD int scan32(const int* cnt, int* off) {
    const int v = cnt[lane];
    int incl = v;
    for (int d = 1; d < MJ_WARP; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    off[lane] = incl - v;
    __syncwarp();
    return __shfl_sync(0xffffffffu, incl, MJ_WARP - 1);
  }
  template <int LD>
  MJ_WD void lower_solve(int n, float (*L)[LD], const float* dinv, const float* b,
                         float* x) {
    const int r0 = lane, r1 = lane + MJ_WARP;
    float s0 = r0 < n ? b[r0] : 0.0f, s1 = r1 < n ? b[r1] : 0.0f;
    for (int q = 0; q < n; ++q) {
      const float xq = __shfl_sync(0xffffffffu, q < MJ_WARP ? s0 : s1, q % MJ_WARP) * dinv[q];
      if (r0 == q || r1 == q) x[q] = xq;
      if (r0 > q && r0 < n) s0 -= L[r0][q] * xq;
      if (r1 > q && r1 < n) s1 -= L[r1][q] * xq;
    }
    __syncwarp();
  }
  template <int LD>
  MJ_WD void upper_solve(int n, float (*L)[LD], const float* dinv, const float* y,
                         float* x) {
    const int r0 = lane, r1 = lane + MJ_WARP;
    float s0 = r0 < n ? y[r0] : 0.0f, s1 = r1 < n ? y[r1] : 0.0f;
    for (int q = n - 1; q >= 0; --q) {
      const float xq = __shfl_sync(0xffffffffu, q < MJ_WARP ? s0 : s1, q % MJ_WARP) * dinv[q];
      if (r0 == q || r1 == q) x[q] = xq;
      if (r0 < q) s0 -= L[q][r0] * xq;
      if (r1 < q) s1 -= L[q][r1] * xq;
    }
    __syncwarp();
  }
  template <class T, class F>
  MJ_WD T sum(int n, T s, F&& f) {
    for (int base = 0; base < n; base += MJ_WARP) {
      const T t = base + lane < n ? f(base + lane) : T{};
      // every shuffle issues ahead of the adds, which keep lane order
#pragma unroll
      for (int l = 0; l < MJ_WARP; ++l) {
        const T u = mj_shfl(t, l);
        if (l < n - base) s = s + u;
      }
    }
    return s;
  }
};
#endif

struct MjWarpHost {
  template <class F>
  void lanes(F&& f) {
    for (int l = 0; l < MJ_WARP; ++l) f(l);
  }
  template <class F>
  void each(int n, F&& f) {
    for (int l = 0; l < MJ_WARP; ++l)
      for (int i = l; i < n; i += MJ_WARP) f(i);
  }
  template <class F>
  void one(F&& f) {
    f();
  }
  bool any32(const int* v) {
    for (int l = 0; l < MJ_WARP; ++l)
      if (v[l] != 0) return true;
    return false;
  }
  int scan32(const int* cnt, int* off) {
    int s = 0;
    for (int l = 0; l < MJ_WARP; ++l) {
      off[l] = s;
      s += cnt[l];
    }
    return s;
  }
  template <class T, class F>
  T sum(int n, T s, F&& f) {
    for (int i = 0; i < n; ++i) s = s + f(i);
    return s;
  }
  template <int LD>
  void lower_solve(int n, float (*L)[LD], const float* dinv, const float* b,
                   float* x) {
    for (int i = 0; i < n; ++i) {
      float s = b[i];
      for (int q = 0; q < i; ++q) s -= L[i][q] * x[q];
      x[i] = s * dinv[i];
    }
  }
  template <int LD>
  void upper_solve(int n, float (*L)[LD], const float* dinv, const float* y,
                   float* x) {
    for (int i = n - 1; i >= 0; --i) {
      float s = y[i];
      for (int q = n - 1; q > i; --q) s -= L[q][i] * x[q];
      x[i] = s * dinv[i];
    }
  }
};

// Stream compaction in index order: item i < n brings count(i) slots, and
// write(i, slot) runs for each item with a count, slot being the number
// of slots before it. Items go over the lanes 32 at a time, each chunk's
// slots placed by the warp scan. cnt and off are 32 ints each of the
// shared state. Returns the total of the counts.
template <class W, class Count, class Write>
MJ_WD int mj_warp_compact(W& w, int* cnt, int* off, int n, Count&& count,
                          Write&& write) {
  int total = 0;
  for (int base = 0; base < n; base += MJ_WARP) {
    w.lanes([&](int l) { cnt[l] = base + l < n ? count(base + l) : 0; });
    if (!w.any32(cnt)) continue;
    const int t = w.scan32(cnt, off);
    w.lanes([&](int l) {
      if (cnt[l] > 0) write(base + l, total + off[l]);
    });
    total += t;
  }
  return total;
}
