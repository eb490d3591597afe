// Shared device code of the demixing kernels (motion.cu, c1.cu, gram.cu,
// refine.cu, through cull.cuh).
//
// Every kernel evaluates warped Gaussian footprints on the fly: the 10
// quadratic basis values of a voxel, the per-frame warp psi_d = sum_j
// beta[j][d] phi_j (denormalized for the "normalized" parameterization),
// the border fade w = prod_d clip(1 + min(psi_d, hi_d - psi_d), 0, 1), and
// the Gaussian in direct (psi - p)^2 form with exp2f.  A matmul-form
// exponent would sum cancelling O(coord^2) terms, so it is never used.
// Pixel index p = (m * N + n) * Z + z.  The kernels cull by spatial
// bricks (cull.cuh).  A voxel range [p_lo, p_lo + PL) (a pixel shard of
// the volume: y then holds only those voxels, PL per frame) restricts
// every sum to its voxels; without one it is the whole volume.  The range
// lives in RangedGeom, which only the host code and the ranged kernel
// instances take: the whole-volume instances take Geom by value, without
// it.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace dnmf {

constexpr int THREADS = 256;  // threads per block of every kernel
constexpr int NWARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Geom {
  int M, N, Z, P;
  int normalized;   // beta acts on [-1, 1] coordinates
  float hi[3];      // size_d - 1 (fade bounds)
  float den[3];     // max(size_d - 1, 1) (normalization scale)
};

struct RangedGeom : Geom {
  int p_lo, PL;     // the voxel range [p_lo, p_lo + PL) of y's rows
};

// The basis coordinate of voxel index v on axis d: v itself, or its
// [-1, 1] normalization.
__device__ __forceinline__ float basis_coord(int v, int d, const Geom& g) {
  const float x = (float)v;
  return g.normalized ? 2.0f * x / g.den[d] - 1.0f : x;
}

// The 10 quadratic basis values at basis coordinates (x, y, z).
__device__ __forceinline__ void basis_xyz(float x, float y, float z,
                                          float phi[10]) {
  phi[0] = 1.0f; phi[1] = x; phi[2] = y; phi[3] = z;
  phi[4] = x * x; phi[5] = y * y; phi[6] = z * z;
  phi[7] = x * y; phi[8] = x * z; phi[9] = y * z;
}

// Pixel-space deformed coordinates; beta is one frame's [10][3] row-major.
__device__ __forceinline__ void warp_psi(const float* beta, const float phi[10],
                                         const Geom& g, float psi[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 10; ++j) acc = fmaf(beta[j * 3 + d], phi[j], acc);
    psi[d] = g.normalized ? (acc + 1.0f) / 2.0f * g.den[d] : acc;
  }
}

__device__ __forceinline__ float fade_axis(float pd, float hi) {
  const float dist = fminf(pd, hi - pd);
  return fminf(fmaxf(1.0f + dist, 0.0f), 1.0f);
}

__device__ __forceinline__ float fade(const float psi[3], const Geom& g) {
  return fade_axis(psi[0], g.hi[0]) * fade_axis(psi[1], g.hi[1]) *
         fade_axis(psi[2], g.hi[2]);
}

// Raw Gaussian of one neuron at psi: prm = p (3), log2(e) / sigma_d^2 (3).
__device__ __forceinline__ float gauss(const float* prm, const float psi[3]) {
  const float dx = prm[0] - psi[0];
  const float dy = prm[1] - psi[1];
  const float dz = prm[2] - psi[2];
  float e = dx * dx * prm[3];
  e += dy * dy * prm[4];
  e += dz * dz * prm[5];
  return exp2f(-e);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Block-wide sum of n <= THREADS per-thread values into out[0..n), in a
// fixed order: within warps by shuffle, then warp 0..NWARPS-1.  red is
// shared scratch of at least NWARPS * n floats.
template <int n>
__device__ __forceinline__ void block_sum(const float* vals, float* red,
                                          float* out) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float v = warp_sum(vals[i]);
    if (lane == 0) red[wid * n + i] = v;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float s = 0.0f;
    for (int w = 0; w < NWARPS; ++w) s += red[w * n + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

inline RangedGeom make_geom(int M, int N, int Z, int normalized,
                            int p_lo = 0, int p_count = -1) {
  RangedGeom g;
  g.M = M; g.N = N; g.Z = Z; g.P = M * N * Z;
  g.p_lo = p_lo;
  g.PL = p_count < 0 ? g.P : p_count;
  g.normalized = normalized;
  const int s[3] = {M, N, Z};
  for (int d = 0; d < 3; ++d) {
    g.hi[d] = (float)s[d] - 1.0f;
    g.den[d] = s[d] > 1 ? (float)s[d] - 1.0f : 1.0f;
  }
  return g;
}

}  // namespace dnmf
