// Shared device code of the demixing kernels (motion.cu, c1.cu, gram.cu,
// refine.cu).
//
// Every kernel evaluates warped Gaussian footprints on the fly from flat
// voxel indices: pixel index -> (m, n, z) by integer divmod, the 10
// quadratic basis values, the per-frame warp psi_d = sum_j beta[j][d]
// phi_j (denormalized for the "normalized" parameterization), the border
// fade w = prod_d clip(1 + min(psi_d, hi_d - psi_d), 0, 1), and the
// Gaussian in direct (psi - p)^2 form with exp2f.  A matmul-form exponent
// would sum cancelling O(coord^2) terms, so it is never used.
//
// Neuron parameters arrive sorted by their m coordinate, in blocks of KB
// neurons; each block carries an m-interval [lo, hi] widened by 6 sigma.
// A warp (32 consecutive pixels) skips a block whose interval misses the
// warp's deformed-m range: exp(-36) ~ 2e-16 is below float32 resolution.
// With per-frame (tracked) positions the table holds one row set per
// frame, prm_stride floats apart (0 for shared anchors), sorted by each
// neuron's mean m; a block's interval spans its members' m over all
// frames, so the same culling holds in every frame.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace dnmf {

constexpr int KB = 32;        // neurons per culling block
constexpr int NPARAM = 8;     // params row: px py pz sx sy sz c 0
                              // (s_d = log2(e) / sigma_d^2; the frame's
                              // trace value c is read by refine.cu only)
constexpr int THREADS = 256;  // threads per block of every kernel
constexpr int NWARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Geom {
  int M, N, Z, P;
  int normalized;   // beta acts on [-1, 1] coordinates
  float hi[3];      // size_d - 1 (fade bounds)
  float den[3];     // max(size_d - 1, 1) (normalization scale)
};

__device__ __forceinline__ void basis(int p, const Geom& g, float phi[10]) {
  const int zi = p % g.Z;
  const int rest = p / g.Z;
  const int ni = rest % g.N;
  const int mi = rest / g.N;
  float x = (float)mi, y = (float)ni, z = (float)zi;
  if (g.normalized) {
    x = 2.0f * x / g.den[0] - 1.0f;
    y = 2.0f * y / g.den[1] - 1.0f;
    z = 2.0f * z / g.den[2] - 1.0f;
  }
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

// Raw Gaussian of one neuron (params row prm) at psi.
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

inline Geom make_geom(int M, int N, int Z, int normalized) {
  Geom g;
  g.M = M; g.N = N; g.Z = Z; g.P = M * N * Z;
  g.normalized = normalized;
  const int s[3] = {M, N, Z};
  for (int d = 0; d < 3; ++d) {
    g.hi[d] = (float)s[d] - 1.0f;
    g.den[d] = s[d] > 1 ? (float)s[d] - 1.0f : 1.0f;
  }
  return g;
}

// Fixed-order cross-chunk sum: out[r][c] = sum_k part[r][k][c].
static __global__ void sum_chunks(const float* __restrict__ part, float* __restrict__ out,
                           int n_chunks, int width) {
  const size_t r = blockIdx.x;
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < n_chunks; ++k) s += part[(r * n_chunks + k) * width + c];
    out[r * width + c] = s;
  }
}

}  // namespace dnmf
