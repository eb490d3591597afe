// Spatial-brick culling of warped Gaussian footprints (refine.cu; meant
// for the other footprint kernels too).
//
// A thread block owns a brick of pixels: bm x bn x bz voxels of the
// (m, n, z) grid, pixel index p = (m * N + n) * Z + z as in footprint.cuh.
// From the frame's warp it takes the brick's exact per-axis range of
// deformed coordinates psi (block min/max), and lists in shared memory the
// neurons whose per-axis reach box [p_d - r_d, p_d + r_d] (r_d = 6 sigma_d)
// meets that range on all three axes.  Any other neuron's footprint is
// below exp(-36) at every pixel of the brick: under float32 resolution.
// The neuron table is sorted by the frame's own m coordinate, so the m
// test is a binary search (window widened by the largest m reach) and
// only that window is tested on all three axes.  The list keeps table
// order, so everything summed over it repeats exactly.
#pragma once

#include "footprint.cuh"

namespace dnmf {

// Brick layout: bricks numbered ((im * nbn) + in) * nbz + iz.
struct Bricks {
  int bm, bn, bz;     // brick extent (bm * bn * bz <= THREADS * PPT)
  int nbm, nbn, nbz;  // bricks per axis
};

constexpr int PPT = 8;  // pixels per thread of a brick, at most

// The brick's pixel origin and (edge-clipped) extent.
struct Brick {
  int m0, n0, z0, wm, wn, wz;
  __device__ int count() const { return wm * wn * wz; }
  // Voxel (mi, ni, zi) of the brick's l-th pixel (z fastest).
  __device__ void voxel(int l, int& mi, int& ni, int& zi) const {
    const int rest = l / wz;
    zi = z0 + l % wz;
    ni = n0 + rest % wn;
    mi = m0 + rest / wn;
  }
};

__device__ __forceinline__ Brick brick_at(int id, const Bricks& bk,
                                          const Geom& g) {
  const int iz = id % bk.nbz, rest = id / bk.nbz;
  const int in = rest % bk.nbn, im = rest / bk.nbn;
  Brick b;
  b.m0 = im * bk.bm;
  b.n0 = in * bk.bn;
  b.z0 = iz * bk.bz;
  b.wm = min(bk.bm, g.M - b.m0);
  b.wn = min(bk.bn, g.N - b.n0);
  b.wz = min(bk.bz, g.Z - b.z0);
  return b;
}

// Block-wide min (box[d]) and max (box[3 + d]) of per-thread psi ranges.
// red: shared scratch of NWARPS * 6 floats; box: shared, 6 floats.
__device__ __forceinline__ void block_box(const float lo[3], const float hi[3],
                                          float* red, float* box) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float a = warp_min(lo[d]), b = warp_max(hi[d]);
    if (lane == 0) {
      red[wid * 6 + d] = a;
      red[wid * 6 + 3 + d] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const bool is_min = threadIdx.x < 3;
    float v = red[threadIdx.x];
    for (int w = 1; w < NWARPS; ++w) {
      const float u = red[w * 6 + threadIdx.x];
      v = is_min ? fminf(v, u) : fmaxf(v, u);
    }
    box[threadIdx.x] = v;
  }
  __syncthreads();
}

// First index i in [0, k) with table[i * stride] >= v (k if none).
__device__ __forceinline__ int lower_bound(const float* table, int stride,
                                           int k, float v) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (table[(size_t)mid * stride] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// First index i in [0, k) with table[i * stride] > v (k if none).
__device__ __forceinline__ int upper_bound(const float* table, int stride,
                                           int k, float v) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (table[(size_t)mid * stride] <= v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Does the reach box of a neuron at p with per-axis reach r meet the
// psi box (lo = box[0..2], hi = box[3..5]) on all three axes?
__device__ __forceinline__ bool box_meets(const float p[3], const float r[3],
                                          const float* box) {
  bool ok = true;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    ok = ok && (p[d] + r[d] >= box[d]) && (p[d] - r[d] <= box[3 + d]);
  return ok;
}

// Order-keeping block compaction: each thread offers one item (keep);
// returns its slot (base + rank among the kept, in thread order) or -1,
// and the count kept by the whole block in *total.  warp_n: shared
// scratch of NWARPS ints.  Contains two __syncthreads.
__device__ __forceinline__ int block_compact(bool keep, int base, int* warp_n,
                                             int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(FULL, keep);
  if (lane == 0) warp_n[wid] = __popc(mask);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < NWARPS; ++w) {
    const int c = warp_n[w];
    if (w < wid) before += c;
    all += c;
  }
  __syncthreads();  // warp_n is reused by the next call
  *total = all;
  if (!keep) return -1;
  return base + before + __popc(mask & ((1u << lane) - 1u));
}

}  // namespace dnmf
