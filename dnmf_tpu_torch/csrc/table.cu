// The brick kernels' neuron tables (cull.cuh), built on the card: one per
// frame of positions, each sorted by the frame's own m coordinate (a
// stable sort).  The motion, c1 and Gram wrappers launch it before their
// kernel (shared anchors: one table; per-frame positions: one per frame;
// a recordings axis: one per recording, each with its own widths), and
// so does the refine wrapper (one per frame); fused.neuron_table_plain is
// the same table in plain torch.
//
// What bounds it: operations, K^2 comparisons per frame (0.04 M at K=200);
// a thread ranks one neuron against shared tiles of the frame's m column,
// so any K is taken in one launch.
#include "cull.cuh"

namespace dnmf {

constexpr int TABLE_TILE = 1024;  // build_table: m values per shared tile

// Neuron tables sorted by m, one per frame of positions (grid: (k /
// THREADS rounded up, F), THREADS threads): pos [F][k][3], sigma [k]
// (aniso 0) or [k][3] for table f at sigma + f * sig_stride (0: one set of
// widths for every table); writes table [F][k][TROW], order [F][k], row
// i's neuron, and raises *rmax (zeroed before) to the largest m reach 6
// sigma_m of all the tables (atomicMax on the bits of non-negative
// floats: exact, in any order).  One maximum over tables of different
// widths only widens the m window that a kernel searches in the tables
// of narrower ones: the box test takes each neuron's own reach, so the
// listed candidates, and every sum over them, do not move.  A thread
// ranks one neuron: the neurons with a smaller m, or an equal m and a
// smaller index (a stable sort), counted over tiles of the frame's m
// column.
__global__ void __launch_bounds__(THREADS)
build_table(const float* __restrict__ pos, const float* __restrict__ sigma,
            int sig_stride, int aniso, int k, float* __restrict__ table,
            long long* __restrict__ order, float* __restrict__ rmax) {
  __shared__ float s_m[TABLE_TILE];
  const size_t f = blockIdx.y;
  const float* pf = pos + f * k * 3;
  sigma += f * sig_stride;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const float m = i < k ? pf[(size_t)i * 3] : 0.0f;
  int rank = 0;
  for (int j0 = 0; j0 < k; j0 += TABLE_TILE) {
    const int n = min(TABLE_TILE, k - j0);
    __syncthreads();  // the previous tile is read
    for (int j = threadIdx.x; j < n; j += THREADS)
      s_m[j] = pf[(size_t)(j0 + j) * 3];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float v = s_m[j];
      rank += (v < m) || (v == m && j0 + j < i);
    }
  }
  const float reach = i < k ? 6.0f * (aniso ? sigma[i * 3] : sigma[i]) : 0.0f;
  const float r = warp_max(reach);
  if ((threadIdx.x & 31) == 0 && r > 0.0f)
    atomicMax(reinterpret_cast<int*>(rmax), __float_as_int(r));
  if (i >= k) return;
  float* row = table + (f * k + rank) * TROW;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float sd = aniso ? sigma[i * 3 + d] : sigma[i];
    const float inv = 1.0f / (sd * sd);
    row[d] = pf[(size_t)i * 3 + d];
    row[3 + d] = inv * LOG2E_F;
    row[8 + d] = 6.0f * sd;
    row[12 + d] = inv;
  }
  row[6] = row[7] = row[11] = row[15] = 0.0f;
  order[f * k + rank] = i;
}

}  // namespace dnmf

// pos [F][k][3], sigma [k] (aniso 0) or [k][3], or with per_table one
// set per table, [F][k] or [F][k][3]; table [F][k][TROW] (rows of
// cull.cuh), order [F][k] (int64): row i's neuron; rmax (1 float): the
// largest m reach of all the tables.
extern "C" int dnmf_table(const float* pos, const float* sigma, float* table,
                          long long* order, float* rmax, int F, int k,
                          int aniso, int per_table, void* stream) {
  using namespace dnmf;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(rmax, 0, sizeof(float), s);
  if (e != cudaSuccess || F == 0 || k == 0) return (int)e;
  build_table<<<dim3((k + THREADS - 1) / THREADS, F), THREADS, 0, s>>>(
      pos, sigma, per_table ? k * (aniso ? 3 : 1) : 0, aniso, k, table, order,
      rmax);
  return (int)cudaGetLastError();
}
