// Refinement pass: per-frame data term with per-frame neuron positions and
// its gradient with respect to those positions (and the widths).
//
//   recon_p = w_p * S_p,  S = sum_k c_k A_k,  r = recon - y
//   A_k = exp(-sum_d (psi_d - p_kd)^2 / s_kd^2)   (this frame's own p_k)
//   mse = sum_p r^2 / P
//   dL/dp_kd = 4 c_k / (P s_kd^2) * M1_kd,  M1_kd = sum_p r w A_k (psi_d - p_kd)
//   dL/ds_kd = 4 c_k / (P s_kd^3) * M2_kd,  M2_kd = sum_p r w A_k (psi_d - p_kd)^2
//
// Replaces the Pallas kernel dnmf_tpu/ops/pallas_culled.py:1131
// refine_block_culled (body _refine_kernel_culled :1035), the engine of
// position refinement and of per-neuron width fitting.  The Pallas wrapper
// builds M1 and M2 from raw moments (sum r w A psi^j) by a binomial
// expansion around p_k, which cancels ~1e-3 relative at whole-brain
// coordinates; here the moments are centred on p_k per pixel, so nothing
// cancels.
//
// What bounds it on this card: operations.  Per pixel and frame the warp
// (basis, 30 FMAs, fade: ~70 operations) and, per neuron within reach
// (6 sigma: 18 px at sigma 3, a few neurons per pixel), a Gaussian and
// its moments; the video is read once.  Culling by m alone (the earlier
// design: 32-neuron blocks sorted by m, tested per warp of 32 pixels
// that span every z) left each pixel evaluating the 32-64 Gaussians of
// every block whose m band it met, and re-walked the frame's warp once
// per 8-neuron sub-block.  The design here:
//  * one launch, grid (brick group, frame).  A thread block walks its
//    group's bricks (cull.cuh: 8 m x 8 n x up to 32 z), keeping each
//    pixel's warp and fade in registers: one warp evaluation per pixel.
//  * the brick's exact psi box (block min/max) against each neuron's
//    per-axis 6 sigma box, on the frame's own m-sorted table (binary
//    search for the m window, then all three axes): the candidate list,
//    in table order, in shared memory; its length goes to `counts`.
//  * residual phase: S over the candidates only, r w kept in registers,
//    the squared residual summed per thread;
//  * moments phase: per chunk of candidates, NMOM sums per thread,
//    block-reduced in a fixed order and added to shared per-neuron
//    accumulators of the group.
//  * the group writes its dense [K][NMOM] partials and its SSE;
//    refine_finish adds the groups in a fixed order (a warp per neuron),
//    applies the 4 c / (P s^n) factors and writes each neuron's gradient
//    at its place in the caller's order.  No float atomics: results repeat
//    exactly, and a frame's result does not depend on the other frames of
//    the call (the group count depends only on the volume and K).
#include "cull.cuh"

namespace dnmf {

constexpr int RPARAM = 16;  // table row: p (3), log2e / sigma^2 (3), c, 0,
                            // reach 6 sigma (3), 0, 1 / sigma^2 (3), 0
constexpr int CPARAM = 8;   // candidate row in shared memory: p, s, c, 0

template <int NMOM>
__global__ void __launch_bounds__(THREADS)
refine_bricks(const float* __restrict__ betas, const float* __restrict__ table,
              const float* __restrict__ rmax_m, const float* __restrict__ y,
              float* __restrict__ sse_part, float* __restrict__ mom_part,
              int* __restrict__ counts, Geom g, Bricks bk, int n_bricks,
              int bricks_per_group, int k) {
  constexpr int CH = NMOM == 6 ? 4 : 8;  // candidates per moments chunk
  constexpr int NACC = CH * NMOM;
  const int grp = blockIdx.x, n_groups = gridDim.x, b = blockIdx.y;
  extern __shared__ float smem[];
  float* s_acc = smem;                            // [k][NMOM]
  float* s_cprm = s_acc + (size_t)k * NMOM;       // [k][CPARAM]
  float* s_pm = s_cprm + (size_t)k * CPARAM;      // [k] the table's m
  int* s_cand = (int*)(s_pm + k);                 // [k]
  __shared__ float s_beta[30];
  __shared__ float s_red[NWARPS * NACC];
  __shared__ float s_box[6];
  __shared__ float s_sum[NACC];
  __shared__ int s_warp_n[NWARPS];
  __shared__ int s_range[2];
  const int tid = threadIdx.x;
  if (tid < 30) s_beta[tid] = betas[b * 30 + tid];
  for (int i = tid; i < k * NMOM; i += THREADS) s_acc[i] = 0.0f;
  const float* tab = table + (size_t)b * k * RPARAM;
  for (int i = tid; i < k; i += THREADS) s_pm[i] = tab[(size_t)i * RPARAM];
  const float* yb = y + (size_t)b * g.P;
  const float rm = *rmax_m;
  __syncthreads();

  float sse = 0.0f;
  const int first = grp * bricks_per_group;
  const int last = min(first + bricks_per_group, n_bricks);
  for (int id = first; id < last; ++id) {
    const Brick br = brick_at(id, bk, g);
    const int npix = br.count();
    // The warp of this thread's pixels, once; their video values are
    // loaded here, to arrive while the candidates are listed.
    float psi[PPT][3], rw[PPT], yv[PPT];
    float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int l = tid + i * THREADS;
      psi[i][0] = psi[i][1] = psi[i][2] = 0.0f;
      rw[i] = yv[i] = 0.0f;
      if (l < npix) {
        float phi[10];
        int mi, ni, zi;
        br.voxel(l, mi, ni, zi);
        yv[i] = yb[(mi * g.N + ni) * g.Z + zi];
        basis_at(mi, ni, zi, g, phi);
        warp_psi(s_beta, phi, g, psi[i]);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          lo[d] = fminf(lo[d], psi[i][d]);
          hi[d] = fmaxf(hi[d], psi[i][d]);
        }
      }
    }
    block_box(lo, hi, s_red, s_box);

    // Candidates: the m window by binary search, then all three axes.
    if (tid == 0) s_range[0] = lower_bound(s_pm, 1, k, s_box[0] - rm);
    if (tid == 32) s_range[1] = upper_bound(s_pm, 1, k, s_box[3] + rm);
    __syncthreads();
    const int i0 = s_range[0], i1 = s_range[1];
    int nc = 0;
    for (int c0 = i0; c0 < i1; c0 += THREADS) {
      const int kk = c0 + tid;
      bool keep = false;
      if (kk < i1) {
        const float* row = tab + (size_t)kk * RPARAM;
        const float p[3] = {row[0], row[1], row[2]};
        const float r[3] = {row[8], row[9], row[10]};
        keep = box_meets(p, r, s_box);
      }
      int total;
      const int slot = block_compact(keep, nc, s_warp_n, &total);
      if (slot >= 0) {
        s_cand[slot] = kk;
        const float* row = tab + (size_t)kk * RPARAM;
#pragma unroll
        for (int j = 0; j < CPARAM; ++j) s_cprm[slot * CPARAM + j] = row[j];
      }
      nc += total;
    }
    if (tid == 0) counts[(size_t)b * n_bricks + id] = nc;
    __syncthreads();

    // Residual phase: S over the candidates.
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int l = tid + i * THREADS;
      if (l >= npix) continue;
      float S = 0.0f;
      for (int c = 0; c < nc; ++c) {
        const float* pk = &s_cprm[c * CPARAM];
        S = fmaf(pk[6], gauss(pk, psi[i]), S);
      }
      const float w = fade(psi[i], g);
      const float r = w * S - yv[i];
      sse = fmaf(r, r, sse);
      rw[i] = r * w;
    }

    // Moments phase: CH candidates at a time.
    for (int c0 = 0; c0 < nc; c0 += CH) {
      float acc[NACC];
#pragma unroll
      for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (tid + i * THREADS >= npix) continue;
#pragma unroll
        for (int cc = 0; cc < CH; ++cc) {
          if (c0 + cc >= nc) continue;
          const float* pk = &s_cprm[(c0 + cc) * CPARAM];
          const float a = gauss(pk, psi[i]) * rw[i];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float dd = psi[i][d] - pk[d];
            acc[cc * NMOM + d] = fmaf(a, dd, acc[cc * NMOM + d]);
            if (NMOM == 6)
              acc[cc * NMOM + 3 + d] = fmaf(a * dd, dd, acc[cc * NMOM + 3 + d]);
          }
        }
      }
      block_sum<NACC>(acc, s_red, s_sum);
      __syncthreads();
      if (tid < NACC && c0 + tid / NMOM < nc)
        s_acc[s_cand[c0 + tid / NMOM] * NMOM + tid % NMOM] += s_sum[tid];
      __syncthreads();
    }
  }
  block_sum<1>(&sse, s_red, sse_part + (size_t)b * n_groups + grp);
  __syncthreads();
  float* out = mom_part + ((size_t)b * n_groups + grp) * k * NMOM;
  for (int i = tid; i < k * NMOM; i += THREADS) out[i] = s_acc[i];
}

// Per frame b (blockIdx.y): mse = sum_g sse_part / P; per neuron of the
// table (a warp each) the sums of its group partials in a fixed order,
// times 4 c / (P s^2) for dpos [B][k][3] and 4 c / (P s^3) for dsig
// ([B][k][3], or [B][k] summed over the axes when !aniso), written at the
// neuron's index in the caller's order.
template <int NMOM>
__global__ void __launch_bounds__(THREADS)
refine_finish(const float* __restrict__ table,
              const long long* __restrict__ order,
              const float* __restrict__ sse_part,
              const float* __restrict__ mom_part, float* __restrict__ mse,
              float* __restrict__ dpos, float* __restrict__ dsig,
              int n_groups, int k, int P, int aniso) {
  const int lane = threadIdx.x & 31, b = blockIdx.y;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float s = 0.0f;
    for (int gi = lane; gi < n_groups; gi += 32)
      s += sse_part[(size_t)b * n_groups + gi];
    s = warp_sum(s);
    if (lane == 0) mse[b] = s / (float)P;
  }
  if (i >= k) return;
  float m[NMOM];
#pragma unroll
  for (int j = 0; j < NMOM; ++j) m[j] = 0.0f;
  for (int gi = lane; gi < n_groups; gi += 32) {
    const float* src = mom_part + (((size_t)b * n_groups + gi) * k + i) * NMOM;
#pragma unroll
    for (int j = 0; j < NMOM; ++j) m[j] += src[j];
  }
#pragma unroll
  for (int j = 0; j < NMOM; ++j) m[j] = warp_sum(m[j]);
  if (lane != 0) return;
  const float* row = table + ((size_t)b * k + i) * RPARAM;
  const float cf = (4.0f / (float)P) * row[6];
  const size_t o = (size_t)b * k + (size_t)order[(size_t)b * k + i];
  float ds = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float coeff = cf * row[12 + d];
    dpos[o * 3 + d] = coeff * m[d];
    if (NMOM == 6) {
      const float v = coeff * sqrtf(row[12 + d]) * m[3 + d];
      if (aniso) dsig[o * 3 + d] = v;
      else ds += v;
    }
  }
  if (NMOM == 6 && !aniso) dsig[o] = ds;
}

}  // namespace dnmf

// table [B][k][16] per-frame neuron rows sorted by the frame's m
// coordinate, order [B][k] (int64) each row's neuron in the caller's
// order; rmax_m (device, 1 float): the largest m reach.  Bricks of bm x bn
// x bz voxels (nbm x nbn x nbz of them), bricks_per_group per thread
// block.  Outputs, in the caller's neuron order: mse [B], dpos [B][k][3],
// with want_dsigma dsig ([B][k][3] if aniso, else [B][k]); counts
// [B][n_bricks] candidates per brick.  Scratch: sse_part [B][n_groups],
// mom_part [B][n_groups][k][nmom], nmom = 3 (M1) or 6 (M1, M2).
extern "C" int dnmf_refine(const float* betas, const float* table,
                           const void* order, const float* rmax_m,
                           const float* y, float* sse_part, float* mom_part,
                           float* mse, float* dpos, float* dsig, int* counts,
                           int B, int M, int N, int Z, int normalized, int k,
                           int bm, int bn, int bz, int bricks_per_group,
                           int want_dsigma, int aniso, void* stream) {
  using namespace dnmf;
  const Geom g = make_geom(M, N, Z, normalized);
  Bricks bk;
  bk.bm = bm; bk.bn = bn; bk.bz = bz;
  bk.nbm = (M + bm - 1) / bm;
  bk.nbn = (N + bn - 1) / bn;
  bk.nbz = (Z + bz - 1) / bz;
  if (bm * bn * bz > THREADS * PPT) return (int)cudaErrorInvalidValue;
  const int n_bricks = bk.nbm * bk.nbn * bk.nbz;
  const int n_groups = (n_bricks + bricks_per_group - 1) / bricks_per_group;
  const int nmom = want_dsigma ? 6 : 3;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)k * (nmom + CPARAM + 2) * sizeof(float);
  const dim3 grid(n_groups, B), fgrid((k + NWARPS - 1) / NWARPS, B);
  const long long* ord = (const long long*)order;
  cudaError_t e;
  if (want_dsigma) {
    e = cudaFuncSetAttribute(refine_bricks<6>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    refine_bricks<6><<<grid, THREADS, smem, s>>>(
        betas, table, rmax_m, y, sse_part, mom_part, counts, g, bk, n_bricks,
        bricks_per_group, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    refine_finish<6><<<fgrid, THREADS, 0, s>>>(table, ord, sse_part,
                                               mom_part, mse, dpos, dsig,
                                               n_groups, k, g.P, aniso);
  } else {
    e = cudaFuncSetAttribute(refine_bricks<3>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    refine_bricks<3><<<grid, THREADS, smem, s>>>(
        betas, table, rmax_m, y, sse_part, mom_part, counts, g, bk, n_bricks,
        bricks_per_group, k);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    refine_finish<3><<<fgrid, THREADS, 0, s>>>(table, ord, sse_part,
                                               mom_part, mse, dpos, dsig,
                                               n_groups, k, g.P, aniso);
  }
  return (int)cudaGetLastError();
}
