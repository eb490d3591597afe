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
//    per-axis 6 sigma box, on the frame's own m-sorted table (table.cu; a
//    search for the m window, then all three axes; candidate_window and
//    list_chunk, shared with motion.cu, c1.cu and gram.cu): the
//    candidates, in table order, with each neuron's trace (c_rows: the
//    traces in table order), into shared rows CAND at a time, so any K
//    runs (a list of several chunks is listed twice: S, then the
//    moments); their count goes to `counts`.
//  * residual phase: S over the candidates only, r w kept in registers,
//    the squared residual summed per thread;
//  * moments phase: per chunk of candidates, NMOM sums per thread,
//    block-reduced in a fixed order and added by one thread each to the
//    group's own dense [K][NMOM] row of partials in global memory (zeroed
//    first; the barriers order the additions);
//  * refine_finish adds the groups' rows and SSEs in a fixed order (a
//    warp per neuron), applies the 4 c / (P s^n) factors and writes each
//    neuron's gradient at its place in the caller's order.  No float
//    atomics: results repeat exactly, and a frame's result does not depend
//    on the other frames of the call (the group count depends only on the
//    volume and K).
#include "cull.cuh"

namespace dnmf {

constexpr int CPARAM = 8;          // candidate row in shared memory: p, s, c, 0
constexpr int CAND = 2 * THREADS;  // candidate rows listed at a time

// Three blocks per SM (80 registers): the dsigma variant otherwise takes
// 105 and runs at two, ~15% slower at 16 frames.
template <int NMOM>
__global__ void __launch_bounds__(THREADS, 3)
refine_bricks(const float* __restrict__ betas, const float* __restrict__ table,
              const float* __restrict__ rmax,
              const float* __restrict__ c_rows, const float* __restrict__ y,
              float* __restrict__ sse_part, float* __restrict__ mom_part,
              int* __restrict__ counts, Geom g, Bricks bk, int n_bricks,
              int bricks_per_group, int k) {
  constexpr int CH = NMOM == 6 ? 4 : 8;  // candidates per moments chunk
  constexpr int NACC = CH * NMOM;
  const int grp = blockIdx.x, n_groups = gridDim.x, b = blockIdx.y;
  __shared__ float s_cprm[CAND * CPARAM];
  __shared__ int s_cand[CAND];
  __shared__ float s_beta[30];
  __shared__ float s_red[NWARPS * NACC];
  __shared__ float s_box[6];
  __shared__ int s_off[PPT * THREADS];
  __shared__ float s_coord[2][COORDS];
  __shared__ float s_sum[NACC];
  __shared__ int s_warp_n[NWARPS];
  __shared__ int s_range[2];
  const int tid = threadIdx.x;
  if (tid < 30) s_beta[tid] = betas[b * 30 + tid];
  brick_slots(bk, s_off);
  // The group's own dense [k][NMOM] row of partials, in table order; the
  // barriers of the first listing order these stores before any addition.
  float* out = mom_part + ((size_t)b * n_groups + grp) * k * NMOM;
  for (int i = tid; i < k * NMOM; i += THREADS) out[i] = 0.0f;
  const float* tab = table + (size_t)b * k * TROW;
  const float* cr = c_rows + (size_t)b * k;
  const float* yb = y + (size_t)b * g.P;
  const float rm = *rmax;

  float sse = 0.0f;
  const int first = grp * bricks_per_group;
  const int last = min(first + bricks_per_group, n_bricks);
  for (int id = first; id < last; ++id) {
    const Brick br = brick_at(id, bk, g);
    float* coord = s_coord[(id - first) & 1];
    const int npix = br.count();
    // The warp of this thread's pixels, once; rw holds S, then r w.
    float psi[PPT][3], rw[PPT], yv[PPT];
    brick_pixels<true>(br, bk, g, s_off, coord, s_beta, yb, psi, yv, s_red);
#pragma unroll
    for (int i = 0; i < PPT; ++i) rw[i] = 0.0f;
    candidate_window(tab, TROW, k, rm, s_red, s_box, s_range);
    const int i1 = s_range[1];
    // Phase 0 lists the candidates chunk by chunk and sums S; phase 1
    // takes the moments, from the slots where the list came in one chunk,
    // else listing it again.  One call site of the listing and of each
    // phase.
    bool chunked = false;  // block-uniform: the list came in several chunks
    int nc = 0, n = 0, c0 = s_range[0], phase = 0;
    for (;;) {
      if (phase == 0 || chunked) {
        int next;
        n = list_chunk(tab, c0, i1, CAND, s_box, s_cand, s_warp_n, next,
                       [&](int slot, int kk, const float* row) {
#pragma unroll
                         for (int j = 0; j < 6; ++j)
                           s_cprm[slot * CPARAM + j] = row[j];
                         s_cprm[slot * CPARAM + 6] = cr[kk];
                         s_cprm[slot * CPARAM + 7] = 0.0f;
                       });
        c0 = next;
        __syncthreads();
      }
      const bool listed = c0 >= i1;  // the chunk was the list's last
      if (phase == 0) {
        // Residual phase: S over the chunk's candidates, then r w.
        nc += n;
        chunked = chunked || !listed;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          if (tid + i * THREADS >= npix) continue;
          float S = rw[i];
          for (int c = 0; c < n; ++c) {
            const float* pk = &s_cprm[c * CPARAM];
            S = fmaf(pk[6], gauss(pk, psi[i]), S);
          }
          rw[i] = S;
          if (listed) {
            const float w = fade(psi[i], g);
            const float r = w * S - yv[i];
            sse = fmaf(r, r, sse);
            rw[i] = r * w;
          }
        }
        if (listed) {
          phase = 1;
          c0 = s_range[0];
        }
        continue;
      }
      // Moments phase: CH candidates at a time.
      for (int q0 = 0; q0 < n; q0 += CH) {
        float acc[NACC];
#pragma unroll
        for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          if (tid + i * THREADS >= npix) continue;
#pragma unroll
          for (int cc = 0; cc < CH; ++cc) {
            if (q0 + cc >= n) continue;
            const float* pk = &s_cprm[(q0 + cc) * CPARAM];
            const float a = gauss(pk, psi[i]) * rw[i];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float dd = psi[i][d] - pk[d];
              acc[cc * NMOM + d] = fmaf(a, dd, acc[cc * NMOM + d]);
              if (NMOM == 6)
                acc[cc * NMOM + 3 + d] =
                    fmaf(a * dd, dd, acc[cc * NMOM + 3 + d]);
            }
          }
        }
        block_sum<NACC>(acc, s_red, s_sum);
        __syncthreads();
        if (tid < NACC && q0 + tid / NMOM < n)
          out[s_cand[q0 + tid / NMOM] * NMOM + tid % NMOM] += s_sum[tid];
        __syncthreads();
      }
      if (!chunked || listed) break;
    }
    if (tid == 0) counts[(size_t)b * n_bricks + id] = nc;
  }
  block_sum<1>(&sse, s_red, sse_part + (size_t)b * n_groups + grp);
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
              const float* __restrict__ c_rows,
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
  const float* row = table + ((size_t)b * k + i) * TROW;
  const float cf = (4.0f / (float)P) * c_rows[(size_t)b * k + i];
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

template <int NMOM>
int refine_launch(const float* betas, const float* table,
                  const long long* order, const float* rmax,
                  const float* c_rows, const float* y,
                  float* sse_part, float* mom_part, float* mse, float* dpos,
                  float* dsig, int* counts, int B, const Geom& g,
                  const Bricks& bk, int k, int bricks_per_group, int aniso,
                  cudaStream_t s) {
  const int n_bricks = bk.nbm * bk.nbn * bk.nbz;
  const int n_groups = (n_bricks + bricks_per_group - 1) / bricks_per_group;
  refine_bricks<NMOM><<<dim3(n_groups, B), THREADS, 0, s>>>(
      betas, table, rmax, c_rows, y, sse_part, mom_part, counts, g, bk,
      n_bricks, bricks_per_group, k);
  const cudaError_t le = cudaGetLastError();
  if (le != cudaSuccess) return (int)le;
  refine_finish<NMOM><<<dim3((k + NWARPS - 1) / NWARPS, B), THREADS, 0, s>>>(
      table, order, c_rows, sse_part, mom_part, mse, dpos, dsig, n_groups, k,
      g.P, aniso);
  return (int)cudaGetLastError();
}

}  // namespace dnmf

// table [B][k][16] per-frame neuron rows sorted by the frame's m
// coordinate, order [B][k] (int64) each row's neuron in the caller's order
// and rmax (1 float) their largest m reach (table.cu); c_rows [B][k] the
// traces in table order.
// Bricks of bm x bn x bz voxels (nbm x nbn x nbz of them),
// bricks_per_group per thread block.  Outputs,
// in the caller's neuron order: mse [B], dpos [B][k][3], with want_dsigma
// dsig ([B][k][3] if aniso, else [B][k]); counts [B][n_bricks] candidates
// per brick.  Scratch: sse_part [B][n_groups], mom_part
// [B][n_groups][k][nmom], nmom = 3 (M1) or 6 (M1, M2).
extern "C" int dnmf_refine(const float* betas, const float* table,
                           const long long* order, const float* rmax,
                           const float* c_rows, const float* y,
                           float* sse_part, float* mom_part, float* mse,
                           float* dpos, float* dsig, int* counts,
                           int B, int M, int N, int Z, int normalized, int k,
                           int bm, int bn, int bz, int bricks_per_group,
                           int want_dsigma, int aniso, void* stream) {
  using namespace dnmf;
  const RangedGeom g = make_geom(M, N, Z, normalized);
  const RangedBricks bk = make_bricks(g, bm, bn, bz);
  if (bm * bn * bz > THREADS * PPT || bm + bn + bz > COORDS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return want_dsigma
             ? refine_launch<6>(betas, table, order, rmax, c_rows, y,
                                sse_part, mom_part, mse, dpos, dsig, counts,
                                B, g, bk, k, bricks_per_group, aniso, s)
             : refine_launch<3>(betas, table, order, rmax, c_rows, y,
                                sse_part, mom_part, mse, dpos, dsig, counts,
                                B, g, bk, k, bricks_per_group, aniso, s);
}
