// Refinement pass: per-frame data term with per-frame neuron positions and
// its gradient with respect to those positions (and the widths).
//
//   recon_p = w_p * S_p,  S = sum_k c_k A_k,  r = recon - y
//   A_k = exp(-sum_d (psi_d - p_kd)^2 / s_kd^2)   (this frame's own p_k)
//   mse = sum_p r^2 / P
//   dL/dp_kd = 4 c_k / (P s_kd^2) * M1_kd,  M1_kd = sum_p r w A_k (psi_d - p_kd)
//   dL/ds_kd = 4 c_k / (P s_kd^3) * M2_kd,  M2_kd = sum_p r w A_k (psi_d - p_kd)^2
//
// Replaces the Pallas kernel dnmf_tpu/ops/pallas_culled.py
// refine_block_culled (_refine_kernel_culled), the engine of position
// refinement and of per-neuron width fitting.  The Pallas wrapper builds
// M1 and M2 from raw moments (sum r w A psi^j) by a binomial expansion
// around p_k, which cancels ~1e-3 relative at whole-brain coordinates;
// here the moments are centred on p_k per pixel, so nothing cancels.  The
// 4 c / (P s^n) factors are applied by the wrapper (O(K) work).
//
// Bound: exp2 plus ~12 FMAs per pixel per neuron of every block a warp
// does not cull, in each pass (the residual needs every neuron before any
// moment can be taken); the video is read once and r w written and read
// once per sub-block.  Each of the moments pass's KB / SUB sub-blocks
// also recomputes the warp of every pixel before it can cull: on an H100
// at 512x512x20, K=200 that per-pixel work makes the moments pass ~7x the
// residual pass.
// Design: two launches.
//  (a) refine_residual, grid (pixel chunk, frame), shaped like the motion
//      kernel without its gradient: each thread takes a pixel per step,
//      sums S over the culled neuron blocks of its frame's table (shared
//      memory), writes r w to a [B][P] scratch and keeps its SSE in a
//      register.
//  (b) refine_moments, grid (pixel chunk, neuron sub-block, frame), shaped
//      like the c1 kernel with r w in the place of w y.  A thread keeps
//      SUB neurons x NMOM moments (3, or 6 with the widths) in registers:
//      the full block of KB = 32 neurons x 6 would spill, so each block is
//      split into KB / SUB sub-blocks that each recompute the warp.
// Chunks take every n_chunks-th tile (round-robin) and their partials are
// summed in a fixed order (sum_chunks): results repeat run to run.
#include "footprint.cuh"

namespace dnmf {

constexpr int SUB = 8;    // neurons per moments thread block
constexpr int C_COL = 6;  // params column of the frame's trace value

__global__ void __launch_bounds__(THREADS)
refine_residual(const float* __restrict__ betas,
                const float* __restrict__ params,
                const float* __restrict__ blocks, const float* __restrict__ y,
                float* __restrict__ rw, float* __restrict__ partial, Geom g,
                int nkb) {
  const int chunk = blockIdx.x, n_chunks = gridDim.x, b = blockIdx.y;
  const int k_pad = nkb * KB;
  extern __shared__ float smem[];
  float* s_prm = smem;                   // [k_pad][NPARAM], this frame
  float* s_blk = s_prm + k_pad * NPARAM;  // [nkb][2]
  __shared__ float s_beta[30];
  __shared__ float s_red[NWARPS];
  const int tid = threadIdx.x;
  if (tid < 30) s_beta[tid] = betas[b * 30 + tid];
  const float* prm = params + (size_t)b * k_pad * NPARAM;
  for (int i = tid; i < k_pad * NPARAM; i += THREADS) s_prm[i] = prm[i];
  for (int i = tid; i < 2 * nkb; i += THREADS) s_blk[i] = blocks[i];
  __syncthreads();

  const float* yb = y + (size_t)b * g.P;
  float* rwb = rw + (size_t)b * g.P;
  float sse = 0.0f;
  const int n_tiles = (g.P + THREADS - 1) / THREADS;
  for (int tile = chunk; tile < n_tiles; tile += n_chunks) {
    const int p = tile * THREADS + tid;
    const bool valid = p < g.P;
    float psi[3] = {0.0f, 0.0f, 0.0f};
    float mlo = CUDART_INF_F, mhi = -CUDART_INF_F;
    if (valid) {
      float phi[10];
      basis(p, g, phi);
      warp_psi(s_beta, phi, g, psi);
      mlo = mhi = psi[0];
    }
    mlo = warp_min(mlo);
    mhi = warp_max(mhi);

    float S = 0.0f;
    for (int i = 0; i < nkb; ++i) {
      if (!(s_blk[2 * i] <= mhi && s_blk[2 * i + 1] >= mlo)) continue;
#pragma unroll 4
      for (int k = i * KB; k < (i + 1) * KB; ++k) {
        const float* pk = &s_prm[k * NPARAM];
        S = fmaf(pk[C_COL], gauss(pk, psi), S);
      }
    }
    if (!valid) continue;
    const float w = fade(psi, g);
    const float r = w * S - yb[p];
    sse = fmaf(r, r, sse);
    rwb[p] = r * w;
  }
  block_sum<1>(&sse, s_red, partial + (size_t)b * n_chunks + chunk);
}

template <int NMOM>
__global__ void __launch_bounds__(THREADS)
refine_moments(const float* __restrict__ betas,
               const float* __restrict__ params,
               const float* __restrict__ blocks, const float* __restrict__ rw,
               float* __restrict__ partial, Geom g, int nkb) {
  constexpr int NACC = SUB * NMOM;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int sb = blockIdx.y, n_sb = gridDim.y, b = blockIdx.z;
  const int blk = sb / (KB / SUB);
  __shared__ float s_beta[30];
  __shared__ float s_prm[SUB * NPARAM];
  __shared__ float s_red[NWARPS * NACC];
  const int tid = threadIdx.x;
  if (tid < 30) s_beta[tid] = betas[b * 30 + tid];
  const float* prm =
      params + ((size_t)b * nkb * KB + (size_t)sb * SUB) * NPARAM;
  for (int i = tid; i < SUB * NPARAM; i += THREADS) s_prm[i] = prm[i];
  __syncthreads();

  const float lo = blocks[2 * blk], hi = blocks[2 * blk + 1];
  const float* rwb = rw + (size_t)b * g.P;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  const int n_tiles = (g.P + THREADS - 1) / THREADS;
  for (int tile = chunk; tile < n_tiles; tile += n_chunks) {
    const int p = tile * THREADS + tid;
    float psi[3] = {0.0f, 0.0f, 0.0f};
    float rwv = 0.0f, mlo = CUDART_INF_F, mhi = -CUDART_INF_F;
    if (p < g.P) {
      float phi[10];
      basis(p, g, phi);
      warp_psi(s_beta, phi, g, psi);
      rwv = rwb[p];
      mlo = mhi = psi[0];
    }
    mlo = warp_min(mlo);
    mhi = warp_max(mhi);
    if (lo <= mhi && hi >= mlo) {
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        const float* pk = &s_prm[k * NPARAM];
        const float a = gauss(pk, psi) * rwv;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float dd = psi[d] - pk[d];
          acc[k * NMOM + d] = fmaf(a, dd, acc[k * NMOM + d]);
          if (NMOM == 6)
            acc[k * NMOM + 3 + d] = fmaf(a * dd, dd, acc[k * NMOM + 3 + d]);
        }
      }
    }
  }
  block_sum<NACC>(acc, s_red,
                  partial + (((size_t)b * n_sb + sb) * n_chunks + chunk) * NACC);
}

}  // namespace dnmf

// params [B][k_pad][8] (per-frame positions, c in column 6) sorted by
// mean m; blocks [nkb][2].  Outputs: sse_out [B]; mom_out [B][k_pad][nmom]
// with nmom = 3 (M1) or 6 (M1, M2) in sorted order.  Scratch: rw B * P,
// sse_part B * n_chunks_res, mom_part B * nkb * (KB / SUB) * n_chunks_mom
// * SUB * nmom floats.
extern "C" int dnmf_refine(const float* betas, const float* params,
                           const float* blocks, const float* y, float* rw,
                           float* sse_part, float* sse_out, float* mom_part,
                           float* mom_out, int B, int M, int N, int Z,
                           int normalized, int nkb, int n_chunks_res,
                           int n_chunks_mom, int want_dsigma, void* stream) {
  using namespace dnmf;
  const Geom g = make_geom(M, N, Z, normalized);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem =
      ((size_t)nkb * KB * NPARAM + 2 * (size_t)nkb) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        refine_residual, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  refine_residual<<<dim3(n_chunks_res, B), THREADS, smem, s>>>(
      betas, params, blocks, y, rw, sse_part, g, nkb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_chunks<<<B, 32, 0, s>>>(sse_part, sse_out, n_chunks_res, 1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int n_sb = nkb * (KB / SUB);
  const dim3 grid(n_chunks_mom, n_sb, B);
  const int nmom = want_dsigma ? 6 : 3;
  if (want_dsigma)
    refine_moments<6><<<grid, THREADS, 0, s>>>(betas, params, blocks, rw,
                                               mom_part, g, nkb);
  else
    refine_moments<3><<<grid, THREADS, 0, s>>>(betas, params, blocks, rw,
                                               mom_part, g, nkb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_chunks<<<B * n_sb, SUB * nmom, 0, s>>>(mom_part, mom_out, n_chunks_mom,
                                              SUB * nmom);
  return (int)cudaGetLastError();
}
