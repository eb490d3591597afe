// Motion pass: per-frame data term and its analytic beta gradient.
//
//   recon_p = w_p * S_p,  S = sum_k c_k A_k,  r = recon - y
//   dL/dpsi_d = 2 r [ w (B2_d - psi_d B1_d) + S dw/dpsi_d ]
//   B1_d = sum_k (2 c_k / s_kd^2) A_k,  B2_d = sum_k (2 c_k p_kd / s_kd^2) A_k
//   mse = sum_p r^2 / P,  dbeta[j][d] = sum_p dL/dpsi_d * phi_j * chain_d / P
//
// Replaces the Pallas kernels dnmf_tpu/ops/pallas_kernels.py motion_block
// (_motion_kernel, K <= 64) and dnmf_tpu/ops/pallas_culled.py
// motion_block_culled (_motion_kernel_culled, K > 64): with one neuron
// block this kernel is the dense one.
//
// Bound: one exp2 plus ~13 FMAs per pixel per neuron of every block the
// pixel's warp does not cull; the per-pixel warp, fade and 30-term
// gradient outer product are a fixed ~100 FLOPs on top.
// Design: one thread per pixel per step loops over all neuron blocks
// (the residual needs every neuron), keeping S, B1, B2 and the 31 output
// sums (sse + dbeta) in registers across its chunk (every n_chunks-th
// tile of THREADS pixels); neuron parameters and the frame's
// trace weights sit in shared memory.  Grid (pixel chunk, frame); chunk
// partials [B][chunks][32] are summed in a fixed order by
// motion_finalize, which also applies the 1/P and normalization chain
// factors.  The fade's derivative follows JAX's subgradients at ties
// (0.5 where clip or min meet their bounds) exactly as the Pallas kernel
// does: on thin volumes every face voxel sits on a tie.
#include "footprint.cuh"

namespace dnmf {

constexpr int MW = 8;   // per-neuron weight row: c, 2c p_d/s_d^2 (3), 2c/s_d^2 (3), 0
constexpr int NOUT = 31;

__global__ void __launch_bounds__(THREADS)
motion_kernel(const float* __restrict__ betas, const float* __restrict__ params,
              const float* __restrict__ wts, const float* __restrict__ blocks,
              const float* __restrict__ y, float* __restrict__ partial, Geom g,
              int nkb) {
  const int chunk = blockIdx.x, n_chunks = gridDim.x, b = blockIdx.y;
  const int k_pad = nkb * KB;
  extern __shared__ float smem[];
  float* s_prm = smem;                      // [k_pad][NPARAM]
  float* s_wt = s_prm + k_pad * NPARAM;     // [k_pad][MW]
  float* s_blk = s_wt + k_pad * MW;         // [nkb][2]
  __shared__ float s_beta[30];
  __shared__ float s_red[NWARPS * 32];
  const int tid = threadIdx.x;
  if (tid < 30) s_beta[tid] = betas[b * 30 + tid];
  for (int i = tid; i < k_pad * NPARAM; i += THREADS) s_prm[i] = params[i];
  for (int i = tid; i < k_pad * MW; i += THREADS)
    s_wt[i] = wts[(size_t)b * k_pad * MW + i];
  for (int i = tid; i < 2 * nkb; i += THREADS) s_blk[i] = blocks[i];
  __syncthreads();

  const float* yb = y + (size_t)b * g.P;
  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.0f;

  const int n_tiles = (g.P + THREADS - 1) / THREADS;
  for (int tile = chunk; tile < n_tiles; tile += n_chunks) {  // round-robin
    const int p = tile * THREADS + tid;
    const bool valid = p < g.P;
    float phi[10], psi[3] = {0.0f, 0.0f, 0.0f};
    float mlo = CUDART_INF_F, mhi = -CUDART_INF_F;
    if (valid) {
      basis(p, g, phi);
      warp_psi(s_beta, phi, g, psi);
      mlo = mhi = psi[0];
    }
    mlo = warp_min(mlo);
    mhi = warp_max(mhi);

    float S = 0.0f, B1[3] = {0.0f, 0.0f, 0.0f}, B2[3] = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < nkb; ++i) {
      if (!(s_blk[2 * i] <= mhi && s_blk[2 * i + 1] >= mlo)) continue;
#pragma unroll 4
      for (int k = i * KB; k < (i + 1) * KB; ++k) {
        const float a = gauss(&s_prm[k * NPARAM], psi);
        const float* wt = &s_wt[k * MW];
        S = fmaf(wt[0], a, S);
        B2[0] = fmaf(wt[1], a, B2[0]);
        B2[1] = fmaf(wt[2], a, B2[1]);
        B2[2] = fmaf(wt[3], a, B2[2]);
        B1[0] = fmaf(wt[4], a, B1[0]);
        B1[1] = fmaf(wt[5], a, B1[1]);
        B1[2] = fmaf(wt[6], a, B1[2]);
      }
    }
    if (!valid) continue;

    float wd[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) wd[d] = fade_axis(psi[d], g.hi[d]);
    const float w = wd[0] * wd[1] * wd[2];
    const float r = w * S - yb[p];
    acc[0] = fmaf(r, r, acc[0]);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float pd = psi[d], qd = g.hi[d] - pd;
      const float dist = fminf(pd, qd);
      // d clip(1 + dist, 0, 1) / d dist: 1 inside the ramp, 0.5 at its
      // ends (JAX's tie subgradient), 0 outside.
      const float ramp = (dist > -1.0f && dist < 0.0f) ? 1.0f
                         : ((dist == 0.0f || dist == -1.0f) ? 0.5f : 0.0f);
      // d min(pd, hi - pd) / d pd: 0 at its own tie.
      const float sign = (pd == qd) ? 0.0f : (pd < qd ? 1.0f : -1.0f);
      const float w_over = wd[d] > 0.0f ? w / fmaxf(wd[d], 1e-12f) : 0.0f;
      const float dpsi =
          2.0f * r * (w * (B2[d] - pd * B1[d]) + S * w_over * ramp * sign);
#pragma unroll
      for (int j = 0; j < 10; ++j)
        acc[1 + j * 3 + d] = fmaf(dpsi, phi[j], acc[1 + j * 3 + d]);
    }
  }
  block_sum<NOUT>(acc, s_red, partial + ((size_t)b * n_chunks + chunk) * 32);
}

// mse[b] = sse / P; dbeta[b][j][d] = sum * chain_d / P.
__global__ void motion_finalize(const float* __restrict__ partial,
                                float* __restrict__ mse,
                                float* __restrict__ dbeta, int n_chunks,
                                Geom g) {
  const int b = blockIdx.x, i = threadIdx.x;
  if (i >= NOUT) return;
  float s = 0.0f;
  for (int k = 0; k < n_chunks; ++k) s += partial[((size_t)b * n_chunks + k) * 32 + i];
  const float inv_p = 1.0f / (float)g.P;
  if (i == 0) {
    mse[b] = s * inv_p;
  } else {
    const int d = (i - 1) % 3;
    const float chain = g.normalized ? g.den[d] / 2.0f : 1.0f;
    dbeta[b * 30 + i - 1] = s * chain * inv_p;
  }
}

}  // namespace dnmf

// params [k_pad][8] sorted by m; wts [B][k_pad][8]; blocks [nkb][2];
// mse_out [B]; dbeta_out [B][10][3]; partial: B * n_chunks * 32 floats.
extern "C" int dnmf_motion(const float* betas, const float* params,
                           const float* wts, const float* blocks,
                           const float* y, float* partial, float* mse_out,
                           float* dbeta_out, int B, int M, int N, int Z,
                           int normalized, int nkb, int n_chunks,
                           void* stream) {
  using namespace dnmf;
  const Geom g = make_geom(M, N, Z, normalized);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem =
      ((size_t)nkb * KB * (NPARAM + MW) + 2 * (size_t)nkb) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        motion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  motion_kernel<<<dim3(n_chunks, B), THREADS, smem, s>>>(
      betas, params, wts, blocks, y, partial, g, nkb);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  motion_finalize<<<B, 32, 0, s>>>(partial, mse_out, dbeta_out, n_chunks, g);
  return (int)cudaGetLastError();
}
