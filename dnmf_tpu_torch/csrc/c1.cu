// c1 video pass: c1[b][k] = sum_p w(psi_b(p)) A_k(psi_b(p)) y_b(p).
//
// Replaces the Pallas kernel dnmf_tpu/ops/pallas_culled.py c1_block_culled
// (_c1_kernel_culled and its DMA-ring twin _c1_kernel_pipe), the video
// pass of the closed-form-Gram default at every K, with shared anchors
// pos [K,3] (prm_stride 0) or per-frame positions pos [B,K,3] (the
// refinement phase; prm_stride K_pad * NPARAM).
//
// Bound: one exp2 plus ~8 FMAs per pixel per neuron of every block that
// the pixel's warp does not cull; the video is read once per neuron block
// (4 bytes per pixel, far below the card's bandwidth at these exp rates).
// Design: grid (pixel chunk, neuron block, frame).  A chunk is every
// n_chunks-th tile of THREADS pixels; each thread walks its chunk one pixel
// per step and keeps the block's KB sums in registers, so
// nothing leaves the SM until the chunk ends; a warp skips a neuron block
// whose m-interval misses its 32 pixels.  Chunk partials [B][nkb][chunks][KB]
// are summed in a fixed order by sum_chunks (deterministic, float32
// accumulation throughout).
#include "footprint.cuh"

namespace dnmf {

__global__ void __launch_bounds__(THREADS)
c1_kernel(const float* __restrict__ betas, const float* __restrict__ params,
          const float* __restrict__ blocks, const float* __restrict__ y,
          float* __restrict__ partial, Geom g, int nkb, int prm_stride) {
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int blk = blockIdx.y, b = blockIdx.z;
  __shared__ float s_beta[30];
  __shared__ float s_prm[KB * NPARAM];
  __shared__ float s_red[NWARPS * KB];
  const int tid = threadIdx.x;
  if (tid < 30) s_beta[tid] = betas[b * 30 + tid];
  const float* prm = params + (size_t)b * prm_stride + (size_t)blk * KB * NPARAM;
  for (int i = tid; i < KB * NPARAM; i += THREADS) s_prm[i] = prm[i];
  __syncthreads();

  const float lo = blocks[2 * blk], hi = blocks[2 * blk + 1];
  const float* yb = y + (size_t)b * g.P;
  float acc[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) acc[k] = 0.0f;

  // Tiles are dealt to the chunks round-robin, so every chunk of a
  // neuron block meets that block's active region alike.
  const int n_tiles = (g.P + THREADS - 1) / THREADS;
  for (int tile = chunk; tile < n_tiles; tile += n_chunks) {
    const int p = tile * THREADS + tid;
    float psi[3] = {0.0f, 0.0f, 0.0f};
    float wy = 0.0f, mlo = CUDART_INF_F, mhi = -CUDART_INF_F;
    if (p < g.P) {
      float phi[10];
      basis(p, g, phi);
      warp_psi(s_beta, phi, g, psi);
      wy = fade(psi, g) * yb[p];
      mlo = mhi = psi[0];
    }
    mlo = warp_min(mlo);
    mhi = warp_max(mhi);
    if (lo <= mhi && hi >= mlo) {
#pragma unroll
      for (int k = 0; k < KB; ++k)
        acc[k] = fmaf(gauss(&s_prm[k * NPARAM], psi), wy, acc[k]);
    }
  }
  block_sum<KB>(acc, s_red,
                partial + (((size_t)b * nkb + blk) * n_chunks + chunk) * KB);
}

}  // namespace dnmf

// c1_out [B][nkb * KB] in sorted neuron order; partial is scratch of
// B * nkb * n_chunks * KB floats; params [k_pad][8], or [B][k_pad][8]
// with prm_stride = k_pad * 8.
extern "C" int dnmf_c1(const float* betas, const float* params,
                       const float* blocks, const float* y, float* partial,
                       float* c1_out, int B, int M, int N, int Z,
                       int normalized, int nkb, int n_chunks, int prm_stride,
                       void* stream) {
  using namespace dnmf;
  const Geom g = make_geom(M, N, Z, normalized);
  cudaStream_t s = (cudaStream_t)stream;
  c1_kernel<<<dim3(n_chunks, nkb, B), THREADS, 0, s>>>(
      betas, params, blocks, y, partial, g, nkb, prm_stride);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_chunks<<<B * nkb, KB, 0, s>>>(partial, c1_out, n_chunks, KB);
  return (int)cudaGetLastError();
}
