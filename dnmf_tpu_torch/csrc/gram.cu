// Exact MU Gram: G[b] = sum_p (w A)(w A)^T [K][K] and c1[b] = sum_p w A y.
//
// Replaces the Pallas kernels dnmf_tpu/ops/pallas_kernels.py gram_block
// (_gram_kernel, K <= 64), dnmf_tpu/ops/pallas_culled.py gram_block_culled
// (_gram_kernel_culled / _culled_tile_body, K > 64) and
// gram_block_pipelined (_gram_kernel_pipe, the same math behind a TPU DMA
// ring).  It serves the analytic-Gram trust audit and gram_mode="exact".
// With per-frame positions (prm_stride = K_pad * NPARAM) it also replaces
// gram_block_tracked (_gram_kernel_culled(tracked=True)), the exact MU
// statistics of the position-refinement phase.
// With ROWS (entry dnmf_gram_rows) it replaces the streamed-row variant of
// gram_block_culled (psi_source="stream", _gram_kernel_streamed): each
// pixel's deformed coordinates psi [B][P][3] (pixel space) and fade
// w [B][P] were computed outside the kernel and are read from global
// memory (16 bytes more per pixel and frame) instead of being evaluated
// from the basis and the frame's beta; culling, staging, the FMA order
// and gram_assemble are shared.
//
// Bound: KB^2 = 1024 FMAs per pixel per active neuron-block pair, plus
// one exp2 per pixel per neuron of each block of the pair.  The products
// run in float32 FMA: JAX's bf16 "split" dot is a TPU emulation.
// Design: grid (pixel chunk, upper-triangle block pair (i <= j), frame).
// A pair whose +-6 sigma m-intervals do not overlap is culled whole.  A
// chunk is every n_chunks-th tile of GT pixels, so the chunks of a pair
// share its active region alike.  Per tile, 64 threads compute the warp
// and fade, the block tests the tile's deformed-m range against both
// blocks, then stages the two weighted footprint tiles [GT][KB] in shared
// memory; each of the 256 threads accumulates 4 entries of the 32 x 32
// pair Gram in registers across the whole chunk.  The diagonal pair also accumulates c1.  Chunk
// partials are summed in a fixed order by gram_assemble, which mirrors
// the strictly-upper blocks into the lower triangle.
#include "footprint.cuh"

namespace dnmf {

constexpr int GT = 64;                      // pixels per tile
constexpr int PER_THREAD = KB * KB / THREADS;  // 4 Gram entries per thread

__device__ __forceinline__ void pair_of(int pair, int nkb, int& bi, int& bj) {
  bi = 0;
  while (pair >= nkb - bi) {
    pair -= nkb - bi;
    ++bi;
  }
  bj = bi + pair;
}

template <bool ROWS>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ betas, const float* __restrict__ psi_rows,
            const float* __restrict__ w_rows, const float* __restrict__ params,
            const float* __restrict__ blocks, const float* __restrict__ y,
            float* __restrict__ gpart, float* __restrict__ cpart, Geom g,
            int nkb, int n_pairs, int prm_stride) {
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int pair = blockIdx.y, b = blockIdx.z;
  int bi, bj;
  pair_of(pair, nkb, bi, bj);
  const bool diag = bi == bj;
  const int tid = threadIdx.x;
  float* gout = gpart + (((size_t)b * n_pairs + pair) * n_chunks + chunk) * KB * KB;
  float* cout = cpart + (((size_t)b * nkb + bi) * n_chunks + chunk) * KB;

  float acc[PER_THREAD];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) acc[q] = 0.0f;
  float cacc = 0.0f;

  // Pair cull, testing one side only: for j >= i the intervals overlap iff
  // block j starts before block i ends, because block j never ends below
  // block i's start (hi_j >= lo_i).  Shared anchors: the blocks are sorted
  // by m.  Per-frame positions: the sort key is each neuron's mean m and
  // an interval spans its members' m over all frames, so for members q of
  // block j and r of block i, hi_j >= max_t m_q >= mean m_q >= mean m_r
  // >= min_t m_r >= lo_i, even where two tracks cross in m.  A skipped
  // pair is apart in every frame.
  if (blocks[2 * bj] <= blocks[2 * bi + 1]) {
    __shared__ float s_beta[30];
    __shared__ float s_pi[KB * NPARAM], s_pj[KB * NPARAM];
    __shared__ float s_psi[3][GT], s_w[GT], s_y[GT];
    __shared__ float s_ai[GT][KB], s_aj[GT][KB];
    __shared__ float s_mm[2][2];
    if (!ROWS && tid < 30) s_beta[tid] = betas[b * 30 + tid];
    const float* prm = params + (size_t)b * prm_stride;
    for (int i = tid; i < KB * NPARAM; i += THREADS) {
      s_pi[i] = prm[(size_t)bi * KB * NPARAM + i];
      s_pj[i] = prm[(size_t)bj * KB * NPARAM + i];
    }
    const float ilo = blocks[2 * bi], ihi = blocks[2 * bi + 1];
    const float jlo = blocks[2 * bj], jhi = blocks[2 * bj + 1];
    const float* yb = y + (size_t)b * g.P;
    __syncthreads();

    const int n_tiles = (g.P + GT - 1) / GT;
    for (int tile = chunk; tile < n_tiles; tile += n_chunks) {  // round-robin
      const int base = tile * GT;
      if (tid < GT) {
        const int p = base + tid;
        float psi[3] = {0.0f, 0.0f, 0.0f}, w = 0.0f, yv = 0.0f;
        float mlo = CUDART_INF_F, mhi = -CUDART_INF_F;
        if (p < g.P) {
          if constexpr (ROWS) {
            const size_t r = (size_t)b * g.P + p;
            psi[0] = psi_rows[3 * r];
            psi[1] = psi_rows[3 * r + 1];
            psi[2] = psi_rows[3 * r + 2];
            w = w_rows[r];
          } else {
            float phi[10];
            basis(p, g, phi);
            warp_psi(s_beta, phi, g, psi);
            w = fade(psi, g);
          }
          yv = yb[p];
          mlo = mhi = psi[0];
        }
        s_psi[0][tid] = psi[0];
        s_psi[1][tid] = psi[1];
        s_psi[2][tid] = psi[2];
        s_w[tid] = w;
        s_y[tid] = yv;
        mlo = warp_min(mlo);
        mhi = warp_max(mhi);
        if ((tid & 31) == 0) {
          s_mm[tid >> 5][0] = mlo;
          s_mm[tid >> 5][1] = mhi;
        }
      }
      __syncthreads();
      const float tlo = fminf(s_mm[0][0], s_mm[1][0]);
      const float thi = fmaxf(s_mm[0][1], s_mm[1][1]);
      const bool active = ilo <= thi && ihi >= tlo && jlo <= thi && jhi >= tlo;
      if (active) {  // block-uniform
        for (int e = tid; e < GT * KB; e += THREADS) {
          const int p = e / KB, k = e % KB;
          const float psi[3] = {s_psi[0][p], s_psi[1][p], s_psi[2][p]};
          s_ai[p][k] = gauss(&s_pi[k * NPARAM], psi) * s_w[p];
          if (!diag) s_aj[p][k] = gauss(&s_pj[k * NPARAM], psi) * s_w[p];
        }
        __syncthreads();
        const float(*aj)[KB] = diag ? s_ai : s_aj;
#pragma unroll 8
        for (int p = 0; p < GT; ++p) {
#pragma unroll
          for (int q = 0; q < PER_THREAD; ++q) {
            const int e = tid + q * THREADS;
            acc[q] = fmaf(s_ai[p][e / KB], aj[p][e % KB], acc[q]);
          }
        }
        if (diag && tid < KB) {
          for (int p = 0; p < GT; ++p) cacc = fmaf(s_ai[p][tid], s_y[p], cacc);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) gout[tid + q * THREADS] = acc[q];
  if (diag && tid < KB) cout[tid] = cacc;
}

// G[b] (k_pad x k_pad, sorted order) and c1[b] from the chunk partials.
__global__ void gram_assemble(const float* __restrict__ gpart,
                              const float* __restrict__ cpart,
                              float* __restrict__ G, float* __restrict__ c1,
                              int nkb, int n_pairs, int n_chunks) {
  const int pair = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int k_pad = nkb * KB;
  int bi, bj;
  pair_of(pair, nkb, bi, bj);
  const float* src = gpart + ((size_t)b * n_pairs + pair) * n_chunks * KB * KB;
  float* gb = G + (size_t)b * k_pad * k_pad;
  for (int e = tid; e < KB * KB; e += THREADS) {
    float s = 0.0f;
    for (int k = 0; k < n_chunks; ++k) s += src[(size_t)k * KB * KB + e];
    const int r = bi * KB + e / KB, c = bj * KB + e % KB;
    gb[(size_t)r * k_pad + c] = s;
    if (bi != bj) gb[(size_t)c * k_pad + r] = s;
  }
  if (bi == bj && tid < KB) {
    const float* csrc = cpart + ((size_t)b * nkb + bi) * n_chunks * KB;
    float s = 0.0f;
    for (int k = 0; k < n_chunks; ++k) s += csrc[(size_t)k * KB + tid];
    c1[(size_t)b * k_pad + bi * KB + tid] = s;
  }
}

}  // namespace dnmf

// g_out [B][k_pad][k_pad], c1_out [B][k_pad] (sorted order).  Scratch:
// gpart B * n_pairs * n_chunks * KB * KB floats, cpart B * nkb * n_chunks
// * KB floats, n_pairs = nkb (nkb + 1) / 2.  params [k_pad][8], or
// [B][k_pad][8] with prm_stride = k_pad * 8.
namespace {

template <bool ROWS>
int launch_gram(const float* betas, const float* psi_rows,
                const float* w_rows, const float* params, const float* blocks,
                const float* y, float* gpart, float* cpart, float* g_out,
                float* c1_out, int B, const dnmf::Geom& g, int nkb,
                int n_chunks, int prm_stride, void* stream) {
  using namespace dnmf;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_pairs = nkb * (nkb + 1) / 2;
  gram_kernel<ROWS><<<dim3(n_chunks, n_pairs, B), THREADS, 0, s>>>(
      betas, psi_rows, w_rows, params, blocks, y, gpart, cpart, g, nkb,
      n_pairs, prm_stride);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gram_assemble<<<dim3(n_pairs, B), THREADS, 0, s>>>(gpart, cpart, g_out,
                                                       c1_out, nkb, n_pairs,
                                                       n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dnmf_gram(const float* betas, const float* params,
                         const float* blocks, const float* y, float* gpart,
                         float* cpart, float* g_out, float* c1_out, int B,
                         int M, int N, int Z, int normalized, int nkb,
                         int n_chunks, int prm_stride, void* stream) {
  return launch_gram<false>(betas, nullptr, nullptr, params, blocks, y,
                            gpart, cpart, g_out, c1_out, B,
                            dnmf::make_geom(M, N, Z, normalized), nkb,
                            n_chunks, prm_stride, stream);
}

// The same from precomputed rows: psi [B][P][3] pixel-space deformed
// coordinates and w [B][P] fades; params [k_pad][8] (shared anchors).
extern "C" int dnmf_gram_rows(const float* psi, const float* w,
                              const float* params, const float* blocks,
                              const float* y, float* gpart, float* cpart,
                              float* g_out, float* c1_out, int B, int P,
                              int nkb, int n_chunks, void* stream) {
  return launch_gram<true>(nullptr, psi, w, params, blocks, y, gpart, cpart,
                           g_out, c1_out, B, dnmf::make_geom(P, 1, 1, 0), nkb,
                           n_chunks, 0, stream);
}
