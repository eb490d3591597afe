// c1 video pass: c1[b][k] = sum_p w(psi_b(p)) A_k(psi_b(p)) y_b(p).
//
// Replaces the Pallas kernel dnmf_tpu/ops/pallas_culled.py:648
// c1_block_culled (bodies _c1_kernel_culled :548 and its DMA-ring twin
// _c1_kernel_pipe :611, calls at :723 and :764), the video pass of the
// closed-form-Gram default at every K, with shared anchors pos [K,3] (one
// neuron table) or per-frame positions pos [B,K,3] (the refinement phase;
// one table per frame, sorted by that frame's own m), and over a
// recordings axis (parallel.batched_round: one table per recording, with
// its own widths, and every recording's frames in one launch, as the
// JAX package's vmap prepends the recordings axis to the Pallas grid).
//
// What bounds it on this card: operations.  Per pixel and frame the warp
// (basis, 30 FMAs) and the fade; per neuron within reach (6 sigma: a few
// per pixel) a Gaussian and one FMA; the video is read once (4 bytes per
// pixel: well under the card's memory rate at these operation counts).
// The earlier design culled by m alone (32-neuron blocks sorted by m,
// tested per warp of 32 pixels that span every z), so each pixel
// evaluated the 32 Gaussians of every block whose m band it met, and its
// grid (chunk, neuron block, frame) read the video and evaluated each
// pixel's warp once per neuron block.  The design here (cull.cuh, as
// refine.cu):
//  * table.cu sorts the neurons by m on the card (once for shared anchors,
//    once per frame for per-frame positions); the table stays in global
//    memory, where it is L1- and L2-resident;
//  * one launch, grid (brick group, frame).  A thread block walks its
//    group's bricks (8 m x 8 n x up to 32 z), keeping each pixel's warp,
//    fade and video value in registers: one warp evaluation and one video
//    read per pixel (basis coordinates from a per-brick table, pixel slots
//    from a per-block one: no division per pixel);
//  * the brick's exact psi box against each neuron's per-axis 6 sigma box
//    lists the candidates, in table order, into shared rows, CAND at a
//    time, so any K runs;
//  * per chunk of CH candidates, per-thread sums over the thread's pixels,
//    block-reduced in a fixed order and added by one thread each to the
//    group's own dense [K] row of partials in global memory (zeroed first;
//    the barriers order the additions);
//  * c1_finish adds the groups' rows in a fixed order and writes each
//    neuron's c1 at its place in the caller's order.  No float atomics:
//    results repeat exactly, and the group count depends only on the
//    volume and K, so a frame's result does not depend on the other frames
//    of the call.
#include "cull.cuh"

namespace dnmf {

constexpr int CH = 8;              // candidates per reduction chunk
constexpr int CAND = 2 * THREADS;  // candidate rows listed at a time

// A candidate's shared row, two float4s: p (3), log2e / s^2 (3), 0, 0.
// Frame b reads table frame_table(b, fpt) and its video at
// frame_video(b, fpt, y_rec, P) (cull.cuh).  rmax: the largest m reach of
// the tables; counts (or null): [B][n_bricks] candidates per brick.
template <int NP>
__global__ void __launch_bounds__(THREADS, 4)
c1_bricks(const float* __restrict__ betas, const float* __restrict__ table,
          int fpt, const float* __restrict__ rmax,
          const float* __restrict__ y, long long y_rec,
          float* __restrict__ partial, int* __restrict__ counts, Geom g,
          Bricks bk, int n_bricks, int bricks_per_group, int k) {
  const int grp = blockIdx.x, n_groups = gridDim.x, b = blockIdx.y;
  __shared__ float4 s_rows[CAND * 2];
  __shared__ int s_cand[CAND];
  __shared__ float s_beta[30];
  __shared__ float s_red[NWARPS * CH];
  __shared__ float s_box[6];
  __shared__ int s_off[NP * THREADS];
  __shared__ float s_coord[2][COORDS];
  __shared__ int s_warp_n[NWARPS];
  __shared__ int s_range[2];
  const int tid = threadIdx.x;
  if (tid < 30) s_beta[tid] = betas[b * 30 + tid];
  brick_slots<NP>(bk, s_off);
  float* out = partial + ((size_t)b * n_groups + grp) * k;
  for (int i = tid; i < k; i += THREADS) out[i] = 0.0f;
  const float* tab = table + frame_table(b, fpt) * k * TROW;
  const float rm = *rmax;
  const float* yb = y + frame_video(b, fpt, y_rec, g.P);

  const int first = grp * bricks_per_group;
  const int last = min(first + bricks_per_group, n_bricks);
  for (int id = first; id < last; ++id) {
    const Brick br = brick_at(id, bk, g);
    float* coord = s_coord[(id - first) & 1];
    const int npix = br.count();
    float psi[NP][3], yv[NP], w[NP];
    brick_pixels<true, NP>(br, bk, g, s_off, coord, s_beta, yb, psi, yv, s_red);
#pragma unroll
    for (int i = 0; i < NP; ++i) w[i] = fade(psi[i], g);
    const int nc = list_candidates(
        tab, tab, TROW, k, rm, CAND, s_red, s_box, s_cand, s_warp_n, s_range,
        [&](int slot, int, const float* row) {
          s_rows[slot * 2] = make_float4(row[0], row[1], row[2], row[3]);
          s_rows[slot * 2 + 1] = make_float4(row[4], row[5], 0.0f, 0.0f);
        },
        [&](int n, bool, bool) {
          for (int c0 = 0; c0 < n; c0 += CH) {
            float acc[CH];
#pragma unroll
            for (int j = 0; j < CH; ++j) acc[j] = 0.0f;
#pragma unroll
            for (int cc = 0; cc < CH; ++cc) {
              if (c0 + cc >= n) break;
              const float4 r0 = s_rows[(c0 + cc) * 2];
              const float4 r1 = s_rows[(c0 + cc) * 2 + 1];
#pragma unroll
              for (int i = 0; i < NP; ++i) {
                if (tid + i * THREADS >= npix) continue;
                // gauss() of footprint.cuh, from the float4 row.
                const float d0 = r0.x - psi[i][0], d1 = r0.y - psi[i][1];
                const float d2 = r0.z - psi[i][2];
                float e = d0 * d0 * r0.w;
                e += d1 * d1 * r1.x;
                e += d2 * d2 * r1.y;
                acc[cc] = fmaf(exp2f(-e), w[i] * yv[i], acc[cc]);
              }
            }
            // block_sum<CH>, its result added to the group's row.
            const int lane = tid & 31, wid = tid >> 5;
#pragma unroll
            for (int j = 0; j < CH; ++j) {
              const float v = warp_sum(acc[j]);
              if (lane == 0) s_red[wid * CH + j] = v;
            }
            __syncthreads();
            if (tid < CH && c0 + tid < n) {
              float t = 0.0f;
              for (int wi = 0; wi < NWARPS; ++wi) t += s_red[wi * CH + tid];
              out[s_cand[c0 + tid]] += t;
            }
            __syncthreads();
          }
        });
    if (counts != nullptr && tid == 0) counts[(size_t)b * n_bricks + id] = nc;
  }
}

// c1 of 32 table rows (blockIdx.x) of frame b (blockIdx.y), a block of 32
// x 32 threads: warp w sums groups w, w + 32, ... of each row, then the
// warps' sums are added in order; written at the row's neuron index in
// the frame's table's order, order[frame_table(b, fpt) * k + row].
__global__ void __launch_bounds__(1024)
c1_finish(const float* __restrict__ partial,
          const long long* __restrict__ order,
          int fpt, float* __restrict__ c1, int n_groups, int k) {
  __shared__ float s_part[32][33];
  const int b = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (i < k)
    for (int gi = w; gi < n_groups; gi += 32)
      s += partial[((size_t)b * n_groups + gi) * k + i];
  s_part[w][lane] = s;
  __syncthreads();
  if (w != 0 || i >= k) return;
  float t = 0.0f;
  for (int r = 0; r < 32; ++r) t += s_part[r][lane];
  c1[(size_t)b * k + order[frame_table(b, fpt) * k + i]] = t;
}

}  // namespace dnmf

// betas [B][10][3]; tables [B / fpt][k][TROW] and orders [B / fpt][k]
// (table.cu, order int64), frame b's at b / fpt (fpt = B: shared anchors,
// 1: per-frame positions, the frames of a recording: a recordings axis),
// and rmax (1 float) their largest m reach; y: frame b's P voxels at
// frame_video(b, fpt, y_rec, P) (y_rec = fpt P: [B][P]); c1 [B][k] in the
// caller's neuron order.  Bricks of bm x bn x bz voxels, bricks_per_group
// per thread block; partial: [B][n_groups][k] floats of scratch; counts
// (or null): [B][n_bricks] candidates per brick.
extern "C" int dnmf_c1(const float* betas, const float* table,
                       const long long* order, const float* rmax,
                       const float* y, long long y_rec, float* partial,
                       float* c1, int* counts, int B, int M, int N, int Z,
                       int normalized, int k, int fpt, int bm, int bn,
                       int bz, int bricks_per_group, void* stream) {
  using namespace dnmf;
  const RangedGeom g = make_geom(M, N, Z, normalized);
  const RangedBricks bk = make_bricks(g, bm, bn, bz);
  if (bm * bn * bz > THREADS * PPT || bm + bn + bz > COORDS || fpt < 1)
    return (int)cudaErrorInvalidValue;
  const int n_bricks = bk.nbm * bk.nbn * bk.nbz;
  const int n_groups = (n_bricks + bricks_per_group - 1) / bricks_per_group;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = with_slots(bm * bn * bz, [&](auto np) {
    constexpr int NP = decltype(np)::value;
    c1_bricks<NP><<<dim3(n_groups, B), THREADS, 0, s>>>(
        betas, table, fpt, rmax, y, y_rec, partial, counts, g, bk, n_bricks,
        bricks_per_group, k);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return (int)e;
  c1_finish<<<dim3((k + 31) / 32, B), 1024, 0, s>>>(
      partial, order, fpt, c1, n_groups, k);
  return (int)cudaGetLastError();
}
