// Motion pass: per-frame data term and its analytic beta gradient.
//
//   recon_p = w_p * S_p,  S = sum_k c_k A_k,  r = recon - y
//   dL/dpsi_d = 2 r [ w T_d + S dw/dpsi_d ]
//   T_d = sum_k (2 c_k / s_kd^2) (p_kd - psi_d) A_k
//   mse = sum_p r^2 / P,  dbeta[j][d] = sum_p dL/dpsi_d * phi_j * chain_d / P
//
// Replaces the Pallas kernels dnmf_tpu/ops/pallas_kernels.py:522
// motion_block (body _motion_kernel :424, K <= 64) and
// dnmf_tpu/ops/pallas_culled.py:1464 motion_block_culled (body
// _motion_kernel_culled :1343, K > 64): one kernel for every K.  T_d is
// taken centred on each neuron: the Pallas kernels' B2_d - psi_d B1_d
// cancels at whole-brain coordinates (psi up to 511).
//
// What bounds it on this card: operations.  Per pixel and frame the warp
// (basis, 30 FMAs), the fade and its tie subgradients, and the 30-term
// gradient outer product (~150 operations in all); per neuron within
// reach (6 sigma: a few per pixel) a Gaussian and 5 FMAs; the video is
// read once.  Culling by m alone (the earlier design: 32-neuron blocks
// sorted by m, tested per warp of 32 pixels that span every z) left each
// pixel evaluating the 48-64 Gaussians of every block whose m band it
// met.  The design here (cull.cuh, as refine.cu):
//  * the neuron table is sorted by m once per call (table.cu; shared
//    anchors, one table; with a recordings axis, parallel.batched_round,
//    one per recording, each with its own widths, and every recording's
//    frames in one launch, as the JAX package's vmap prepends the
//    recordings axis to the Pallas grid) and stays in global memory, where
//    it is L1- and L2-resident;
//  * one launch, grid (brick group, frame).  A thread block walks its
//    group's bricks (8 m x 8 n x up to 32 z), keeping each pixel's warp
//    in registers (basis coordinates from a per-brick table, pixel slots
//    from a per-block one: no division per pixel); the brick's exact psi
//    box against each neuron's per-axis 6 sigma box lists the candidates,
//    in table order, into shared rows with this frame's trace weights
//    (c_rows: the traces in table order), CAND rows at a time, so any K
//    runs;
//  * per pixel, S and T summed over the candidates only (carried in
//    shared memory from chunk to chunk), then with the last chunk the
//    residual (the video value read here, to spare registers), dpsi and
//    the 31 running sums (sse + 30 dbeta terms) in registers across the
//    whole group;
//  * one block reduction per group into partial [B][groups][32];
//    motion_finish adds the groups in a fixed order and applies the 1/P
//    and normalization chain factors.  No float atomics: results repeat
//    exactly, and the group count depends only on the volume, so a
//    frame's result does not depend on the other frames of the call.
// A voxel range (a pixel shard: y [B][PL] holds global voxels [p_lo, p_lo
// + PL), as the Pallas kernels' p_offset; the instance RANGE) walks only
// the bricks the range meets, skips the voxels outside it in the two
// bricks it cuts, and divides by PL: each shard's mse and dbeta are means
// over its own voxels, so the mean over the shards is the whole volume's.
// The fade's derivative follows JAX's subgradients at ties (0.5 where
// clip or min meet their bounds) exactly as the Pallas kernel does: on
// thin volumes every face voxel sits on a tie.
#include "cull.cuh"

namespace dnmf {

constexpr int NOUT = 31;
constexpr int CAND = 2 * THREADS;  // candidate rows listed at a time

// A candidate's shared row, three float4s: p (3), log2e / s^2 (3), c, 0,
// 2 c / s_d^2 (3), 0, with this frame's trace c.  A brick whose list comes
// in several chunks carries each pixel's S and T from chunk to chunk in
// s_carry (dynamic, NP * 4 * THREADS floats); the last chunk finishes the
// pixel (residual, dpsi, the 31 sums), so nothing per pixel stays in
// registers while the next brick's candidates are listed.  Frame b reads
// table frame_table(b, fpt) and its video at frame_video(b, fpt, y_rec,
// PL) (cull.cuh).  rmax: the tables' largest m reach; counts (or null):
// [B][n_bricks] candidates per brick.
template <int NP, bool RANGE>
__global__ void __launch_bounds__(THREADS, 3)
motion_bricks(const float* __restrict__ betas, const float* __restrict__ table,
              int fpt, const float* __restrict__ rmax,
              const float* __restrict__ c_rows, const float* __restrict__ y,
              long long y_rec, float* __restrict__ partial,
              int* __restrict__ counts, GeomOf<RANGE> g, BricksOf<RANGE> bk,
              int n_bricks, int bricks_per_group, int k) {
  const int grp = blockIdx.x, n_groups = gridDim.x, b = blockIdx.y;
  extern __shared__ float s_carry[];  // [NP * 4][THREADS]
  __shared__ float4 s_rows[CAND * 3];
  __shared__ int s_cand[CAND];
  __shared__ float s_beta[30];
  __shared__ float s_red[NWARPS * 32];
  __shared__ float s_box[6];
  __shared__ int s_off[NP * THREADS];
  __shared__ float s_coord[2][COORDS];
  __shared__ int s_warp_n[NWARPS];
  __shared__ int s_range[2];
  const int tid = threadIdx.x;
  if (tid < 30) s_beta[tid] = betas[b * 30 + tid];
  brick_slots<NP>(bk, s_off);
  const float rm = *rmax;
  const float* tab = table + frame_table(b, fpt) * k * TROW;
  const float* cb = c_rows + (size_t)b * k;
  const float* yb = y + frame_video(b, fpt, y_rec, range_voxels<RANGE>(g));

  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.0f;

  const int first = grp * bricks_per_group;
  const int last = min(first + bricks_per_group, n_bricks);
  for (int id = first; id < last; ++id) {
    const Brick br = brick_at<RANGE>(id, bk, g);
    float* coord = s_coord[(id - first) & 1];
    const bool cut = brick_cut<RANGE>(br, g);
    const bool full = RANGE ? brick_full(br, bk, cut)
                            : br.count() == bk.bm * bk.bn * bk.bz;
    float psi[NP][3], no_y[NP];  // the video is read per pixel below
    brick_pixels<false, NP, RANGE>(br, bk, g, s_off, coord, s_beta, yb, psi,
                                   no_y, s_red);
    const int nc = list_candidates(
        tab, tab, TROW, k, rm, CAND, s_red, s_box, s_cand, s_warp_n,
        s_range,
        [&](int slot, int kk, const float* row) {
          const float c = cb[kk];
          s_rows[slot * 3] = make_float4(row[0], row[1], row[2], row[3]);
          s_rows[slot * 3 + 1] = make_float4(row[4], row[5], c, 0.0f);
          s_rows[slot * 3 + 2] = make_float4(
              2.0f * c * row[12], 2.0f * c * row[13], 2.0f * c * row[14], 0.0f);
        },
        [&](int n, bool first_chunk, bool last_chunk) {
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            int dm, dn, dz;
            if (!slot_at<RANGE>(br, full, cut, s_off, i, dm, dn, dz, g))
              continue;
            float* carry = s_carry + i * 4 * THREADS + tid;
            float S = 0.0f, T[3] = {0.0f, 0.0f, 0.0f};
            if (!first_chunk) {
              S = carry[0];
              T[0] = carry[THREADS];
              T[1] = carry[2 * THREADS];
              T[2] = carry[3 * THREADS];
            }
            for (int c = 0; c < n; ++c) {
              const float4 r0 = s_rows[c * 3], r1 = s_rows[c * 3 + 1];
              const float4 r2 = s_rows[c * 3 + 2];
              // gauss() of footprint.cuh, from the float4 row.
              const float d0 = r0.x - psi[i][0], d1 = r0.y - psi[i][1];
              const float d2 = r0.z - psi[i][2];
              float e = d0 * d0 * r0.w;
              e += d1 * d1 * r1.x;
              e += d2 * d2 * r1.y;
              const float a = exp2f(-e);
              S = fmaf(r1.z, a, S);
              T[0] = fmaf(r2.x * d0, a, T[0]);
              T[1] = fmaf(r2.y * d1, a, T[1]);
              T[2] = fmaf(r2.z * d2, a, T[2]);
            }
            if (!last_chunk) {
              carry[0] = S;
              carry[THREADS] = T[0];
              carry[2 * THREADS] = T[1];
              carry[3 * THREADS] = T[2];
              continue;
            }
            float wd[3];
#pragma unroll
            for (int d = 0; d < 3; ++d) wd[d] = fade_axis(psi[i][d], g.hi[d]);
            const float w = wd[0] * wd[1] * wd[2];
            const float r = w * S - yb[((br.m0 + dm) * g.N + br.n0 + dn) * g.Z +
                                       br.z0 + dz - range_lo<RANGE>(g)];
            acc[0] = fmaf(r, r, acc[0]);
            float phi[10];
            slot_basis(coord, bk, dm, dn, dz, phi);
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const float pd = psi[i][d], qd = g.hi[d] - pd;
              const float dist = fminf(pd, qd);
              // d clip(1 + dist, 0, 1) / d dist: 1 inside the ramp, 0.5 at
              // its ends (JAX's tie subgradient), 0 outside.
              const float ramp =
                  (dist > -1.0f && dist < 0.0f)
                      ? 1.0f
                      : ((dist == 0.0f || dist == -1.0f) ? 0.5f : 0.0f);
              // d min(pd, hi - pd) / d pd: 0 at its own tie.
              const float sign = (pd == qd) ? 0.0f : (pd < qd ? 1.0f : -1.0f);
              // w / wd_d as the product of the other two fades; 0 where
              // wd_d is.
              const float w_over =
                  wd[d] > 0.0f ? wd[(d + 1) % 3] * wd[(d + 2) % 3] : 0.0f;
              const float dpsi =
                  2.0f * r * (w * T[d] + S * w_over * ramp * sign);
#pragma unroll
              for (int j = 0; j < 10; ++j)
                acc[1 + j * 3 + d] = fmaf(dpsi, phi[j], acc[1 + j * 3 + d]);
            }
          }
        });
    if (counts != nullptr && tid == 0) counts[(size_t)b * n_bricks + id] = nc;
  }
  block_sum<NOUT>(acc, s_red, partial + ((size_t)b * n_groups + grp) * 32);
}

// Per frame b (a block of 32 x 32 threads): warp w sums groups w, w + 32,
// ... of each output, then the warps' sums are added in order; mse[b] =
// sse / pl, dbeta[b][j][d] = sum * chain_d / pl (pl: the voxels summed, P
// without a range).
__global__ void __launch_bounds__(1024)
motion_finish(const float* __restrict__ partial, float* __restrict__ mse,
              float* __restrict__ dbeta, int n_groups, Geom g, int pl) {
  __shared__ float s_part[32][33];
  const int b = blockIdx.x, col = threadIdx.x & 31, row = threadIdx.x >> 5;
  float s = 0.0f;
  for (int gi = row; gi < n_groups; gi += 32)
    s += partial[((size_t)b * n_groups + gi) * 32 + col];
  s_part[row][col] = s;
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= NOUT) return;
  float t = 0.0f;
  for (int w = 0; w < 32; ++w) t += s_part[w][i];
  const float inv_p = 1.0f / (float)pl;
  if (i == 0) {
    mse[b] = t * inv_p;
  } else {
    const int d = (i - 1) % 3;
    const float chain = g.normalized ? g.den[d] / 2.0f : 1.0f;
    dbeta[b * 30 + i - 1] = t * chain * inv_p;
  }
}

}  // namespace dnmf

// betas [B][10][3]; tables [B / fpt][k][TROW] (table.cu), frame b's at b
// / fpt (fpt = B: shared anchors; the frames of a recording: a recordings
// axis), and rmax (1 float) their largest m reach; c_rows [B][k] each
// frame's traces in its table's order; y: frame b's voxels [p_lo, p_lo +
// p_count) (0 and M N Z: the whole volume) at frame_video(b, fpt, y_rec,
// p_count) (y_rec = fpt p_count: [B][p_count]); out [B + 30 B]:
// mse [B], then dbeta [B][10][3].  Bricks of bm x bn x bz voxels,
// bricks_per_group per thread block; partial: [B][n_groups][32] floats of
// scratch; counts (or null): [B][n_bricks] candidates per brick, for the
// n_bricks bricks that the range meets (make_bricks).
extern "C" int dnmf_motion(const float* betas, const float* table,
                           const float* rmax, const float* c_rows,
                           const float* y, long long y_rec, float* partial,
                           float* out, int* counts, int B, int M, int N,
                           int Z, int normalized, int k, int fpt, int bm,
                           int bn, int bz,
                           int bricks_per_group, int p_lo, int p_count,
                           void* stream) {
  using namespace dnmf;
  const RangedGeom g = make_geom(M, N, Z, normalized, p_lo, p_count);
  if (!range_ok(g)) return (int)cudaErrorInvalidValue;
  const RangedBricks bk = make_bricks(g, bm, bn, bz);
  if (bm * bn * bz > THREADS * PPT || bm + bn + bz > COORDS || fpt < 1)
    return (int)cudaErrorInvalidValue;
  const int n_bricks = bk.count;
  const int n_groups = (n_bricks + bricks_per_group - 1) / bricks_per_group;
  cudaStream_t s = (cudaStream_t)stream;
  const auto launch = [&](auto kernel, int carry) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, carry);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(n_groups, B), THREADS, carry, s>>>(
        betas, table, fpt, rmax, c_rows, y, y_rec, partial, counts, g, bk,
        n_bricks, bricks_per_group, k);
    return cudaGetLastError();
  };
  const bool ranged = g.p_lo != 0 || g.PL != g.P;
  const cudaError_t e = with_slots(bm * bn * bz, [&](auto np) {
    constexpr int NP = decltype(np)::value;
    const int carry = NP * 4 * THREADS * sizeof(float);
    return ranged ? launch(motion_bricks<NP, true>, carry)
                  : launch(motion_bricks<NP, false>, carry);
  });
  if (e != cudaSuccess) return (int)e;
  motion_finish<<<B, 1024, 0, s>>>(partial, out, out + B, n_groups, g, g.PL);
  return (int)cudaGetLastError();
}
