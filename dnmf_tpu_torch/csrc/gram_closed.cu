// Closed-form MU Grams: G[b][k][l] = exp(-sum_d gamma_d (p_kd - p_ld)^2)
// * S_kl(b), the function of ops/gram_analytic.py _grams, for every frame
// of a Grams pass in one launch (with c = c_k + c_l, c_k = 1 / s_k^2,
// gamma = c_k c_l / c and the midpoint m = (c_k p_k + c_l p_l) / c per
// axis, S the fade-weighted lattice sum of exp(-c |psi(x) - m|^2),
// linearized around the volume-clamped inverse midpoint with the own-axis
// curvature; a thin axis of at most plane_axis_max planes summed plane by
// plane).
//
// Replaces no Pallas kernel: the JAX package's ops/gram_analytic.py is
// XLA code.  It was added because the plain form, called once per frame
// block, ran ~213 elementwise kernels over [B, K, K, 2w + 1] tensors per
// call: at whole-brain size (frame_block 2, K = 200, w = 12) 500 calls and
// ~106,500 kernel nodes per captured Grams pass, ~295 ms of device time
// per 1000 frames (well under 1% of the bound below) and most of set-up's
// graph capture.
//
// What bounds it on this card: the pairs whose factor exp(-gamma delta^2)
// is non-zero in float32 (neurons within ~43 px at sigma 3: a few % of
// the pairs at whole-brain size) each take 3 x (2w + 1) lattice terms
// (an exponential and ~15 operations each); every other pair is one
// exponential and a write of 0.  The [B][K][K] output (160 MB per 1000
// whole-brain frames, ~48 us at 3.35 TB/s) and the lattice terms (~1 ms
// at 67 TFLOP/s if every pair of every frame were summed) bound it.
//
// Design:
//  * a flat grid of (frame, tile of the upper triangle of the K x K
//    pairs); a block of GT x GT threads, one unordered pair per thread (on
//    a diagonal tile the pairs k <= l);
//  * prologue: the frame's warp (30 floats) and, for the tile's GT row and
//    GT column neurons, p, c = 1 / s^2 per axis and the inverse point x =
//    psi^-1(p) (iters fixed-point steps, in the betas' own space, as
//    ops/basis.py invert_warp_points), in shared memory.  Frame b reads
//    positions table b / fpt (cull.cuh frame_table: fpt = B for shared
//    anchors, 1 for per-frame positions, the frames of a recording for a
//    recordings axis) and widths table b / fpt where each table has its
//    own (a recordings axis), else the one set: nothing is expanded per
//    frame;
//  * per pair the factor first; where it is exactly 0 in float32 the entry
//    is 0 (the plain form's 0 * S, S a finite sum of terms <= 1), so only
//    the others are listed (block_compact, in thread order) and evaluated,
//    each by a group of LANES lanes: the midpoint, the clamp, the warp and
//    the Jacobian diagonal at the clamped point in every lane, and the
//    three windowed lattice sums (or the plane form) split over the lanes
//    and added in a fixed order (a pair's sums are a chain of 3 (2w + 1)
//    exponentials: one thread per pair left the block waiting on it);
//  * the tile goes to G at (k, l) and, transposed through shared memory,
//    at (l, k); each unordered pair is evaluated once, so G is exactly
//    symmetric.  No atomics: results repeat bit for bit, and a frame's
//    entries do not depend on the other frames of the launch.
#include "cull.cuh"

namespace dnmf {

constexpr int GT = 16;  // tile edge: GT x GT pairs, one per thread
static_assert(GT * GT == THREADS, "one pair per thread");
constexpr int LANES = 8;  // lanes that share an evaluated pair's sums

// Sum over the LANES lanes of a group (mask: theirs), in a fixed order;
// every lane gets the same bits (each step adds a and b as its partner
// adds b and a).
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(mask, v, o, LANES);
  return v;
}

// Pixel coordinate x on axis d in the betas' own space, and back.
__device__ __forceinline__ float to_space(float x, int d, const Geom& g) {
  return g.normalized ? 2.0f * x / g.den[d] - 1.0f : x;
}

__device__ __forceinline__ float from_space(float u, int d, const Geom& g) {
  return g.normalized ? (u + 1.0f) / 2.0f * g.den[d] : u;
}

// The warp at space coordinates s, in the betas' own space.
__device__ __forceinline__ void warp_space(const float* beta, const float s[3],
                                           float out[3]) {
  float phi[10];
  basis_xyz(s[0], s[1], s[2], phi);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 10; ++j) acc = fmaf(beta[j * 3 + d], phi[j], acc);
    out[d] = acc;
  }
}

// Diagonal of the warp's Jacobian at space coordinates s (equal in pixel
// and normalized space).
__device__ __forceinline__ void jac_diag(const float* b, const float s[3],
                                         float jd[3]) {
  jd[0] = b[3] + 2.0f * s[0] * b[12] + s[1] * b[21] + s[2] * b[24];
  jd[1] = b[7] + 2.0f * s[1] * b[16] + s[0] * b[22] + s[2] * b[28];
  jd[2] = b[11] + 2.0f * s[2] * b[20] + s[0] * b[26] + s[1] * b[29];
}

// Windowed lattice sum along one axis: sum over the voxels x0 + i, |i| <=
// w, inside [0, hi], of fade(u)^2 exp(-c (u - m)^2), u = u0 + jd ds + h
// ds^2 / 2 the warp along the axis (ds = x0 + i - xc, x0 = rint(xc)).
// The group's lanes take every LANES-th voxel, then add their sums.
__device__ __forceinline__ float axis_sum(float u0, float jd, float h,
                                          float xc, float c, float m,
                                          float hi, int w, int lane,
                                          unsigned mask) {
  const float x0 = rintf(xc);  // half to even, as torch.round
  const int i0 = max(-w, (int)(-x0)), i1 = min(w, (int)(hi - x0));
  float s = 0.0f;
  for (int i = i0 + lane; i <= i1; i += LANES) {
    const float ds = (x0 + (float)i) - xc;
    const float u = u0 + jd * ds + 0.5f * h * ds * ds;
    const float r = fade_axis(u, hi);
    const float e = u - m;
    s += r * r * expf(-c * (e * e));
  }
  return group_sum(s, mask);
}

// S of the pair (row slot a, column slot q): the product of the three
// lattice sums around the clamped inverse midpoint, or over the planes of
// the thin axis `plane`; every lane of the group (lane, mask) gets it.
__device__ float pair_sum(const float* beta, const float h[3],
                          const float (*p)[GT][3], const float (*cs)[GT][3],
                          const float (*xs)[GT][3], int a, int q,
                          const Geom& g, int w, int plane, int lane,
                          unsigned mask) {
  float c[3], m[3], xc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float ck = cs[0][a][d], cl = cs[1][q][d];
    c[d] = ck + cl;
    const float wk = ck / c[d], wl = cl / c[d];
    m[d] = wk * p[0][a][d] + wl * p[1][q][d];
    const float xm = wk * xs[0][a][d] + wl * xs[1][q][d];
    xc[d] = fminf(fmaxf(xm, 0.0f), g.hi[d]);
  }
  float sp[3], u0[3], jd[3];
  if (plane < 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) sp[d] = to_space(xc[d], d, g);
    warp_space(beta, sp, u0);
    jac_diag(beta, sp, jd);
    float s = 1.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      s *= axis_sum(from_space(u0[d], d, g), jd[d], h[d], xc[d], c[d], m[d],
                    g.hi[d], w, lane, mask);
    return s;
  }
  const int nz = plane == 0 ? g.M : (plane == 1 ? g.N : g.Z);
  float acc = 0.0f;
  for (int zp = 0; zp < nz; ++zp) {
#pragma unroll
    for (int d = 0; d < 3; ++d)
      sp[d] = to_space(d == plane ? (float)zp : xc[d], d, g);
    warp_space(beta, sp, u0);
    jac_diag(beta, sp, jd);
    const float ut = from_space(u0[plane], plane, g);
    const float r = fade_axis(ut, g.hi[plane]);
    const float e = ut - m[plane];
    float s = r * r * expf(-c[plane] * (e * e));
#pragma unroll
    for (int d = 0; d < 3; ++d)
      if (d != plane)
        s *= axis_sum(from_space(u0[d], d, g), jd[d], h[d], xc[d], c[d], m[d],
                      g.hi[d], w, lane, mask);
    acc += s;
  }
  return acc;
}

// Grid: frames x upper-triangle tiles (frame-major), THREADS threads.
// betas [B][10][3]; pos [B / fpt][k][3]; sigma [k] or [k][3] (aniso), or
// with sig_tables one set per positions table; out [B][k][k]; counts (or
// null) [B][tiles]: the entries of the tile's pairs whose lattice sums
// were evaluated (both entries of an off-diagonal pair).
__global__ void __launch_bounds__(THREADS)
gram_closed(const float* __restrict__ betas, const float* __restrict__ pos,
            const float* __restrict__ sigma, int fpt, int sig_tables,
            int aniso, float* __restrict__ out, int* __restrict__ counts,
            Geom g, int k, int w, int iters, int plane) {
  __shared__ float s_beta[30];
  __shared__ float s_h[3];
  __shared__ float s_p[2][GT][3], s_c[2][GT][3], s_x[2][GT][3];
  __shared__ float s_g[GT][GT + 1];
  __shared__ float s_pf[THREADS];
  __shared__ int s_item[THREADS];
  __shared__ int s_warp_n[NWARPS];
  // Block (frame b, tile) of the flat grid; the tile of the upper
  // triangle, row by row: (ti, tj), ti <= tj; row i starts at tile_row(i).
  const int tid = threadIdx.x;
  const int nt = (k + GT - 1) / GT;
  const unsigned tiles = (unsigned)nt * (unsigned)(nt + 1) / 2u;
  const int b = (int)(blockIdx.x / tiles);  // 32-bit: the host bounds it
  const long long tile = blockIdx.x - (unsigned)b * tiles;
  auto tile_row = [nt](long long i) { return i * nt - i * (i - 1) / 2; };
  const double q2 = 2.0 * nt + 1.0;
  int ti = (int)((q2 - sqrt(q2 * q2 - 8.0 * (double)tile)) / 2.0);
  while (ti > 0 && tile_row(ti) > tile) --ti;
  while (ti + 1 < nt && tile_row(ti + 1) <= tile) ++ti;
  const int tj = ti + (int)(tile - tile_row(ti));

  if (tid < 30) s_beta[tid] = betas[(size_t)b * 30 + tid];
  __syncthreads();
  if (tid < 3)  // own-axis curvature d^2 psi_d / dx_d^2 in pixel space
    s_h[tid] = g.normalized ? 4.0f * s_beta[(4 + tid) * 3 + tid] / g.den[tid]
                            : 2.0f * s_beta[(4 + tid) * 3 + tid];
  if (tid < 2 * GT) {
    const int side = tid / GT, i = tid % GT;
    const int n = (side ? tj : ti) * GT + i;
    if (n < k) {
      const size_t tab = frame_table(b, fpt);
      const float* pn = pos + (tab * k + n) * 3;
      const float* sg = sigma + (sig_tables ? tab : 0) * k * (aniso ? 3 : 1);
      float pt[3], x[3], wx[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float sd = aniso ? sg[n * 3 + d] : sg[n];
        pt[d] = to_space(pn[d], d, g);
        x[d] = pt[d];
        s_p[side][i][d] = pn[d];
        s_c[side][i][d] = 1.0f / (sd * sd);
      }
      for (int it = 0; it < iters; ++it) {
        warp_space(s_beta, x, wx);
#pragma unroll
        for (int d = 0; d < 3; ++d) x[d] = x[d] + (pt[d] - wx[d]);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) s_x[side][i][d] = from_space(x[d], d, g);
    }
  }
  const int ty = tid / GT, tx = tid % GT;
  const int kk = ti * GT + ty, ll = tj * GT + tx;
  s_g[ty][tx] = 0.0f;
  __syncthreads();

  const bool mine = kk < k && ll < k && (ti != tj || ty <= tx);
  float pf = 0.0f;
  if (mine) {
    float e = 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float ck = s_c[0][ty][d], cl = s_c[1][tx][d];
      const float gam = ck * cl / (ck + cl);
      const float dd = s_p[0][ty][d] - s_p[1][tx][d];
      e += gam * (dd * dd);
    }
    pf = expf(-e);
  }
  const bool keep = mine && pf != 0.0f;
  int n_items;
  const int slot = block_compact(keep, 0, s_warp_n, &n_items);
  if (keep) {
    s_item[slot] = tid;
    s_pf[slot] = pf;
  }
  if (counts != nullptr) {
    const int nd = __syncthreads_count(keep && kk == ll);
    if (tid == 0)
      counts[blockIdx.x] = 2 * n_items - nd;
  }
  __syncthreads();
  // The listed pairs, LANES lanes each.
  const int lane = tid % LANES;
  const unsigned mask = (0xffffffffu >> (32 - LANES))
                        << (tid & 31 & ~(LANES - 1));
  for (int it = tid / LANES; it < n_items; it += THREADS / LANES) {
    const int t = s_item[it], a = t / GT, q = t % GT;
    const float sv = pair_sum(s_beta, s_h, s_p, s_c, s_x, a, q, g, w, plane,
                              lane, mask);
    if (lane == 0) s_g[a][q] = s_pf[it] * sv;
  }
  __syncthreads();

  float* gb = out + (size_t)b * k * k;
  if (kk < k && ll < k)
    gb[(size_t)kk * k + ll] = ty <= tx || ti != tj ? s_g[ty][tx] : s_g[tx][ty];
  if (ti != tj) {  // the transposed tile: (l, k) = (tj GT + ty, ti GT + tx)
    const int r = tj * GT + ty, col = ti * GT + tx;
    if (r < k && col < k) gb[(size_t)r * k + col] = s_g[tx][ty];
  }
}

}  // namespace dnmf

// betas [B][10][3]; pos [B / fpt][k][3] (frame b's table at b / fpt: fpt
// = B for shared anchors, 1 for per-frame positions, the frames of one
// recording for a recordings axis); sigma [k] (aniso 0) or [k][3], or
// with sig_tables one set per positions table; out [B][k][k]; counts (or
// null) [B][tiles] int32, tiles = nt (nt + 1) / 2 with nt = ceil(k / 16).
// window: the lattice half-width; iters: the inversion's fixed-point
// steps; plane: the thin axis summed plane by plane, or -1.
extern "C" int dnmf_gram_closed(const float* betas, const float* pos,
                                const float* sigma, float* out, int* counts,
                                int B, int M, int N, int Z, int normalized,
                                int k, int fpt, int sig_tables, int aniso,
                                int window, int iters, int plane,
                                void* stream) {
  using namespace dnmf;
  const int nt = (k + GT - 1) / GT;
  const long long tiles = (long long)nt * (nt + 1) / 2;
  if (B < 1 || k < 1 || fpt < 1 || tiles * B > 0x7fffffffLL || window < 0 ||
      iters < 0 || plane > 2)
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(M, N, Z, normalized);
  gram_closed<<<(unsigned)(tiles * B), THREADS, 0, (cudaStream_t)stream>>>(
      betas, pos, sigma, fpt, sig_tables, aniso, out, counts, g, k, window,
      iters, plane);
  return (int)cudaGetLastError();
}
