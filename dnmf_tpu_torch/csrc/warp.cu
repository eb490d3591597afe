// Kernel G: piecewise-rigid shift application (field upsample + separable
// warp) for a 3-D frame block.
//
// Replaces dnmf_tpu/ops/pallas_warp.py:163 fused_separable_warp (body
// _warp_kernel :78), whose semantics are
// _apply_remap_field(..., remap_mode="separable"): the per-patch shift
// grid F [Gm, Gn, Gz, 3] is upsampled with the cubic resize matrices of
// jax.image.resize, clipped to rigid +- (max_deviation_rigid + 2), and
// three sequential edge-clamped linear passes (m, then n, then z) sample
// the previous pass's output at x + s_d(x), with the weights evaluated on
// the output lattice.
//
// What bounds it on this card: memory.  A 512x512x20 frame is 21 MB, read
// once and written once (42 MB per frame); the field and the three lerps
// cost a few tens of operations per voxel.  The earlier design made one
// launch per pass, each reading and writing the whole frame (~3x the
// bytes), and evaluated the whole triple sum of the cubic field over the
// patch grid (gm gn gz terms) in every voxel and pass, with 64-bit index
// divisions per voxel.  The design here:
//  * one launch, grid (n tile, m tile, frame).  A thread block owns TM m
//    rows x TN n columns x the whole z column of one frame.  It samples
//    the source along m (taps gathered from device memory, L2-resident)
//    for its rows and the n columns of the tile plus a halo of
//    H = ceil(max_shifts_n) + 1 + rb + 2 on each side (the base's integer
//    part, the residual's bound and the lerp's second tap: every tap the
//    n pass can take) into shared memory, then along n into a second
//    shared buffer, then along z, and writes the tile once.  Edge clamps
//    map taps outside the volume onto its edge rows, which the halo then
//    holds;
//  * the field by partial contraction: per frame H[a][c][xz] = sum_e
//    Rz[xz][e] F[a][c][e], per m row of the tile Q[c][xz] = sum_a
//    Rm[xm][a] H[a][c][xz] (both in shared memory, per axis), and per
//    voxel sum_c Rn[xn][c] Q[c][xz]: gn FMAs per voxel and axis in place
//    of gm gn gz;
//  * 32-bit index arithmetic, one division per (n, z) element and pass,
//    shared by the tile's m rows.
// The clip and the lerp are the earlier kernel's, so only the order of the
// field's FMAs differs.  Plain C interface (ctypes); no reductions, so
// results repeat exactly.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TM = 4;  // tile rows in m (ops/warp.py WARP_TM)

struct WarpArgs {
  int M, N, Z, gm, gn, gz;
  int tn, halo;  // tile columns, n halo on each side
  float rb;      // max_deviation_rigid + 2
  int bb[3];     // ceil(max_shifts) + 1 per axis
};

// Clip of the field value f on axis `axis` around the frame's rigid shift
// bs, the base's integer part moved into the tap: the taps x + t and
// x + t + 1 and the second tap's weight (resample.separable_warp with a
// base).
__device__ __forceinline__ void taps(float f, float bs, float rb, float bb,
                                     int x, int len, int& t0, int& t1,
                                     float& frac) {
  float s = fminf(fmaxf(f, bs - rb), bs + rb);
  const float b_int = fminf(fmaxf(floorf(bs), -bb), bb);
  s = fminf(fmaxf(s - b_int, -rb - 1.f), rb + 1.f);
  const float o = floorf(s);
  frac = s - o;
  const int i0 = x + static_cast<int>(b_int) + static_cast<int>(o);
  t0 = min(max(i0, 0), len - 1);
  t1 = min(max(i0 + 1, 0), len - 1);
}

// The field on axis `axis` at the tile's TM rows, column xn, plane xz:
// f[xl] = sum_c Rn[xn][c] Q[xl][c][xz][axis] (Q is 0 past the tile's last
// row).  The rows share Rn's loads.
__device__ __forceinline__ void fields(const float* s_q,
                                       const float* __restrict__ rn,
                                       const WarpArgs& a, int xn, int xz,
                                       int axis, float f[TM]) {
  const float* q = s_q + (size_t)xz * 3 + axis;
  const float* r = rn + (size_t)xn * a.gn;
  const size_t row = (size_t)a.gn * a.Z * 3, col = (size_t)a.Z * 3;
#pragma unroll
  for (int xl = 0; xl < TM; ++xl) f[xl] = 0.f;
  for (int c = 0; c < a.gn; ++c) {
    const float rc = r[c];
#pragma unroll
    for (int xl = 0; xl < TM; ++xl)
      f[xl] = fmaf(rc, q[xl * row + c * col], f[xl]);
  }
}

__global__ void __launch_bounds__(THREADS) warp_tile(
    const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ grid, const float* __restrict__ rm,
    const float* __restrict__ rn, const float* __restrict__ rz,
    const float* __restrict__ base, WarpArgs a) {
  extern __shared__ float smem[];
  const int n0 = blockIdx.x * a.tn, m0 = blockIdx.y * TM, b = blockIdx.z;
  const int tid = threadIdx.x, Z = a.Z;
  const int wm = min(TM, a.M - m0), wn = min(a.tn, a.N - n0);
  const int n_lo = max(0, n0 - a.halo), n_hi = min(a.N, n0 + wn + a.halo);
  const int w1 = n_hi - n_lo;
  const int w1_max = min(a.N, a.tn + 2 * a.halo), tn_max = min(a.N, a.tn);
  float* s1 = smem;                                    // [TM][w1_max][Z]
  float* s2 = s1 + (size_t)TM * w1_max * Z;            // [TM][tn_max][Z]
  float* s_h = s2 + (size_t)TM * tn_max * Z;           // [gm][gn][Z][3]
  float* s_q = s_h + (size_t)a.gm * a.gn * Z * 3;      // [TM][gn][Z][3]
  const float* f = grid + (size_t)b * a.gm * a.gn * a.gz * 3;
  const size_t plane = (size_t)a.N * Z;
  const float* sb = src + (size_t)b * a.M * plane;
  float* db = dst + (size_t)b * a.M * plane;
  const float bs[3] = {base[b * 3], base[b * 3 + 1], base[b * 3 + 2]};

  // H[a][c][xz][d] = sum_e Rz[xz][e] F[a][c][e][d].
  for (int i = tid; i < a.gm * a.gn * Z * 3; i += THREADS) {
    const int d = i % 3, xz = (i / 3) % Z, ac = i / (3 * Z);
    const float* fe = f + (size_t)ac * a.gz * 3 + d;
    float h = 0.f;
    for (int e = 0; e < a.gz; ++e) h = fmaf(rz[xz * a.gz + e], fe[e * 3], h);
    s_h[i] = h;
  }
  __syncthreads();
  // Q[xl][c][xz][d] = sum_a Rm[m0 + xl][a] H[a][c][xz][d] (0 past row wm).
  for (int i = tid; i < TM * a.gn * Z * 3; i += THREADS) {
    const int xl = i / (a.gn * Z * 3), czd = i - xl * a.gn * Z * 3;
    float q = 0.f;
    if (xl < wm) {
      const float* r = rm + (size_t)(m0 + xl) * a.gm;
      for (int g = 0; g < a.gm; ++g)
        q = fmaf(r[g], s_h[(size_t)g * a.gn * Z * 3 + czd], q);
    }
    s_q[i] = q;
  }
  __syncthreads();

  // Pass m: the tile's rows over the halo's columns, from the source; the
  // rows' taps are loaded together.
  for (int e = tid; e < w1 * Z; e += THREADS) {
    const int jn = e / Z, xz = e - jn * Z, xn = n_lo + jn;
    const float* col = sb + (size_t)xn * Z + xz;
    float fm[TM], fr[TM], v0[TM], v1[TM];
    fields(s_q, rn, a, xn, xz, 0, fm);
#pragma unroll
    for (int xl = 0; xl < TM; ++xl) {
      int t0, t1;
      taps(fm[xl], bs[0], a.rb, (float)a.bb[0], m0 + xl, a.M, t0, t1,
           fr[xl]);
      v0[xl] = col[t0 * plane];
      v1[xl] = col[t1 * plane];
    }
#pragma unroll
    for (int xl = 0; xl < TM; ++xl)
      if (xl < wm)
        s1[((size_t)xl * w1_max + jn) * Z + xz] =
            fmaf(fr[xl], v1[xl], (1.f - fr[xl]) * v0[xl]);
  }
  __syncthreads();
  // Pass n: the tile's columns, from the halo in shared memory.
  for (int e = tid; e < wn * Z; e += THREADS) {
    const int jn = e / Z, xz = e - jn * Z, xn = n0 + jn;
    float fn[TM];
    fields(s_q, rn, a, xn, xz, 1, fn);
#pragma unroll
    for (int xl = 0; xl < TM; ++xl) {
      if (xl >= wm) continue;
      int t0, t1;
      float frac;
      taps(fn[xl], bs[1], a.rb, (float)a.bb[1], xn, a.N, t0, t1, frac);
      const float* row = s1 + (size_t)xl * w1_max * Z + xz;
      s2[((size_t)xl * tn_max + jn) * Z + xz] =
          fmaf(frac, row[(t1 - n_lo) * Z], (1.f - frac) * row[(t0 - n_lo) * Z]);
    }
  }
  __syncthreads();
  // Pass z: along each column, written to the frame once.
  for (int e = tid; e < wn * Z; e += THREADS) {
    const int jn = e / Z, xz = e - jn * Z, xn = n0 + jn;
    float fz[TM];
    fields(s_q, rn, a, xn, xz, 2, fz);
#pragma unroll
    for (int xl = 0; xl < TM; ++xl) {
      if (xl >= wm) continue;
      int t0, t1;
      float frac;
      taps(fz[xl], bs[2], a.rb, (float)a.bb[2], xz, Z, t0, t1, frac);
      const float* col = s2 + ((size_t)xl * tn_max + jn) * Z;
      db[(size_t)(m0 + xl) * plane + (size_t)xn * Z + xz] =
          fmaf(frac, col[t1], (1.f - frac) * col[t0]);
    }
  }
}

}  // namespace

// frames, out [B, M, N, Z]; grid [B, gm*gn*gz, 3] (row-major grid); rm
// [M, gm], rn [N, gn], rz [Z, gz] resize matrices; base [B, 3] rigid
// shifts; rb = max_deviation_rigid + 2; bb_* = ceil(max_shifts) + 1;
// tiles of tm (= TM) m rows x tn n columns with an n halo of halo
// columns on each side; smem_bytes: the dynamic shared memory the tile takes
// (ops/warp.py warp_tile_bytes).
extern "C" int dnmf_warp(const float* frames, float* out, const float* grid,
                         const float* rm, const float* rn, const float* rz,
                         const float* base, int nframes, int M, int N, int Z,
                         int gm, int gn, int gz, int bb_m, int bb_n, int bb_z,
                         int tm, int tn, int halo, int smem_bytes, float rb,
                         cudaStream_t stream) {
  if (tm != TM) return cudaErrorInvalidValue;
  if (nframes == 0) return cudaSuccess;
  WarpArgs a;
  a.M = M; a.N = N; a.Z = Z; a.gm = gm; a.gn = gn; a.gz = gz;
  a.tn = tn; a.halo = halo; a.rb = rb;
  a.bb[0] = bb_m; a.bb[1] = bb_n; a.bb[2] = bb_z;
  cudaError_t err = cudaFuncSetAttribute(
      warp_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 blocks((N + tn - 1) / tn, (M + TM - 1) / TM, nframes);
  warp_tile<<<blocks, THREADS, smem_bytes, stream>>>(frames, out, grid, rm, rn,
                                                      rz, base, a);
  return cudaGetLastError();
}
