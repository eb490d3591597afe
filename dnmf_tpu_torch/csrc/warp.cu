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
// What bounds it on this card: memory.  A 512x512x20 frame is 21 MB and
// each pass reads and writes it once (~126 MB per frame for the three
// passes); the field costs ~40 FMAs per voxel and pass.  The design:
//
// * one launch per pass, one thread per output voxel (z fastest, so
//   neighbouring threads touch neighbouring addresses);
// * the field is evaluated in the thread from the tiny grid and the three
//   resize matrices (L1/L2 resident): no dense [3, M, N, Z] field ever
//   reaches device memory, unlike the plain version;
// * the TPU kernel's hat-weighted sum over ~14 static offsets is a
//   two-tap lerp here: the integer part of the (clipped) shift selects the
//   taps, which are clamped to the volume (edge padding).
//
// Plain C interface (ctypes); no reductions, so results repeat exactly.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) warp_pass(
    const float* __restrict__ src, float* __restrict__ dst,
    const float* __restrict__ grid, const float* __restrict__ rm,
    const float* __restrict__ rn, const float* __restrict__ rz,
    const float* __restrict__ base, int M, int N, int Z, int gm, int gn,
    int gz, int axis, float rb, float bb, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= total) return;
  const int xz = static_cast<int>(i % Z);
  long long t = i / Z;
  const int xn = static_cast<int>(t % N);
  t /= N;
  const int xm = static_cast<int>(t % M);
  const long long b = t / M;

  // s_axis(x) = sum_g Rm[xm, gm] Rn[xn, gn] Rz[xz, gz] F[g, axis]
  const float* f = grid + b * gm * gn * gz * 3;
  float field = 0.f;
  for (int a = 0; a < gm; ++a) {
    float acc_n = 0.f;
    for (int c = 0; c < gn; ++c) {
      float acc_z = 0.f;
      for (int e = 0; e < gz; ++e) {
        acc_z = fmaf(rz[xz * gz + e], f[((a * gn + c) * gz + e) * 3 + axis],
                     acc_z);
      }
      acc_n = fmaf(rn[xn * gn + c], acc_z, acc_n);
    }
    field = fmaf(rm[xm * gm + a], acc_n, field);
  }
  // Clip around the frame's rigid shift; the integer part of the base
  // moves into the tap index and the residual stays in [-rb-1, rb+1]
  // (resample.separable_warp with base).
  const float bs = base[b * 3 + axis];
  float s = fminf(fmaxf(field, bs - rb), bs + rb);
  const float b_int = fminf(fmaxf(floorf(bs), -bb), bb);
  s = fminf(fmaxf(s - b_int, -rb - 1.f), rb + 1.f);
  const float o = floorf(s);
  const float frac = s - o;

  int len, x;
  long long stride;
  if (axis == 0) {
    len = M; x = xm; stride = static_cast<long long>(N) * Z;
  } else if (axis == 1) {
    len = N; x = xn; stride = Z;
  } else {
    len = Z; x = xz; stride = 1;
  }
  const int i0 = x + static_cast<int>(b_int) + static_cast<int>(o);
  const int t0 = min(max(i0, 0), len - 1);
  const int t1 = min(max(i0 + 1, 0), len - 1);
  const float* row = src + (i - x * stride);
  dst[i] = fmaf(frac, row[t1 * stride], (1.f - frac) * row[t0 * stride]);
}

}  // namespace

// frames, out, tmp [B, M, N, Z]; grid [B, gm*gn*gz, 3] (row-major grid);
// rm [M, gm], rn [N, gn], rz [Z, gz] resize matrices; base [B, 3] rigid
// shifts; rb = max_deviation_rigid + 2; bb* = ceil(max_shifts) + 1.
extern "C" int dnmf_warp(const float* frames, float* out, float* tmp,
                         const float* grid, const float* rm, const float* rn,
                         const float* rz, const float* base, int nframes,
                         int M, int N, int Z, int gm, int gn, int gz,
                         int bb_m, int bb_n, int bb_z, float rb,
                         cudaStream_t stream) {
  const long long total = static_cast<long long>(nframes) * M * N * Z;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) /
                                                THREADS);
  const float* srcs[3] = {frames, out, tmp};
  float* dsts[3] = {out, tmp, out};
  const int bbs[3] = {bb_m, bb_n, bb_z};
  for (int axis = 0; axis < 3; ++axis) {
    warp_pass<<<blocks, THREADS, 0, stream>>>(
        srcs[axis], dsts[axis], grid, rm, rn, rz, base, M, N, Z, gm, gn, gz,
        axis, rb, static_cast<float>(bbs[axis]), total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
