// Kernel F: integer-shift phase correlation of a frame block's patches.
//
// Replaces dnmf_tpu/ops/pallas_phasecorr.py:176 phase_corr_block (body
// _phasecorr_kernel :56): per (frame, patch), the 3-D DFT of the real
// patch, the cross-power product S * conj(T) with the template patch
// spectrum (an output: the subpixel refinement reads it), the inverse
// transform, the shift-window mask over signed wrapped indices and the
// first-occurrence argmax.  Layout at the boundary is the JAX one:
// patches [B, NP, z*m, n] (row = z_index * m + m_index), spectra in the
// same layout with the standard frequency index on every axis.
//
// What bounds it on this card: the forward transform is ~0.7 GFLOP per
// 160x160x10 patch as dense DFT products (~22 GFLOP per whole-brain
// frame of 32 patches), so it is bound by fp32 FMA throughput and by
// shared-memory reads of the tiles (2 loads per 4 FMAs).  The design:
//
// * one generic kernel, dft_axis, contracts one axis of a batch of
//   complex (or real) arrays against the twiddles exp(sign 2 pi i k x / L)
//   as a shared-memory-tiled complex product (32 outputs x 32 columns per
//   block, 2 x 2 per thread, fp32 FMA in a fixed order, no TF32).
//   Twiddles are evaluated in the block as sincospif(2 ((k x) mod L) / L)
//   with the index reduced in integers: no L x L table has to fit shared
//   memory (264 x 264 complex would be 557 KB).
// * F1 is three dft_axis launches (n, m, z); the z pass multiplies by the
//   conjugated template spectrum in its epilogue and writes prod_re/im.
// * F2 does not invert the whole spectrum: the window keeps at most
//   ub - lb shifts per axis (<= 2 max_deviation_rigid), so dft_axis runs
//   the inverse restricted to the window's lattice points (n, then m,
//   then z: the same sums at the same points, ~1% of a full inverse),
//   and window_argmax takes the magnitude and the argmax, one block per
//   (frame, patch).  Each block derives its frame's candidates from the
//   bounds row (shift_window), so nothing goes through the host.
// Candidates are listed per axis in ascending wrapped index, so the
// flattened (z, m, n) candidate order is the JAX kernel's first-occurrence
// order.  An empty window gives shift 0, as the masked -1 surface does.
//
// Plain C interface (ctypes); no atomics, so results repeat exactly.

#include <cuda_runtime.h>

namespace {

constexpr int TK = 32;       // output positions per tile
constexpr int TC = 32;       // columns per tile
constexpr int TX = 32;       // contraction chunk
constexpr int THREADS = 256;

// Axis d's shift window for one frame (bounds row: lb m, n, z, ub m, n,
// z, 0, 0): the signed shifts s in [lb, ub - 1] that length L has
// (s in [L/2 - L + 1, L/2]), in ascending wrapped index, the JAX kernel's
// first-occurrence order: s >= 0 ascending, then s < 0 ascending.  At
// most cap are kept (the caller's window size, which bounds ub - lb).
struct Window {
  int lo, count, npos;  // lowest shift, candidates, non-negative ones
  __device__ int shift(int k) const {
    return k < npos ? max(lo, 0) + k : lo + (k - npos);
  }
};

__device__ Window shift_window(const float* bnd, int d, int L, int cap) {
  const float lim = static_cast<float>(L);
  const int lo = max(static_cast<int>(ceilf(fminf(fmaxf(bnd[d], -lim), lim))),
                     L / 2 - L + 1);
  const int hi = min(
      static_cast<int>(floorf(fminf(fmaxf(bnd[3 + d] - 1.f, -lim), lim))),
      L / 2);
  Window w;
  w.lo = lo;
  w.count = min(max(hi - lo + 1, 0), cap);
  w.npos = max(hi - max(lo, 0) + 1, 0);
  return w;
}

struct Axis {
  const float* in_re;
  const float* in_im;        // null: real input
  float* out_re;
  float* out_im;
  const float* t_re;         // non-null: multiply by conj(T) (epilogue)
  const float* t_im;
  const float* bounds;       // non-null: output k evaluates the k-th shift
                             // of axis win_axis's window of frame b / pos_div
  long long in_sb, in_sx, in_sc;
  long long out_sb, out_sk, out_sc;
  long long t_sb;
  int t_mod;                 // template batch index = b % t_mod
  int win_axis, pos_div;
  int L, K, C;
  long long nb;
  float sign;                // -1 forward, +1 inverse
};

// out[b, k, c] = sum_{x < L} exp(sign 2 pi i x pos_k / L) in[b, x, c],
// pos_k = k, or the wrapped index of the window's k-th shift
__global__ void __launch_bounds__(THREADS) dft_axis(Axis p) {
  __shared__ float xre[TX][TC + 1], xim[TX][TC + 1];
  __shared__ float wre[TK][TX + 1], wim[TK][TX + 1];
  __shared__ int kpos[TK];

  const int nct = (p.C + TC - 1) / TC;
  const int nkt = (p.K + TK - 1) / TK;
  long long blk = blockIdx.x;
  const int ct = static_cast<int>(blk % nct);
  blk /= nct;
  const int kt = static_cast<int>(blk % nkt);
  const long long b = blk / nkt;
  const int c0 = ct * TC, k0 = kt * TK;
  // Threads run along the output's contiguous axis, so stores coalesce.
  const bool kfast = p.out_sk == 1;
  const int lo = threadIdx.x & 15, hi = threadIdx.x >> 4;
  const int tk = kfast ? lo : hi, tc = kfast ? hi : lo;

  if (threadIdx.x < TK) {
    const int k = k0 + threadIdx.x;
    int v = 0;
    if (k < p.K && !p.bounds) {
      v = k;
    } else if (k < p.K) {
      const Window w =
          shift_window(p.bounds + (b / p.pos_div) * 8, p.win_axis, p.L, p.K);
      const int sh = w.shift(k);
      v = k < w.count ? (sh < 0 ? sh + p.L : sh) : 0;
    }
    kpos[threadIdx.x] = v;
  }
  const float* in_re = p.in_re + b * p.in_sb;
  const float* in_im = p.in_im ? p.in_im + b * p.in_sb : nullptr;
  const bool xfast = p.in_sx == 1;

  float are[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float aim[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int x0 = 0; x0 < p.L; x0 += TX) {
    __syncthreads();  // kpos written; previous chunk consumed
    for (int e = threadIdx.x; e < TX * TC; e += THREADS) {
      const int xi = xfast ? e % TX : e / TC;
      const int ci = xfast ? e / TX : e % TC;
      const int x = x0 + xi, c = c0 + ci;
      float vr = 0.f, vi = 0.f;
      if (x < p.L && c < p.C) {
        const long long off = x * p.in_sx + c * p.in_sc;
        vr = in_re[off];
        if (in_im) vi = in_im[off];
      }
      xre[xi][ci] = vr;
      xim[xi][ci] = vi;
    }
    for (int e = threadIdx.x; e < TK * TX; e += THREADS) {
      const int ki = e / TX, xi = e % TX;
      const long long r =
          (static_cast<long long>(x0 + xi) * kpos[ki]) % p.L;
      float s, c;
      sincospif(2.0f * static_cast<float>(r) / static_cast<float>(p.L), &s,
                &c);
      wre[ki][xi] = c;
      wim[ki][xi] = p.sign * s;
    }
    __syncthreads();
    const int xn = min(TX, p.L - x0);
    for (int xi = 0; xi < xn; ++xi) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float wr = wre[tk + 16 * i][xi], wi = wim[tk + 16 * i][xi];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float vr = xre[xi][tc + 16 * j], vi = xim[xi][tc + 16 * j];
          are[i][j] = fmaf(wr, vr, are[i][j]);
          are[i][j] = fmaf(-wi, vi, are[i][j]);
          aim[i][j] = fmaf(wr, vi, aim[i][j]);
          aim[i][j] = fmaf(wi, vr, aim[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + tk + 16 * i;
    if (k >= p.K) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + tc + 16 * j;
      if (c >= p.C) continue;
      float re = are[i][j], im = aim[i][j];
      const long long off = k * p.out_sk + c * p.out_sc;
      if (p.t_re) {
        // q = S * conj(T)
        const long long toff = (b % p.t_mod) * p.t_sb + off;
        const float tr = p.t_re[toff], ti = p.t_im[toff];
        const float qr = fmaf(re, tr, im * ti);
        const float qi = fmaf(im, tr, -(re * ti));
        re = qr;
        im = qi;
      }
      p.out_re[b * p.out_sb + off] = re;
      p.out_im[b * p.out_sb + off] = im;
    }
  }
}

// One block per (frame, patch): magnitude of the windowed correlation
// cc [bp, wz, wm * wn] and the first-occurrence argmax over the frame's
// candidates.
__global__ void __launch_bounds__(THREADS) window_argmax(
    const float* __restrict__ cc_re, const float* __restrict__ cc_im,
    const float* __restrict__ bounds, float* __restrict__ shifts, int np,
    int z, int m, int n, int wm, int wn, int wz) {
  __shared__ float sval[THREADS];
  __shared__ int sidx[THREADS];
  const long long bp = blockIdx.x;
  const float* bnd = bounds + (bp / np) * 8;
  const Window win_m = shift_window(bnd, 0, m, wm);
  const Window win_n = shift_window(bnd, 1, n, wn);
  const Window win_z = shift_window(bnd, 2, z, wz);
  const int cm = win_m.count, cn = win_n.count, cz = win_z.count;
  const int total = cm * cn * cz;
  const float* re = cc_re + bp * wz * wm * wn;
  const float* im = cc_im + bp * wz * wm * wn;

  float best = -1.0f;
  int best_i = total;  // none
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int l = e / (cm * cn), i = (e / cn) % cm, j = e % cn;
    const long long off = (static_cast<long long>(l) * wm + i) * wn + j;
    const float a = re[off], bimag = im[off];
    const float mag = sqrtf(fmaf(a, a, bimag * bimag));
    if (mag > best) {  // ascending e per thread: keeps the first maximum
      best = mag;
      best_i = e;
    }
  }
  sval[threadIdx.x] = best;
  sidx[threadIdx.x] = best_i;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      const float v = sval[threadIdx.x + half];
      const int vi = sidx[threadIdx.x + half];
      if (v > sval[threadIdx.x] ||
          (v == sval[threadIdx.x] && vi < sidx[threadIdx.x])) {
        sval[threadIdx.x] = v;
        sidx[threadIdx.x] = vi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float sm = 0.f, sn = 0.f, sz = 0.f;
    const int e = sidx[0];
    if (e < total) {
      const int l = e / (cm * cn), i = (e / cn) % cm, j = e % cn;
      sm = static_cast<float>(win_m.shift(i));
      sn = static_cast<float>(win_n.shift(j));
      sz = static_cast<float>(win_z.shift(l));
    }
    shifts[bp * 3 + 0] = sm;
    shifts[bp * 3 + 1] = sn;
    shifts[bp * 3 + 2] = sz;
  }
}

cudaError_t launch(const Axis& p, cudaStream_t stream) {
  const long long blocks = static_cast<long long>((p.C + TC - 1) / TC) *
                           ((p.K + TK - 1) / TK) * p.nb;
  dft_axis<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

Axis axis(const float* in_re, const float* in_im, float* out_re,
          float* out_im, long long nb, int L, int K, int C, long long in_sb,
          long long in_sx, long long in_sc, long long out_sb,
          long long out_sk, long long out_sc, float sign) {
  Axis p{};
  p.in_re = in_re;
  p.in_im = in_im;
  p.out_re = out_re;
  p.out_im = out_im;
  p.in_sb = in_sb;
  p.in_sx = in_sx;
  p.in_sc = in_sc;
  p.out_sb = out_sb;
  p.out_sk = out_sk;
  p.out_sc = out_sc;
  p.t_mod = 1;
  p.pos_div = 1;
  p.L = L;
  p.K = K;
  p.C = C;
  p.nb = nb;
  p.sign = sign;
  return p;
}

}  // namespace

// patches [B, NP, z*m, n]; tmpl_re/im [NP, z*m, n]; bounds [B, 8]; wm,
// wn, wz >= 1 bound the windows' candidate counts.  Outputs prod_re/im
// [B, NP, z*m, n] and shifts [B, NP, 3]; scratch buf_re/im as prod,
// r1 [B*NP, z*m, wn], r2 [B*NP*z, wm, wn], cc [B*NP, wz, wm*wn].
extern "C" int dnmf_phasecorr(
    const float* patches, const float* tmpl_re, const float* tmpl_im,
    const float* bounds, float* prod_re, float* prod_im,
    float* buf_re, float* buf_im, float* r1_re, float* r1_im, float* r2_re,
    float* r2_im, float* cc_re, float* cc_im, float* shifts, int nframes,
    int np, int z, int m, int n, int wm, int wn, int wz,
    cudaStream_t stream) {
  const long long bp = static_cast<long long>(nframes) * np;
  const long long vol = static_cast<long long>(z) * m * n;
  const long long mn = static_cast<long long>(m) * n;
  cudaError_t err;

  // F1: forward n pass (real input) into prod, m pass into buf, z pass
  // with the conj(T) product back into prod.
  Axis p = axis(patches, nullptr, prod_re, prod_im, bp, n, n, z * m, vol, 1,
                n, vol, 1, n, -1.f);
  if ((err = launch(p, stream)) != cudaSuccess) return err;
  p = axis(prod_re, prod_im, buf_re, buf_im, bp * z, m, m, n, mn, n, 1, mn,
           n, 1, -1.f);
  if ((err = launch(p, stream)) != cudaSuccess) return err;
  p = axis(buf_re, buf_im, prod_re, prod_im, bp, z, z, static_cast<int>(mn),
           vol, mn, 1, vol, mn, 1, -1.f);
  p.t_re = tmpl_re;
  p.t_im = tmpl_im;
  p.t_sb = vol;
  p.t_mod = np;
  if ((err = launch(p, stream)) != cudaSuccess) return err;

  // F2: the inverse at the window's lattice points only (n, m, z), then
  // the magnitude and the argmax.
  p = axis(prod_re, prod_im, r1_re, r1_im, bp, n, wn, z * m, vol, 1, n,
           static_cast<long long>(z) * m * wn, 1, wn, 1.f);
  p.bounds = bounds;
  p.win_axis = 1;
  p.pos_div = np;
  if ((err = launch(p, stream)) != cudaSuccess) return err;
  const long long mw = static_cast<long long>(m) * wn;
  const long long ww = static_cast<long long>(wm) * wn;
  p = axis(r1_re, r1_im, r2_re, r2_im, bp * z, m, wm, wn, mw, wn, 1, ww, wn,
           1, 1.f);
  p.bounds = bounds;
  p.win_axis = 0;
  p.pos_div = np * z;
  if ((err = launch(p, stream)) != cudaSuccess) return err;
  p = axis(r2_re, r2_im, cc_re, cc_im, bp, z, wz, static_cast<int>(ww),
           z * ww, ww, 1, wz * ww, ww, 1, 1.f);
  p.bounds = bounds;
  p.win_axis = 2;
  p.pos_div = np;
  if ((err = launch(p, stream)) != cudaSuccess) return err;
  window_argmax<<<static_cast<unsigned>(bp), THREADS, 0, stream>>>(
      cc_re, cc_im, bounds, shifts, np, z, m, n, wm, wn, wz);
  return cudaGetLastError();
}
