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
// What bounds it on this card: bytes.  The least traffic is the patches
// read once and prod written once; an FFT's ~5 L log2 L operations per
// line are ~100x under the fp32 peak at these sizes.  The design moves
// the complex volume through device memory three times and keeps every
// transform in shared memory:
//
// * forward transforms are mixed-radix Stockham FFTs over lines held in
//   shared memory (fft_lines): a host plan (ops/phasecorr.py fft_plan)
//   factors each length into radices 8, 4, 2, 11, 5, 3 (specialised
//   butterflies) and any other prime (one generic radix-p butterfly);
//   twiddles come from one float32 table of L entries per length, made in
//   float64 and cached on the device by the wrapper.  fp32 throughout.
// * launch 1 (fft_rows): a few whole rows per block, real input, two rows
//   per complex transform along n, complex rows into prod (as scratch);
// * launch 2 (fft_cols): an m x (up to 16) column tile per block, the m
//   transform, in place in prod;
// * launch 3 (fft_z_product): all z x a run of n columns at one m per
//   block: the z transform, S * conj(T) written to prod, then the inverse
//   along n at the shift window's lattice points only (at most the
//   caller's cap, 2 max_deviation_rigid), so prod is never read back;
// * launch 4 (window_argmax): one block per (frame, patch): the windowed
//   inverse along m and z, the magnitude and the first-occurrence argmax.
// Candidates are listed per axis in ascending wrapped index, so the
// flattened (z, m, n) candidate order is the JAX kernel's first-occurrence
// order.  An empty window gives shift 0, as the masked -1 surface does.
//
// Plain C interface (ctypes); no atomics, so results repeat exactly.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_STAGES = 20;  // ops/phasecorr.py MAX_STAGES
constexpr unsigned FULL = 0xffffffffu;

// One length's FFT plan: its radices in stage order.
struct Plan {
  int L, nst;
  int radix[MAX_STAGES];
};

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
  __device__ int wrapped(int k, int L) const {
    const int s = shift(k);
    return s < 0 ? s + L : s;
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

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -(a.y * b.y)), fmaf(a.x, b.y, a.y * b.x));
}

// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -(a.x * b.y)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// ------------------------------------------------------------ butterflies
// In-register DFT of R points, X[q] = sum_r v[r] exp(-2 pi i r q / R);
// w[k lr] = exp(-2 pi i k / R) (odd R only: the length's table in shared
// memory, read where used so that no register holds it).
template <int R>
struct Butterfly;

template <>
struct Butterfly<2> {
  __device__ static void run(float2 (&v)[2], const float2*, int) {
    const float2 t = csub(v[0], v[1]);
    v[0] = cadd(v[0], v[1]);
    v[1] = t;
  }
};

__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2,
                                     float2& v3) {
  const float2 a = cadd(v0, v2), b = csub(v0, v2);
  const float2 c = cadd(v1, v3), d = csub(v1, v3);
  v0 = cadd(a, c);
  v2 = csub(a, c);
  v1 = make_float2(b.x + d.y, b.y - d.x);  // b - i d
  v3 = make_float2(b.x - d.y, b.y + d.x);  // b + i d
}

template <>
struct Butterfly<4> {
  __device__ static void run(float2 (&v)[4], const float2*, int) {
    dft4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Butterfly<8> {
  __device__ static void run(float2 (&v)[8], const float2*, int) {
    constexpr float H = 0.70710678118654752f;
    dft4(v[0], v[2], v[4], v[6]);  // even points: E[q] in v[2q]
    dft4(v[1], v[3], v[5], v[7]);  // odd points: O[q] in v[2q + 1]
    // O[q] *= exp(-2 pi i q / 8)
    float2 o1 = v[3], o2 = v[5], o3 = v[7];
    o1 = make_float2(H * (o1.x + o1.y), H * (o1.y - o1.x));
    o2 = make_float2(o2.y, -o2.x);
    o3 = make_float2(H * (o3.y - o3.x), -H * (o3.x + o3.y));
    const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1);
    v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2);
    v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3);
    v[7] = csub(e3, o3);
  }
};

// Odd R: pair r with R - r, X[q] = v0 + sum_r cos (v_r + v_{R-r})
// - i sin (v_r - v_{R-r}), angles 2 pi r q / R read from w.
template <int R>
struct ButterflyOdd {
  __device__ static void run(float2 (&v)[R], const float2* w, int lr) {
    constexpr int H = (R - 1) / 2;
    float2 s[H], d[H];
    float2 x0 = v[0];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      s[r - 1] = cadd(v[r], v[R - r]);
      d[r - 1] = csub(v[r], v[R - r]);
      x0 = cadd(x0, s[r - 1]);
    }
    const float2 v0 = v[0];
    v[0] = x0;
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      float2 a = v0, b = v0;
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const float2 t = w[((r * q) % R) * lr];  // (cos, -sin)
        const float cr = t.x * s[r - 1].x, ci = t.x * s[r - 1].y;
        const float sr = -t.y * d[r - 1].y, si = -t.y * d[r - 1].x;
        a = make_float2(a.x + (cr + sr), a.y + (ci - si));
        b = make_float2(b.x + (cr - sr), b.y + (ci + si));
      }
      v[q] = a;
      v[R - q] = b;
    }
  }
};

template <>
struct Butterfly<3> : ButterflyOdd<3> {};
template <>
struct Butterfly<5> : ButterflyOdd<5> {};
template <>
struct Butterfly<11> : ButterflyOdd<11> {};

// ------------------------------------------------------- Stockham stages
// Element x of line l lives at buf[l * ls + x * xs].  Threads run along
// the lines (line_fast) or along the butterflies of one line.
struct Lines {
  int count, ls, xs;
  bool line_fast;
};

// One radix-R stage of a length-L transform after stages of product ns:
// butterfly j (k = j mod ns) reads x = j + r L/R, multiplies by the
// twiddle exp(-2 pi i r k / (ns R)) = tw[r k L / (ns R)], transforms, and
// writes x = (j - k) R + k + q ns (Stockham: natural order at the end).
template <int R>
__device__ void stage(const float2* __restrict__ src, float2* __restrict__ dst,
                      const Lines& ln, int L, int ns,
                      const float2* __restrict__ tw) {
  const int lr = L / R, stride = L / (ns * R);
  const int total = ln.count * lr;
  for (int t = threadIdx.x; t < total; t += THREADS) {
    const int line = ln.line_fast ? t % ln.count : t / lr;
    const int j = ln.line_fast ? t / ln.count : t % lr;
    const int k = j % ns;
    const float2* s = src + line * ln.ls;
    float2* o = dst + line * ln.ls;
    float2 v[R];
    v[0] = s[j * ln.xs];
#pragma unroll
    for (int r = 1; r < R; ++r)
      v[r] = cmul(s[(j + r * lr) * ln.xs], tw[r * k * stride]);
    Butterfly<R>::run(v, tw, lr);
    const int d = (j - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) o[(d + q * ns) * ln.xs] = v[q];
  }
}

// Any radix p (a prime the specialised butterflies do not cover): output
// q of butterfly j is sum_r src[j + r L/p] tw[(r e_q) mod L] with
// e_q = (L / (ns p)) (k + q ns): the stage twiddle and the p-point DFT in
// one exponent.
__device__ void stage_generic(const float2* __restrict__ src,
                              float2* __restrict__ dst, const Lines& ln,
                              int L, int ns, int R,
                              const float2* __restrict__ tw) {
  const int lr = L / R, stride = L / (ns * R);
  const int total = ln.count * lr * R;
  for (int t = threadIdx.x; t < total; t += THREADS) {
    const int q = t % R;
    const int u = t / R;
    const int line = ln.line_fast ? u % ln.count : u / lr;
    const int j = ln.line_fast ? u / ln.count : u % lr;
    const int k = j % ns;
    const float2* s = src + line * ln.ls;
    const int step = stride * (k + q * ns);
    float2 acc = make_float2(0.f, 0.f);
    int e = 0;
    for (int r = 0; r < R; ++r) {
      const float2 p = cmul(s[(j + r * lr) * ln.xs], tw[e]);
      acc = cadd(acc, p);
      e += step;
      if (e >= L) e -= L;
    }
    dst[line * ln.ls + ((j - k) * R + k + q * ns) * ln.xs] = acc;
  }
}

// Forward FFT of every line in a (b is the ping-pong buffer); returns the
// buffer that holds the result.  The caller syncs after filling a.
__device__ float2* fft_lines(float2* a, float2* b, const Lines& ln,
                             const Plan& pl, const float2* tw) {
  int ns = 1;
  for (int s = 0; s < pl.nst; ++s) {
    const int R = pl.radix[s];
    switch (R) {
      case 2: stage<2>(a, b, ln, pl.L, ns, tw); break;
      case 3: stage<3>(a, b, ln, pl.L, ns, tw); break;
      case 4: stage<4>(a, b, ln, pl.L, ns, tw); break;
      case 5: stage<5>(a, b, ln, pl.L, ns, tw); break;
      case 8: stage<8>(a, b, ln, pl.L, ns, tw); break;
      case 11: stage<11>(a, b, ln, pl.L, ns, tw); break;
      default: stage_generic(a, b, ln, pl.L, ns, R, tw); break;
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    ns *= R;
  }
  return a;
}

__device__ void load_twiddles(float2* dst, const float2* src, int L) {
  for (int i = threadIdx.x; i < L; i += THREADS) dst[i] = src[i];
}

// ------------------------------------------------------------- launches
// Launch 1: rb rows of length n per block (real input) -> complex rows.
// Rows 2p and 2p + 1 go through one complex FFT as its real and imaginary
// parts, Z = FFT(x + i y), and are split after it: X[k] = (Z[k] +
// conj Z[-k]) / 2, Y[k] = (Z[k] - conj Z[-k]) / 2i.
__global__ void __launch_bounds__(THREADS, 3)
fft_rows(const float* __restrict__ in, float* __restrict__ out_re,
         float* __restrict__ out_im, long long rows, int rb, Plan pn,
         const float2* __restrict__ tw_n) {
  extern __shared__ float2 sm[];
  const int n = pn.L;
  float2* tw = sm;
  float2* a = tw + n;
  float2* b = a + ((rb + 1) / 2) * n;
  const long long r0 = static_cast<long long>(blockIdx.x) * rb;
  const int nr = static_cast<int>(min(static_cast<long long>(rb), rows - r0));
  const int pairs = (nr + 1) / 2;
  load_twiddles(tw, tw_n, n);
  const float* src = in + r0 * n;
  for (int e = threadIdx.x; e < pairs * n; e += THREADS) {
    const int p = e / n, x = e - p * n;
    const float y = 2 * p + 1 < nr ? src[(2 * p + 1) * n + x] : 0.f;
    a[e] = make_float2(src[2 * p * n + x], y);
  }
  __syncthreads();
  const float2* res = fft_lines(a, b, Lines{pairs, n, 1, false}, pn, tw);
  float* ore = out_re + r0 * n;
  float* oim = out_im + r0 * n;
  for (int e = threadIdx.x; e < pairs * n; e += THREADS) {
    const int p = e / n, k = e - p * n;
    const float2 zk = res[e], zc = res[p * n + (k == 0 ? 0 : n - k)];
    const int o = 2 * p * n + k;
    ore[o] = 0.5f * (zk.x + zc.x);
    oim[o] = 0.5f * (zk.y - zc.y);
    if (2 * p + 1 < nr) {
      ore[o + n] = 0.5f * (zk.y + zc.y);
      oim[o + n] = 0.5f * (zc.x - zk.x);
    }
  }
}

// Launch 2: the m transform of an m x cc column tile of one [m, n] plane,
// in place.
__global__ void __launch_bounds__(THREADS, 3)
fft_cols(float* __restrict__ re, float* __restrict__ im, int n, int cc,
         Plan pm, const float2* __restrict__ tw_m) {
  extern __shared__ float2 sm[];
  const int m = pm.L;
  float2* tw = sm;
  float2* a = tw + m;
  float2* b = a + m * cc;
  const int nct = (n + cc - 1) / cc;
  const long long plane = blockIdx.x / nct;
  const int c0 = (blockIdx.x % nct) * cc;
  const int cw = min(cc, n - c0);
  const long long base = plane * m * n + c0;
  load_twiddles(tw, tw_m, m);
  for (int e = threadIdx.x; e < m * cw; e += THREADS) {
    const long long off = base + static_cast<long long>(e / cw) * n + e % cw;
    a[e] = make_float2(re[off], im[off]);
  }
  __syncthreads();
  const float2* res = fft_lines(a, b, Lines{cw, 1, cw, true}, pm, tw);
  for (int e = threadIdx.x; e < m * cw; e += THREADS) {
    const long long off = base + static_cast<long long>(e / cw) * n + e % cw;
    re[off] = res[e].x;
    im[off] = res[e].y;
  }
}

// Launch 3: one m index and a run of cw n columns of one (frame, patch):
// the z transform, the product with conj(T) (written to prod), and the
// inverse along n at the frame's window lattice points, summed over this
// run's columns: r1[bp][chunk][z * m][wn].
__global__ void __launch_bounds__(THREADS, 3)
fft_z_product(float* __restrict__ re, float* __restrict__ im,
              const float* __restrict__ t_re, const float* __restrict__ t_im,
              const float* __restrict__ bounds, float2* __restrict__ r1,
              int np, int m, int cw, int wn, Plan pz, Plan pn,
              const float2* __restrict__ tw_z_g,
              const float2* __restrict__ tw_n_g) {
  extern __shared__ float2 sm[];
  const int z = pz.L, n = pn.L;
  const int nch = (n + cw - 1) / cw;
  float2* tw_z = sm;
  float2* tw_n = tw_z + z;
  float2* a = tw_n + n;
  float2* b = a + z * cw;
  float2* tb = b + z * cw;  // the template spectra, loaded with the data
  long long blk = blockIdx.x;
  const int ch = static_cast<int>(blk % nch);
  blk /= nch;
  const int mi = static_cast<int>(blk % m);
  const long long bp = blk / m;
  const int c0 = ch * cw;
  const int w = min(cw, n - c0);
  const long long vol = static_cast<long long>(z) * m * n;
  const long long mn = static_cast<long long>(m) * n;
  const long long base = bp * vol + static_cast<long long>(mi) * n + c0;
  const long long tbase = (bp % np) * vol + static_cast<long long>(mi) * n + c0;
  load_twiddles(tw_z, tw_z_g, z);
  load_twiddles(tw_n, tw_n_g, n);
  for (int e = threadIdx.x; e < z * w; e += THREADS) {
    const long long rel = (e / w) * mn + e % w;
    a[e] = make_float2(re[base + rel], im[base + rel]);
    tb[e] = make_float2(t_re[tbase + rel], t_im[tbase + rel]);
  }
  __syncthreads();
  float2* res = fft_lines(a, b, Lines{w, 1, w, true}, pz, tw_z);
  for (int e = threadIdx.x; e < z * w; e += THREADS) {
    const long long rel = (e / w) * mn + e % w;
    const float2 q = cmulc(res[e], tb[e]);  // S * conj(T)
    re[base + rel] = q.x;
    im[base + rel] = q.y;
    res[e] = q;
  }
  __syncthreads();
  // The inverse along n at the window's points, z * count outputs, each
  // summed by `split` threads over every split-th column of the run (then
  // combined by shuffles in a fixed order).
  const Window win = shift_window(bounds + (bp / np) * 8, 1, n, wn);
  const int outs = z * win.count;
  int split = 1;
  while (split < 8 && outs * split * 2 <= THREADS) split *= 2;
  float2* out = r1 + ((bp * nch + ch) * z * m + mi) * wn;
  for (int o0 = 0; o0 < outs * split; o0 += THREADS) {
    const int t = o0 + threadIdx.x, o = t / split, part = t % split;
    float2 acc = make_float2(0.f, 0.f);
    if (o < outs) {
      const int zi = o / win.count, j = o % win.count;
      const int u = win.wrapped(j, n);
      // exp(+2 pi i x u / n) = conj(tw_n[x u mod n]), x = c0 + c; two
      // chains (columns c and c + split), added at the end.
      int e0 = static_cast<int>((static_cast<long long>(c0 + part) * u) % n);
      int e1 = static_cast<int>(
          (static_cast<long long>(c0 + part + split) * u) % n);
      const int step =
          static_cast<int>((static_cast<long long>(2 * split) * u) % n);
      float2 acc1 = make_float2(0.f, 0.f);
      const float2* row = res + zi * w;
      int c = part;
      for (; c + split < w; c += 2 * split) {
        acc = cadd(acc, cmulc(row[c], tw_n[e0]));
        acc1 = cadd(acc1, cmulc(row[c + split], tw_n[e1]));
        e0 += step;
        if (e0 >= n) e0 -= n;
        e1 += step;
        if (e1 >= n) e1 -= n;
      }
      if (c < w) acc = cadd(acc, cmulc(row[c], tw_n[e0]));
      acc = cadd(acc, acc1);
    }
    for (int off = 1; off < split; off <<= 1) {
      acc.x += __shfl_xor_sync(FULL, acc.x, off);
      acc.y += __shfl_xor_sync(FULL, acc.y, off);
    }
    if (o < outs && part == 0)
      out[static_cast<long long>(o / win.count) * m * wn + o % win.count] =
          acc;
  }
}

// Launch 4: one block per (frame, patch): the inverse along m of r1
// (summed over its n chunks) into r2 [z][cm][cn], then along z at each
// candidate, the magnitude and the first-occurrence argmax.
__global__ void __launch_bounds__(THREADS)
window_argmax(const float2* __restrict__ r1, float2* __restrict__ r2,
              const float* __restrict__ bounds, float* __restrict__ shifts,
              int np, int z, int m, int n, int nch, int wm, int wn, int wz,
              const float2* __restrict__ tw_m,
              const float2* __restrict__ tw_z) {
  __shared__ float sval[THREADS];
  __shared__ int sidx[THREADS];
  const long long bp = blockIdx.x;
  const float* bnd = bounds + (bp / np) * 8;
  const Window win_m = shift_window(bnd, 0, m, wm);
  const Window win_n = shift_window(bnd, 1, n, wn);
  const Window win_z = shift_window(bnd, 2, z, wz);
  const int cm = win_m.count, cn = win_n.count, cz = win_z.count;
  const long long zmw = static_cast<long long>(z) * m * wn;
  const float2* src = r1 + bp * nch * zmw;
  float2* mid = r2 + bp * z * wm * wn;

  for (int o = threadIdx.x; o < z * cm * cn; o += THREADS) {
    const int zi = o / (cm * cn), i = (o / cn) % cm, j = o % cn;
    const int u = win_m.wrapped(i, m);
    float2 acc = make_float2(0.f, 0.f);
    int e = 0;
    for (int x = 0; x < m; ++x) {
      const long long off = (static_cast<long long>(zi) * m + x) * wn + j;
      float2 v = src[off];
      for (int c = 1; c < nch; ++c) v = cadd(v, src[c * zmw + off]);
      acc = cadd(acc, cmulc(v, tw_m[e]));
      e += u;
      if (e >= m) e -= m;
    }
    mid[o] = acc;
  }
  __syncthreads();

  const int total = cz * cm * cn;
  float best = -1.0f;
  int best_i = total;  // none
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int l = e / (cm * cn), ij = e % (cm * cn);
    const int u = win_z.wrapped(l, z);
    float2 acc = make_float2(0.f, 0.f);
    int t = 0;
    for (int zi = 0; zi < z; ++zi) {
      acc = cadd(acc, cmulc(mid[zi * cm * cn + ij], tw_z[t]));
      t += u;
      if (t >= z) t -= z;
    }
    const float mag = sqrtf(fmaf(acc.x, acc.x, acc.y * acc.y));
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

Plan make_plan(const int* row) {
  Plan p{};
  p.L = row[0];
  p.nst = row[1];
  for (int s = 0; s < p.nst && s < MAX_STAGES; ++s) p.radix[s] = row[2 + s];
  return p;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// patches [B, NP, z*m, n]; tmpl_re/im [NP, z*m, n]; bounds [B, 8]; wm,
// wn, wz >= 1 bound the windows' candidate counts.  Outputs prod_re/im
// [B, NP, z*m, n] and shifts [B, NP, 3]; scratch r1 [B*NP, nch, z*m, wn]
// and r2 [B*NP, z, wm, wn] complex (float2) with nch = ceil(n / cw).
// plans: host ints, per axis (m, n, z) a row of 2 + MAX_STAGES: L, stage
// count, radices.  tw_m/n/z: device twiddle tables exp(-2 pi i x / L).
// Tiles: rb rows per block (launch 1), cc columns (launch 2), cw columns
// (launch 3).
extern "C" int dnmf_phasecorr(
    const float* patches, const float* tmpl_re, const float* tmpl_im,
    const float* bounds, float* prod_re, float* prod_im, void* r1, void* r2,
    float* shifts, const void* tw_m, const void* tw_n, const void* tw_z,
    const int* plans, int nframes, int np, int z, int m, int n, int wm,
    int wn, int wz, int rb, int cc, int cw, cudaStream_t stream) {
  const long long bp = static_cast<long long>(nframes) * np;
  const Plan pm = make_plan(plans);
  const Plan pn = make_plan(plans + 2 + MAX_STAGES);
  const Plan pz = make_plan(plans + 2 * (2 + MAX_STAGES));
  const float2* twm = static_cast<const float2*>(tw_m);
  const float2* twn = static_cast<const float2*>(tw_n);
  const float2* twz = static_cast<const float2*>(tw_z);
  float2* r1c = static_cast<float2*>(r1);
  float2* r2c = static_cast<float2*>(r2);
  const int nch = (n + cw - 1) / cw;
  cudaError_t err;

  const long long rows = bp * z * m;
  const size_t s1 =
      (n + 2 * static_cast<size_t>((rb + 1) / 2) * n) * sizeof(float2);
  if ((err = allow_smem(fft_rows, s1)) != cudaSuccess) return err;
  fft_rows<<<static_cast<unsigned>((rows + rb - 1) / rb), THREADS, s1,
             stream>>>(patches, prod_re, prod_im, rows, rb, pn, twn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s2 = (m + 2 * static_cast<size_t>(m) * cc) * sizeof(float2);
  if ((err = allow_smem(fft_cols, s2)) != cudaSuccess) return err;
  fft_cols<<<static_cast<unsigned>(bp * z * ((n + cc - 1) / cc)), THREADS,
             s2, stream>>>(prod_re, prod_im, n, cc, pm, twm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s3 =
      (z + n + 3 * static_cast<size_t>(z) * cw) * sizeof(float2);
  if ((err = allow_smem(fft_z_product, s3)) != cudaSuccess) return err;
  fft_z_product<<<static_cast<unsigned>(bp * m * nch), THREADS, s3,
                  stream>>>(prod_re, prod_im, tmpl_re, tmpl_im, bounds, r1c,
                            np, m, cw, wn, pz, pn, twz, twn);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  window_argmax<<<static_cast<unsigned>(bp), THREADS, 0, stream>>>(
      r1c, r2c, bounds, shifts, np, z, m, n, nch, wm, wn, wz, twm, twz);
  return cudaGetLastError();
}
