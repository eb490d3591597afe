// Spatial-brick culling of warped Gaussian footprints, shared by the
// motion (motion.cu), c1 (c1.cu), Gram (gram.cu) and refine (refine.cu)
// kernels.
//
// A thread block owns a brick of pixels: bm x bn x bz voxels of the
// (m, n, z) grid, pixel index p = (m * N + n) * Z + z as in footprint.cuh.
// From the frame's warp it takes the brick's exact per-axis range of
// deformed coordinates psi (block min/max), and lists in shared memory the
// neurons whose per-axis reach box [p_d - r_d, p_d + r_d] (r_d = 6 sigma_d)
// meets that range on all three axes.  Any other neuron's footprint is
// below exp(-36) at every pixel of the brick: under float32 resolution.
// The neuron table is sorted by m (each frame's own m for per-frame
// positions; table.cu builds it on the card), so the m test is a search
// of the sorted column (window widened by the largest m reach) and only
// that window is tested on all three axes.  The list keeps table order,
// so everything summed over it repeats exactly.  The table stays in
// global memory (L1/L2-resident: 64 bytes per neuron), and a kernel gets
// the listed rows in chunks of at most its shared-memory capacity, so
// every brick kernel takes any K.
#pragma once

#include <type_traits>

#include "footprint.cuh"

namespace dnmf {

constexpr int TROW = 16;  // neuron table row: p (3), log2e / sigma^2 (3), 0,
                          // 0, reach 6 sigma (3), 0, 1 / sigma^2 (3), 0
constexpr float LOG2E_F = 1.44269504088896341f;

// Brick layout: bricks numbered ((im * nbn) + in) * nbz + iz.  A voxel
// range (Geom::p_lo, PL) is a run of m rows, so the bricks it meets are
// the consecutive ids [id0, id0 + count): a kernel walks local ids 0 ..
// count - 1, and brick_at<true> adds id0.  In the bricks that the range's
// ends cut (brick_cut), its voxels outside it are past the brick
// (slot_in_range).  The range is a template parameter (RANGE) of the
// kernels that take one (motion.cu, gram.cu), and their whole-volume
// instances run the code without it and take Geom and Bricks, without
// the range's fields, by value (GeomOf, BricksOf).
struct Bricks {
  int bm, bn, bz;     // brick extent (bm * bn * bz <= THREADS * PPT)
  int nbm, nbn, nbz;  // bricks per axis
};

struct RangedBricks : Bricks {
  int id0, count;     // the bricks that the voxel range meets
};

template <bool RANGE>
using GeomOf = std::conditional_t<RANGE, RangedGeom, Geom>;
template <bool RANGE>
using BricksOf = std::conditional_t<RANGE, RangedBricks, Bricks>;

constexpr int PPT = 8;  // pixels per thread of a brick, at most

// The frames of a launch of the motion, c1 and Gram kernels and their
// tables: frame f reads table f / fpt (fpt = 1: a table per frame, for
// per-frame positions; fpt = the launch's frames: one table, for shared
// anchors; fpt = the frames of one recording: a table per recording, for
// a recordings axis), and its video row starts at frame_video(f, ...):
// the recordings (runs of fpt frames) y_rec floats apart, their frames
// `row` floats apart, so a block of frames cut from every recording's
// video [R][T][P] is read in place.
__device__ __forceinline__ size_t frame_table(int f, int fpt) {
  return (size_t)(f / fpt);
}

__device__ __forceinline__ size_t frame_video(int f, int fpt,
                                              long long y_rec, int row) {
  return (size_t)(f / fpt) * y_rec + (size_t)(f % fpt) * row;
}

// Calls launch(std::integral_constant<int, NP>()) with the fewest pixel
// slots per thread NP, of 3, 5 and PPT, that hold a brick of n pixels:
// registers go to the slots a volume's bricks use (3 for the ROI's 8 x 8 x
// 10 bricks, 5 for the whole brain's 8 x 8 x 20).
template <class F>
cudaError_t with_slots(int n, F launch) {
  const int need = (n + THREADS - 1) / THREADS;
  if (need <= 3) return launch(std::integral_constant<int, 3>());
  if (need <= 5) return launch(std::integral_constant<int, 5>());
  return launch(std::integral_constant<int, PPT>());
}

// The brick's pixel origin and (edge-clipped) extent.
struct Brick {
  int m0, n0, z0, wm, wn, wz;
  __device__ int count() const { return wm * wn * wz; }
};

// The brick layout, and the bricks that the voxel range of g meets (all
// of them without a range).
inline RangedBricks make_bricks(const RangedGeom& g, int bm, int bn,
                                int bz) {
  RangedBricks bk;
  bk.bm = bm; bk.bn = bn; bk.bz = bz;
  bk.nbm = (g.M + bm - 1) / bm;
  bk.nbn = (g.N + bn - 1) / bn;
  bk.nbz = (g.Z + bz - 1) / bz;
  const int row = g.N * g.Z;
  const int im_lo = g.p_lo / row / bm;
  const int im_hi = (g.p_lo + g.PL - 1) / row / bm;
  bk.id0 = im_lo * bk.nbn * bk.nbz;
  bk.count = (im_hi - im_lo + 1) * bk.nbn * bk.nbz;
  return bk;
}

// Whether a voxel range fits the volume (and is not empty).
inline bool range_ok(const RangedGeom& g) {
  return g.p_lo >= 0 && g.PL >= 1 && g.p_lo <= g.P - g.PL;
}

// Local brick id (0 .. bk.count - 1) to its brick.
template <bool RANGE = false, class BK>
__device__ __forceinline__ Brick brick_at(int id, const BK& bk,
                                          const Geom& g) {
  if constexpr (RANGE) id += bk.id0;
  const int iz = id % bk.nbz, rest = id / bk.nbz;
  const int in = rest % bk.nbn, im = rest / bk.nbn;
  Brick b;
  b.m0 = im * bk.bm;
  b.n0 = in * bk.bn;
  b.z0 = iz * bk.bz;
  b.wm = min(bk.bm, g.M - b.m0);
  b.wn = min(bk.bn, g.N - b.n0);
  b.wz = min(bk.bz, g.Z - b.z0);
  return b;
}

// Whether the voxel range cuts brick b (some of its voxels lie outside
// it); never without a range.
template <bool RANGE, class G>
__device__ __forceinline__ bool brick_cut(const Brick& b, const G& g) {
  if constexpr (!RANGE) {
    return false;
  } else {
    // p grows with m, n and z: the brick's first and last voxels bound it.
    const int p_first = (b.m0 * g.N + b.n0) * g.Z + b.z0;
    const int p_last =
        ((b.m0 + b.wm - 1) * g.N + b.n0 + b.wn - 1) * g.Z + b.z0 + b.wz - 1;
    return p_first < g.p_lo || p_last >= g.p_lo + g.PL;
  }
}

// The first voxel of y's rows and their count: the range's, or 0 and P.
template <bool RANGE, class G>
__device__ __forceinline__ int range_lo(const G& g) {
  if constexpr (RANGE) return g.p_lo; else return 0;
}

template <bool RANGE, class G>
__device__ __forceinline__ int range_voxels(const G& g) {
  if constexpr (RANGE) return g.PL; else return g.P;
}

// Whether every slot of the per-block slot table is a voxel of brick b: a
// brick of full size that the range does not cut.
__device__ __forceinline__ bool brick_full(const Brick& b, const Bricks& bk,
                                           bool cut) {
  return !cut && b.wm == bk.bm && b.wn == bk.bn && b.wz == bk.bz;
}

// Per-warp min (red[w * 6 + d]) and max (red[w * 6 + 3 + d]) of the
// threads' psi ranges, then a barrier; list_candidates finishes the box.
// red: shared scratch of NWARPS * 6 floats.
__device__ __forceinline__ void box_partials(const float lo[3],
                                             const float hi[3], float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float a = warp_min(lo[d]), b = warp_max(hi[d]);
    if (lane == 0) {
      red[wid * 6 + d] = a;
      red[wid * 6 + 3 + d] = b;
    }
  }
  __syncthreads();
}

// Entry j of the brick's psi box from the warps' partials: the min over
// warps for j < 3, the max for j >= 3.
__device__ __forceinline__ float box_entry(const float* red, int j) {
  float v = red[j];
  for (int w = 1; w < NWARPS; ++w)
    v = j < 3 ? fminf(v, red[w * 6 + j]) : fmaxf(v, red[w * 6 + j]);
  return v;
}

// First index i in [0, k) with table[i * stride] >= v (strict: > v), k if
// none, by a whole warp: 32 probes per round narrow the range 32-fold.
template <bool STRICT>
__device__ __forceinline__ int warp_bound(const float* table, int stride,
                                          int k, float v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = k;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + lane * step;
    const float t = idx < hi ? table[(size_t)idx * stride] : 0.0f;
    const bool before = idx < hi && (STRICT ? t <= v : t < v);
    const int n = __popc(__ballot_sync(FULL, before));
    hi = min(hi, lo + n * step);
    lo = n == 0 ? lo : lo + (n - 1) * step + 1;
  }
  const int idx = lo + lane;
  const float t = idx < hi ? table[(size_t)idx * stride] : 0.0f;
  const bool before = idx < hi && (STRICT ? t <= v : t < v);
  return lo + __popc(__ballot_sync(FULL, before));
}

// Does the reach box of a neuron at p with per-axis reach r meet the
// psi box (lo = box[0..2], hi = box[3..5]) on all three axes?
__device__ __forceinline__ bool box_meets(const float p[3], const float r[3],
                                          const float* box) {
  bool ok = true;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    ok = ok && (p[d] + r[d] >= box[d]) && (p[d] - r[d] <= box[3 + d]);
  return ok;
}

// Order-keeping block compaction: each thread offers one item (keep);
// returns its slot (base + rank among the kept, in thread order) or -1,
// and the count kept by the whole block in *total.  warp_n: shared
// scratch of NWARPS ints.  Contains two __syncthreads.
__device__ __forceinline__ int block_compact(bool keep, int base, int* warp_n,
                                             int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(FULL, keep);
  if (lane == 0) warp_n[wid] = __popc(mask);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < NWARPS; ++w) {
    const int c = warp_n[w];
    if (w < wid) before += c;
    all += c;
  }
  __syncthreads();  // warp_n is reused by the next call
  *total = all;
  if (!keep) return -1;
  return base + before + __popc(mask & ((1u << lane) - 1u));
}

constexpr int COORDS = 64;  // brick coordinate table: bm + bn + bz values

// Each thread's NP pixel slots in a full brick (pixel l = threadIdx.x +
// i * THREADS, z fastest): s_off[l] = (dm << 16) | (dn << 8) | dz, -1
// past the brick.  A thread writes and reads only its own slots: no
// barrier.
template <int NP = PPT>
__device__ __forceinline__ void brick_slots(const Bricks& bk, int* s_off) {
  const int n = bk.bm * bk.bn * bk.bz;
  for (int l = threadIdx.x; l < NP * THREADS; l += THREADS) {
    const int rest = l / bk.bz;
    s_off[l] = l < n ? ((rest / bk.bn) << 16) | ((rest % bk.bn) << 8) |
                           (l % bk.bz)
                     : -1;
  }
}

// The brick-local voxel (dm, dn, dz) of this thread's slot i; false past
// the brick.  A full brick (brick_full) reads the slot table; a brick
// clipped at the volume's far faces or cut by a voxel range numbers its
// own pixels, z fastest.
__device__ __forceinline__ bool slot_voxel(const Brick& br, bool full,
                                           const int* s_off, int i, int& dm,
                                           int& dn, int& dz) {
  const int l = threadIdx.x + i * THREADS;
  if (full) {
    const int code = s_off[l];
    dm = code >> 16;
    dn = (code >> 8) & 0xff;
    dz = code & 0xff;
    return code >= 0;
  }
  const int rest = l / br.wz;
  dz = l % br.wz;
  dn = rest % br.wn;
  dm = rest / br.wn;
  return l < br.count();
}

// slot_voxel, and false outside the voxel range of a brick it cuts.
__device__ __forceinline__ bool slot_in_range(const Brick& br, bool full,
                                              bool cut, const int* s_off,
                                              int i, int& dm, int& dn,
                                              int& dz, const RangedGeom& g) {
  if (!slot_voxel(br, full, s_off, i, dm, dn, dz)) return false;
  if (!cut) return true;
  const int p = ((br.m0 + dm) * g.N + br.n0 + dn) * g.Z + br.z0 + dz;
  return p >= g.p_lo && p < g.p_lo + g.PL;
}

// slot_in_range with RANGE, else slot_voxel.
template <bool RANGE, class G>
__device__ __forceinline__ bool slot_at(const Brick& br, bool full, bool cut,
                                        const int* s_off, int i, int& dm,
                                        int& dn, int& dz, const G& g) {
  if constexpr (RANGE)
    return slot_in_range(br, full, cut, s_off, i, dm, dn, dz, g);
  else
    return slot_voxel(br, full, s_off, i, dm, dn, dz);
}

// The basis at a brick-local voxel from the brick's coordinate table.
__device__ __forceinline__ void slot_basis(const float* coord,
                                           const Bricks& bk, int dm, int dn,
                                           int dz, float phi[10]) {
  basis_xyz(coord[dm], coord[bk.bm + dn], coord[bk.bm + bk.bn + dz], phi);
}

// The warp of this thread's pixels of brick br, their video values yv
// with LOAD_Y (0 outside the brick or the voxel range; yb holds the
// frame's PL voxels from p_lo; the loads are issued here, to arrive
// while the candidates are listed), and the per-warp partials of the
// brick's psi box in red (box_partials).  The brick's
// basis coordinates (basis_coord of its m, n and z values: the bits
// basis_xyz takes) go to coord first, so each pixel multiplies instead of
// dividing.  Slots past the brick get psi = 0.  red: shared scratch of
// NWARPS * 6 floats; coord: COORDS shared floats that no thread reads
// until the next barrier (alternate two tables between bricks).
template <bool LOAD_Y, int NP = PPT, bool RANGE = false, class G>
__device__ __forceinline__ void brick_pixels(const Brick& br,
                                             const Bricks& bk, const G& g,
                                             const int* s_off, float* coord,
                                             const float* beta,
                                             const float* __restrict__ yb,
                                             float psi[NP][3], float yv[NP],
                                             float* red) {
  const int t = threadIdx.x;
  if (t < bk.bm + bk.bn + bk.bz) {
    const int d = t < bk.bm ? 0 : (t < bk.bm + bk.bn ? 1 : 2);
    const int v = d == 0 ? br.m0 + t
                         : (d == 1 ? br.n0 + t - bk.bm
                                   : br.z0 + t - bk.bm - bk.bn);
    coord[t] = basis_coord(v, d, g);
  }
  __syncthreads();
  const bool cut = brick_cut<RANGE>(br, g);
  const bool full = brick_full(br, bk, cut);
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    psi[i][0] = psi[i][1] = psi[i][2] = 0.0f;
    yv[i] = 0.0f;
    int dm, dn, dz;
    if (slot_at<RANGE>(br, full, cut, s_off, i, dm, dn, dz, g)) {
      float phi[10];
      if (LOAD_Y)
        yv[i] = yb[((br.m0 + dm) * g.N + br.n0 + dn) * g.Z + br.z0 + dz -
                   range_lo<RANGE>(g)];
      slot_basis(coord, bk, dm, dn, dz, phi);
      warp_psi(beta, phi, g, psi[i]);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[d] = fminf(lo[d], psi[i][d]);
        hi[d] = fmaxf(hi[d], psi[i][d]);
      }
    }
  }
  box_partials(lo, hi, red);
}

// The brick's psi box and its m window of an m-sorted table (k rows; its
// m column at pm, every pm_stride floats, in global or shared memory; rm
// its largest m reach, from table.cu): the box comes from the warps'
// partials in red (brick_pixels) into box (6 shared floats), then warps 0
// and 1 bound the rows [s_range[0], s_range[1]) whose m reach can meet it
// by warp searches.  Ends with a barrier.  s_range: 2 shared ints.
__device__ __forceinline__ void candidate_window(const float* pm,
                                                 int pm_stride, int k,
                                                 float rm, const float* red,
                                                 float* box, int* s_range) {
  const int tid = threadIdx.x, wid = tid >> 5;
  if (tid < 6) box[tid] = box_entry(red, tid);
  if (wid < 2) {
    const float v = wid == 0 ? box_entry(red, 0) - rm : box_entry(red, 3) + rm;
    const int i = wid == 0 ? warp_bound<false>(pm, pm_stride, k, v)
                           : warp_bound<true>(pm, pm_stride, k, v);
    if ((tid & 31) == 0) s_range[wid] = i;
  }
  __syncthreads();
}

// One chunk of a listing: the rows from c0 up to i1 of table tab (rows of
// TROW floats) whose reach box meets the psi box, tested THREADS rows a
// round (every thread on all three axes) and kept in table order: each
// kept row's index goes to s_cand[slot] and emit(slot, index, row) copies
// what the kernel needs of it into the kernel's own slots, slots [0, n).
// Stops before a round that could pass cap slots (cap >= THREADS); next
// gets the first row not tested.  Returns n, in every thread.  Contains
// barriers (block_compact); s_warp_n: NWARPS shared ints.
template <class Emit>
__device__ __forceinline__ int list_chunk(const float* tab, int c0, int i1,
                                          int cap, const float* box,
                                          int* s_cand, int* s_warp_n,
                                          int& next, Emit emit) {
  const int tid = threadIdx.x;
  int nc = 0;
  for (; c0 < i1 && nc + min(THREADS, i1 - c0) <= cap; c0 += THREADS) {
    const int kk = c0 + tid;
    bool keep = false;
    if (kk < i1) {
      const float* row = tab + (size_t)kk * TROW;
      const float p[3] = {row[0], row[1], row[2]};
      const float r[3] = {row[8], row[9], row[10]};
      keep = box_meets(p, r, box);
    }
    int total;
    const int slot = block_compact(keep, nc, s_warp_n, &total);
    if (slot >= 0) {
      s_cand[slot] = kk;
      emit(slot, kk, tab + (size_t)kk * TROW);
    }
    nc += total;
  }
  next = min(c0, i1);
  return nc;
}

// The candidates of a brick (candidate_window, then list_chunk's rounds),
// handed over in chunks of at most cap rows: after a barrier, body(n, first,
// last) uses slots [0, n), then a barrier frees them; the last chunk,
// perhaps with n = 0, is always handed over.  Returns the count, in every
// thread.
template <class Emit, class Body>
__device__ __forceinline__ int list_candidates(const float* tab,
                                               const float* pm, int pm_stride,
                                               int k, float rm, int cap,
                                               const float* red, float* box,
                                               int* s_cand, int* s_warp_n,
                                               int* s_range, Emit emit,
                                               Body body) {
  candidate_window(pm, pm_stride, k, rm, red, box, s_range);
  const int tid = threadIdx.x;
  const int i0 = s_range[0], i1 = s_range[1];
  int nc = 0, done = 0;
  // list_chunk's rounds, written out so that A's and B's loops stay as
  // they were tuned; one call site of body, so that it is inlined once.
  for (int c0 = i0;; c0 += THREADS) {
    if (c0 < i1) {
      const int kk = c0 + tid;
      bool keep = false;
      if (kk < i1) {
        const float* row = tab + (size_t)kk * TROW;
        const float p[3] = {row[0], row[1], row[2]};
        const float r[3] = {row[8], row[9], row[10]};
        keep = box_meets(p, r, box);
      }
      int total;
      const int slot = block_compact(keep, nc, s_warp_n, &total);
      if (slot >= 0) {
        s_cand[slot] = kk;
        emit(slot, kk, tab + (size_t)kk * TROW);
      }
      nc += total;
    }
    // Hand the chunk over at the end, or if the next round of rows could
    // overflow it.
    const int next = i1 - c0 - THREADS;
    const bool last = next <= 0;
    if (last || nc + min(THREADS, next) > cap) {
      __syncthreads();
      body(nc, done == 0, last);
      __syncthreads();
      done += nc;
      nc = 0;
      if (last) return done;
    }
  }
}

}  // namespace dnmf
