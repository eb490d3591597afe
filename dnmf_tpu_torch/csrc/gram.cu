// Exact MU Gram: G[b] = sum_p (w A)(w A)^T [K][K] and c1[b] = sum_p w A y.
//
// Replaces the Pallas kernels dnmf_tpu/ops/pallas_kernels.py:330
// gram_block (_gram_kernel :291, K <= 64), dnmf_tpu/ops/pallas_culled.py:399
// gram_block_culled (_gram_kernel_culled :318 / _culled_tile_body :206,
// K > 64) and :852 gram_block_pipelined (_gram_kernel_pipe :798, the same
// math behind a TPU DMA ring).  It serves the analytic-Gram trust audit and
// gram_mode="exact".  With one neuron table per frame (per-frame positions
// pos [B,K,3]) it replaces :944 gram_block_tracked, the exact MU statistics
// of the position-refinement phase.  Over a recordings axis
// (parallel.batched_round) a table per recording, each with its own
// widths, serves every recording's frames in one launch, as the JAX
// package's vmap prepends the recordings axis to the Pallas grid.  With ROWS (entry dnmf_gram_rows) it
// replaces the streamed-row variant of gram_block_culled
// (psi_source="stream", _gram_kernel_streamed :1263): each pixel's deformed
// coordinates psi [B][P][3] (pixel space) and fade w [B][P] were computed
// outside the kernel and are read instead of evaluated from the basis.
//
// What bounds it on this card: operations.  Per pixel and frame the warp
// (basis, 30 FMAs, fade), per neuron within reach (6 sigma: a few per
// pixel) a Gaussian, and per pair of such neurons one FMA; the video is
// read once.  The earlier design culled by m alone: grid (pixel chunk,
// 32-neuron block pair, frame), tiles of 64 z-fastest pixels, so an active
// tile evaluated 64 x 32 x 2 Gaussians and 32 x 32 pair products per pixel
// although ~0.65 neurons are active per pixel at whole-brain, and it read
// the video and evaluated the warp once per block pair (K^2 / 2048 of
// them).  The design here walks the bricks of cull.cuh, as motion.cu,
// c1.cu and refine.cu do:
//  * one launch, grid (brick group, split, frame).  A thread block walks
//    its group's bricks (8 m x 8 n x up to 32 z), each pixel's warp, fade
//    and video value in registers: one warp evaluation and one video read
//    per pixel (ROWS: one read of the rows);
//  * the brick's exact psi box against each neuron's per-axis 6 sigma box,
//    on the m-sorted table of table.cu (one for shared anchors, one per
//    frame for per-frame positions, so crossing tracks are listed from
//    each frame's own positions), lists the candidates in table order,
//    GCAND shared rows at a time (list_chunk), so any K runs;
//  * the pairs of a brick's candidates, chunk I (the candidates of a block
//    of GROWS table rows) with itself and with the later candidates J.
//    Few candidates (the common case: ~2 per brick at whole-brain) go in
//    register tiles of GCH x GCH: per pixel the tile's w A values in
//    registers, the pair products (and, on a diagonal tile, c1) summed
//    over the thread's pixels, block-reduced in a fixed order and added by
//    one thread each to the group's partial.  Many (a crowded volume) go
//    in staged tiles of SC x SC: w A at THREADS pixels in shared memory, a
//    thread per pair summing over them in order, no block reduction.  Only
//    the listed candidates take part, so a brick does n (n + 1) / 2 pair
//    sums for its n candidates;
//  * splits: where a volume has few groups (the K x K partials below cap
//    them at large K), each group is walked by several thread blocks, each
//    taking the chunks I of the row blocks it owns, so no two blocks add
//    to one cell;
//  * a group's bricks are consecutive, so its candidates lie in one window
//    [lo, hi) of table rows.  Its partial is the upper triangle of a K x K
//    matrix in table order (and a K row for c1), of which it zeroes and
//    adds to only the window, zeroing each cell as the window grows over
//    it; the window goes to `windows`;
//  * gram_assemble adds, for each pair of table rows, the partials of the
//    groups whose window holds both, in group order, and writes G (both
//    triangles) and c1 at the neurons' places in the caller's order.  No
//    float atomics: results repeat exactly, and the group and split
//    counts depend on the volume and K only, so a frame's (G, c1) are the
//    same bits alone or inside a call of any length.
// A voxel range (a pixel shard: y [B][PL] holds global voxels [p_lo, p_lo
// + PL), as the Pallas kernels' p_offset; the instances RANGE) walks only
// the bricks the range meets and gives the voxels outside it in the two
// bricks it cuts a zero fade: G and c1 are the sums over the shard's
// voxels, whose sum over the shards is the whole volume's.  The rows
// variant takes no range.
// The products run in float32 FMA (the footprint exponent in direct
// (psi - p)^2 form, never a matmul form): JAX's bf16 "split" dot is a TPU
// emulation.
#include "cull.cuh"

namespace dnmf {

constexpr int GCH = 4;                  // candidates per side of a pair tile
constexpr int GTILE = GCH * GCH + GCH;  // a tile's pair sums, then its c1
constexpr int GCAND = THREADS;          // candidate rows listed at a time
constexpr int GROWS = 64;  // table rows per block that one split owns
constexpr int SC = 16;      // candidates per side of a staged tile
constexpr int SPITCH = THREADS + 1;  // staged w A row (padded: no conflicts)
constexpr int GSMEM = 2 * SC * SPITCH + THREADS;  // staged tiles, floats
constexpr int GSTAGE = 32;  // chunks I of more candidates take staged tiles

// The split that owns table row i: blocks of GROWS rows dealt to the
// splits in a zigzag (0, 1, .., n - 1, n - 1, .., 0, 0, ..), so that the
// early blocks, which pair with the most later rows, spread evenly.
__device__ __forceinline__ int row_owner(int i, int n_split) {
  const int q = i / GROWS, r = q % n_split;
  return (q / n_split) % 2 ? n_split - 1 - r : r;
}

// The upper triangle (i <= j) of a k x k matrix, row-major: entry (i, j)
// sits at tri_row(i, k) + j.
__device__ __forceinline__ long long tri_row(int i, int k) {
  return (long long)i * k - (long long)i * (i - 1) / 2 - i;
}

// Gaussian of the shared candidate row c (two float4s: p (3), log2e /
// s_m^2; log2e / s_n^2, log2e / s_z^2, 0, 0) at psi: gauss() of
// footprint.cuh.
__device__ __forceinline__ float gauss_row(const float4* rows, int c,
                                           const float psi[3]) {
  const float4 r0 = rows[c * 2], r1 = rows[c * 2 + 1];
  const float d0 = r0.x - psi[0], d1 = r0.y - psi[1], d2 = r0.z - psi[2];
  float e = d0 * d0 * r0.w;
  e += d1 * d1 * r1.x;
  e += d2 * d2 * r1.y;
  return exp2f(-e);
}

// Zeroes the partial cells that a group's window adds as it grows from
// [lo, hi) (empty where lo == hi) to [nlo, nhi): the Gram cells (i, j),
// nlo <= i <= j < nhi, outside [lo, hi)^2, and the c1 rows outside
// [lo, hi); only the rows that this split owns.  A warp per row.
__device__ __forceinline__ void zero_grown(float* gp, float* cp, int k,
                                           int lo, int hi, int nlo, int nhi,
                                           int split, int n_split) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int i = nlo + wid; i < nhi; i += NWARPS) {
    if (n_split > 1 && row_owner(i, n_split) != split) continue;
    const bool old_row = i >= lo && i < hi;
    if (!old_row && lane == 0) cp[i] = 0.0f;
    const long long base = tri_row(i, k);
    for (int j = (old_row ? max(i, hi) : i) + lane; j < nhi; j += 32)
      gp[base + j] = 0.0f;
  }
}

// Whether entry e of a pair tile (rows a0.., columns b0..; e < GCH^2 a
// pair, else c1 of row a0 + e - GCH^2) is live: inside both lists (na,
// nb), on or above the diagonal of a diagonal tile, c1 only there.
__device__ __forceinline__ bool tile_entry(int e, int a0, int b0, int na,
                                           int nb, bool diag_tile) {
  if (e >= GCH * GCH) return diag_tile && a0 + e - GCH * GCH < na;
  const int x = e / GCH, yy = e % GCH;
  return a0 + x < na && b0 + yy < nb && (!diag_tile || yy >= x);
}

// This thread's pixels of brick br: deformed coordinates, fades (0 past
// the brick or, with RANGE, outside the voxel range) and video values,
// and the per-warp partials of the brick's psi box in red.  ROWS reads psi
// and w from the rows (psi_b [P][3], w_b [P] of this frame); otherwise
// brick_pixels evaluates the warp.
template <bool ROWS, int NP, bool RANGE, class G>
__device__ __forceinline__ void gram_pixels(
    const Brick& br, const Bricks& bk, const G& g, const int* s_off,
    float* coord, const float* beta, const float* __restrict__ psi_b,
    const float* __restrict__ w_b, const float* __restrict__ yb,
    float psi[NP][3], float w[NP], float yv[NP], float* red) {
  if constexpr (ROWS) {
    const bool full = br.wm == bk.bm && br.wn == bk.bn && br.wz == bk.bz;
    float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      psi[i][0] = psi[i][1] = psi[i][2] = 0.0f;
      w[i] = yv[i] = 0.0f;
      int dm, dn, dz;
      if (slot_voxel(br, full, s_off, i, dm, dn, dz)) {
        const int p = ((br.m0 + dm) * g.N + br.n0 + dn) * g.Z + br.z0 + dz;
        yv[i] = yb[p];
        w[i] = w_b[p];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          psi[i][d] = psi_b[(size_t)p * 3 + d];
          lo[d] = fminf(lo[d], psi[i][d]);
          hi[d] = fmaxf(hi[d], psi[i][d]);
        }
      }
    }
    box_partials(lo, hi, red);
  } else {
    brick_pixels<true, NP, RANGE>(br, bk, g, s_off, coord, beta, yb, psi, yv,
                                  red);
    const int npix = br.count();
    const bool cut = brick_cut<RANGE>(br, g);
    const bool full = brick_full(br, bk, cut);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      int dm, dn, dz;
      bool in;
      if constexpr (RANGE)
        in = slot_in_range(br, full, cut, s_off, i, dm, dn, dz, g);
      else
        in = threadIdx.x + i * THREADS < npix;
      w[i] = in ? fade(psi[i], g) : 0.0f;
    }
  }
}

// Grid (brick group, split, frame).  table: [k][TROW] rows sorted by m,
// frame b's at frame_table(b, fpt) (cull.cuh), and its video at
// frame_video(b, fpt, y_rec, PL); rmax the tables' largest m reach.  The
// splits of a group walk the same bricks; split s takes the pairs whose
// first row lies in a block of GROWS table rows that it owns (row_owner),
// so no two thread blocks add to one cell.
// Writes the group's partial (the upper triangle of a k x k
// matrix in table order at gpart + group * k (k + 1) / 2, and a k row of
// c1 at cpart + group * k; only the window's cells), its window [lo, hi)
// of table rows to windows [B][n_groups][2], and with counts ([B][n_bricks],
// or null) the candidates each brick listed.  SPLIT (several splits)
// adds the staged tiles, GSMEM floats of dynamic shared memory.
template <bool ROWS, bool SPLIT, int NP, bool RANGE>
__global__ void __launch_bounds__(THREADS, 3)
gram_bricks(const float* __restrict__ betas, const float* __restrict__ psi_rows,
            const float* __restrict__ w_rows, const float* __restrict__ table,
            int fpt, const float* __restrict__ rmax,
            const float* __restrict__ y, long long y_rec,
            float* __restrict__ gpart,
            float* __restrict__ cpart, int* __restrict__ windows,
            int* __restrict__ counts, GeomOf<RANGE> g, BricksOf<RANGE> bk,
            int n_bricks, int bricks_per_group, int k) {
  const int grp = blockIdx.x, n_groups = gridDim.x;
  const int split = SPLIT ? blockIdx.y : 0, n_split = SPLIT ? gridDim.y : 1;
  const int b = blockIdx.z;
  extern __shared__ float s_stage[];  // [2][SC][SPITCH], then [THREADS]
  __shared__ float4 s_rows[2][GCAND * 2];  // the two sides of a chunk pair
  __shared__ int s_cand[2][GCAND];
  __shared__ float s_beta[30];
  __shared__ float s_red[NWARPS * GTILE];
  __shared__ float s_box[6];
  __shared__ int s_off[NP * THREADS];
  __shared__ float s_coord[2][COORDS];
  __shared__ int s_warp_n[NWARPS];
  __shared__ int s_range[2];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  if (!ROWS && tid < 30) s_beta[tid] = betas[b * 30 + tid];
  brick_slots<NP>(bk, s_off);
  const size_t part = (size_t)b * n_groups + grp;
  float* gp = gpart + part * ((size_t)k * (k + 1) / 2);
  float* cp = cpart + part * k;
  const float* tab = table + frame_table(b, fpt) * k * TROW;
  const float rm = *rmax;
  const float* yb = y + frame_video(b, fpt, y_rec, range_voxels<RANGE>(g));
  const float* psi_b = ROWS ? psi_rows + (size_t)b * g.P * 3 : nullptr;
  const float* w_b = ROWS ? w_rows + (size_t)b * g.P : nullptr;
  int lo = 0, hi = 0;  // the group's window of table rows so far

  const int first = grp * bricks_per_group;
  const int last = min(first + bricks_per_group, n_bricks);
  for (int id = first; id < last; ++id) {
    const Brick br = brick_at<RANGE>(id, bk, g);
    float* coord = s_coord[(id - first) & 1];
    const int npix = br.count();
    float psi[NP][3], w[NP], yv[NP];
    gram_pixels<ROWS, NP, RANGE>(br, bk, g, s_off, coord, s_beta, psi_b, w_b,
                                 yb, psi, w, yv, s_red);
    candidate_window(tab, TROW, k, rm, s_red, s_box, s_range);
    const int i0 = s_range[0], i1 = s_range[1];
    int nc = 0;
    if (i0 < i1) {  // block-uniform
      const int nlo = lo < hi ? min(lo, i0) : i0;
      const int nhi = lo < hi ? max(hi, i1) : i1;
      // The barriers of the listing below order these stores before any
      // addition to the same cells.
      zero_grown(gp, cp, k, lo, hi, nlo, nhi, split, n_split);
      lo = nlo;
      hi = nhi;
      // Chunks I of at most GCAND candidates (with splits: the candidates
      // of one block of GROWS table rows), listed by every split (the count);
      // their pairs (I, I) and (I, J), J the later candidates in chunks of
      // GCAND, taken by the owner.  One call site of the listing and of
      // each tile path, so that each is inlined once.
      int ci = i0, next_i = i0, cj = 0, ni = 0;
      bool diag = true, own = true;
      for (;;) {
        const int side = diag ? 0 : 1;
        if (diag) own = n_split == 1 || row_owner(ci, n_split) == split;
        const int end =
            diag && n_split > 1 ? min(ci - ci % GROWS + GROWS, i1) : i1;
        int next;
        const int n = list_chunk(
            tab, diag ? ci : cj, end, GCAND, s_box, s_cand[side], s_warp_n,
            next,
            [&](int slot, int, const float* row) {
              s_rows[side][slot * 2] =
                  make_float4(row[0], row[1], row[2], row[3]);
              s_rows[side][slot * 2 + 1] =
                  make_float4(row[4], row[5], 0.0f, 0.0f);
            });
        if (diag) {
          ni = n;
          nc += n;
          next_i = next;
        }
        cj = next;
        __syncthreads();
        const float4* rb = s_rows[side];
        const int* cb = s_cand[side];
        const int nb = n;
        if (SPLIT && own && ni > GSTAGE) {
          // Staged tiles of SC x SC pairs: w A of the tile's candidates at
          // THREADS pixels in shared memory, a thread per pair summing over
          // the pixels in order (the first SC threads also c1 on a diagonal
          // tile); no block reduction.
          float* s_fa = s_stage;
          float* s_fb = s_stage + SC * SPITCH;
          float* s_y = s_stage + 2 * SC * SPITCH;
          const int x = tid / SC, yy = tid % SC;
          for (int a0 = 0; a0 < ni; a0 += SC) {
            for (int b0 = diag ? a0 : 0; b0 < nb; b0 += SC) {
              const bool dt = diag && a0 == b0;
              const bool live =
                  a0 + x < ni && b0 + yy < nb && (!dt || yy >= x);
              float acc = 0.0f, cacc = 0.0f;
#pragma unroll
              for (int i = 0; i < NP; ++i) {
                if (i * THREADS >= npix) break;  // block-uniform
                const bool valid = tid + i * THREADS < npix;
#pragma unroll 4
                for (int c = 0; c < SC; ++c)
                  s_fa[c * SPITCH + tid] =
                      valid && a0 + c < ni
                          ? gauss_row(s_rows[0], a0 + c, psi[i]) * w[i]
                          : 0.0f;
                if (dt) {
                  s_y[tid] = valid ? yv[i] : 0.0f;
                } else {
#pragma unroll 4
                  for (int c = 0; c < SC; ++c)
                    s_fb[c * SPITCH + tid] =
                        valid && b0 + c < nb
                            ? gauss_row(rb, b0 + c, psi[i]) * w[i]
                            : 0.0f;
                }
                __syncthreads();
                const int np = min(THREADS, npix - i * THREADS);
                const float* fa = s_fa + x * SPITCH;
                const float* fb = (dt ? s_fa : s_fb) + yy * SPITCH;
                if (live)
                  for (int p = 0; p < np; ++p) acc = fmaf(fa[p], fb[p], acc);
                if (dt && tid < SC) {
                  const float* fc = s_fa + tid * SPITCH;
                  for (int p = 0; p < np; ++p) cacc = fmaf(fc[p], s_y[p], cacc);
                }
                __syncthreads();
              }
              // Table order: a row of I never follows one of J, or a later
              // row of I.
              if (live) gp[tri_row(s_cand[0][a0 + x], k) + cb[b0 + yy]] += acc;
              if (dt && tid < SC && a0 + tid < ni)
                cp[s_cand[0][a0 + tid]] += cacc;
            }
          }
        } else if (own) {
          // Register tiles of GCH x GCH pairs: per pixel the tile's w A
          // values in registers, block sums of the pair products.
          for (int a0 = 0; a0 < ni; a0 += GCH) {
            for (int b0 = diag ? a0 : 0; b0 < nb; b0 += GCH) {
              const bool dt = diag && a0 == b0;  // a diagonal tile
              float acc[GTILE];
#pragma unroll
              for (int e = 0; e < GTILE; ++e) acc[e] = 0.0f;
#pragma unroll
              for (int i = 0; i < NP; ++i) {
                if (tid + i * THREADS >= npix) continue;
                float fa[GCH], fb[GCH];
#pragma unroll
                for (int x = 0; x < GCH; ++x)
                  fa[x] = a0 + x < ni
                              ? gauss_row(s_rows[0], a0 + x, psi[i]) * w[i]
                              : 0.0f;
#pragma unroll
                for (int x = 0; x < GCH; ++x)
                  fb[x] = dt ? fa[x]
                             : (b0 + x < nb
                                    ? gauss_row(rb, b0 + x, psi[i]) * w[i]
                                    : 0.0f);
#pragma unroll
                for (int x = 0; x < GCH; ++x) {
#pragma unroll
                  for (int yy = 0; yy < GCH; ++yy)
                    acc[x * GCH + yy] = fmaf(fa[x], fb[yy], acc[x * GCH + yy]);
                  acc[GCH * GCH + x] = fmaf(fa[x], yv[i], acc[GCH * GCH + x]);
                }
              }
              // Block sums of the tile's live entries, in a fixed order,
              // added by one thread each to the group's partial.
#pragma unroll
              for (int e = 0; e < GTILE; ++e) {
                if (!tile_entry(e, a0, b0, ni, nb, dt)) continue;
                const float v = warp_sum(acc[e]);
                if (lane == 0) s_red[wid * GTILE + e] = v;
              }
              __syncthreads();
              if (tid < GTILE && tile_entry(tid, a0, b0, ni, nb, dt)) {
                float t = 0.0f;
                for (int wi = 0; wi < NWARPS; ++wi)
                  t += s_red[wi * GTILE + tid];
                if (tid < GCH * GCH) {
                  const int ia = s_cand[0][a0 + tid / GCH];
                  gp[tri_row(ia, k) + cb[b0 + tid % GCH]] += t;
                } else {
                  cp[s_cand[0][a0 + tid - GCH * GCH]] += t;
                }
              }
              __syncthreads();
            }
          }
        }
        if (own && ni > 0 && cj < i1) {
          diag = false;  // the next chunk J of this chunk I
        } else {
          if (next_i >= i1) break;
          ci = next_i;  // the next chunk I
          diag = true;
        }
      }
    }
    if (counts != nullptr && split == 0 && tid == 0)
      counts[(size_t)b * n_bricks + id] = nc;
  }
  if (split == 0 && tid == 0) {
    windows[part * 2] = lo;
    windows[part * 2 + 1] = hi;
  }
}

// G [B][k][k] and c1 [B][k] in the caller's order from the groups'
// partials: grid (k / 32, k / 8, B) rounded up, blocks of 32 x 8 threads,
// a thread per entry (i, j) of table rows with i <= j (blocks wholly below
// the diagonal return at once).  The entry is the sum, in group order, of
// the partials of the groups whose window holds both rows (0 if none),
// written at (order[i], order[j]) and its mirror; order[frame_table(b,
// fpt) * k + i] is table row i's neuron.  The first row of blocks also
// writes c1.  Dynamic shared memory: n_groups * 2 ints.
__global__ void __launch_bounds__(THREADS)
gram_assemble(const float* __restrict__ gpart, const float* __restrict__ cpart,
              const int* __restrict__ windows,
              const long long* __restrict__ order, int fpt,
              float* __restrict__ G, float* __restrict__ c1, int n_groups,
              int k) {
  extern __shared__ int s_win[];
  const int j0 = blockIdx.x * 32, i0 = blockIdx.y * NWARPS, b = blockIdx.z;
  if (j0 + 31 < i0) return;
  const size_t fb = (size_t)b * n_groups;
  for (int gi = threadIdx.x; gi < 2 * n_groups; gi += THREADS)
    s_win[gi] = windows[fb * 2 + gi];
  __syncthreads();
  const size_t tri = (size_t)k * (k + 1) / 2;
  const long long* ob = order + frame_table(b, fpt) * k;
  const int j = j0 + (threadIdx.x & 31), i = i0 + (threadIdx.x >> 5);
  if (i < k && j < k && i <= j) {
    const float* cell = gpart + fb * tri + tri_row(i, k) + j;
    float s = 0.0f;
#pragma unroll 8
    for (int gi = 0; gi < n_groups; ++gi)
      if (s_win[2 * gi] <= i && j < s_win[2 * gi + 1]) s += cell[gi * tri];
    const size_t oi = ob[i], oj = ob[j];
    G[((size_t)b * k + oi) * k + oj] = s;
    G[((size_t)b * k + oj) * k + oi] = s;
  }
  if (blockIdx.y == 0 && threadIdx.x < 32 && j < k) {
    float s = 0.0f;
#pragma unroll 8
    for (int gi = 0; gi < n_groups; ++gi)
      if (s_win[2 * gi] <= j && j < s_win[2 * gi + 1])
        s += cpart[(fb + gi) * k + j];
    c1[(size_t)b * k + ob[j]] = s;
  }
}

template <bool ROWS>
int gram_launch(const float* betas, const float* psi, const float* w,
                const float* table, const long long* order,
                const float* rmax, const float* y, long long y_rec,
                float* gpart, float* cpart, int* windows, float* g_out,
                float* c1_out, int* counts, int B, const RangedGeom& g, int k,
                int fpt, int bm, int bn, int bz, int bricks_per_group,
                int n_split, cudaStream_t s) {
  if (!range_ok(g)) return (int)cudaErrorInvalidValue;
  const RangedBricks bk = make_bricks(g, bm, bn, bz);
  if (bm * bn * bz > THREADS * PPT || bm + bn + bz > COORDS || n_split < 1 ||
      fpt < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || k == 0) return (int)cudaSuccess;
  const int n_bricks = bk.count;
  const int n_groups = (n_bricks + bricks_per_group - 1) / bricks_per_group;
  // Splits, and the staged tiles with their shared memory, only where a
  // volume has few groups: one with groups enough lists few candidates
  // per brick.
  const auto launch = [&](auto kernel, int smem) {
    if (smem > 0) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<dim3(n_groups, n_split, B), THREADS, smem, s>>>(
        betas, psi, w, table, fpt, rmax, y, y_rec, gpart, cpart, windows,
        counts, g, bk, n_bricks, bricks_per_group, k);
    return cudaGetLastError();
  };
  const bool ranged = g.p_lo != 0 || g.PL != g.P;
  if (ROWS && ranged) return (int)cudaErrorInvalidValue;
  const cudaError_t e = with_slots(bm * bn * bz, [&](auto np) {
    constexpr int NP = decltype(np)::value;
    constexpr int STAGED = GSMEM * sizeof(float);
    if constexpr (!ROWS) {
      if (ranged)
        return n_split > 1 ? launch(gram_bricks<false, true, NP, true>, STAGED)
                           : launch(gram_bricks<false, false, NP, true>, 0);
    }
    return n_split > 1 ? launch(gram_bricks<ROWS, true, NP, false>, STAGED)
                       : launch(gram_bricks<ROWS, false, NP, false>, 0);
  });
  if (e != cudaSuccess) return (int)e;
  gram_assemble<<<dim3((k + 31) / 32, (k + NWARPS - 1) / NWARPS, B),
                  THREADS, 2 * n_groups * sizeof(int), s>>>(
      gpart, cpart, windows, order, fpt, g_out, c1_out, n_groups, k);
  return (int)cudaGetLastError();
}

}  // namespace dnmf

// betas [B][10][3]; tables [B / fpt][k][TROW] and orders [B / fpt][k]
// (table.cu, order int64), frame b's at b / fpt (fpt = B: shared anchors,
// 1: per-frame positions, the frames of a recording: a recordings axis),
// and rmax (1 float) their largest m reach; y: frame b's voxels [p_lo,
// p_lo + p_count) (0 and M N Z: the whole volume) at frame_video(b, fpt,
// y_rec, p_count) (y_rec = fpt p_count: [B][p_count]).  Outputs
// in the caller's neuron order: g_out [B][k][k], c1_out [B][k]; counts (or
// null): [B][n_bricks] candidates per brick, for the n_bricks bricks that
// the range meets (make_bricks).  Bricks of bm x bn x bz voxels,
// bricks_per_group per group, n_split thread blocks per group.  Scratch:
// gpart [B][n_groups][k (k + 1) / 2] and cpart [B][n_groups][k] floats,
// windows [B][n_groups][2] ints.
extern "C" int dnmf_gram(const float* betas, const float* table,
                         const long long* order, const float* rmax,
                         const float* y, long long y_rec, float* gpart,
                         float* cpart, int* windows, float* g_out,
                         float* c1_out, int* counts, int B, int M, int N,
                         int Z, int normalized, int k, int fpt, int bm, int bn,
                         int bz, int bricks_per_group, int n_split, int p_lo,
                         int p_count, void* stream) {
  return dnmf::gram_launch<false>(
      betas, nullptr, nullptr, table, order, rmax, y, y_rec, gpart, cpart,
      windows, g_out, c1_out, counts, B,
      dnmf::make_geom(M, N, Z, normalized, p_lo, p_count), k, fpt, bm, bn,
      bz, bricks_per_group, n_split, (cudaStream_t)stream);
}

// The same from precomputed rows of the volume M x N x Z: psi [B][P][3]
// pixel-space deformed coordinates and w [B][P] fades; shared anchors
// (one table).
extern "C" int dnmf_gram_rows(const float* psi, const float* w,
                              const float* table, const long long* order,
                              const float* rmax, const float* y, float* gpart,
                              float* cpart, int* windows, float* g_out,
                              float* c1_out, int* counts, int B, int M, int N,
                              int Z, int k, int bm, int bn, int bz,
                              int bricks_per_group, int n_split,
                              void* stream) {
  return dnmf::gram_launch<true>(
      nullptr, psi, w, table, order, rmax, y, (long long)B * M * N * Z,
      gpart, cpart, windows, g_out, c1_out, counts, B,
      dnmf::make_geom(M, N, Z, 0), k, B > 0 ? B : 1, bm, bn, bz,
      bricks_per_group, n_split, (cudaStream_t)stream);
}
