// Temporally blocked FDTD simulation (B3) and chunked RT60 moments (B4)
// for Hopper: the large-world route of the engine step.
//
// B3 `fdtd_sim_tiled` replaces planeverb_tpu/ops/fdtd_tiled.py::_tiled_kernel.
//   The pass runs in rounds of k steps. Each block owns 2D tiles of
//   tile_x x tile_y interior cells and advances the window around a tile
//   (the tile plus a k-cell halo on every side) k steps; the stencil radius
//   is one cell per step, so after k local steps every interior cell is
//   exact. The window records the interior's pre-injection pressure every
//   step, and the interior state and accumulators are kept for the next
//   round.
//   - The whole pass is one cooperative launch (`fdtd_tiled_kernel`) of one
//     block per SM. Block b steps the tiles b, b + gridDim.x, ... in every
//     round, and a grid barrier (an arrival counter and a generation word
//     in global memory) separates the rounds. The state is read and written
//     past L1 (ld/st.cg), as other SMs wrote it within the launch.
//   - Where a block's tiles' six accumulators fit its shared memory (a
//     [6][tile cells] slot a tile; up to ~1100^2 cells on 132 SMs), they
//     stay there for the whole pass and reach global memory once, in the
//     last round, so a round moves only the state (kSharedAcc). Above that
//     the launcher takes the same kernel with the accumulators read and
//     written in global memory every round. It decides from the shared
//     memory the card lets a block opt into, before launch; both give the
//     same bits.
//   - The window lives in registers. A thread owns one window column (lane
//     = column, so a warp's loads and stores of a row are consecutive
//     addresses) and a run of 4 consecutive rows: p, vx, vy and the seven
//     folded coefficients (beta, A/B/D in x and y) of its 4 cells, and the
//     six accumulators (onset, flux, windowed energies) of those that are
//     tile cells, sit in registers for the whole round, loaded once and
//     stored once. The row neighbour is the thread's next or previous
//     register; the column neighbour comes from the next or previous lane
//     by __shfl_sync (every lane takes part, lanes past the window's edge
//     too). Only the rows at the ends of a run and the columns at the edges
//     of a warp go through shared memory, a few KB a block, behind the two
//     block barriers of a step (after the pressure update, after the
//     velocity update).
//   - State is double-buffered in global memory by round parity: round c
//     reads slot c%2 and writes slot (c+1)%2; the grid barrier keeps any
//     block from reading a cell another block writes in the same round.
//   - The listener's pulse of step t-1 is added to its cell's pressure at
//     the start of step t, in every window that holds the listener cell,
//     halo copies included; only the thread of that cell reads its old
//     pressure, and the stored state is the pre-injection pressure.
//   - Window cells outside the field load zero state, beta and Y and so
//     stay 0: they play the reference's zero padding. The fold places the
//     edge ABC by global cell index, so it sits at the global edge.
//   - The window reads two static planes, beta and the wall admittance Y,
//     and folds the seven coefficients in registers (common.cuh
//     fold_cell, shared with B6) instead of reading seven folded
//     planes: a neighbour before the window's first row or column folds as
//     0, which is wrong only in the halo, where k steps do not carry it into
//     the tile.
//   - No overlap of one window's loads with another's compute: ~110
//     registers a thread hold one 512-thread block of 4-row runs per SM.
//     Two resident blocks of smaller (32 x 32) windows are no faster
//     (probe_tiled.py sweeps windows, k and the accumulators' place), nor
//     were runs of 8 rows (fewer warps) or blocks prefetching the next
//     window into shared memory with cp.async, so none is kept.
//   What bounds it on this card: per cell and step the 4-byte recording
//   write (7.46 GB a pass at 964^2, ~2.2 ms at the HBM rate, the bound),
//   plus per round the window's reads of p, vx, vy, beta and Y (times the
//   halo redundancy) and the tile's state written back (and with the
//   accumulators in global memory their six planes read and written);
//   rounds of 0 steps (pv_fdtd_sim_tiled_probe's `dry`) take about half a
//   pass at k = 6 (PERF.md), so those moves and the stepping are of the
//   same order.
//
// B4 `rt60_moments_tiled` replaces
// planeverb_tpu/ops/fdtd_tiled.py::_tiled_moments_kernel.
//   One thread per cell, kMomRun cells a block, as B2: each thread walks
//   its cell's samples newest first with direct loads (a warp's loads of a
//   step are 128 coalesced bytes, whatever nx * ny), in reverse chunks of
//   `chunk` steps, carrying the suffix EDC, s0 and s1 in registers. It
//   reads the [T, nx, ny] recording B3 wrote in place. What bounds it: one
//   read of the recording (7.46 GB at 964^2 x 2006) and one logf per
//   element. Staging chunks in shared memory with asynchronous copies, and
//   holding a chunk per thread in registers, were both slower than these
//   direct loads on an H100 (PERF.md).
//
// Numerics: built with -fmad=false and without fast math, each expression
// in the order of the plain PyTorch versions (ops/fdtd_tiled.py), so every
// op rounds once as PyTorch's elementwise kernels do. The +inf onset
// sentinel and the 1e-37 EDC clamp rely on IEEE semantics (no FTZ, exact
// logf); the moments use the select form, never m * (t - start) * y, which
// is 0 * -inf = NaN where the onset is +inf. Recording offsets are 64-bit.
//
// Launchers allocate nothing, never synchronise, count their launches
// (common.cuh) and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// Rows of a B3 thread's run, and the most threads in a block: the bound
// lets ptxas give each thread the registers of its kRun cells' values and
// accumulators (up to 128 a thread).
constexpr int kRun = 4;
constexpr int kTiledThreads = 512;
// Cells per B4 block, one thread each (B2's block size).
constexpr int kMomRun = 128;

// The two static planes a window reads: the air flags and the wall
// admittance, from which it folds the seven stencil coefficients.
struct Fold {
  const float* __restrict__ beta;
  const float* __restrict__ Y;
};

struct State {
  float* __restrict__ p;
  float* __restrict__ vx;
  float* __restrict__ vy;
};

struct Acc {
  float* __restrict__ onset;
  float* __restrict__ fx;
  float* __restrict__ fy;
  float* __restrict__ ed;
  float* __restrict__ ew;
  float* __restrict__ et;
};

struct Round {
  int nx, ny;          // field
  int t0, nsteps;      // first step of this round, steps in it
  int tile_x, tile_y;  // interior
  int k;               // halo = steps per full round
  int lix, liy;        // listener cell (outside every window when absent)
  int gx, gy;          // analysis grid: the edge rows and columns of the fold
  int absorbing;       // edge ABC (else rigid outer walls)
  int tiles_y;         // tiles along y (tile t is row t / tiles_y)
  int tiles;           // tiles in the field
  float courant, thr, src_dir_n, dry_n, wet_n;
};

// A B3 block: one thread a window column (rounded up to whole warps) and a
// run of kRun rows; its dynamic shared memory holds the run and warp edges.
struct TiledLaunch {
  dim3 block;
  size_t smem;
};

TiledLaunch tiled_launch(int tile_x, int tile_y, int k) {
  const int wx = tile_x + 2 * k;
  const int wy = tile_y + 2 * k;
  const int lanes = (wy + 31) / 32 * 32;
  const int trows = (wx + kRun - 1) / kRun;
  const size_t edges = 2 * (size_t)trows * lanes +
                       2 * (size_t)(lanes / 32) * trows * kRun;
  return {dim3(lanes, trows), edges * sizeof(float)};
}

// One thread's part of a window: column j of the window, rows i0 .. i0+R-1.
// The values of its cells, the seven folded coefficients and the six
// accumulators of its tile cells live in registers.
template <int R>
struct Run {
  float p[R], vx[R], vy[R];
  float c[7][R];       // beta, ax, bx, dx, ay, by, dy
  float y[R];          // the wall admittance, until the fold
  float on[R], fx[R], fy[R], ed[R], ew[R], et[R];
  unsigned interior;   // bit m: row i0 + m is a tile row in the field
};

// This thread's place in the block and the window's run and warp edges.
struct Edges {
  float* row_p;    // [trows][lanes] p of a run's last row
  float* row_vx;   // vx of a run's first row
  float* col_p;    // [warps][rows] p of lane 31
  float* col_vy;   // vy of lane 0
  int lanes, trows, warps, rows;
  int j, lane, w, tr, i0;
};

__device__ __forceinline__ Edges block_edges(float* smem, int R) {
  Edges e;
  e.lanes = blockDim.x;
  e.trows = blockDim.y;
  e.warps = e.lanes >> 5;
  e.rows = e.trows * R;
  e.row_p = smem;
  e.row_vx = e.row_p + e.trows * e.lanes;
  e.col_p = e.row_vx + e.trows * e.lanes;
  e.col_vy = e.col_p + e.warps * e.rows;
  e.j = threadIdx.x;
  e.lane = e.j & 31;
  e.w = e.j >> 5;
  e.tr = threadIdx.y;
  e.i0 = e.tr * R;
  return e;
}

// Publish a run's values at its edges for the neighbours that read them
// after the next barrier: the last row (row) and, from lane 31, every row
// (col). p, beta and Y travel this way.
template <int R>
__device__ __forceinline__ void publish_down(const Edges& e, const float* a,
                                             float* row, float* col) {
  row[e.tr * e.lanes + e.j] = a[R - 1];
  if (e.lane == 31) {
#pragma unroll
    for (int m = 0; m < R; ++m) col[e.w * e.rows + e.i0 + m] = a[m];
  }
}

// The velocities the next pressure update reads across an edge: vx of the
// run's first row, and vy of lane 0's rows.
template <int R>
__device__ __forceinline__ void publish_velocities(const Edges& e,
                                                   const Run<R>& u) {
  e.row_vx[e.tr * e.lanes + e.j] = u.vx[0];
  if (e.lane == 0) {
#pragma unroll
    for (int m = 0; m < R; ++m) e.col_vy[e.w * e.rows + e.i0 + m] = u.vy[m];
  }
}

// Fold the window's coefficients (common.cuh fold_cell: ops/fdtd.py
// stencil_coefficients, in its order; a neighbour before the window's first
// row or column is 0, so the fold is wrong there, in the halo, and k steps
// do not carry that into the tile), then advance the window r.nsteps steps, recording and accumulating
// its tile cells. beta and Y, p and the velocities of row i-1 / i+1 are the
// next register or the neighbour run's edge row; of column j-1 / j+1 the
// neighbour lane's (__shfl_sync, every lane taking part), or the neighbour
// warp's edge column. Two block barriers a step.
template <int R>
__device__ __forceinline__ void run_window(Run<R>& u, const Edges& e,
                                           const Round& r, int gi0, int gj0,
                                           const float* __restrict__ pulse,
                                           float* __restrict__ rec) {
  const unsigned full = 0xffffffffu;
  const int wx = r.tile_x + 2 * r.k;
  const int wy = r.tile_y + 2 * r.k;
  const int j = e.j;
  const int gj = gj0 + j;
  // the listener's row in this run, if this thread holds its cell (else -1)
  const int lrow = r.lix - gi0 - e.i0;
  const int inject = (r.liy == gj && j < wy && lrow >= 0 && lrow < R &&
                      e.i0 + lrow < wx) ? lrow : -1;

  // -- the fold
  __syncthreads();   // the edge buffers are free
  publish_down<R>(e, u.c[0], e.row_p, e.col_p);
  publish_down<R>(e, u.y, e.row_vx, e.col_vy);
  __syncthreads();
  {
    const bool above = e.tr > 0;
    float b_prev = above ? e.row_p[(e.tr - 1) * e.lanes + j] : 0.0f;
    float y_prev = above ? e.row_vx[(e.tr - 1) * e.lanes + j] : 0.0f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = e.i0 + m;
      const float beta = u.c[0][m];
      const float Y = u.y[m];
      float b_left = __shfl_up_sync(full, beta, 1);
      float y_left = __shfl_up_sync(full, Y, 1);
      if (e.lane == 0) {
        b_left = e.w > 0 ? e.col_p[(e.w - 1) * e.rows + i] : 0.0f;
        y_left = e.w > 0 ? e.col_vy[(e.w - 1) * e.rows + i] : 0.0f;
      }
      const float b_xm = i > 0 ? b_prev : 0.0f;
      const float y_xm = i > 0 ? y_prev : 0.0f;
      const float b_ym = j > 0 ? b_left : 0.0f;
      const float y_ym = j > 0 ? y_left : 0.0f;
      b_prev = beta;
      y_prev = Y;
      const pv::Folded k =
          pv::fold_cell(beta, Y, b_xm, y_xm, b_ym, y_ym, gi0 + i, gj, r.gx,
                        r.gy, r.absorbing != 0);
      u.c[1][m] = k.ax;
      u.c[2][m] = k.bx;
      u.c[3][m] = k.dx;
      u.c[4][m] = k.ay;
      u.c[5][m] = k.by;
      u.c[6][m] = k.dy;
    }
  }
  __syncthreads();   // the fold's edges are read

  // velocity edges for the first pressure update
  publish_velocities<R>(e, u);
  __syncthreads();

  for (int s = 0; s < r.nsteps; ++s) {
    const int t = r.t0 + s;
    const float inj = t > 0 ? pulse[t - 1] : 0.0f;

    // -- pressure: p = beta * (p_old - C * div v), p_old with the pending
    // injection of step t-1 at the listener cell
    const float vx_below = (e.tr + 1 < e.trows)
                               ? e.row_vx[(e.tr + 1) * e.lanes + j] : 0.0f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = e.i0 + m;
      float vy_right = __shfl_down_sync(full, u.vy[m], 1);
      if (e.lane == 31)
        vy_right = (e.w + 1 < e.warps) ? e.col_vy[(e.w + 1) * e.rows + i]
                                       : 0.0f;
      float pv = u.p[m];
      if (t > 0 && m == inject) pv = pv + inj;
      const float vx_xp =
          (i + 1 < wx) ? (m + 1 < R ? u.vx[m + 1] : vx_below) : 0.0f;
      const float vy_yp = (j + 1 < wy) ? vy_right : 0.0f;
      const float div = (vx_xp - u.vx[m]) + (vy_yp - u.vy[m]);
      u.p[m] = u.c[0][m] * (pv - r.courant * div);
    }
    publish_down<R>(e, u.p, e.row_p, e.col_p);
    __syncthreads();

    // -- velocities (walls + edge ABC folded), then the tile's streaming
    // accumulators and its pre-injection recording; window bounds are
    // small-integer-valued, so exact in f32
    const float tf = (float)t;
    const float c_flux = tf - r.src_dir_n;
    const float c_dry = tf - r.dry_n;
    const float c_wet_lo = tf - r.dry_n - 1.0f;
    const float c_wet_hi = tf - r.dry_n - 1.0f - r.wet_n;
    float* rec_t = rec + (int64_t)t * r.nx * r.ny;
    const float p_above = e.tr > 0 ? e.row_p[(e.tr - 1) * e.lanes + j] : 0.0f;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int i = e.i0 + m;
      float p_left = __shfl_up_sync(full, u.p[m], 1);
      if (e.lane == 0)
        p_left = (e.w > 0) ? e.col_p[(e.w - 1) * e.rows + i] : 0.0f;
      const float pc = u.p[m];
      const float p_xm = (i > 0) ? (m > 0 ? u.p[m - 1] : p_above) : 0.0f;
      const float p_ym = (j > 0) ? p_left : 0.0f;
      float air = u.vx[m] - r.courant * (pc - p_xm);
      const float nvx = u.c[1][m] * air + u.c[2][m] * pc + u.c[3][m] * p_xm;
      air = u.vy[m] - r.courant * (pc - p_ym);
      const float nvy = u.c[4][m] * air + u.c[5][m] * pc + u.c[6][m] * p_ym;
      u.vx[m] = nvx;
      u.vy[m] = nvy;
      if (u.interior & (1u << m)) {
        const float onset = fminf(u.on[m], fabsf(pc) > r.thr ? tf : INFINITY);
        const float mp = (onset > c_flux) ? pc : 0.0f;
        u.on[m] = onset;
        u.fx[m] = u.fx[m] + mp * nvx;
        u.fy[m] = u.fy[m] + mp * nvy;
        const float sq = pc * pc;
        if (onset > c_dry) u.ed[m] = u.ed[m] + sq;
        if (onset <= c_wet_lo && onset > c_wet_hi) u.ew[m] = u.ew[m] + sq;
        u.et[m] = u.et[m] + sq;
        rec_t[(int64_t)(gi0 + i) * r.ny + gj] = pc;
      }
    }
    publish_velocities<R>(e, u);
    __syncthreads();
  }
}

// Window origin (global) of tile `tile`.
__device__ __forceinline__ void window_origin(const Round& r, int tile,
                                              int& gi0, int& gj0) {
  gi0 = (tile / r.tiles_y) * r.tile_x - r.k;
  gj0 = (tile % r.tiles_y) * r.tile_y - r.k;
}

// Which of this thread's cells are in the field (bit m of the result), and
// which are tile cells in the field (u.interior).
template <int R>
__device__ __forceinline__ unsigned cell_masks(Run<R>& u, const Edges& e,
                                               const Round& r, int gi0,
                                               int gj0) {
  const int wx = r.tile_x + 2 * r.k;
  const int wy = r.tile_y + 2 * r.k;
  const int gj = gj0 + e.j;
  const bool col_in = e.j < wy && gj >= 0 && gj < r.ny;
  const bool col_tile = e.j >= r.k && e.j < r.k + r.tile_y && gj < r.ny;
  unsigned field = 0;
  u.interior = 0;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = e.i0 + m;
    const int gi = gi0 + i;
    const bool in = col_in && i < wx && gi >= 0 && gi < r.nx;
    const bool tile = col_tile && i >= r.k && i < r.k + r.tile_x && gi < r.nx;
    field |= (in ? 1u : 0u) << m;
    u.interior |= (tile ? 1u : 0u) << m;
  }
  return field;
}

// Load this thread's cells: cells outside the field (or the window) are 0
// in every plane; state and accumulators are at rest in the first round. A
// warp's loads of a row are consecutive. The state is read past L1 (other
// SMs wrote it in this launch). kSharedAcc: the accumulators live in the
// block's shared memory `as` ([6][tile cells]), else in global memory.
template <int R, bool kSharedAcc>
__device__ __forceinline__ void load_window(Run<R>& u, const Edges& e,
                                            const Round& r, const Fold& f,
                                            const State& in, const Acc& acc,
                                            const float* as, int gi0,
                                            int gj0) {
  const unsigned field = cell_masks<R>(u, e, r, gi0, gj0);
  const bool first_round = (r.t0 == 0);
  const int tcells = r.tile_x * r.tile_y;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const bool in_field = field & (1u << m);
    const bool tile = u.interior & (1u << m);
    const int64_t g = (int64_t)(gi0 + e.i0 + m) * r.ny + gj0 + e.j;
    const bool load_state = in_field && !first_round;
    u.p[m] = load_state ? __ldcg(in.p + g) : 0.0f;
    u.vx[m] = load_state ? __ldcg(in.vx + g) : 0.0f;
    u.vy[m] = load_state ? __ldcg(in.vy + g) : 0.0f;
    u.c[0][m] = in_field ? f.beta[g] : 0.0f;
    u.y[m] = in_field ? f.Y[g] : 0.0f;
    const bool load_acc = tile && !first_round;
    if (kSharedAcc) {
      const float* a = as + (e.i0 + m - r.k) * r.tile_y + (e.j - r.k);
      u.on[m] = load_acc ? a[0] : INFINITY;
      u.fx[m] = load_acc ? a[tcells] : 0.0f;
      u.fy[m] = load_acc ? a[2 * tcells] : 0.0f;
      u.ed[m] = load_acc ? a[3 * tcells] : 0.0f;
      u.ew[m] = load_acc ? a[4 * tcells] : 0.0f;
      u.et[m] = load_acc ? a[5 * tcells] : 0.0f;
    } else {
      u.on[m] = load_acc ? __ldcg(acc.onset + g) : INFINITY;
      u.fx[m] = load_acc ? __ldcg(acc.fx + g) : 0.0f;
      u.fy[m] = load_acc ? __ldcg(acc.fy + g) : 0.0f;
      u.ed[m] = load_acc ? __ldcg(acc.ed + g) : 0.0f;
      u.ew[m] = load_acc ? __ldcg(acc.ew + g) : 0.0f;
      u.et[m] = load_acc ? __ldcg(acc.et + g) : 0.0f;
    }
  }
}

// Write back the tile cells: state for the next round (none after the
// last, out.p null); accumulators to global memory, or with kSharedAcc to
// the block's shared memory until the last round.
template <int R, bool kSharedAcc>
__device__ __forceinline__ void store_window(const Run<R>& u, const Edges& e,
                                             const Round& r, const State& out,
                                             const Acc& acc, float* as,
                                             int gi0, int gj0) {
  const int tcells = r.tile_x * r.tile_y;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if (!(u.interior & (1u << m))) continue;
    const int64_t g = (int64_t)(gi0 + e.i0 + m) * r.ny + gj0 + e.j;
    if (out.p != nullptr) {
      __stcg(out.p + g, u.p[m]);
      __stcg(out.vx + g, u.vx[m]);
      __stcg(out.vy + g, u.vy[m]);
    }
    if (kSharedAcc && out.p != nullptr) {
      float* a = as + (e.i0 + m - r.k) * r.tile_y + (e.j - r.k);
      a[0] = u.on[m];
      a[tcells] = u.fx[m];
      a[2 * tcells] = u.fy[m];
      a[3 * tcells] = u.ed[m];
      a[4 * tcells] = u.ew[m];
      a[5 * tcells] = u.et[m];
      continue;
    }
    __stcg(acc.onset + g, u.on[m]);
    __stcg(acc.fx + g, u.fx[m]);
    __stcg(acc.fy + g, u.fy[m]);
    __stcg(acc.ed + g, u.ed[m]);
    __stcg(acc.ew + g, u.ew[m]);
    __stcg(acc.et + g, u.et[m]);
  }
}

// All blocks of a cooperative launch wait here until every one arrives;
// their global writes before it are visible to all after it. bar[0] counts
// arrivals (back to 0 when the last arrives), bar[1] the generation.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The whole pass in one cooperative launch: block b steps the tiles b,
// b + gridDim.x, ... round after round, with a grid barrier between
// rounds. kSharedAcc: the tiles' accumulators stay in its shared memory
// (slot by slot, [6][tile cells] each) and reach global memory once, in the
// last round; else they are read and written in global memory every round.
// dry: every round runs 0 steps (its loads, fold and write-back alone).
template <int R, bool kSharedAcc>
__global__ void __launch_bounds__(kTiledThreads)
fdtd_tiled_kernel(Fold f, State s0, State s1, Acc acc,
                  const float* __restrict__ pulse, float* __restrict__ rec,
                  Round r, int T, int dry, unsigned* bar) {
  extern __shared__ float smem[];
  const Edges e = block_edges(smem, R);
  float* acc_s = e.col_vy + e.warps * e.rows;
  const int slot_floats = 6 * r.tile_x * r.tile_y;
  const State none{nullptr, nullptr, nullptr};
  const int rounds = (T + r.k - 1) / r.k;
  for (int c = 0; c < rounds; ++c) {
    const int nsteps = T - c * r.k < r.k ? T - c * r.k : r.k;  // last: T - c*k
    r.t0 = c * r.k;
    r.nsteps = dry ? 0 : nsteps;
    // copies, not references: a parameter's address would move it to
    // local memory
    const State in = (c & 1) ? s1 : s0;
    const State out = (c + 1 < rounds) ? ((c & 1) ? s0 : s1) : none;
    int slot = 0;
    for (int tile = blockIdx.x; tile < r.tiles; tile += gridDim.x, ++slot) {
      float* as = acc_s + slot * slot_floats;
      int gi0, gj0;
      window_origin(r, tile, gi0, gj0);
      Run<R> u;
      load_window<R, kSharedAcc>(u, e, r, f, in, acc, as, gi0, gj0);
      run_window<R>(u, e, r, gi0, gj0, pulse, rec);
      store_window<R, kSharedAcc>(u, e, r, out, acc, as, gi0, gj0);
    }
    if (c + 1 < rounds) grid_barrier(bar);
  }
}

// A thread owns one cell and walks its samples newest first, in reverse
// chunks of `chunk` steps, carrying the suffix EDC, s0 and s1 in registers
// across chunks. A warp's loads of one step are 128 coalesced bytes.
__global__ void __launch_bounds__(kMomRun)
rt60_moments_tiled_kernel(const float* __restrict__ rec,
                          const float* __restrict__ onset,
                          float* __restrict__ s0_out,
                          float* __restrict__ s1_out, int64_t n_cells, int T,
                          int chunk, float dry_n1, float end,
                          float log10_scale) {
  const int64_t c = (int64_t)blockIdx.x * kMomRun + threadIdx.x;
  if (c >= n_cells) return;
  const float* __restrict__ cell = rec + c;
  const float start = onset[c] + dry_n1;
  float edc = 0.0f;
  float s0 = 0.0f;
  float s1 = 0.0f;
  for (int t_lo = ((T - 1) / chunk) * chunk; t_lo >= 0; t_lo -= chunk) {
    const int t_hi = t_lo + chunk < T ? t_lo + chunk : T;
    // unrolled: several independent loads in flight per thread
#pragma unroll 8
    for (int t = t_hi - 1; t >= t_lo; --t) {
      const float p = cell[(int64_t)t * n_cells];
      edc = edc + p * p;  // suffix sum including the current sample
      const float y = logf(fmaxf(edc, 1e-37f)) * log10_scale;
      const float tf = (float)t;
      if (tf >= start && tf < end) {
        s0 = s0 + y;
        s1 = s1 + (tf - start) * y;
      }
    }
  }
  s0_out[c] = s0;
  s1_out[c] = s1;
}

// Shared memory of a block whose tiles' accumulators stay in it: the edges
// and the accumulator slots of its tiles.
size_t shared_acc_smem(const TiledLaunch& geo, int tiles, int blocks,
                       int tile_x, int tile_y) {
  const size_t per_block = (size_t)((tiles + blocks - 1) / blocks);
  return geo.smem + per_block * 6 * tile_x * tile_y * sizeof(float);
}

// The B3 pass: one cooperative launch of min(tiles, SMs) blocks, the
// accumulators in shared memory where a block's slots fit what the card
// lets it opt into (and not `global_acc`), else in global memory.
int launch_tiled(const float* beta, const float* Y, const float* pulse,
                 float* rec, float* onset, float* fx, float* fy, float* ed,
                 float* ew, float* et, float* p_a, float* vx_a, float* vy_a,
                 float* p_b, float* vx_b, float* vy_b, unsigned* bar, int nx,
                 int ny, int T, int tile_x, int tile_y, int k, int lix,
                 int liy, int gx, int gy, int absorbing, float courant,
                 float thr, float src_dir_n, float dry_n, float wet_n,
                 int dry, bool global_acc, cudaStream_t s) {
  Fold f{beta, Y};
  Acc acc{onset, fx, fy, ed, ew, et};
  State s0{p_a, vx_a, vy_a};
  State s1{p_b, vx_b, vy_b};
  // a listener outside the field injects nothing: move it out of every
  // window (window origins are >= -k)
  if (!(lix >= 0 && lix < nx && liy >= 0 && liy < ny)) lix = liy = -(1 << 30);
  const int tiles_y = (ny + tile_y - 1) / tile_y;
  const int tiles = tiles_y * ((nx + tile_x - 1) / tile_x);
  Round r{nx, ny, 0, 0, tile_x, tile_y, k, lix, liy, gx, gy, absorbing,
          tiles_y, tiles, courant, thr, src_dir_n, dry_n, wet_n};
  const TiledLaunch geo = tiled_launch(tile_x, tile_y, k);
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int blocks = tiles < sms ? tiles : sms;
  const size_t slots = shared_acc_smem(geo, tiles, blocks, tile_x, tile_y);
  const bool shared_acc = !global_acc && slots <= (size_t)optin;
  const void* kernel =
      shared_acc ? (const void*)fdtd_tiled_kernel<kRun, true>
                 : (const void*)fdtd_tiled_kernel<kRun, false>;
  const size_t smem = shared_acc ? slots : geo.smem;
  const int err = pv::set_smem(kernel, smem);
  if (err != 0) return err;
  void* args[] = {&f, &s0, &s1, &acc, &pulse, &rec, &r, &T, &dry, &bar};
  return pv::count_launch(
      pv::kFdtdTiledKernel,
      cudaLaunchCooperativeKernel(kernel, dim3(blocks), geo.block, args, smem,
                                  s));
}

}  // namespace

// beta, Y: the air flags and wall admittance (the kernel folds the stencil
// coefficients from them); bar: 2 zeroed words for the grid barrier. A
// tiling the kernel cannot hold (more threads than its bound) fails at
// launch, and the error is returned.
extern "C" int pv_fdtd_sim_tiled(
    const float* beta, const float* Y, const float* pulse, float* rec,
    float* onset, float* fx, float* fy, float* ed, float* ew, float* et,
    float* p_a, float* vx_a, float* vy_a, float* p_b, float* vx_b,
    float* vy_b, unsigned* bar, int nx, int ny, int T, int tile_x,
    int tile_y, int k, int lix, int liy, int gx, int gy, int absorbing,
    float courant, float thr, float src_dir_n, float dry_n, float wet_n,
    void* stream) {
  return launch_tiled(beta, Y, pulse, rec, onset, fx, fy, ed, ew, et, p_a,
                      vx_a, vy_a, p_b, vx_b, vy_b, bar, nx, ny, T, tile_x,
                      tile_y, k, lix, liy, gx, gy, absorbing, courant, thr,
                      src_dir_n, dry_n, wet_n, 0, false,
                      static_cast<cudaStream_t>(stream));
}

// pv_fdtd_sim_tiled with a probe's options, for probe_tiled.py and
// chip_smoke.py (the engine never takes them): dry != 0 runs every round's
// window loads, fold and write-back with no step (the recording is left
// unwritten); global_acc != 0 keeps the accumulators in global memory where
// they would fit shared memory.
extern "C" int pv_fdtd_sim_tiled_probe(
    const float* beta, const float* Y, const float* pulse, float* rec,
    float* onset, float* fx, float* fy, float* ed, float* ew, float* et,
    float* p_a, float* vx_a, float* vy_a, float* p_b, float* vx_b,
    float* vy_b, unsigned* bar, int nx, int ny, int T, int tile_x,
    int tile_y, int k, int lix, int liy, int gx, int gy, int absorbing,
    float courant, float thr, float src_dir_n, float dry_n, float wet_n,
    int dry, int global_acc, void* stream) {
  return launch_tiled(beta, Y, pulse, rec, onset, fx, fy, ed, ew, et, p_a,
                      vx_a, vy_a, p_b, vx_b, vy_b, bar, nx, ny, T, tile_x,
                      tile_y, k, lix, liy, gx, gy, absorbing, courant, thr,
                      src_dir_n, dry_n, wet_n, dry, global_acc != 0,
                      static_cast<cudaStream_t>(stream));
}
extern "C" int pv_rt60_moments_tiled(const float* rec, const float* onset,
                                     float* s0, float* s1, int nx, int ny,
                                     int T, int chunk, float dry_n1,
                                     float end, float log10_scale,
                                     void* stream) {
  const int64_t n_cells = (int64_t)nx * ny;
  const int grid = (int)((n_cells + kMomRun - 1) / kMomRun);
  rt60_moments_tiled_kernel<<<grid, kMomRun, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      rec, onset, s0, s1, n_cells, T, chunk, dry_n1, end, log10_scale);
  return pv::count_launch(pv::kRt60MomentsTiledKernel);
}
