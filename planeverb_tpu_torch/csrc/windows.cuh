// B3's register-resident windows for Hopper, shared by the temporally
// blocked simulation (fdtd_tiled.cu, B3) and the sharded rounds
// (solver_rounds.cu, B5/B6).
//
// A block of kRun-row runs advances one window: a tile of tile_x x tile_y
// cells plus a k-cell border on every side, for at most k steps. The
// stencil reaches one cell per step, so the tile's cells come out exact
// whatever the border held. A thread owns one window column (lane =
// column, so a warp's loads and stores of a row are consecutive addresses)
// and a run of kRun consecutive rows: p, vx, vy and the seven folded
// coefficients (beta, A/B/D in x and y) of its cells, and the six
// accumulators (onset, flux, windowed energies) of those that are recorded,
// sit in registers for the whole (sub-)round, loaded once and stored once.
// The row neighbour is the thread's next or previous register; the column
// neighbour comes from the next or previous lane by __shfl_sync (every lane
// takes part, lanes past the window's edge too). Only the rows at the ends
// of a run and the columns at the edges of a warp go through shared memory,
// a few KB a block, behind the two block barriers of a step.
//
// The window lies in a block of cells [0, ex) x [0, ey) (B3: the field; a
// round: a shard's ghost-extended block or a row window of it). Window
// cells outside the block load zero state, beta and Y and so stay 0: they
// play the zero padding beyond the block. The window reads two static
// planes, beta and the wall admittance Y, and folds the seven coefficients
// in registers (common.cuh fold_cell) by global cell index: a neighbour
// before the window's first row or column folds as 0, which is wrong only
// in the border, where k steps do not carry it into the tile. The
// listener's pulse of step t-1 is added to its cell's pressure at the start
// of step t, in every window that holds the listener cell, border copies
// included; the recorded pressure is the pre-injection one.
//
// Callers say where each of a thread's cells lives with an index of its
// first row (the cell (i0, j) of its run) and a row stride, for the
// static planes and the window's state (g0, srow) and for the accumulators
// (a0, arow: the cell's offset in a [nx * ny] plane); the recording is
// addressed by global cell.
//
// Numerics: every expression in the order of the plain PyTorch versions
// (ops/_common.py, ops/fdtd.py); the sources build with -fmad=false and
// without fast math, so each op rounds once as PyTorch's do.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace pv {

// Rows of a thread's run, and the most threads in a block: the bound lets
// ptxas give each thread the registers of its kRun cells' values and
// accumulators (up to 128 a thread).
constexpr int kRun = 4;
constexpr int kWindowThreads = 512;

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

// What a window's steps read: its shape, the (sub-)round's steps and the
// engine's scalars.
struct Stepping {
  int tile_x, tile_y;  // the window's tile
  int k;               // its border (and the most steps it may take)
  int t0, nsteps;      // first step, steps
  int inj0;            // a round's steps t > inj0 inject the pulse of step
                       // t - 1 (run_window's kRound)
  int lix, liy;        // listener cell, global (outside every window when
                       // absent)
  int gx, gy;          // analysis grid: the edge rows and columns of the fold
  int absorbing;       // edge ABC (else rigid outer walls)
  float courant, thr, src_dir_n, dry_n, wet_n;
};

// A block: one thread a window column (rounded up to whole warps) and a run
// of kRun rows; its dynamic shared memory holds the run and warp edges.
struct WindowLaunch {
  dim3 block;
  size_t smem;
};

inline WindowLaunch window_launch(int tile_x, int tile_y, int k) {
  const int wx = tile_x + 2 * k;
  const int wy = tile_y + 2 * k;
  const int lanes = (wy + 31) / 32 * 32;
  const int trows = (wx + kRun - 1) / kRun;
  const size_t edges = 2 * (size_t)trows * lanes +
                       2 * (size_t)(lanes / 32) * trows * kRun;
  return {dim3(lanes, trows), edges * sizeof(float)};
}

// Shared memory of a block whose windows' accumulators stay in it: the
// edges and a [6][tile cells] slot for each of its `per_block` tiles.
inline size_t shared_acc_smem(const WindowLaunch& geo, int per_block,
                              int tile_x, int tile_y) {
  return geo.smem + (size_t)per_block * 6 * tile_x * tile_y * sizeof(float);
}

// One thread's part of a window: column j of the window, rows i0 .. i0+R-1.
// The values of its cells, the seven folded coefficients and the six
// accumulators of its recorded cells live in registers.
template <int R>
struct Run {
  float p[R], vx[R], vy[R];
  float c[7][R];       // beta, ax, bx, dx, ay, by, dy
  float y[R];          // the wall admittance, until the fold
  float on[R], fx[R], fy[R], ed[R], ew[R], et[R];
  unsigned interior;   // bit m: row i0 + m is a recorded tile cell
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

// The shared memory after the edges: the accumulator slots.
__device__ __forceinline__ float* acc_slots(const Edges& e) {
  return e.col_vy + e.warps * e.rows;
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
// row or column is 0, so the fold is wrong there, in the border, and k
// steps do not carry that into the tile), then advance the window r.nsteps
// steps, recording and accumulating its recorded cells: the sample of
// step t of global cell (gi, gj) goes to rec[t * plane + gi * arow + gj]
// (rec is the recording's base shifted so, for a shard's recording).
// (gi0, gj0) is the window's global origin. kRound: the window starts a
// sharded round, from a state injected up to step r.inj0 - 1, so steps
// t > r.inj0 inject; else (B3) every step t > 0 does. beta and Y, p and
// the velocities of row i-1 / i+1 are the next register or the neighbour
// run's edge row; of column j-1 / j+1 the neighbour lane's (__shfl_sync,
// every lane taking part), or the neighbour warp's edge column. Two block
// barriers a step.
template <int R, bool kRound = false>
__device__ __forceinline__ void run_window(Run<R>& u, const Edges& e,
                                           const Stepping& r, int gi0,
                                           int gj0,
                                           const float* __restrict__ pulse,
                                           float* __restrict__ rec,
                                           int64_t plane, int arow) {
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
      const Folded k = fold_cell(beta, Y, b_xm, y_xm, b_ym, y_ym, gi0 + i,
                                 gj, r.gx, r.gy, r.absorbing != 0);
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
    const bool injects = t > (kRound ? r.inj0 : 0);
    const float inj = injects ? pulse[t - 1] : 0.0f;

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
      if (injects && m == inject) pv = pv + inj;
      const float vx_xp =
          (i + 1 < wx) ? (m + 1 < R ? u.vx[m + 1] : vx_below) : 0.0f;
      const float vy_yp = (j + 1 < wy) ? vy_right : 0.0f;
      const float div = (vx_xp - u.vx[m]) + (vy_yp - u.vy[m]);
      u.p[m] = u.c[0][m] * (pv - r.courant * div);
    }
    publish_down<R>(e, u.p, e.row_p, e.col_p);
    __syncthreads();

    // -- velocities (walls + edge ABC folded), then the recorded cells'
    // streaming accumulators and pre-injection recording; window bounds
    // are small-integer-valued, so exact in f32
    const float tf = (float)t;
    const float c_flux = tf - r.src_dir_n;
    const float c_dry = tf - r.dry_n;
    const float c_wet_lo = tf - r.dry_n - 1.0f;
    const float c_wet_hi = tf - r.dry_n - 1.0f - r.wet_n;
    float* rec_t = rec + (int64_t)t * plane;
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
        rec_t[(int64_t)(gi0 + i) * arow + gj] = pc;
      }
    }
    publish_velocities<R>(e, u);
    __syncthreads();
  }
}

// Which of this thread's cells lie in the block [0, ex) x [0, ey) (bit m of
// the result: they load), and sets u.interior to those that are tile cells
// in the recorded range [ri0, ri1) x [rj0, rj1). (li0, lj0): the window's
// origin in block coordinates.
template <int R>
__device__ __forceinline__ unsigned cell_masks(Run<R>& u, const Edges& e,
                                               const Stepping& r, int li0,
                                               int lj0, int ex, int ey,
                                               int ri0, int ri1, int rj0,
                                               int rj1) {
  const int wx = r.tile_x + 2 * r.k;
  const int wy = r.tile_y + 2 * r.k;
  const int lj = lj0 + e.j;
  const bool col_in = e.j < wy && lj >= 0 && lj < ey;
  const bool col_tile = e.j >= r.k && e.j < r.k + r.tile_y && lj >= rj0 &&
                        lj < rj1;
  unsigned field = 0;
  u.interior = 0;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = e.i0 + m;
    const int li = li0 + i;
    const bool in = col_in && i < wx && li >= 0 && li < ex;
    const bool tile = col_tile && i >= r.k && i < r.k + r.tile_x &&
                      li >= ri0 && li < ri1;
    field |= (in ? 1u : 0u) << m;
    u.interior |= (tile ? 1u : 0u) << m;
  }
  return field;
}

// Where a window's accumulators come from at its load, and go to at its
// store: at rest (onset +inf, the rest 0; load only), the block's shared
// memory slot ([6][tile cells]), or global memory.
enum AccPlace : int { kAccRest = 0, kAccShared, kAccGlobal };

// Load this thread's cells: beta and Y at f + g0 + m * srow, and the state
// from state_at(m, in_block), which sets u.p[m], u.vx[m] and u.vy[m] (0
// outside the block). The accumulators of recorded cells from `from`:
// the slot `as`, or global memory at a0 + m * arow (read past L1: other
// SMs wrote them in this launch).
template <int R, class StateAt>
__device__ __forceinline__ void load_window(Run<R>& u, const Edges& e,
                                            const Stepping& r,
                                            unsigned field, const Fold& f,
                                            int64_t g0, int srow,
                                            const Acc& acc, int64_t a0,
                                            int arow, const float* as,
                                            AccPlace from, StateAt state_at) {
  const int tcells = r.tile_x * r.tile_y;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const bool in_field = field & (1u << m);
    const int64_t g = g0 + (int64_t)m * srow;
    state_at(m, in_field);
    u.c[0][m] = in_field ? f.beta[g] : 0.0f;
    u.y[m] = in_field ? f.Y[g] : 0.0f;
    const bool tile = u.interior & (1u << m);
    // one branch for the slot and the rest state: on an H100 this keeps
    // B3 as fast as its own copy of the machinery was (PERF.md)
    if (from != kAccGlobal) {
      const bool load = tile && from == kAccShared;
      const float* a = as + (e.i0 + m - r.k) * r.tile_y + (e.j - r.k);
      u.on[m] = load ? a[0] : INFINITY;
      u.fx[m] = load ? a[tcells] : 0.0f;
      u.fy[m] = load ? a[2 * tcells] : 0.0f;
      u.ed[m] = load ? a[3 * tcells] : 0.0f;
      u.ew[m] = load ? a[4 * tcells] : 0.0f;
      u.et[m] = load ? a[5 * tcells] : 0.0f;
    } else {
      const int64_t c = a0 + (int64_t)m * arow;
      u.on[m] = tile ? __ldcg(acc.onset + c) : INFINITY;
      u.fx[m] = tile ? __ldcg(acc.fx + c) : 0.0f;
      u.fy[m] = tile ? __ldcg(acc.fy + c) : 0.0f;
      u.ed[m] = tile ? __ldcg(acc.ed + c) : 0.0f;
      u.ew[m] = tile ? __ldcg(acc.ew + c) : 0.0f;
      u.et[m] = tile ? __ldcg(acc.et + c) : 0.0f;
    }
  }
}

// Write back: the state of the cells in `state_mask` to out + g0 + m *
// srow (none where out.p is null), with `inj` added to the pressure of run
// row inj_m (the listener's cell of a round's last step; -1: none), written
// past L1; the accumulators of the recorded cells to `to`: the slot `as`,
// or global memory at a0 + m * arow.
template <int R>
__device__ __forceinline__ void store_window(const Run<R>& u, const Edges& e,
                                             const Stepping& r,
                                             unsigned state_mask,
                                             const State& out, int64_t g0,
                                             int srow, int inj_m, float inj,
                                             const Acc& acc, int64_t a0,
                                             int arow, float* as,
                                             AccPlace to) {
  const int tcells = r.tile_x * r.tile_y;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if (out.p != nullptr && (state_mask & (1u << m))) {
      const int64_t g = g0 + (int64_t)m * srow;
      __stcg(out.p + g, m == inj_m ? u.p[m] + inj : u.p[m]);
      __stcg(out.vx + g, u.vx[m]);
      __stcg(out.vy + g, u.vy[m]);
    }
    if (!(u.interior & (1u << m))) continue;
    if (to == kAccShared) {
      float* a = as + (e.i0 + m - r.k) * r.tile_y + (e.j - r.k);
      a[0] = u.on[m];
      a[tcells] = u.fx[m];
      a[2 * tcells] = u.fy[m];
      a[3 * tcells] = u.ed[m];
      a[4 * tcells] = u.ew[m];
      a[5 * tcells] = u.et[m];
      continue;
    }
    const int64_t c = a0 + (int64_t)m * arow;
    __stcg(acc.onset + c, u.on[m]);
    __stcg(acc.fx + c, u.fx[m]);
    __stcg(acc.fy + c, u.fy[m]);
    __stcg(acc.ed + c, u.ed[m]);
    __stcg(acc.ew + c, u.ew[m]);
    __stcg(acc.et + c, u.et[m]);
  }
}

// All blocks of a cooperative launch wait here until every one arrives;
// their global writes before it are visible to all after it. bar[0] counts
// arrivals and returns to 0 when the last arrives, bar[1] is the
// generation, which only changes: so the two words serve launch after
// launch without being zeroed again.
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

// Whether a card's blocks can hold `per_block` tiles' accumulator slots
// beside the edges, and the shared memory the launch then takes.
inline bool acc_fits(const WindowLaunch& geo, int per_block, int tile_x,
                     int tile_y, size_t* smem) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t slots = shared_acc_smem(geo, per_block, tile_x, tile_y);
  const bool fits = slots <= (size_t)optin;
  *smem = fits ? slots : geo.smem;
  return fits;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace pv
