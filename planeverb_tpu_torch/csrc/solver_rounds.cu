// Sharded fused rounds (B5) and banded sharded rounds (B6) for Hopper: one
// round of the sharded engine on one shard.
//
// B5 `sharded_round` replaces
// planeverb_tpu/parallel/solver_pallas.py::_round_kernel, in the plain
// rounds and in the overlap split's frame and interior launches
// (_overlap_impl).
// B6 `banded_round` replaces
// planeverb_tpu/parallel/solver_pallas.py::_banded_round_kernel, likewise
// (_overlap_banded_impl).
//
// A shard owns a bx x by interior of the global field. Before each round the
// host exchanges ghosts, so the kernel reads the shard's extended block: the
// interior with kx ghost rows and ky ghost columns on each side (B6: k on
// both axes), zeros beyond the global edge. One launch advances the shard
// `nsteps` steps (k, or T - t0 in the last round), records the interior's
// pre-injection pressure into rows [t0, t0 + nsteps) of the shard's
// [T, bx, by] recording, streams its six accumulators (onset, flux,
// windowed energies; updated in place) and writes the interior's new state
// (p after this round's last injection, vx, vy) into a [3, bx, by] buffer.
//
// Row windows (the overlap split): a launch may advance only `rows` of the
// shard's bx rows, in one or two windows on blockIdx.z. Window z is an
// extended block of rows + 2 kx rows, stacked after window z - 1 in the
// planes and state arrays; its interior lands on rows row0 + z * out_stride
// of the shard's recording, accumulators and new state, in place, and its
// global row origin (B6) moves by the same z * out_stride. The split's frame
// launch is two windows of 3k rows ([ghost k | rows 0:2k] and
// [rows bx-2k:bx | ghost k], k rows each, out_stride bx - k); its interior
// launch one window of the shard's bx rows advancing rows [k, bx - k). So
// the launches of a round fill disjoint rows of one recording, and nothing
// is concatenated after them. The plain round is one window with
// rows = bx and row0 = 0.
//
// No SM holds a shard's extended planes, so the kernel tiles the interior
// as fdtd_tiled.cu's B3 round does: a block owns a tile_x x tile_y interior
// tile and keeps its window (the tile plus a `halo`-cell border, halo >=
// nsteps) in shared memory, with the tile's accumulators. The stencil
// reaches one cell per step, so after nsteps <= halo local steps the tile
// interior is exact, whatever the window's border held: this cone argument
// is what lets each block ignore its neighbours for a round, as it lets the
// shard ignore its neighbours between exchanges. Window cells outside the
// extended block load zeros: on an unsharded axis (no ghosts) they are the
// zero padding beyond the global edge, and on a ragged tile they lie more
// than halo cells from any interior cell.
//   - B5 (kFold = false) reads the eight planes folded once per simulation
//     on the extended block in global coordinates: beta, A/B/D in x and y,
//     and the listener mask.
//   - B6 (kFold = true) reads only beta and the wall admittance Y and folds
//     the six coefficients in shared memory (common.cuh fold_cell, as B3
//     does) from the window's own backward shifts (zero at the window's
//     first row and column) and the global coordinates of its cells; the
//     listener mask is the test gi == lix &&
//     gj == liy. The fold's wrong values at the window's first row and
//     column are again outside the cone of the tile interior.
//   - A step is the pressure update over the window, a barrier, the
//     velocity update with the interior's accumulators and recording, a
//     barrier. The pulse of step t-1 is added (src * pulse, every cell) to
//     the pressure at the start of step t, by each cell's own thread, so the
//     velocity phase reads pre-injection pressure without an extra barrier;
//     the write-back adds the round's last pulse. The listener's copies in
//     the ghosts of neighbouring shards are injected the same way.
// What bounds it on this card: like B3, the latency of the shared-memory
// stencil and its two barriers a step, over windows (tile + 2 halo)^2 that
// at halo 16 are 2.25-9x the tile; the shard's launches run one after
// another on the caller's stream. B6 adds the fold's ~40 operations a window
// cell once a round and reads 5 planes a round against B5's 11. Blocks for
// several shards in one launch, clusters sharing halos and the host's
// exchange on the device are the follow-ups.
//
// Numerics: built with -fmad=false and without fast math; every expression
// in the order of the plain PyTorch versions (parallel/solver_fused.py,
// ops/fdtd.py::stencil_coefficients), so each op rounds once as PyTorch's
// elementwise kernels do. Recording offsets are 64-bit.
//
// Launchers allocate nothing, never synchronise, count their launches
// (common.cuh) and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// Most threads in a block (caps ptxas at 64 registers a thread).
constexpr int kMaxThreads = 1024;
// p, vx, vy, beta, ax, bx, dx, ay, by, dy and the listener mask (B5) or Y
// (B6).
constexpr int kPlanes = 11;
constexpr int kAccPlanes = 6;  // onset, fx, fy, ed, ew, et of the tile

// ex = rows + 2 kx, ey = by + 2 ky, nwin = gridDim.z windows
struct Round {
  const float* __restrict__ planes;  // B5: [8][nwin*ex*ey]; B6: [2][...]
  const float* __restrict__ state;   // [3][nwin*ex*ey]: extended p, vx, vy
  const float* __restrict__ pulse;   // [T]
  float* __restrict__ rec;           // [T][bx*by], rows written in place
  float* __restrict__ acc;           // [6][bx*by], in place
  float* __restrict__ state_out;     // [3][bx*by]: p, vx, vy, in place
  int rows, by;                      // interior of each window
  int kx, ky;                        // ghost widths of each window
  int bx;                            // the shard's rows (output arrays)
  int row0, out_stride;              // window z's rows start at
                                     // row0 + z * out_stride
  int t0, nsteps, halo;              // first step, steps, window border
  int tile_x, tile_y;
  // B6 only: global coordinates of window 0's extended cell (0, 0), the
  // listener, the analysis grid's edges and the boundary type
  int gi0, gj0, lix, liy, gx, gy, absorbing;
  float courant, thr, src_dir_n, dry_n, wet_n;
};

size_t round_smem_bytes(int tile_x, int tile_y, int halo) {
  const size_t window = (size_t)(tile_x + 2 * halo) * (tile_y + 2 * halo);
  return (kPlanes * window + kAccPlanes * (size_t)tile_x * tile_y) *
         sizeof(float);
}

template <bool kFold>
__global__ void __launch_bounds__(kMaxThreads) round_kernel(Round r) {
  extern __shared__ float smem[];
  const int h = r.halo;
  const int wx = r.tile_x + 2 * h;
  const int wy = r.tile_y + 2 * h;
  const int wcells = wx * wy;
  const int tcells = r.tile_x * r.tile_y;
  float* sp = smem;
  float* svx = sp + wcells;
  float* svy = svx + wcells;
  float* sbeta = svy + wcells;
  float* sax = sbeta + wcells;
  float* sbx = sax + wcells;
  float* sdx = sbx + wcells;
  float* say = sdx + wcells;
  float* sby = say + wcells;
  float* sdy = sby + wcells;
  float* s11 = sdy + wcells;   // B5: listener mask; B6: Y during the fold
  float* a_on = s11 + wcells;  // tile accumulators, [6][tile_x * tile_y]
  float* a_fx = a_on + tcells;
  float* a_fy = a_fx + tcells;
  float* a_ed = a_fy + tcells;
  float* a_ew = a_ed + tcells;
  float* a_et = a_ew + tcells;

  const int ex = r.rows + 2 * r.kx;  // this window's extended block
  const int ey = r.by + 2 * r.ky;
  const int z = (int)blockIdx.z;       // the row window
  const int64_t wplane = (int64_t)ex * ey;
  const int64_t eplane = wplane * gridDim.z;  // a plane of every window
  const float* __restrict__ planes = r.planes + z * wplane;
  const float* __restrict__ state = r.state + z * wplane;
  const int64_t iplane = (int64_t)r.bx * r.by;
  const int orow = r.row0 + z * r.out_stride;  // shard row of interior row 0
  const int gi0 = r.gi0 + z * r.out_stride;    // B6: global row of ext row 0
  const int ti0 = blockIdx.y * r.tile_x;  // tile origin, interior coords
  const int tj0 = blockIdx.x * r.tile_y;
  const int ei0 = ti0 + r.kx - h;         // window origin, extended coords
  const int ej0 = tj0 + r.ky - h;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // -- load the window; cells outside the extended block are 0 everywhere
  for (int w = tid; w < wcells; w += nthreads) {
    const int ei = ei0 + w / wy;
    const int ej = ej0 + w % wy;
    const bool in = ei >= 0 && ei < ex && ej >= 0 && ej < ey;
    const int64_t g = (int64_t)ei * ey + ej;
    sp[w] = in ? state[g] : 0.0f;
    svx[w] = in ? state[eplane + g] : 0.0f;
    svy[w] = in ? state[2 * eplane + g] : 0.0f;
    sbeta[w] = in ? planes[g] : 0.0f;
    if (kFold) {
      s11[w] = in ? planes[eplane + g] : 0.0f;
    } else {
      sax[w] = in ? planes[1 * eplane + g] : 0.0f;
      sbx[w] = in ? planes[2 * eplane + g] : 0.0f;
      sdx[w] = in ? planes[3 * eplane + g] : 0.0f;
      say[w] = in ? planes[4 * eplane + g] : 0.0f;
      sby[w] = in ? planes[5 * eplane + g] : 0.0f;
      sdy[w] = in ? planes[6 * eplane + g] : 0.0f;
      s11[w] = in ? planes[7 * eplane + g] : 0.0f;
    }
  }
  // -- and the tile's accumulators
  for (int w = tid; w < tcells; w += nthreads) {
    const int ii = ti0 + w / r.tile_y;
    const int jj = tj0 + w % r.tile_y;
    const bool in = ii < r.rows && jj < r.by;
    const int64_t g = (int64_t)(orow + ii) * r.by + jj;
    a_on[w] = in ? r.acc[g] : INFINITY;
    a_fx[w] = in ? r.acc[iplane + g] : 0.0f;
    a_fy[w] = in ? r.acc[2 * iplane + g] : 0.0f;
    a_ed[w] = in ? r.acc[3 * iplane + g] : 0.0f;
    a_ew[w] = in ? r.acc[4 * iplane + g] : 0.0f;
    a_et[w] = in ? r.acc[5 * iplane + g] : 0.0f;
  }
  __syncthreads();

  // -- B6: fold the coefficients in the window (ops/fdtd.py
  // stencil_coefficients, with the window's zero-filled backward shifts)
  if (kFold) {
    for (int w = tid; w < wcells; w += nthreads) {
      const int wi = w / wy;
      const int wj = w % wy;
      const float beta = sbeta[w];
      const float Y = s11[w];
      const float b_xm = wi > 0 ? sbeta[w - wy] : 0.0f;
      const float y_xm = wi > 0 ? s11[w - wy] : 0.0f;
      const float b_ym = wj > 0 ? sbeta[w - 1] : 0.0f;
      const float y_ym = wj > 0 ? s11[w - 1] : 0.0f;
      const pv::Folded k = pv::fold_cell(
          beta, Y, b_xm, y_xm, b_ym, y_ym, gi0 + ei0 + wi, r.gj0 + ej0 + wj,
          r.gx, r.gy, r.absorbing != 0);
      sax[w] = k.ax;
      sbx[w] = k.bx;
      sdx[w] = k.dx;
      say[w] = k.ay;
      sby[w] = k.by;
      sdy[w] = k.dy;
    }
    __syncthreads();
  }

  // this thread's cells: window column j, rows threadIdx.y + m * blockDim.y
  const int j = threadIdx.x;
  const int gj_src = r.gj0 + ej0 + j;  // B6: the column's global index
  const bool col_interior = j >= h && j < h + r.tile_y && tj0 + j - h < r.by;
  for (int s = 0; s < r.nsteps; ++s) {
    const int t = r.t0 + s;
    const float inj = s > 0 ? r.pulse[t - 1] : 0.0f;

    // -- pressure: p = beta * (p_old - C * div v), p_old with the pending
    // injection of step t-1
    for (int i = threadIdx.y; i < wx; i += blockDim.y) {
      const int c = i * wy + j;
      float pv = sp[c];
      if (s > 0) {
        const float src = kFold ? ((gi0 + ei0 + i == r.lix &&
                                    gj_src == r.liy) ? 1.0f : 0.0f)
                                : s11[c];
        pv = pv + src * inj;
      }
      const float vxc = svx[c];
      const float vyc = svy[c];
      const float vx_xp = (i + 1 < wx) ? svx[c + wy] : 0.0f;
      const float vy_yp = (j + 1 < wy) ? svy[c + 1] : 0.0f;
      const float div = (vx_xp - vxc) + (vy_yp - vyc);
      sp[c] = sbeta[c] * (pv - r.courant * div);
    }
    __syncthreads();

    // -- velocities, then the interior's accumulators and its
    // pre-injection recording; window bounds are small-integer-valued, so
    // exact in f32
    const float tf = (float)t;
    const float c_flux = tf - r.src_dir_n;
    const float c_dry = tf - r.dry_n;
    const float c_wet_lo = tf - r.dry_n - 1.0f;
    const float c_wet_hi = tf - r.dry_n - 1.0f - r.wet_n;
    float* rec_t = r.rec + (int64_t)t * iplane;
    for (int i = threadIdx.y; i < wx; i += blockDim.y) {
      const int c = i * wy + j;
      const float p = sp[c];
      const float p_xm = (i > 0) ? sp[c - wy] : 0.0f;
      const float p_ym = (j > 0) ? sp[c - 1] : 0.0f;
      float air = svx[c] - r.courant * (p - p_xm);
      const float vx = sax[c] * air + sbx[c] * p + sdx[c] * p_xm;
      air = svy[c] - r.courant * (p - p_ym);
      const float vy = say[c] * air + sby[c] * p + sdy[c] * p_ym;
      svx[c] = vx;
      svy[c] = vy;
      if (col_interior && i >= h && i < h + r.tile_x &&
          ti0 + i - h < r.rows) {
        const int a = (i - h) * r.tile_y + (j - h);
        const float onset = fminf(a_on[a], fabsf(p) > r.thr ? tf : INFINITY);
        const float mp = (onset > c_flux) ? p : 0.0f;
        a_on[a] = onset;
        a_fx[a] = a_fx[a] + mp * vx;
        a_fy[a] = a_fy[a] + mp * vy;
        const float sq = p * p;
        if (onset > c_dry) a_ed[a] = a_ed[a] + sq;
        if (onset <= c_wet_lo && onset > c_wet_hi) a_ew[a] = a_ew[a] + sq;
        a_et[a] = a_et[a] + sq;
        rec_t[(int64_t)(orow + ti0 + i - h) * r.by + (tj0 + j - h)] = p;
      }
    }
    __syncthreads();
  }

  // -- write back the tile's in-shard cells: the new state (p with the
  // round's last injection) and the accumulators
  const float inj = r.pulse[r.t0 + r.nsteps - 1];
  for (int w = tid; w < tcells; w += nthreads) {
    const int ii = w / r.tile_y;
    const int jj = w % r.tile_y;
    if (ti0 + ii >= r.rows || tj0 + jj >= r.by) continue;
    const int64_t g = (int64_t)(orow + ti0 + ii) * r.by + (tj0 + jj);
    const int c = (ii + h) * wy + (jj + h);
    const float src = kFold ? ((gi0 + ei0 + ii + h == r.lix &&
                                r.gj0 + ej0 + jj + h == r.liy) ? 1.0f : 0.0f)
                            : s11[c];
    r.state_out[g] = sp[c] + src * inj;
    r.state_out[iplane + g] = svx[c];
    r.state_out[2 * iplane + g] = svy[c];
    r.acc[g] = a_on[w];
    r.acc[iplane + g] = a_fx[w];
    r.acc[2 * iplane + g] = a_fy[w];
    r.acc[3 * iplane + g] = a_ed[w];
    r.acc[4 * iplane + g] = a_ew[w];
    r.acc[5 * iplane + g] = a_et[w];
  }
}

template <bool kFold>
int launch_round(const Round& r, int nwin, void* stream) {
  const int wx = r.tile_x + 2 * r.halo;
  const int wy = r.tile_y + 2 * r.halo;
  // one thread per window column, as many row strides as fit; a window the
  // card cannot hold (wider than 1024 columns, or beyond the shared memory
  // limit) fails at launch, and the error is returned
  const int rows = kMaxThreads / wy;
  const dim3 block(wy, rows < 1 ? 1 : (rows < wx ? rows : wx));
  const dim3 grid((r.by + r.tile_y - 1) / r.tile_y,
                  (r.rows + r.tile_x - 1) / r.tile_x, nwin);
  const size_t smem = round_smem_bytes(r.tile_x, r.tile_y, r.halo);
  const int err = pv::set_smem((const void*)round_kernel<kFold>, smem);
  if (err != 0) return err;
  round_kernel<kFold><<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(r);
  return pv::count_launch(kFold ? pv::kBandedRoundKernel
                                : pv::kShardedRoundKernel);
}

}  // namespace

// rows, nwin, bx, row0, out_stride: the row windows above (the plain round:
// rows = bx, nwin = 1, row0 = out_stride = 0)
extern "C" int pv_sharded_round(
    const float* planes, const float* state, const float* pulse,
    float* rec, float* acc, float* state_out, int rows, int by, int kx,
    int ky, int nwin, int bx, int row0, int out_stride, int t0, int nsteps,
    int halo, int tile_x, int tile_y, float courant, float thr,
    float src_dir_n, float dry_n, float wet_n, void* stream) {
  const Round r{planes, state,  pulse,  rec,    acc,     state_out,
                rows,   by,     kx,     ky,     bx,      row0,
                out_stride,     t0,     nsteps, halo,    tile_x,
                tile_y, 0,      0,      0,      0,       0,
                0,      0,      courant, thr,   src_dir_n, dry_n, wet_n};
  return launch_round<false>(r, nwin, stream);
}

extern "C" int pv_banded_round(
    const float* fields, const float* state, const float* pulse,
    float* rec, float* acc, float* state_out, int rows, int by, int k,
    int nwin, int bx, int row0, int out_stride, int t0, int nsteps,
    int tile_x, int tile_y, int gi0, int gj0, int lix, int liy, int gx,
    int gy, int absorbing, float courant, float thr, float src_dir_n,
    float dry_n, float wet_n, void* stream) {
  const Round r{fields, state,  pulse,  rec,    acc,     state_out,
                rows,   by,     k,      k,      bx,      row0,
                out_stride,     t0,     nsteps, k,       tile_x,
                tile_y, gi0,    gj0,    lix,    liy,     gx,
                gy,     absorbing, courant, thr, src_dir_n, dry_n, wet_n};
  return launch_round<true>(r, nwin, stream);
}
