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
//   - The window lives in registers (windows.cuh, shared with the sharded
//     rounds of solver_rounds.cu): a thread owns one window column and a
//     run of 4 rows, neighbours come from registers, __shfl_sync or the
//     run and warp edges in shared memory, behind two block barriers a
//     step, and the coefficients are folded in the kernel from beta and Y.
//   - State is double-buffered in global memory by round parity: round c
//     reads slot c%2 and writes slot (c+1)%2; the grid barrier keeps any
//     block from reading a cell another block writes in the same round.
//     Its two words return to their rest state at every barrier, so the
//     engine keeps one pair a card and never zeroes it again.
//   - The stored state is the pre-injection pressure; every window holding
//     the listener cell injects it (windows.cuh). Window cells outside the
//     field load zero and play the reference's zero padding.
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
//   accumulators in global memory their six planes read and written).
//   The grid barrier makes every round wait for the busiest SM, so a pass
//   costs its rounds times that SM's windows: the caller chooses the tile
//   and k by field shape (ops/fdtd_tiled.py plan_tiled; at 964^2 22 x 54
//   at k = 5, 792 = 6 x 132 windows, no SM stepping an extra window in any
//   round). There rounds of 0 steps (pv_fdtd_sim_tiled_probe's `dry`) take
//   about 37 % of a pass, and a window's step is mostly latency: two block
//   barriers and the shuffles (PERF.md).
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

#include "windows.cuh"

namespace {

using pv::Acc;
using pv::Fold;
using pv::State;

// Cells per B4 block, one thread each (B2's block size).
constexpr int kMomRun = 128;

// A B3 round: the window machinery's stepping, and the field and its tiles
struct Round : pv::Stepping {
  int nx, ny;          // field
  int tiles_y;         // tiles along y (tile t is row t / tiles_y)
  int tiles;           // tiles in the field
};

// The whole pass in one cooperative launch: block b steps the tiles b,
// b + gridDim.x, ... round after round, with a grid barrier between
// rounds. kSharedAcc: the tiles' accumulators stay in its shared memory
// (slot by slot, [6][tile cells] each) and reach global memory once, in the
// last round; else they are read and written in global memory every round.
// dry: every round runs 0 steps (its loads, fold and write-back alone).
template <int R, bool kSharedAcc>
__global__ void __launch_bounds__(pv::kWindowThreads)
fdtd_tiled_kernel(Fold f, State s0, State s1, Acc acc,
                  const float* __restrict__ pulse, float* __restrict__ rec,
                  Round r, int T, int dry, unsigned* bar) {
  extern __shared__ float smem[];
  const pv::Edges e = pv::block_edges(smem, R);
  float* acc_s = pv::acc_slots(e);
  const int slot_floats = 6 * r.tile_x * r.tile_y;
  const State none{nullptr, nullptr, nullptr};
  const int64_t plane = (int64_t)r.nx * r.ny;
  const int rounds = (T + r.k - 1) / r.k;
  for (int c = 0; c < rounds; ++c) {
    const int nsteps = T - c * r.k < r.k ? T - c * r.k : r.k;  // last: T - c*k
    r.t0 = c * r.k;
    r.nsteps = dry ? 0 : nsteps;
    // copies, not references: a parameter's address would move it to
    // local memory
    const State in = (c & 1) ? s1 : s0;
    const State out = (c + 1 < rounds) ? ((c & 1) ? s0 : s1) : none;
    const bool first = c == 0;
    const pv::AccPlace from =
        first ? pv::kAccRest : (kSharedAcc ? pv::kAccShared : pv::kAccGlobal);
    const pv::AccPlace to = (kSharedAcc && out.p != nullptr) ? pv::kAccShared
                                                             : pv::kAccGlobal;
    int slot = 0;
    for (int tile = blockIdx.x; tile < r.tiles; tile += gridDim.x, ++slot) {
      float* as = acc_s + slot * slot_floats;
      // the window's origin: the tile's, less the border
      const int gi0 = (tile / r.tiles_y) * r.tile_x - r.k;
      const int gj0 = (tile % r.tiles_y) * r.tile_y - r.k;
      pv::Run<R> u;
      const unsigned field = pv::cell_masks<R>(u, e, r, gi0, gj0, r.nx, r.ny,
                                               0, r.nx, 0, r.ny);
      // this thread's first cell, in the field's planes
      const int64_t g0 = (int64_t)(gi0 + e.i0) * r.ny + gj0 + e.j;
      pv::load_window<R>(u, e, r, field, f, g0, r.ny, acc, g0, r.ny, as,
                         from, [&](int m, bool in_field) {
        // the state, read past L1 (other SMs wrote it in this launch); at
        // rest in the first round
        const bool load = in_field && !first;
        const int64_t g = g0 + (int64_t)m * r.ny;
        u.p[m] = load ? __ldcg(in.p + g) : 0.0f;
        u.vx[m] = load ? __ldcg(in.vx + g) : 0.0f;
        u.vy[m] = load ? __ldcg(in.vy + g) : 0.0f;
      });
      pv::run_window<R>(u, e, r, gi0, gj0, pulse, rec, plane, r.ny);
      pv::store_window<R>(u, e, r, u.interior, out, g0, r.ny, -1, 0.0f, acc,
                          g0, r.ny, as, to);
    }
    if (c + 1 < rounds) pv::grid_barrier(bar);
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
  Round r{{tile_x, tile_y, k, 0, 0, 0, lix, liy, gx, gy, absorbing, courant,
           thr, src_dir_n, dry_n, wet_n},
          nx, ny, tiles_y, tiles};
  const pv::WindowLaunch geo = pv::window_launch(tile_x, tile_y, k);
  const int sms = pv::sm_count();
  const int blocks = tiles < sms ? tiles : sms;
  size_t smem = 0;
  const bool shared_acc =
      pv::acc_fits(geo, (tiles + blocks - 1) / blocks, tile_x, tile_y,
                   &smem) && !global_acc;
  if (!shared_acc) smem = geo.smem;
  const void* kernel =
      shared_acc ? (const void*)fdtd_tiled_kernel<pv::kRun, true>
                 : (const void*)fdtd_tiled_kernel<pv::kRun, false>;
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
