// Sharded rounds for Hopper: one round of the sharded engine over every
// shard a device holds, in one cooperative launch.
//
// B5 `sharded_round` replaces
// planeverb_tpu/parallel/solver_pallas.py::_round_kernel, in the plain
// rounds and in the overlap split's frame and interior launches
// (_overlap_impl). B6 `banded_round` replaces
// planeverb_tpu/parallel/solver_pallas.py::_banded_round_kernel, likewise
// (_overlap_banded_impl). Both are this one kernel: they differ in the
// ghost widths the host gives each region (B5: k on a sharded axis, 0 on
// an unsharded one, whose block edge is the global edge; B6: k on both),
// and each counts its own launches.
//
// A shard owns a bx x by interior of the global field. A round advances
// it `nsteps` steps (halo = k, or T - t0 in the last round) on its
// ghost-extended block: the interior with kx ghost rows and ky ghost
// columns on each side, read at the round's start from the neighbours'
// state. A launch advances a list of regions (a table in device memory,
// made once a simulation): a region is the extended block of a shard's
// `rows` interior rows from shard row orow (the plain round: all bx rows;
// the overlap split's frame launch: the top and bottom k rows of every
// shard, its interior launch: rows [k, bx - k)). Every region of a launch
// belongs to one device, and one launch serves them all.
//
// The design is B3's (fdtd_tiled.cu), whose window machinery it shares
// (windows.cuh):
//   - One cooperative launch of one block per SM (up to the tiles). The
//     tiles of every region (20 x 52 or 20 x 20 with a 6-cell border,
//     parallel/solver_fused.py REGION_TILES and SUB_ROUND; B3 plans its
//     own) are numbered one after another; block b takes tiles
//     b, b + gridDim.x, ... A region's steps run as sub-rounds of at most
//     6 steps (16 = 6 + 6 + 4), with a grid barrier between them; the
//     region's state between sub-rounds lives in its own double-buffered
//     scratch ([2][3][ex][ey]). Windows are B3's: registers, shuffles, two
//     block barriers a step, coefficients folded from beta and Y in the
//     kernel (both modes; the statics are the region's block of the
//     shard's extended beta and Y, exchanged once a simulation).
//   - The cone argument covers the sub-rounds: after s steps a value wrong
//     at the region's edge has moved s cells inward, and a round has at
//     most halo <= kx (ky) steps, so the shard's interior stays exact;
//     each sub-round's windows keep their tiles exact the same way. Window
//     cells outside the region load zero.
//   - The ghosts are read on the device. The first sub-round reads a
//     region's cells from a table of 9 sources, the shard's own round-start
//     state and its 8 neighbours' (corners included, which the cone
//     needs): the neighbour's state where it sits on the same device, or a
//     ghost buffer on this device holding the slab copied from a neighbour
//     on another card; the kernel cannot tell the two apart. A missing
//     neighbour (the global edge) reads zero.
//   - Only the shard's interior cells write the recording (rows [t0, t0 +
//     nsteps) of the shard's own [T, bx, by]), update the six accumulators
//     and write the new state (p after the round's last injection). The
//     accumulators of a block's tiles stay in its shared memory for the
//     launch where they fit (read and written in global memory once a
//     round), else they are read and written every sub-round, with the
//     same bits. The listener is injected in every copy of its cell,
//     ghosts included, by global coordinates.
//   - The launcher allocates nothing and never synchronises; the barrier
//     words return to their rest state at every barrier and serve every
//     launch.
// What bounds it on this card: as B3, per cell and step the recording
// write (the byte bound), plus the windows' loads, fold and write-back
// every 6 steps over the extended blocks (1.14x the field at 126 m on 2x2,
// 1.78x at the headline), then the latency of two block barriers a step
// and of a grid barrier every sub-round. A round of k = halo steps still
// ends at the host, since a shard on another card has to receive its
// ghosts before the next round: that is the JAX design's contract (one
// exchange and one launch per round and device).
//
// Numerics: built with -fmad=false and without fast math; every expression
// in the order of the plain PyTorch versions (parallel/solver_fused.py,
// ops/fdtd.py::stencil_coefficients), so each op rounds once as PyTorch's
// elementwise kernels do. Recording offsets are 64-bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "windows.cuh"

namespace {

using pv::Acc;
using pv::Fold;
using pv::State;

// One of the 3 x 3 states a region reads in its first sub-round.
struct Source {
  const float* p;   // [3][plane]: p, vx, vy; null: zeros (the global edge)
  int plane, row;   // its plane and row strides
  int i0, j0;       // the shard cell (may lie outside the shard) of its
                    // element (0, 0)
};

// A region of a round launch (parallel/solver_fused.py builds the table;
// its ctypes mirror is kernels.RoundRegion).
struct Region {
  Source src[9];           // (dx, dy) in {-1, 0, 1}^2 at (dx + 1) * 3 + dy + 1
  const float* statics;    // beta, then Y at + splane: the region's block,
                           // row stride ey
  float* scratch;          // [2][3][ex * ey]: the block between sub-rounds
  float* rec;              // the shard's [T][bx * by] recording
  float* acc;              // its [6][bx * by] accumulators
  float* out;              // its [3][bx * by] new state
  long long splane;        // statics plane stride
  int ex, ey;              // block: rows + 2 kx, by + 2 ky
  int kx, ky;              // ghost widths
  int bx, by;              // the shard
  int orow, rows;          // interior rows [orow, orow + rows) of the shard
  int oi, oj;              // global cell of block cell (0, 0)
  int tile0, tiles_y;      // its first tile in the launch, tiles along y
};

// Bit m: row i0 + m of this thread is a tile cell in the block [0, ex) x
// [0, ey) (its state goes to the scratch between sub-rounds).
__device__ __forceinline__ unsigned tile_bits(const pv::Edges& e,
                                              const pv::Stepping& r, int li0,
                                              int lj0, int ex, int ey) {
  const int lj = lj0 + e.j;
  const bool col = e.j >= r.k && e.j < r.k + r.tile_y && lj < ey;
  unsigned bits = 0;
#pragma unroll
  for (int m = 0; m < pv::kRun; ++m) {
    const int i = e.i0 + m;
    const bool tile = col && i >= r.k && i < r.k + r.tile_x && li0 + i < ex;
    bits |= (tile ? 1u : 0u) << m;
  }
  return bits;
}

// One round of every region: `steps` steps from r.t0 in sub-rounds of r.k,
// a grid barrier between them. kSharedAcc: the tiles' accumulators stay in
// the block's shared memory between sub-rounds.
template <bool kSharedAcc>
__global__ void __launch_bounds__(pv::kWindowThreads)
round_kernel(const Region* __restrict__ regions, int n_regions, int tiles,
             const float* __restrict__ pulse, pv::Stepping r, int steps,
             unsigned* bar) {
  constexpr int R = pv::kRun;
  extern __shared__ float smem[];
  const pv::Edges e = pv::block_edges(smem, R);
  float* acc_s = pv::acc_slots(e);
  const int slot_floats = 6 * r.tile_x * r.tile_y;
  const int t0 = r.t0;
  const int subs = (steps + r.k - 1) / r.k;
  // the round's first step reads a state injected up to step t0 - 1
  r.inj0 = t0;
  for (int c = 0; c < subs; ++c) {
    const bool first = c == 0;
    const bool last = c + 1 == subs;
    r.t0 = t0 + c * r.k;
    r.nsteps = steps - c * r.k < r.k ? steps - c * r.k : r.k;
    const pv::AccPlace from = (first || !kSharedAcc) ? pv::kAccGlobal
                                                     : pv::kAccShared;
    const pv::AccPlace to = (last || !kSharedAcc) ? pv::kAccGlobal
                                                  : pv::kAccShared;
    int slot = 0;
    int g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++slot) {
      while (g + 1 < n_regions && regions[g + 1].tile0 <= tile) ++g;
      const Region& q = regions[g];
      const int ex = q.ex, ey = q.ey, kx = q.kx, ky = q.ky, by = q.by;
      const int t = tile - q.tile0;
      // the window's origin in block cells: the tile's, less the border
      const int li0 = (t / q.tiles_y) * r.tile_x - r.k;
      const int lj0 = (t % q.tiles_y) * r.tile_y - r.k;
      pv::Run<R> u;
      const unsigned field = pv::cell_masks<R>(
          u, e, r, li0, lj0, ex, ey, kx, kx + q.rows, ky, ky + by);
      // this thread's first cell in the block, and in the shard's planes
      const int64_t gl0 = (int64_t)(li0 + e.i0) * ey + lj0 + e.j;
      const int si0 = q.orow - kx + li0 + e.i0;
      const int sj = lj0 + e.j - ky;
      const int64_t a0 = (int64_t)si0 * by + sj;
      const int64_t plane = (int64_t)q.bx * by;
      const int64_t eplane = (int64_t)ex * ey;
      const Fold f{q.statics, q.statics + q.splane};
      const Acc acc{q.acc,             q.acc + plane,     q.acc + 2 * plane,
                    q.acc + 3 * plane, q.acc + 4 * plane, q.acc + 5 * plane};
      const float* in = q.scratch + ((c - 1) & 1) * 3 * eplane;
      pv::load_window<R>(u, e, r, field, f, gl0, ey, acc, a0, by,
                         acc_s + slot * slot_floats, from,
                         [&](int m, bool in_block) {
        u.p[m] = u.vx[m] = u.vy[m] = 0.0f;
        if (!in_block) return;
        if (!first) {
          // the region's own block, written by other SMs in this launch
          const int64_t gm = gl0 + (int64_t)m * ey;
          u.p[m] = __ldcg(in + gm);
          u.vx[m] = __ldcg(in + eplane + gm);
          u.vy[m] = __ldcg(in + 2 * eplane + gm);
          return;
        }
        // the round-start state: the shard's own, a neighbour's or a ghost
        // buffer, by the 3 x 3 side the cell lies on
        const int si = si0 + m;
        const int dx = si < 0 ? 0 : (si < q.bx ? 1 : 2);
        const int dy = sj < 0 ? 0 : (sj < by ? 1 : 2);
        const Source s = q.src[dx * 3 + dy];
        if (s.p == nullptr) return;
        const int64_t o = (int64_t)(si - s.i0) * s.row + (sj - s.j0);
        u.p[m] = __ldcg(s.p + o);
        u.vx[m] = __ldcg(s.p + s.plane + o);
        u.vy[m] = __ldcg(s.p + 2 * (int64_t)s.plane + o);
      });
      const int gi0 = q.oi + li0;
      const int gj0 = q.oj + lj0;
      // the recording's base shifted to global cells: the shard's cell
      // (0, 0) is global (oi + kx - orow, oj + ky)
      float* rec_g = q.rec - ((int64_t)(q.oi + kx - q.orow) * by + q.oj + ky);
      pv::run_window<R, true>(u, e, r, gi0, gj0, pulse, rec_g, plane, by);
      if (last) {
        // the shard's interior: its new state, with the round's last pulse
        // at the listener's cell
        const int lrow = r.lix - gi0 - e.i0;
        const int inj_m =
            (r.liy == gj0 + e.j && lrow >= 0 && lrow < R) ? lrow : -1;
        const State out{q.out, q.out + plane, q.out + 2 * plane};
        pv::store_window<R>(u, e, r, u.interior, out, a0, by, inj_m,
                            pulse[t0 + steps - 1], acc, a0, by,
                            acc_s + slot * slot_floats, to);
      } else {
        float* o = q.scratch + (c & 1) * 3 * eplane;
        const State out{o, o + eplane, o + 2 * eplane};
        pv::store_window<R>(u, e, r, tile_bits(e, r, li0, lj0, ex, ey), out,
                            gl0, ey, -1, 0.0f, acc, a0, by,
                            acc_s + slot * slot_floats, to);
      }
    }
    if (!last) pv::grid_barrier(bar);
  }
}

}  // namespace

// The size of a Region, for the ctypes mirror's check.
extern "C" int pv_round_region_bytes() { return (int)sizeof(Region); }

// One round launch over `n_regions` regions (a device array of Region) with
// `tiles` tiles in all: one cooperative launch of min(tiles, SMs) blocks,
// the accumulators in shared memory where a block's slots fit. banded:
// count it as B6 (else B5). bar: two words, zero before the first launch
// that uses them. A tiling the kernel cannot hold fails at launch, and the
// error is returned.
extern "C" int pv_device_round(
    const void* regions, const float* pulse, unsigned* bar, int n_regions,
    int tiles, int tile_x, int tile_y, int k, int t0, int nsteps, int lix,
    int liy, int gx, int gy, int absorbing, int banded, float courant,
    float thr, float src_dir_n, float dry_n, float wet_n, void* stream) {
  pv::Stepping r{tile_x, tile_y, k,  t0,  nsteps,    t0,  lix,
                 liy,    gx,     gy, absorbing, courant, thr, src_dir_n,
                 dry_n,  wet_n};
  const pv::WindowLaunch geo = pv::window_launch(tile_x, tile_y, k);
  const int sms = pv::sm_count();
  const int blocks = tiles < sms ? tiles : sms;
  size_t smem = 0;
  const bool shared_acc = pv::acc_fits(geo, (tiles + blocks - 1) / blocks,
                                       tile_x, tile_y, &smem);
  const void* kernel = shared_acc ? (const void*)round_kernel<true>
                                  : (const void*)round_kernel<false>;
  const int err = pv::set_smem(kernel, smem);
  if (err != 0) return err;
  const Region* table = static_cast<const Region*>(regions);
  int steps = nsteps;
  void* args[] = {&table, &n_regions, &tiles, &pulse, &r, &steps, &bar};
  return pv::count_launch(
      banded ? pv::kBandedRoundKernel : pv::kShardedRoundKernel,
      cudaLaunchCooperativeKernel(kernel, dim3(blocks), geo.block, args, smem,
                                  static_cast<cudaStream_t>(stream)));
}
