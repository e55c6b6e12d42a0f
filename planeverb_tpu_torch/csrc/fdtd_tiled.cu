// Temporally blocked FDTD simulation (B3) and chunked RT60 moments (B4)
// for Hopper: the large-world route of the engine step.
//
// B3 `fdtd_sim_tiled` replaces planeverb_tpu/ops/fdtd_tiled.py::_tiled_kernel.
//   One launch per round of k steps, so ceil(T/k) launches per pass instead
//   of B1's T. Each block owns a 2D tile of tile_x x tile_y interior cells
//   and keeps the window around it (the tile plus a k-cell halo on every
//   side) in shared memory: the three state planes p/vx/vy, the seven
//   folded coefficient planes (beta, A/B/D in x and y) and the tile's six
//   streaming accumulators (onset, flux, windowed energies). The stencil
//   radius is one cell per step, so after k local steps every interior cell
//   is exact; the halo's wrong values never reach it. The window advances k
//   steps, recording the interior's pre-injection pressure every step, and
//   the interior state and accumulators are written back for the next round.
//   - State is double-buffered in global memory by round parity: round c
//     reads slot c%2 and writes slot (c+1)%2. Launches serialize on the
//     stream, so no block reads a cell another block writes in its round.
//   - A step is the pressure update over the window, a barrier, the
//     velocity update with the interior's accumulators and recording, a
//     barrier. The listener's pulse of step t-1 is added to its cell's
//     pressure at the start of step t, in every window that holds the
//     listener cell, halo copies included; only the thread of that cell
//     reads its old pressure there, so the deferral needs no extra barrier,
//     and the stored state is the pre-injection pressure.
//   - Window cells outside the field load zero state and zero coefficients
//     and so stay 0: they play the reference's zero padding. The
//     coefficients come from the field-wide fold (ops/fdtd.py
//     coefficients_from_fields), so the edge ABC sits at the global edge.
//   - A thread owns one window column and every blockDim.y-th row of it.
//     The accumulators live in shared memory, not in per-thread register
//     arrays: those for several rows a thread spill.
//   What bounds it on this card: per cell and step it moves the 4-byte
//   recording write plus (10 window planes read + 3 state and 6 accumulator
//   planes written) / k, ~23 B at 32x32 tiles and k = 8; the shared-memory
//   traffic of the stencil (~30 accesses per window cell-step, times the
//   (48/32)^2 = 2.25 halo redundancy) is of the same order. The design
//   answers B1's launch bound with k steps per launch; TMA window loads,
//   clusters sharing halos through distributed shared memory and overlap
//   of the recording stores are the follow-ups.
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
// Launchers allocate nothing, never synchronise, and return
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Most threads in a B3 block (caps ptxas at 64 registers a thread).
constexpr int kMaxTiledThreads = 1024;
constexpr int kPlanes = 10;    // p, vx, vy, beta, ax, bx, dx, ay, by, dy
constexpr int kAccPlanes = 6;  // onset, fx, fy, ed, ew, et of the tile
// Cells per B4 block, one thread each (B2's block size).
constexpr int kMomRun = 128;

struct Coefs {
  const float* __restrict__ beta;
  const float* __restrict__ ax;
  const float* __restrict__ bx;
  const float* __restrict__ dx;
  const float* __restrict__ ay;
  const float* __restrict__ by;
  const float* __restrict__ dy;
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
  float courant, thr, src_dir_n, dry_n, wet_n;
};

size_t tiled_smem_bytes(int tile_x, int tile_y, int k) {
  const size_t window = (size_t)(tile_x + 2 * k) * (tile_y + 2 * k);
  return (kPlanes * window + kAccPlanes * (size_t)tile_x * tile_y) *
         sizeof(float);
}

__global__ void __launch_bounds__(kMaxTiledThreads)
fdtd_tiled_round_kernel(Coefs f, State in, State out, Acc acc,
                        const float* __restrict__ pulse,
                        float* __restrict__ rec, Round r) {
  extern __shared__ float smem[];
  const int wx = r.tile_x + 2 * r.k;
  const int wy = r.tile_y + 2 * r.k;
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
  float* a_on = sdy + wcells;  // tile accumulators, [6][tile_x * tile_y]
  float* a_fx = a_on + tcells;
  float* a_fy = a_fx + tcells;
  float* a_ed = a_fy + tcells;
  float* a_ew = a_ed + tcells;
  float* a_et = a_ew + tcells;

  const int ti0 = blockIdx.y * r.tile_x;  // tile origin, global
  const int tj0 = blockIdx.x * r.tile_y;
  const int gi0 = ti0 - r.k;              // window origin, global
  const int gj0 = tj0 - r.k;
  const int64_t plane = (int64_t)r.nx * r.ny;
  const bool first_round = (r.t0 == 0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // -- load the window; cells outside the field are 0 in every plane
  for (int w = tid; w < wcells; w += nthreads) {
    const int gi = gi0 + w / wy;
    const int gj = gj0 + w % wy;
    const bool in_field = gi >= 0 && gi < r.nx && gj >= 0 && gj < r.ny;
    const int64_t g = (int64_t)gi * r.ny + gj;
    const bool load_state = in_field && !first_round;
    sp[w] = load_state ? in.p[g] : 0.0f;
    svx[w] = load_state ? in.vx[g] : 0.0f;
    svy[w] = load_state ? in.vy[g] : 0.0f;
    sbeta[w] = in_field ? f.beta[g] : 0.0f;
    sax[w] = in_field ? f.ax[g] : 0.0f;
    sbx[w] = in_field ? f.bx[g] : 0.0f;
    sdx[w] = in_field ? f.dx[g] : 0.0f;
    say[w] = in_field ? f.ay[g] : 0.0f;
    sby[w] = in_field ? f.by[g] : 0.0f;
    sdy[w] = in_field ? f.dy[g] : 0.0f;
  }
  // -- and the tile's accumulators (at rest in the first round)
  for (int w = tid; w < tcells; w += nthreads) {
    const int gi = ti0 + w / r.tile_y;
    const int gj = tj0 + w % r.tile_y;
    const int64_t g = (int64_t)gi * r.ny + gj;
    const bool load = gi < r.nx && gj < r.ny && !first_round;
    a_on[w] = load ? acc.onset[g] : INFINITY;
    a_fx[w] = load ? acc.fx[g] : 0.0f;
    a_fy[w] = load ? acc.fy[g] : 0.0f;
    a_ed[w] = load ? acc.ed[g] : 0.0f;
    a_ew[w] = load ? acc.ew[g] : 0.0f;
    a_et[w] = load ? acc.et[g] : 0.0f;
  }
  __syncthreads();

  // this thread's cells: window column j, rows threadIdx.y + m * blockDim.y
  const int j = threadIdx.x;
  const int gj = gj0 + j;
  const bool col_interior = j >= r.k && j < r.k + r.tile_y && gj < r.ny;
  for (int s = 0; s < r.nsteps; ++s) {
    const int t = r.t0 + s;
    const float inj = t > 0 ? pulse[t - 1] : 0.0f;

    // -- pressure: p = beta * (p_old - C * div v), p_old with the pending
    // injection of step t-1 at the listener cell
    for (int i = threadIdx.y; i < wx; i += blockDim.y) {
      const int c = i * wy + j;
      float pv = sp[c];
      if (t > 0 && gi0 + i == r.lix && gj == r.liy) pv = pv + inj;
      const float vxc = svx[c];
      const float vyc = svy[c];
      const float vx_xp = (i + 1 < wx) ? svx[c + wy] : 0.0f;
      const float vy_yp = (j + 1 < wy) ? svy[c + 1] : 0.0f;
      const float div = (vx_xp - vxc) + (vy_yp - vyc);
      sp[c] = sbeta[c] * (pv - r.courant * div);
    }
    __syncthreads();

    // -- velocities (walls + edge ABC prefolded), then the interior's
    // streaming accumulators and its pre-injection recording; window
    // bounds are small-integer-valued, so exact in f32
    const float tf = (float)t;
    const float c_flux = tf - r.src_dir_n;
    const float c_dry = tf - r.dry_n;
    const float c_wet_lo = tf - r.dry_n - 1.0f;
    const float c_wet_hi = tf - r.dry_n - 1.0f - r.wet_n;
    float* rec_t = rec + (int64_t)t * plane;
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
      if (col_interior && i >= r.k && i < r.k + r.tile_x &&
          gi0 + i < r.nx) {
        const int a = (i - r.k) * r.tile_y + (j - r.k);
        const float onset = fminf(a_on[a], fabsf(p) > r.thr ? tf : INFINITY);
        const float mp = (onset > c_flux) ? p : 0.0f;
        a_on[a] = onset;
        a_fx[a] = a_fx[a] + mp * vx;
        a_fy[a] = a_fy[a] + mp * vy;
        const float sq = p * p;
        if (onset > c_dry) a_ed[a] = a_ed[a] + sq;
        if (onset <= c_wet_lo && onset > c_wet_hi) a_ew[a] = a_ew[a] + sq;
        a_et[a] = a_et[a] + sq;
        rec_t[(int64_t)(gi0 + i) * r.ny + gj] = p;
      }
    }
    __syncthreads();
  }

  // -- write back the in-field interior: state for the next round (none
  // after the last), accumulators every round
  for (int w = tid; w < tcells; w += nthreads) {
    const int ii = w / r.tile_y;
    const int jj = w % r.tile_y;
    const int gi = ti0 + ii;
    const int gjw = tj0 + jj;
    if (gi >= r.nx || gjw >= r.ny) continue;
    const int64_t g = (int64_t)gi * r.ny + gjw;
    const int c = (ii + r.k) * wy + (jj + r.k);
    if (out.p != nullptr) {
      out.p[g] = sp[c];
      out.vx[g] = svx[c];
      out.vy[g] = svy[c];
    }
    acc.onset[g] = a_on[w];
    acc.fx[g] = a_fx[w];
    acc.fy[g] = a_fy[w];
    acc.ed[g] = a_ed[w];
    acc.ew[g] = a_ew[w];
    acc.et[g] = a_et[w];
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

// Opt in to more than 48 KB of dynamic shared memory. A refused size leaves
// no error pending, so the next launch reports its own.
int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

}  // namespace

extern "C" int pv_fdtd_sim_tiled(
    const float* beta, const float* ax, const float* bx, const float* dx,
    const float* ay, const float* by, const float* dy, const float* pulse,
    float* rec, float* onset, float* fx, float* fy, float* ed, float* ew,
    float* et, float* p_a, float* vx_a, float* vy_a, float* p_b, float* vx_b,
    float* vy_b, int nx, int ny, int T, int tile_x, int tile_y, int k,
    int lix, int liy, float courant, float thr, float src_dir_n, float dry_n,
    float wet_n, void* stream) {
  const Coefs f{beta, ax, bx, dx, ay, by, dy};
  const Acc acc{onset, fx, fy, ed, ew, et};
  const State slots[2] = {{p_a, vx_a, vy_a}, {p_b, vx_b, vy_b}};
  const State none{nullptr, nullptr, nullptr};
  const int wx = tile_x + 2 * k;
  const int wy = tile_y + 2 * k;
  // one thread per window column, as many row strides as fit; a window the
  // card cannot hold (wider than 1024 columns, or beyond the shared memory
  // limit) fails at launch, and the error is returned
  const int rows = kMaxTiledThreads / wy;
  const dim3 block(wy, rows < 1 ? 1 : (rows < wx ? rows : wx));
  const dim3 grid((ny + tile_y - 1) / tile_y, (nx + tile_x - 1) / tile_x);
  const size_t smem = tiled_smem_bytes(tile_x, tile_y, k);
  int err = set_smem((const void*)fdtd_tiled_round_kernel, smem);
  if (err != 0) return err;
  // a listener outside the field injects nothing: move it out of every
  // window (window origins are >= -k)
  if (!(lix >= 0 && lix < nx && liy >= 0 && liy < ny)) lix = liy = -(1 << 30);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rounds = (T + k - 1) / k;
  for (int c = 0; c < rounds; ++c) {
    const int nsteps = T - c * k < k ? T - c * k : k;  // last round: T - c*k
    const Round r{nx, ny, c * k, nsteps, tile_x, tile_y, k,
                  lix, liy, courant, thr, src_dir_n, dry_n, wet_n};
    const State& in = slots[c & 1];
    const State& out = (c + 1 < rounds) ? slots[(c + 1) & 1] : none;
    fdtd_tiled_round_kernel<<<grid, block, smem, s>>>(f, in, out, acc, pulse,
                                                      rec, r);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
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
  return (int)cudaGetLastError();
}
