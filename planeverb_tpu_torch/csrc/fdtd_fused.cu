// Fused FDTD simulation (B1) and RT60 moments (B2) kernels for Hopper.
//
// B1 `fdtd_sim` replaces planeverb_tpu/ops/fdtd_pallas.py::_kernel.
//   One 2D FDTD timestep per launch, one thread per cell; the host-side
//   launcher enqueues the T launches on the caller's stream. Per step it
//   updates pressure, then vx, then vy (velocities read the pre-injection
//   pressure), records the pre-injection pressure into rec[t], and streams
//   the onset (first |p| > thr, +inf sentinel), the source-directivity flux
//   fx/fy += p*v while onset > t - src_dir_n, and the windowed energies
//   e_dry / e_wet / e_total. The pressure state lives in the recording
//   itself: step t reads rec[t-1] and adds pulse[t-1] at the listener cell
//   (the reference's record-then-inject order), so no separate p buffer is
//   kept. vx/vy are double-buffered by step parity.
//
//   What bounds it on this card: at the 192x192 headline the whole state
//   (rec[t-1], vx, vy, 7 coefficient planes, 6 accumulators: ~2.5 MB) sits in
//   the 50 MB L2, and each step moves ~0.6 MB, so a step is far below a
//   microsecond of bandwidth; the launch latency of ~T launches bounds it.
//   The design answers that only with the single launch per step: each thread
//   recomputes the pre-injection pressure of its (i-1, j) and (i, j-1)
//   neighbours from the old buffers instead of waiting for a second launch.
//   Temporal blocking, a thread-block-cluster version with the grid in
//   distributed shared memory, or a CUDA graph of the step loop are the
//   measured follow-ups.
//
// B2 `rt60_moments` replaces planeverb_tpu/ops/fdtd_pallas.py::_moments_kernel.
//   One thread per cell walks its column of the recording from t = T-1 down
//   to 0: suffix EDC += p^2, y = ln(max(EDC, 1e-37)) * 10/ln10, and
//   s0 += y, s1 += (t - start) * y over [onset + dry_n + 1, T - schroeder_off).
//   What bounds it: one read of the [T, nx, ny] recording (175 MB at the
//   headline) plus one logf per element; neighbouring threads read
//   neighbouring addresses, so the reads coalesce, and the unrolled loop keeps
//   several independent loads in flight per thread.
//
// Numerics: built with -fmad=false and without fast math, every expression in
// the order the plain PyTorch versions (ops/fdtd_fused.py) evaluate it, so
// each op rounds once as PyTorch's elementwise kernels do. The +inf onset
// sentinel and the 1e-37 EDC clamp rely on IEEE semantics (no FTZ, exact
// logf). Recording offsets are 64-bit.
//
// Launchers allocate nothing, never synchronise, and return
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Fields {
  const float* __restrict__ beta;
  const float* __restrict__ ax;
  const float* __restrict__ bx;
  const float* __restrict__ dx;
  const float* __restrict__ ay;
  const float* __restrict__ by;
  const float* __restrict__ dy;
};

struct Acc {
  float* __restrict__ onset;
  float* __restrict__ fx;
  float* __restrict__ fy;
  float* __restrict__ ed;
  float* __restrict__ ew;
  float* __restrict__ et;
};

// Pre-injection pressure of step t at cell (i, j), recomputed from the
// previous step's state: p_old = rec[t-1] (+ pulse[t-1] at the listener),
// then p = beta * (p_old - C * div v), with zero velocity beyond the edges.
__device__ __forceinline__ float pressure_at(
    int i, int j, int nx, int ny, bool first,
    const float* __restrict__ beta, const float* __restrict__ p_prev,
    const float* __restrict__ vx, const float* __restrict__ vy,
    int lix, int liy, float inj, float courant) {
  if (first) return 0.0f;  // the state starts at rest
  const int64_t c = (int64_t)i * ny + j;
  float p = p_prev[c];
  if (i == lix && j == liy) p = p + inj;
  const float vxc = vx[c];
  const float vyc = vy[c];
  const float vx_xp = (i + 1 < nx) ? vx[c + ny] : 0.0f;
  const float vy_yp = (j + 1 < ny) ? vy[c + 1] : 0.0f;
  const float div = (vx_xp - vxc) + (vy_yp - vyc);
  return beta[c] * (p - courant * div);
}

__global__ void fdtd_step_kernel(Fields f, Acc acc,
                                 const float* __restrict__ p_prev,
                                 float* __restrict__ p_out,
                                 const float* __restrict__ vx_in,
                                 const float* __restrict__ vy_in,
                                 float* __restrict__ vx_out,
                                 float* __restrict__ vy_out,
                                 const float* __restrict__ pulse,
                                 int nx, int ny, int t, int lix, int liy,
                                 float courant, float thr, float src_dir_n,
                                 float dry_n, float wet_n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int64_t c = (int64_t)i * ny + j;
  const bool first = (t == 0);
  const float inj = first ? 0.0f : pulse[t - 1];

  // -- pressure (this cell and its backward neighbours)
  const float p = pressure_at(i, j, nx, ny, first, f.beta, p_prev, vx_in,
                              vy_in, lix, liy, inj, courant);
  const float p_xm = (i > 0) ? pressure_at(i - 1, j, nx, ny, first, f.beta,
                                           p_prev, vx_in, vy_in, lix, liy,
                                           inj, courant)
                             : 0.0f;
  const float p_ym = (j > 0) ? pressure_at(i, j - 1, nx, ny, first, f.beta,
                                           p_prev, vx_in, vy_in, lix, liy,
                                           inj, courant)
                             : 0.0f;

  // -- velocities: walls + edge ABC prefolded, v' = A*air + B*p + D*p_m
  const float vx_old = first ? 0.0f : vx_in[c];
  const float vy_old = first ? 0.0f : vy_in[c];
  float air = vx_old - courant * (p - p_xm);
  const float vx = f.ax[c] * air + f.bx[c] * p + f.dx[c] * p_xm;
  air = vy_old - courant * (p - p_ym);
  const float vy = f.ay[c] * air + f.by[c] * p + f.dy[c] * p_ym;

  // -- streaming onset / flux / windowed energies: the running onset is
  // compared against small-integer-valued f32 bounds, which are exact
  const float tf = (float)t;
  const float c_flux = tf - src_dir_n;
  const float c_dry = tf - dry_n;
  const float c_wet_lo = tf - dry_n - 1.0f;
  const float c_wet_hi = tf - dry_n - 1.0f - wet_n;

  float onset = first ? INFINITY : acc.onset[c];
  float fx = first ? 0.0f : acc.fx[c];
  float fy = first ? 0.0f : acc.fy[c];
  float ed = first ? 0.0f : acc.ed[c];
  float ew = first ? 0.0f : acc.ew[c];
  float et = first ? 0.0f : acc.et[c];

  onset = fminf(onset, fabsf(p) > thr ? tf : INFINITY);
  const float mp = (onset > c_flux) ? p : 0.0f;
  fx = fx + mp * vx;
  fy = fy + mp * vy;
  const float sq = p * p;
  if (onset > c_dry) ed = ed + sq;
  if (onset <= c_wet_lo && onset > c_wet_hi) ew = ew + sq;
  et = et + sq;

  p_out[c] = p;  // record pre-injection; step t+1 injects pulse[t]
  vx_out[c] = vx;
  vy_out[c] = vy;
  acc.onset[c] = onset;
  acc.fx[c] = fx;
  acc.fy[c] = fy;
  acc.ed[c] = ed;
  acc.ew[c] = ew;
  acc.et[c] = et;
}

__global__ void rt60_moments_kernel(const float* __restrict__ rec,
                                    const float* __restrict__ onset,
                                    float* __restrict__ s0_out,
                                    float* __restrict__ s1_out,
                                    int64_t n_cells, int T, float dry_n1,
                                    float end, float log10_scale) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const float start = onset[c] + dry_n1;
  float edc = 0.0f;
  float s0 = 0.0f;
  float s1 = 0.0f;
#pragma unroll 8
  for (int t = T - 1; t >= 0; --t) {
    const float p = rec[(int64_t)t * n_cells + c];
    edc = edc + p * p;  // suffix sum including the current sample
    const float y = logf(fmaxf(edc, 1e-37f)) * log10_scale;
    const float tf = (float)t;
    if (tf >= start && tf < end) {
      s0 = s0 + y;
      s1 = s1 + (tf - start) * y;
    }
  }
  s0_out[c] = s0;
  s1_out[c] = s1;
}

}  // namespace

extern "C" int pv_fdtd_sim(
    const float* beta, const float* ax, const float* bx, const float* dx,
    const float* ay, const float* by, const float* dy, const float* pulse,
    float* rec, float* onset, float* fx, float* fy, float* ed, float* ew,
    float* et, float* vx_a, float* vy_a, float* vx_b, float* vy_b, int nx,
    int ny, int T, int lix, int liy, float courant, float thr,
    float src_dir_n, float dry_n, float wet_n, void* stream) {
  const Fields f{beta, ax, bx, dx, ay, by, dy};
  const Acc acc{onset, fx, fy, ed, ew, et};
  const dim3 block(32, 8);
  const dim3 grid((ny + block.x - 1) / block.x, (nx + block.y - 1) / block.y);
  const int64_t plane = (int64_t)nx * ny;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    const float* p_prev = t > 0 ? rec + (int64_t)(t - 1) * plane : nullptr;
    float* p_out = rec + (int64_t)t * plane;
    const bool even = (t & 1) == 0;
    fdtd_step_kernel<<<grid, block, 0, s>>>(
        f, acc, p_prev, p_out, even ? vx_a : vx_b, even ? vy_a : vy_b,
        even ? vx_b : vx_a, even ? vy_b : vy_a, pulse, nx, ny, t, lix, liy,
        courant, thr, src_dir_n, dry_n, wet_n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int pv_rt60_moments(const float* rec, const float* onset,
                               float* s0, float* s1, int nx, int ny, int T,
                               float dry_n1, float end, float log10_scale,
                               void* stream) {
  const int64_t n_cells = (int64_t)nx * ny;
  const int block = 128;
  const int grid = (int)((n_cells + block - 1) / block);
  rt60_moments_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rec, onset, s0, s1, n_cells, T, dry_n1, end, log10_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* pv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
