// Fused FDTD simulation (B1) and RT60 moments (B2) kernels for Hopper.
//
// B1 `fdtd_sim` replaces planeverb_tpu/ops/fdtd_pallas.py::_kernel, in all
// its modes: one listener or B of them (`batched=True`), f32 or bf16 wave
// state (`state_dtype`).
//   One 2D FDTD timestep per launch, one thread per cell and listener
//   (blockIdx.z is the listener); the host-side launcher enqueues the T
//   launches on the caller's stream. Per step it updates pressure, then vx,
//   then vy (velocities read the pre-injection pressure), records the
//   pre-injection pressure into rec[b, t], and streams the onset (first
//   |p| > thr, +inf sentinel), the source-directivity flux fx/fy += p*v
//   while onset > t - src_dir_n, and the windowed energies e_dry / e_wet /
//   e_total. The pressure state lives in the recording itself: step t reads
//   rec[b, t-1] and adds pulse[t-1] at listener b's cell (the reference's
//   record-then-inject order), so no separate p buffer is kept. vx/vy are
//   double-buffered by step parity.
//
//   Batched mode: the B listeners share one copy of beta and the six
//   coefficient planes (they are listener-invariant, as in the TPU kernel);
//   each listener has its own recording [B, T, nx, ny], accumulators
//   [6, B, nx, ny] and velocity buffers [B, 4, nx, ny]. A listener's blocks
//   run exactly the single-listener arithmetic, so the batch is bit-equal to
//   B single passes, and it costs T launches whatever B is.
//
//   bf16 mode (S = __nv_bfloat16): p (the recording), vx, vy, beta and the
//   coefficient planes are stored in bf16; each operation is computed in
//   float and rounded to bf16 once, in the plain version's order (which is
//   what PyTorch's bf16 elementwise kernels do). The pulse is rounded to
//   bf16 before it is injected. Onset, flux and energies stay f32 and read
//   the bf16 values exactly (p32 = float(p)).
//
//   What bounds it on this card: at the 192x192 headline the whole state
//   (rec[t-1], vx, vy, 7 coefficient planes, 6 accumulators: ~2.5 MB a
//   listener) sits in the 50 MB L2, and each step moves ~0.6 MB a listener,
//   so a step is far below a microsecond of bandwidth; the launch latency of
//   ~T launches bounds it. The design answers that only with the single
//   launch per step (for all listeners): each thread recomputes the
//   pre-injection pressure of its (i-1, j) and (i, j-1) neighbours from the
//   old buffers instead of waiting for a second launch. Temporal blocking, a
//   thread-block-cluster version with the grid in distributed shared memory,
//   or a CUDA graph of the step loop are the measured follow-ups.
//
// B2 `rt60_moments` replaces planeverb_tpu/ops/fdtd_pallas.py::_moments_kernel
// (one listener or B: blockIdx.y is the listener; f32 or bf16 recordings,
// each sample upcast to float).
//   One thread per cell walks its column of the recording from t = T-1 down
//   to 0: suffix EDC += p^2, y = ln(max(EDC, 1e-37)) * 10/ln10, and
//   s0 += y, s1 += (t - start) * y over [onset + dry_n + 1, T - schroeder_off).
//   What bounds it: one read of the [T, nx, ny] recording (175 MB at the
//   headline in f32, half that in bf16) plus one logf per element;
//   neighbouring threads read neighbouring addresses, so the reads coalesce,
//   and the unrolled loop keeps several independent loads in flight per
//   thread.
//
// Numerics: built with -fmad=false and without fast math, every expression in
// the order the plain PyTorch versions (ops/fdtd_fused.py) evaluate it, so
// each op rounds once as PyTorch's elementwise kernels do. The +inf onset
// sentinel and the 1e-37 EDC clamp rely on IEEE semantics (no FTZ, exact
// logf). Recording offsets are 64-bit.
//
// Launchers allocate nothing, never synchronise, and return
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Loads, per-op rounding and stores of the wave-state type S: identities for
// float, round-to-nearest-even through bf16 for __nv_bfloat16.
template <typename S>
struct State;

template <>
struct State<float> {
  static __device__ __forceinline__ float load(const float* p, int64_t i) {
    return p[i];
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct State<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p,
                                               int64_t i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename S>
struct Fields {
  const S* __restrict__ beta;
  const S* __restrict__ ax;
  const S* __restrict__ bx;
  const S* __restrict__ dx;
  const S* __restrict__ ay;
  const S* __restrict__ by;
  const S* __restrict__ dy;
};

// Pre-injection pressure of step t at cell (i, j), recomputed from the
// previous step's state: p_old = rec[t-1] (+ pulse[t-1] at the listener),
// then p = beta * (p_old - C * div v), with zero velocity beyond the edges.
template <typename S>
__device__ __forceinline__ float pressure_at(
    int i, int j, int nx, int ny, const S* __restrict__ beta,
    const S* __restrict__ p_prev, const S* __restrict__ vx,
    const S* __restrict__ vy, int lix, int liy, float inj, float courant) {
  using St = State<S>;
  const int64_t c = (int64_t)i * ny + j;
  float p = St::load(p_prev, c);
  if (i == lix && j == liy) p = St::round(p + inj);
  const float vxc = St::load(vx, c);
  const float vyc = St::load(vy, c);
  const float vx_xp = (i + 1 < nx) ? St::load(vx, c + ny) : 0.0f;
  const float vy_yp = (j + 1 < ny) ? St::load(vy, c + 1) : 0.0f;
  const float div = St::round(St::round(vx_xp - vxc) + St::round(vy_yp - vyc));
  return St::round(St::load(beta, c) * St::round(p - St::round(courant * div)));
}

// One step for every listener: cell (i, j) of listener blockIdx.z. The
// per-step pointers address listener 0; listener b's recording is
// rec_stride elements on, its velocity buffers vel_stride, its
// accumulators plane (the six accumulator planes are B planes apart).
template <typename S>
__global__ void fdtd_step_kernel(Fields<S> f, float* __restrict__ acc,
                                 const S* __restrict__ p_prev,
                                 S* __restrict__ p_out,
                                 const S* __restrict__ vx_in,
                                 const S* __restrict__ vy_in,
                                 S* __restrict__ vx_out,
                                 S* __restrict__ vy_out,
                                 const float* __restrict__ pulse,
                                 const int* __restrict__ lcells, int nx,
                                 int ny, int t, int64_t rec_stride,
                                 int64_t vel_stride, float courant, float thr,
                                 float src_dir_n, float dry_n, float wet_n) {
  using St = State<S>;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int b = blockIdx.z;
  const int64_t plane = (int64_t)nx * ny;
  const int64_t c = (int64_t)i * ny + j;
  const bool first = (t == 0);
  const int lix = lcells[2 * b];
  const int liy = lcells[2 * b + 1];
  const float inj = first ? 0.0f : St::round(pulse[t - 1]);
  if (!first) p_prev += b * rec_stride;
  p_out += b * rec_stride;
  vx_in += b * vel_stride;
  vy_in += b * vel_stride;
  vx_out += b * vel_stride;
  vy_out += b * vel_stride;
  float* a = acc + b * plane;
  const int64_t acc_stride = (int64_t)gridDim.z * plane;

  // -- pressure (this cell and its backward neighbours)
  const float p = first ? 0.0f
                        : pressure_at<S>(i, j, nx, ny, f.beta, p_prev, vx_in,
                                         vy_in, lix, liy, inj, courant);
  const float p_xm = (i > 0 && !first)
                         ? pressure_at<S>(i - 1, j, nx, ny, f.beta, p_prev,
                                          vx_in, vy_in, lix, liy, inj, courant)
                         : 0.0f;
  const float p_ym = (j > 0 && !first)
                         ? pressure_at<S>(i, j - 1, nx, ny, f.beta, p_prev,
                                          vx_in, vy_in, lix, liy, inj, courant)
                         : 0.0f;

  // -- velocities: walls + edge ABC prefolded, v' = A*air + B*p + D*p_m
  const float vx_old = first ? 0.0f : St::load(vx_in, c);
  const float vy_old = first ? 0.0f : St::load(vy_in, c);
  float air = St::round(vx_old - St::round(courant * St::round(p - p_xm)));
  const float vx = St::round(
      St::round(St::round(St::load(f.ax, c) * air) +
                St::round(St::load(f.bx, c) * p)) +
      St::round(St::load(f.dx, c) * p_xm));
  air = St::round(vy_old - St::round(courant * St::round(p - p_ym)));
  const float vy = St::round(
      St::round(St::round(St::load(f.ay, c) * air) +
                St::round(St::load(f.by, c) * p)) +
      St::round(St::load(f.dy, c) * p_ym));

  // -- streaming onset / flux / windowed energies in f32, on the state's
  // values: the running onset is compared against small-integer-valued f32
  // bounds, which are exact
  const float tf = (float)t;
  const float c_flux = tf - src_dir_n;
  const float c_dry = tf - dry_n;
  const float c_wet_lo = tf - dry_n - 1.0f;
  const float c_wet_hi = tf - dry_n - 1.0f - wet_n;

  float onset = first ? INFINITY : a[c];
  float fx = first ? 0.0f : a[acc_stride + c];
  float fy = first ? 0.0f : a[2 * acc_stride + c];
  float ed = first ? 0.0f : a[3 * acc_stride + c];
  float ew = first ? 0.0f : a[4 * acc_stride + c];
  float et = first ? 0.0f : a[5 * acc_stride + c];

  onset = fminf(onset, fabsf(p) > thr ? tf : INFINITY);
  const float mp = (onset > c_flux) ? p : 0.0f;
  fx = fx + mp * vx;
  fy = fy + mp * vy;
  const float sq = p * p;
  if (onset > c_dry) ed = ed + sq;
  if (onset <= c_wet_lo && onset > c_wet_hi) ew = ew + sq;
  et = et + sq;

  p_out[c] = St::store(p);  // record pre-injection; step t+1 injects pulse[t]
  vx_out[c] = St::store(vx);
  vy_out[c] = St::store(vy);
  a[c] = onset;
  a[acc_stride + c] = fx;
  a[2 * acc_stride + c] = fy;
  a[3 * acc_stride + c] = ed;
  a[4 * acc_stride + c] = ew;
  a[5 * acc_stride + c] = et;
}

template <typename S>
__global__ void rt60_moments_kernel(const S* __restrict__ rec,
                                    const float* __restrict__ onset,
                                    float* __restrict__ s0_out,
                                    float* __restrict__ s1_out,
                                    int64_t n_cells, int T, float dry_n1,
                                    float end, float log10_scale) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int64_t b = blockIdx.y;  // the listener
  rec += b * T * n_cells;
  const int64_t bc = b * n_cells + c;
  const float start = onset[bc] + dry_n1;
  float edc = 0.0f;
  float s0 = 0.0f;
  float s1 = 0.0f;
#pragma unroll 8
  for (int t = T - 1; t >= 0; --t) {
    const float p = State<S>::load(rec, (int64_t)t * n_cells + c);
    edc = edc + p * p;  // suffix sum including the current sample
    const float y = logf(fmaxf(edc, 1e-37f)) * log10_scale;
    const float tf = (float)t;
    if (tf >= start && tf < end) {
      s0 = s0 + y;
      s1 = s1 + (tf - start) * y;
    }
  }
  s0_out[bc] = s0;
  s1_out[bc] = s1;
}

template <typename S>
int launch_sim(const void* const* planes, const float* pulse, void* rec_v,
               float* acc, void* vel_v, const int* lcells, int nx, int ny,
               int T, int B, float courant, float thr, float src_dir_n,
               float dry_n, float wet_n, cudaStream_t s) {
  const Fields<S> f{
      static_cast<const S*>(planes[0]), static_cast<const S*>(planes[1]),
      static_cast<const S*>(planes[2]), static_cast<const S*>(planes[3]),
      static_cast<const S*>(planes[4]), static_cast<const S*>(planes[5]),
      static_cast<const S*>(planes[6])};
  S* rec = static_cast<S*>(rec_v);
  S* vel = static_cast<S*>(vel_v);
  const dim3 block(32, 8);
  const dim3 grid((ny + block.x - 1) / block.x, (nx + block.y - 1) / block.y,
                  B);
  const int64_t plane = (int64_t)nx * ny;
  const int64_t rec_stride = (int64_t)T * plane;
  const int64_t vel_stride = 4 * plane;
  for (int t = 0; t < T; ++t) {
    const S* p_prev = t > 0 ? rec + (int64_t)(t - 1) * plane : nullptr;
    S* p_out = rec + (int64_t)t * plane;
    const bool even = (t & 1) == 0;
    S* v_in = vel + (even ? 0 : 2) * plane;   // (vx, vy) of step t-1
    S* v_out = vel + (even ? 2 : 0) * plane;  // (vx, vy) of step t
    fdtd_step_kernel<S><<<grid, block, 0, s>>>(
        f, acc, p_prev, p_out, v_in, v_in + plane, v_out, v_out + plane,
        pulse, lcells, nx, ny, t, rec_stride, vel_stride, courant, thr,
        src_dir_n, dry_n, wet_n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// B listeners (lcells: [B, 2] int32 on the device). rec: [B, T, nx, ny],
// vel: [B, 4, nx, ny] (vx_a, vy_a, vx_b, vy_b), both of the state type
// (bf16 != 0: __nv_bfloat16, else float), as are the 7 field planes;
// acc: [6, B, nx, ny] float (onset, fx, fy, e_dry, e_wet, e_total).
extern "C" int pv_fdtd_sim(
    const void* beta, const void* ax, const void* bx, const void* dx,
    const void* ay, const void* by, const void* dy, const float* pulse,
    void* rec, float* acc, void* vel, const int* lcells, int nx, int ny,
    int T, int B, int bf16, float courant, float thr, float src_dir_n,
    float dry_n, float wet_n, void* stream) {
  const void* planes[7] = {beta, ax, bx, dx, ay, by, dy};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_sim<__nv_bfloat16>(planes, pulse, rec, acc, vel, lcells, nx,
                                     ny, T, B, courant, thr, src_dir_n, dry_n,
                                     wet_n, s);
  return launch_sim<float>(planes, pulse, rec, acc, vel, lcells, nx, ny, T, B,
                           courant, thr, src_dir_n, dry_n, wet_n, s);
}

// rec: [B, T, nx, ny] (bf16 != 0: __nv_bfloat16, else float); onset, s0,
// s1: [B, nx, ny] float.
extern "C" int pv_rt60_moments(const void* rec, const float* onset,
                               float* s0, float* s1, int nx, int ny, int T,
                               int B, int bf16, float dry_n1, float end,
                               float log10_scale, void* stream) {
  const int64_t n_cells = (int64_t)nx * ny;
  const int block = 128;
  const dim3 grid((unsigned)((n_cells + block - 1) / block), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    rt60_moments_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(rec), onset, s0, s1, n_cells, T,
        dry_n1, end, log10_scale);
  else
    rt60_moments_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(rec), onset, s0, s1, n_cells, T, dry_n1,
        end, log10_scale);
  return (int)cudaGetLastError();
}

extern "C" const char* pv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
