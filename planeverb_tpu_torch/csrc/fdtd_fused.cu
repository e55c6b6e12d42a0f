// Fused FDTD simulation (B1) kernel for Hopper.
//
// B1 `fdtd_sim` replaces planeverb_tpu/ops/fdtd_pallas.py::_kernel, in all
// its modes: one listener or B of them (`batched=True`), f32 or bf16 wave
// state (`state_dtype`). Per step it updates pressure, then vx, then vy
// (velocities read the pre-injection pressure), records the pre-injection
// pressure into rec[b, t], and streams the onset (first |p| > thr, +inf
// sentinel), the source-directivity flux fx/fy += p*v while onset > t -
// src_dir_n, and the windowed energies e_dry / e_wet / e_total, in one
// launch a pass, as the TPU kernel keeps the whole field in VMEM for all T
// steps. It holds fields of at most kClusterCells cells, which is every grid
// the route sends to B1 (ops/fdtd_fused.py route_tiled); the launcher refuses
// a larger one, which the tiled kernels (fdtd_tiled.cu) step.
//
//   One thread-block cluster of kCluster = 16 blocks (a non-portable size)
//   per listener holds its field in the blocks' shared memory: block `rank`
//   owns the cells [rank * L, rank * L + L) of the row-major field, and its
//   shared memory holds their beta and six coefficient planes (loaded once
//   from L2) and p, vx, vy of the two step parities. A thread owns up to
//   three cells, c = c0 + tid + q * blockDim (a warp's cells are
//   consecutive, so its recording stores coalesce), with their state of
//   the last step and their accumulators in registers. A step is: the
//   pressure of its cells (vy of (i, j+1) from the next lane by
//   __shfl_sync, vx of (i+1, j) from shared memory), a block barrier, the
//   velocities (p of (i, j-1) from the previous lane, p of (i-1, j) from
//   the block's new pressures), one cluster barrier. Where a neighbour
//   lies in another block (a strip's edge rows, a block's first cell), the
//   thread reads that block's step t-1 state through distributed shared
//   memory and recomputes the neighbour's pre-injection pressure itself
//   (cluster_pressure, with the listener's pending injection), so the
//   cluster barrier is the only one across blocks; it is split into arrive
//   and wait, with the recording and the accumulators between. The last
//   wait also keeps every block alive until no block reads its shared
//   memory. Onset, flux and energies go to global memory once, at the end.
//
//   Batched mode: B clusters (blockIdx.y the listener) share one copy of
//   beta and the six coefficient planes (they are listener-invariant, as in
//   the TPU kernel), each reading them from L2; each listener has its own
//   recording [B, T, nx, ny] and accumulators [6, B, nx, ny]. A listener's
//   blocks run exactly the single-listener arithmetic, so the batch is
//   bit-equal to B single passes.
//
//   bf16 mode (S = __nv_bfloat16): p (the recording), vx, vy, beta and the
//   coefficient planes are stored in bf16; each operation is computed in
//   float and rounded to bf16 once, in the plain version's order (which is
//   what PyTorch's bf16 elementwise kernels do). The pulse is rounded to
//   bf16 before it is injected. Onset, flux and energies stay f32 and read
//   the bf16 values exactly (p32 = float(p)).
//
//   What bounds it on this card: at the 192x192 headline the whole state
//   (~2.5 MB a listener) fits the cluster's shared memory, and the bytes
//   the pass must move are the recording's 175 MB, ~0.05 ms at the HBM
//   rate. The pass is bound by the latency of its T steps (the dependent
//   loads and arithmetic of up to 2304 cells an SM on either side of a
//   block barrier, and a cluster barrier each).
//
// B2 (the RT60 moments) lives in moments.cu; this file keeps the device
// launch counters of the library's kernels (pv_device_launches).
//
// Numerics: built with -fmad=false and without fast math, every expression in
// the order the plain PyTorch versions (ops/fdtd_fused.py) evaluate it, so
// each op rounds once as PyTorch's elementwise kernels do. The +inf onset
// sentinel relies on IEEE semantics (no FTZ). Recording offsets are 64-bit.
//
// Launchers allocate nothing, never synchronise, count their launches
// (common.cuh; this file holds the counters) and return cudaGetLastError()
// (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

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

// -- one thread-block cluster a listener for the whole pass. Block `rank`
// of the cluster owns the cells [rank * L, rank * L + L) of the row-major
// field (L = ceil(nx * ny / kCluster)); its shared memory holds their 13
// planes: beta and the six coefficients, then p, vx and vy of the two step
// parities. A cell's neighbours (c +- 1, c +- ny and the two diagonals
// cluster_pressure reaches) are read from whichever block owns them,
// through distributed shared memory, at addresses computed once a pass.
constexpr int kCluster = 16;          // blocks a cluster (non-portable)
constexpr int kClusterThreads = 768;  // most threads a block
constexpr int kClusterRun = 3;        // most cells a thread
constexpr int kClusterPlanes = 13;
constexpr int kClusterCells = kCluster * kClusterThreads * kClusterRun;

enum : int { kBeta = 0, kAx, kBx, kDx, kAy, kBy, kDy, kP0, kP1, kVx0, kVx1,
             kVy0, kVy1 };

// Address of element n of plane 0 for a block of rank `rank`: a shared::cta
// address where this block holds it, else the shared::cluster address of
// the block that does (block n / L) with bit 0 set (elements are 2-byte
// aligned, so bit 0 is free). Local reads then take the SM's own shared
// memory path and only a strip's edge rows cross to a neighbour.
__device__ __forceinline__ uint32_t cluster_addr(const void* base, int n,
                                                 int L, int esize, int rank) {
  const uint32_t local =
      (uint32_t)__cvta_generic_to_shared(base) + (uint32_t)((n % L) * esize);
  const int owner = n / L;
  if (owner == rank) return local;
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"((uint32_t)owner));
  return remote | 1u;
}

template <typename S>
__device__ __forceinline__ float cluster_load(uint32_t addr);

template <>
__device__ __forceinline__ float cluster_load<float>(uint32_t addr) {
  float v;
  if (addr & 1u)
    asm volatile("ld.shared::cluster.f32 %0, [%1];"
                 : "=f"(v)
                 : "r"(addr - 1u));
  else
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

template <>
__device__ __forceinline__ float cluster_load<__nv_bfloat16>(uint32_t addr) {
  unsigned short v;
  if (addr & 1u)
    asm volatile("ld.shared::cluster.b16 %0, [%1];"
                 : "=h"(v)
                 : "r"(addr - 1u));
  else
    asm volatile("ld.shared.b16 %0, [%1];" : "=h"(v) : "r"(addr));
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// Pre-injection pressure of step t at the cell at `a` (row i, column j),
// recomputed from the previous step's state on distributed shared memory:
// p_old (+ pulse[t-1] at the listener), then p = beta * (p_old - C * div v),
// with zero velocity beyond the edges. Its +x neighbour is at `a_xp` and its
// +y neighbour at `a_yp`; `po`, `vxo`, `vyo` are the byte offsets of the
// previous step's planes.
template <typename S>
__device__ __forceinline__ float cluster_pressure(
    uint32_t a, uint32_t a_xp, uint32_t a_yp, int i, int j, int nx, int ny,
    uint32_t po, uint32_t vxo, uint32_t vyo, int lix, int liy, float inj,
    float courant) {
  using St = State<S>;
  float p = cluster_load<S>(a + po);
  if (i == lix && j == liy) p = St::round(p + inj);
  const float vxc = cluster_load<S>(a + vxo);
  const float vyc = cluster_load<S>(a + vyo);
  const float vx_xp = (i + 1 < nx) ? cluster_load<S>(a_xp + vxo) : 0.0f;
  const float vy_yp = (j + 1 < ny) ? cluster_load<S>(a_yp + vyo) : 0.0f;
  const float div = St::round(St::round(vx_xp - vxc) + St::round(vy_yp - vyc));
  return St::round(cluster_load<S>(a) *
                   St::round(p - St::round(courant * div)));
}

template <typename S>
__global__ void __launch_bounds__(kClusterThreads, 1)
fdtd_cluster_kernel(Fields<S> f, float* __restrict__ acc,
                    S* __restrict__ rec, const float* __restrict__ pulse,
                    const int* __restrict__ lcells, int nx, int ny, int T,
                    int L, float courant, float thr, float src_dir_n,
                    float dry_n, float wet_n) {
  using St = State<S>;
  extern __shared__ __align__(16) unsigned char cluster_smem[];
  S* sm = reinterpret_cast<S*>(cluster_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;               // the listener
  const int N = nx * ny;
  const int c0 = rank * L;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nt = blockDim.x;
  const int es = (int)sizeof(S);
  const uint32_t plane = (uint32_t)L * es;
  const uint32_t sm_base = (uint32_t)__cvta_generic_to_shared(sm);
  const int lix = lcells[2 * b];
  const int liy = lcells[2 * b + 1];
  const unsigned full = 0xffffffffu;
  rec += (int64_t)b * T * N;

  // -- the block's cells: the seven field planes from L2, state at rest
  const S* planes[7] = {f.beta, f.ax, f.bx, f.dx, f.ay, f.by, f.dy};
  for (int idx = tid; idx < L; idx += nt) {
    const int c = c0 + idx;
    const bool in = c < N;
#pragma unroll
    for (int q = 0; q < 7; ++q)
      sm[q * L + idx] = in ? planes[q][c] : St::store(0.0f);
#pragma unroll
    for (int q = kP0; q < kClusterPlanes; ++q)
      sm[q * L + idx] = St::store(0.0f);
  }

  // -- per cell (c = c0 + tid + q * nt, so a warp's cells are consecutive):
  // its state of the last step and its accumulators in registers, and the
  // addresses of the neighbours a lane cannot take from another lane
  int cell[kClusterRun], ci[kClusterRun], cj[kClusterRun];
  uint32_t a_xp[kClusterRun], a_xm[kClusterRun], a_yp[kClusterRun],
      a_ym[kClusterRun];
  float po[kClusterRun], vxo[kClusterRun], vyo[kClusterRun];
  float on[kClusterRun], fx[kClusterRun], fy[kClusterRun], ed[kClusterRun],
      ew[kClusterRun], et[kClusterRun];
#pragma unroll
  for (int q = 0; q < kClusterRun; ++q) {
    const int idx = tid + q * nt;
    const int c = c0 + idx;
    const bool ok = idx < L && c < N;
    cell[q] = ok ? c : -1;
    const int i = c / ny;
    const int j = c - i * ny;
    ci[q] = i;
    cj[q] = j;
    a_xp[q] = ok && i + 1 < nx ? cluster_addr(sm, c + ny, L, es, rank) : 0u;
    a_xm[q] = ok && i > 0 ? cluster_addr(sm, c - ny, L, es, rank) : 0u;
    a_yp[q] = ok && j + 1 < ny ? cluster_addr(sm, c + 1, L, es, rank) : 0u;
    a_ym[q] = ok && j > 0 ? cluster_addr(sm, c - 1, L, es, rank) : 0u;
    po[q] = vxo[q] = vyo[q] = 0.0f;
    on[q] = INFINITY;
    fx[q] = fy[q] = ed[q] = ew[q] = et[q] = 0.0f;
  }
  cluster.sync();   // every block's planes are in place

  for (int t = 0; t < T; ++t) {
    const bool first = (t == 0);
    const float inj = first ? 0.0f : St::round(pulse[t - 1]);
    const int old = (t + 1) & 1;          // step t-1's parity
    const int cur = t & 1;
    const uint32_t p_old = (kP0 + old) * plane;
    const uint32_t vx_old = (kVx0 + old) * plane;
    const uint32_t vy_old = (kVy0 + old) * plane;
    const uint32_t p_cur = (kP0 + cur) * plane;

    // -- pressure of the thread's cells: p = beta * (p_old - C * div v),
    // p_old with the pending injection of step t-1 at the listener. vy of
    // (i, j+1) is the next lane's register, else shared memory; vx of
    // (i+1, j) comes from shared memory, this block's or a neighbour's.
    float pn[kClusterRun];
#pragma unroll
    for (int q = 0; q < kClusterRun; ++q) {
      const int idx = tid + q * nt;
      const int i = ci[q];
      const int j = cj[q];
      const bool ok = cell[q] >= 0;
      const float vy_next = __shfl_down_sync(full, vyo[q], 1);
      float p = 0.0f;
      if (ok && !first) {
        const float vx_xp =
            (i + 1 < nx) ? cluster_load<S>(a_xp[q] + vx_old) : 0.0f;
        const float vy_yp =
            (j + 1 < ny)
                ? ((lane < 31 && idx + 1 < L)
                       ? vy_next
                       : cluster_load<S>(a_yp[q] + vy_old))
                : 0.0f;
        float pv = po[q];
        if (i == lix && j == liy) pv = St::round(pv + inj);
        const float div =
            St::round(St::round(vx_xp - vxo[q]) + St::round(vy_yp - vyo[q]));
        p = St::round(St::load(sm, kBeta * L + idx) *
                      St::round(pv - St::round(courant * div)));
      }
      pn[q] = p;
      if (ok) sm[(kP0 + cur) * L + idx] = St::store(p);
    }
    __syncthreads();   // this block's new pressures are in place

    // -- velocities: walls + edge ABC prefolded, v' = A*air + B*p + D*p_m.
    // p of (i, j-1) is the previous lane's; p of (i-1, j) is read from this
    // block's new pressures, or recomputed from a neighbour block's state of
    // step t-1 (cluster_pressure), as is (i, j-1) across a block edge.
    const float tf = (float)t;
    const float c_flux = tf - src_dir_n;
    const float c_dry = tf - dry_n;
    const float c_wet_lo = tf - dry_n - 1.0f;
    const float c_wet_hi = tf - dry_n - 1.0f - wet_n;
    float vxn[kClusterRun], vyn[kClusterRun];
#pragma unroll
    for (int q = 0; q < kClusterRun; ++q) {
      const int idx = tid + q * nt;
      const int i = ci[q];
      const int j = cj[q];
      const int c = cell[q];
      const float p = pn[q];
      const float p_left = __shfl_up_sync(full, p, 1);
      vxn[q] = vyn[q] = 0.0f;
      if (c < 0) continue;
      const uint32_t a_c = sm_base + (uint32_t)(idx * es);
      float p_xm = 0.0f;
      if (i > 0 && !first) {
        p_xm = (a_xm[q] & 1u)
                   ? cluster_pressure<S>(
                         a_xm[q], a_c,
                         j + 1 < ny ? cluster_addr(sm, c - ny + 1, L, es, rank)
                                    : 0u,
                         i - 1, j, nx, ny, p_old, vx_old, vy_old, lix, liy,
                         inj, courant)
                   : cluster_load<S>(a_xm[q] + p_cur);
      }
      float p_ym = 0.0f;
      if (j > 0 && !first) {
        if (lane > 0)
          p_ym = p_left;
        else if (!(a_ym[q] & 1u))
          p_ym = cluster_load<S>(a_ym[q] + p_cur);
        else
          p_ym = cluster_pressure<S>(
              a_ym[q],
              i + 1 < nx ? cluster_addr(sm, c - 1 + ny, L, es, rank) : 0u,
              a_c, i, j - 1, nx, ny, p_old, vx_old, vy_old, lix, liy, inj,
              courant);
      }
      const S* own = sm + idx;
      float air = St::round(vxo[q] - St::round(courant * St::round(p - p_xm)));
      const float vx = St::round(
          St::round(St::round(St::load(own, kAx * L) * air) +
                    St::round(St::load(own, kBx * L) * p)) +
          St::round(St::load(own, kDx * L) * p_xm));
      air = St::round(vyo[q] - St::round(courant * St::round(p - p_ym)));
      const float vy = St::round(
          St::round(St::round(St::load(own, kAy * L) * air) +
                    St::round(St::load(own, kBy * L) * p)) +
          St::round(St::load(own, kDy * L) * p_ym));
      sm[(kVx0 + cur) * L + idx] = St::store(vx);
      sm[(kVy0 + cur) * L + idx] = St::store(vy);
      vxn[q] = vx;
      vyn[q] = vy;
    }
    // step t's state is complete here: arrive, then record and accumulate
    // while the other blocks finish, then wait (the last wait is also the
    // barrier before any block exits, so no block reads a block that is gone)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    S* rec_t = rec + (int64_t)t * N;
#pragma unroll
    for (int q = 0; q < kClusterRun; ++q) {
      if (cell[q] < 0) continue;
      const float p = pn[q];
      const float vx = vxn[q];
      const float vy = vyn[q];
      // streaming onset / flux / windowed energies in f32, on the state's
      // values: the running onset is compared against small-integer-valued
      // f32 bounds, which are exact
      const float onset = fminf(on[q], fabsf(p) > thr ? tf : INFINITY);
      const float mp = (onset > c_flux) ? p : 0.0f;
      on[q] = onset;
      fx[q] = fx[q] + mp * vx;
      fy[q] = fy[q] + mp * vy;
      const float sq = p * p;
      if (onset > c_dry) ed[q] = ed[q] + sq;
      if (onset <= c_wet_lo && onset > c_wet_hi) ew[q] = ew[q] + sq;
      et[q] = et[q] + sq;
      rec_t[cell[q]] = St::store(p);  // record pre-injection
      po[q] = p;
      vxo[q] = vx;
      vyo[q] = vy;
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }

  const int64_t acc_stride = (int64_t)gridDim.y * N;
  float* a = acc + (int64_t)b * N;
#pragma unroll
  for (int q = 0; q < kClusterRun; ++q) {
    if (cell[q] < 0) continue;
    const int c = cell[q];
    a[c] = on[q];
    a[acc_stride + c] = fx[q];
    a[2 * acc_stride + c] = fy[q];
    a[3 * acc_stride + c] = ed[q];
    a[4 * acc_stride + c] = ew[q];
    a[5 * acc_stride + c] = et[q];
  }
}

// Cells a block of the cluster owns, and its dynamic shared memory.
int cluster_run(int nx, int ny) {
  return (int)(((int64_t)nx * ny + kCluster - 1) / kCluster);
}

template <typename S>
size_t cluster_smem(int L) {
  return (size_t)kClusterPlanes * L * sizeof(S);
}

template <typename S>
int set_cluster_attrs(int L) {
  const void* k = (const void*)fdtd_cluster_kernel<S>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cluster_smem<S>(L));
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

template <typename S>
cudaLaunchConfig_t cluster_config(int L, int B, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  const int threads = L < kClusterThreads ? (L + 31) / 32 * 32
                                          : kClusterThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = cluster_smem<S>(L);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename S>
int launch_sim(const void* const* planes, const float* pulse, void* rec_v,
               float* acc, const int* lcells, int nx, int ny, int T, int B,
               float courant, float thr, float src_dir_n, float dry_n,
               float wet_n, cudaStream_t s) {
  // a field larger than a cluster holds is refused
  if ((int64_t)nx * ny > kClusterCells) return (int)cudaErrorInvalidValue;
  const Fields<S> f{
      static_cast<const S*>(planes[0]), static_cast<const S*>(planes[1]),
      static_cast<const S*>(planes[2]), static_cast<const S*>(planes[3]),
      static_cast<const S*>(planes[4]), static_cast<const S*>(planes[5]),
      static_cast<const S*>(planes[6])};
  const int L = cluster_run(nx, ny);
  const int err = set_cluster_attrs<S>(L);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<S>(L, B, s, &attr);
  return pv::count_launch(
      pv::kFdtdClusterKernel,
      cudaLaunchKernelEx(&cfg, fdtd_cluster_kernel<S>, f, acc,
                         static_cast<S*>(rec_v), pulse, lcells, nx, ny, T, L,
                         courant, thr, src_dir_n, dry_n, wet_n));
}

}  // namespace

// B listeners (lcells: [B, 2] int32 on the device), one launch of B
// clusters, nx * ny <= kCluster * kClusterThreads * kClusterRun. rec:
// [B, T, nx, ny] of the state type (bf16 != 0: __nv_bfloat16, else float),
// as are the 7 field planes; acc: [6, B, nx, ny] float (onset, fx, fy,
// e_dry, e_wet, e_total).
extern "C" int pv_fdtd_sim(
    const void* beta, const void* ax, const void* bx, const void* dx,
    const void* ay, const void* by, const void* dy, const float* pulse,
    void* rec, float* acc, const int* lcells, int nx, int ny, int T, int B,
    int bf16, float courant, float thr, float src_dir_n, float dry_n,
    float wet_n, void* stream) {
  const void* planes[7] = {beta, ax, bx, dx, ay, by, dy};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_sim<__nv_bfloat16>(planes, pulse, rec, acc, lcells, nx, ny,
                                     T, B, courant, thr, src_dir_n, dry_n,
                                     wet_n, s);
  return launch_sim<float>(planes, pulse, rec, acc, lcells, nx, ny, T, B,
                           courant, thr, src_dir_n, dry_n, wet_n, s);
}

// Clusters the card can hold at once for an nx x ny field
// (cudaOccupancyMaxActiveClusters), or -(CUDA error) if it refuses.
extern "C" int pv_fdtd_cluster_occupancy(int nx, int ny, int bf16) {
  const int L = cluster_run(nx, ny);
  int err = bf16 ? set_cluster_attrs<__nv_bfloat16>(L)
                 : set_cluster_attrs<float>(L);
  if (err != 0) return -err;
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t e;
  if (bf16) {
    const cudaLaunchConfig_t cfg =
        cluster_config<__nv_bfloat16>(L, 1, nullptr, &attr);
    e = cudaOccupancyMaxActiveClusters(
        &clusters, fdtd_cluster_kernel<__nv_bfloat16>, &cfg);
  } else {
    const cudaLaunchConfig_t cfg = cluster_config<float>(L, 1, nullptr, &attr);
    e = cudaOccupancyMaxActiveClusters(&clusters, fdtd_cluster_kernel<float>,
                                       &cfg);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return clusters;
}

long long* pv::device_launch_counts() {
  static long long counts[pv::kDeviceKernels] = {};
  return counts;
}

// Copies the device launch counts of the library's kernels (common.cuh
// DeviceKernel order) into out[0 .. n), zeroes them if reset != 0, and
// returns how many kernels the library counts.
extern "C" int pv_device_launches(long long* out, int n, int reset) {
  long long* counts = pv::device_launch_counts();
  for (int i = 0; i < pv::kDeviceKernels; ++i) {
    if (i < n) out[i] = counts[i];
    if (reset) counts[i] = 0;
  }
  return pv::kDeviceKernels;
}

extern "C" const char* pv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
