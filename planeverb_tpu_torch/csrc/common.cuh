// What the kernel sources of planeverb_tpu_torch share: the device launch
// counters of the library's kernels, the shared-memory opt-in, and the
// in-kernel fold of the stencil coefficients (B3 and B6).
#pragma once

#include <cuda_runtime.h>

namespace pv {

// The library's kernels, in the order of kernels.py DEVICE_KERNELS. Each
// launcher adds one to its kernel's count at every launch the runtime
// accepted; pv_device_launches (fdtd_fused.cu) reads and resets them.
enum DeviceKernel : int {
  kFdtdClusterKernel = 0,
  kRt60MomentsKernel,
  kFdtdTiledKernel,
  kRt60MomentsTiledKernel,
  kBiquadScanKernel,
  kReverbScanKernel,
  kAnalysisAssembleKernel,
  kAnalysisDirectionsKernel,
  kShardedRoundKernel,
  kBandedRoundKernel,
  kDeviceKernels
};

long long* device_launch_counts();

// The error of the launch just made (`launched`, what a launch call
// returned, else the runtime's last error), after counting it if it was
// accepted. Clears the last error.
inline int count_launch(DeviceKernel k, cudaError_t launched = cudaSuccess) {
  const cudaError_t last = cudaGetLastError();
  const cudaError_t err = launched != cudaSuccess ? launched : last;
  if (err == cudaSuccess) ++device_launch_counts()[k];
  return (int)err;
}

// Opt in to more than 48 KB of dynamic shared memory. A refused size leaves
// no error pending, so the next launch reports its own.
inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// The six velocity coefficients of one cell: A, B, D along x, then along y.
struct Folded {
  float ax, bx, dx, ay, by, dy;
};

// ops/fdtd.py stencil_coefficients for one cell, in its order (the kernels
// build with -fmad=false, so every op rounds as PyTorch's do): from the
// cell's air flag beta and wall admittance Y, those of its (i-1, j) and
// (i, j-1) neighbours (0 where the caller's window has none), and its global
// cell (gi, gj), which places the edge terms at rows and columns 0 and gx /
// gy: the impedance ABC masked to the in-grid span where `absorbing`, else
// rigid outer walls.
__device__ __forceinline__ Folded fold_cell(float beta, float Y, float b_xm,
                                            float y_xm, float b_ym,
                                            float y_ym, int gi, int gj,
                                            int gx, int gy, bool absorbing) {
  const float w_x = (b_xm - beta) * (beta * y_xm + b_xm * Y);
  const float a_x = beta * b_xm;
  const float bc_x = w_x * beta;
  const float d_x = w_x * b_xm;
  const float w_y = (b_ym - beta) * (beta * y_ym + b_ym * Y);
  const float a_y = beta * b_ym;
  const float bc_y = w_y * beta;
  const float d_y = w_y * b_ym;
  const bool row0 = gi == 0;
  const bool rowg = gi == gx;
  const bool col0 = gj == 0;
  const bool colg = gj == gy;
  float eb_x = 0.0f, ed_x = 0.0f, eb_y = 0.0f, ed_y = 0.0f;
  if (absorbing) {
    const float in_gy = gj < gy ? 1.0f : 0.0f;
    const float in_gx = gi < gx ? 1.0f : 0.0f;
    eb_x = -in_gy;
    ed_x = in_gy;
    eb_y = -in_gx;
    ed_y = in_gx;
  }
  Folded k;
  k.ax = (row0 || rowg) ? 0.0f : a_x;
  k.bx = row0 ? eb_x : (rowg ? 0.0f : bc_x);
  k.dx = rowg ? ed_x : (row0 ? 0.0f : d_x);
  k.ay = (col0 || colg) ? 0.0f : a_y;
  k.by = col0 ? eb_y : (colg ? 0.0f : bc_y);
  k.dy = colg ? ed_y : (col0 ? 0.0f : d_y);
  return k;
}

}  // namespace pv
