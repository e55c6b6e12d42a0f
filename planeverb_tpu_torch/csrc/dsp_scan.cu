// The DSP's two recurrences over the sample axis: D1, the batched biquad
// lowpass, and D2, the Schroeder reverb. Neither replaces a Pallas kernel:
// in the JAX package both are jax.lax.scans that XLA compiles into one
// device loop, where eager PyTorch would launch every op of a step once a
// sample (about 6 ops a sample for the biquad, 20 for the reverb: 30,000
// launches for mix_output's 512-frame callback). Here each is one launch.
//
// D1 `biquad_scan` replaces planeverb_tpu/dsp/lowpass.py::process_scan: for
// each source s of an [S, N] block, with coefficients from its cutoff
// (lowpass.py `coefficients`),
//   y[t] = (cx x[t] + cy1 y[t-1]) + cy2 y[t-2],
// a thread a source walking its N samples. What bounds it: the dependent
// chain of one step (two multiplies and two adds in turn, the y[t-1] product
// first) times N; the bytes (S x N read and written) are a few hundred KB.
//
// D2 `reverb_scan` replaces planeverb_tpu/dsp/reverb.py::reverb_scan: for
// each row (one channel of one reverb), 4 lowpass-comb lines, each a ring of
// length lc = max(comb delays) read at (pos - d_k) mod lc before the step's
// write at pos mod lc, summed x 0.25, then 2 series allpasses on rings of
// length la, pos wrapping at lcm(lc, la). A comb may read a sample written in
// the same block (blocks reach 4096 samples, the shortest comb delay is 1309
// at 44.1 kHz), so the loop over time is not split across threads. A launch
// takes a table of rows (a by-value kernel parameter, no copy to the device);
// a block a row loads its rings into shared memory (32.6 KB a row at 44.1
// kHz), one thread runs the recurrence on them, and the block writes the
// rings back. Input and output samples are staged through shared memory in
// chunks of kChunk, loaded and stored by the whole block. What bounds it:
// the serial step (its ring loads, the one-pole damping and the allpass
// chain) times N; the bytes are the rings read and written once.
//
// Numerics: built with -fmad=false and without fast math, every expression
// in the order of the plain versions (dsp/lowpass.py
// process_scan_reference, dsp/reverb.py reverb_scan_reference), so each
// kernel equals its plain version bit for bit; the coefficient divisions
// are IEEE divisions, as PyTorch's tensor-by-tensor division.
//
// Launchers allocate nothing, never synchronise, count their launches
// (common.cuh) and return cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kBiquadThreads = 128;
constexpr int kMaxRows = 32;      // rows a D2 launch (reverb.py MAX_ROWS)
constexpr int kReverbThreads = 256;
constexpr int kChunk = 1024;      // samples staged in shared memory at once

// ------------------------------------------------------------------- D1
__global__ void __launch_bounds__(kBiquadThreads)
    biquad_scan_kernel(const float* __restrict__ x,
                       const float* __restrict__ y1_in,
                       const float* __restrict__ y2_in,
                       const float* __restrict__ cutoff,
                       float* __restrict__ out, float* __restrict__ y1_out,
                       float* __restrict__ y2_out, int S, int N, float fs,
                       float two_pi, float sqrt2) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  // lowpass.py _coefficients_torch, op for op
  const float t = (two_pi * cutoff[s]) / fs;
  const float yy = 1.0f / ((1.0f + sqrt2 * t) + t * t);
  const float cx = (t * t) * yy;
  const float cy1 = (2.0f + sqrt2 * t) * yy;
  const float cy2 = -1.0f * yy;
  float a = y1_in[s];
  float b = y2_in[s];
  const float* xr = x + (size_t)s * N;
  float* orow = out + (size_t)s * N;
#pragma unroll 8
  for (int i = 0; i < N; ++i) {
    const float v = (cx * xr[i] + cy1 * a) + cy2 * b;
    orow[i] = v;
    b = a;
    a = v;
  }
  y1_out[s] = a;
  y2_out[s] = b;
}

// ------------------------------------------------------------------- D2
// One row of a launch (reverb.py / kernels.py ReverbRow mirrors it): its
// [N] input and output, its state in ([4, lc] combs, [4] damping memories,
// [2, la] allpasses, the counter) and the new state out; pos_out is null on
// every row of a state but its first.
struct ReverbRow {
  const float* x;
  float* out;
  const float* comb_in;
  float* comb_out;
  const float* lp_in;
  float* lp_out;
  const float* ap_in;
  float* ap_out;
  const int* pos_in;
  int* pos_out;
  float fb[4];
};

struct ReverbTable {
  ReverbRow r[kMaxRows];
};

struct Delays {
  int cd[4];
  int ad[2];
  int lc, la, wrap;
};

__device__ __forceinline__ int ring_back(int w, int d, int len) {
  const int r = w - d;           // d <= len
  return r < 0 ? r + len : r;
}

__device__ __forceinline__ int mod(long long a, int m) {
  const long long r = a % m;
  return (int)(r < 0 ? r + m : r);
}

__global__ void __launch_bounds__(kReverbThreads)
    reverb_scan_kernel(const __grid_constant__ ReverbTable table, int N,
                       const Delays dl, float damp, float one_minus_damp,
                       float g) {
  extern __shared__ float smem[];
  const ReverbRow& row = table.r[blockIdx.x];
  const int lc = dl.lc, la = dl.la;
  float* comb = smem;               // [4, lc]
  float* ap = comb + 4 * lc;        // [2, la]
  float* xs = ap + 2 * la;          // [kChunk]
  float* ys = xs + kChunk;          // [kChunk]
  for (int i = threadIdx.x; i < 4 * lc; i += blockDim.x)
    comb[i] = row.comb_in[i];
  for (int i = threadIdx.x; i < 2 * la; i += blockDim.x) ap[i] = row.ap_in[i];
  const long long pos0 = *row.pos_in;
  // thread 0's recurrence state: the damping memories and the write
  // positions pos mod lc and pos mod la (lc and la divide the wrap, so they
  // advance by one a step whatever the wrap does)
  float lp0 = 0.0f, lp1 = 0.0f, lp2 = 0.0f, lp3 = 0.0f;
  if (threadIdx.x == 0) {
    lp0 = row.lp_in[0];
    lp1 = row.lp_in[1];
    lp2 = row.lp_in[2];
    lp3 = row.lp_in[3];
  }
  int wc = mod(pos0, lc);
  int wa = mod(pos0, la);
  const float fb0 = row.fb[0], fb1 = row.fb[1], fb2 = row.fb[2],
              fb3 = row.fb[3];
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int m = min(kChunk, N - c0);
    __syncthreads();   // the rings are loaded; the last chunk is stored
    for (int i = threadIdx.x; i < m; i += blockDim.x) xs[i] = row.x[c0 + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 0; t < m; ++t) {
        const float xt = xs[t];
        // every comb reads its ring before the step writes it
        const float y0 = comb[ring_back(wc, dl.cd[0], lc)];
        const float y1 = comb[lc + ring_back(wc, dl.cd[1], lc)];
        const float y2 = comb[2 * lc + ring_back(wc, dl.cd[2], lc)];
        const float y3 = comb[3 * lc + ring_back(wc, dl.cd[3], lc)];
        lp0 = y0 * one_minus_damp + lp0 * damp;
        lp1 = y1 * one_minus_damp + lp1 * damp;
        lp2 = y2 * one_minus_damp + lp2 * damp;
        lp3 = y3 * one_minus_damp + lp3 * damp;
        comb[wc] = xt + lp0 * fb0;
        comb[lc + wc] = xt + lp1 * fb1;
        comb[2 * lc + wc] = xt + lp2 * fb2;
        comb[3 * lc + wc] = xt + lp3 * fb3;
        float s = (((y0 + y1) + y2) + y3) * 0.25f;
        const float b0 = ap[ring_back(wa, dl.ad[0], la)];
        ap[wa] = s + b0 * g;
        s = b0 - g * s;
        const float b1 = ap[la + ring_back(wa, dl.ad[1], la)];
        ap[la + wa] = s + b1 * g;
        s = b1 - g * s;
        ys[t] = s;
        wc = wc + 1 == lc ? 0 : wc + 1;
        wa = wa + 1 == la ? 0 : wa + 1;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) row.out[c0 + i] = ys[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * lc; i += blockDim.x)
    row.comb_out[i] = comb[i];
  for (int i = threadIdx.x; i < 2 * la; i += blockDim.x) row.ap_out[i] = ap[i];
  if (threadIdx.x == 0) {
    row.lp_out[0] = lp0;
    row.lp_out[1] = lp1;
    row.lp_out[2] = lp2;
    row.lp_out[3] = lp3;
    if (row.pos_out != nullptr)
      *row.pos_out = N > 0 ? mod(pos0 + N, dl.wrap) : (int)pos0;
  }
}

}  // namespace

// D1 over S sources of N samples: x [S, N], y1/y2/cutoff [S] -> out [S, N],
// y1_out/y2_out [S]. two_pi and sqrt2 are lowpass.py's float32 constants.
extern "C" int pv_biquad_scan(const float* x, const float* y1,
                              const float* y2, const float* cutoff,
                              float* out, float* y1_out, float* y2_out, int S,
                              int N, float fs, float two_pi, float sqrt2,
                              void* stream) {
  if (S < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const int blocks = (S + kBiquadThreads - 1) / kBiquadThreads;
  biquad_scan_kernel<<<blocks, kBiquadThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, y1, y2, cutoff, out, y1_out, y2_out, S, N, fs, two_pi, sqrt2);
  return pv::count_launch(pv::kBiquadScanKernel);
}

// D2 over a table of n <= kMaxRows rows (ReverbRow), each of N samples, on
// rings of lc and la samples with comb delays cd0..cd3 and allpass delays
// ad0, ad1 (each at least 1 and at most its ring), wrapping pos at wrap.
extern "C" int pv_reverb_scan(const void* rows, int n, int N, int cd0,
                              int cd1, int cd2, int cd3, int ad0, int ad1,
                              int lc, int la, int wrap, float damp,
                              float one_minus_damp, float g, void* stream) {
  if (n < 0 || n > kMaxRows || N < 0 || lc < 1 || la < 1 || wrap < 1)
    return (int)cudaErrorInvalidValue;
  const int cd[4] = {cd0, cd1, cd2, cd3};
  for (int k = 0; k < 4; ++k)
    if (cd[k] < 1 || cd[k] > lc) return (int)cudaErrorInvalidValue;
  if (ad0 < 1 || ad0 > la || ad1 < 1 || ad1 > la)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ReverbTable table;
  memcpy(table.r, rows, sizeof(ReverbRow) * n);
  const Delays dl = {{cd0, cd1, cd2, cd3}, {ad0, ad1}, lc, la, wrap};
  const size_t smem = sizeof(float) * (4 * (size_t)lc + 2 * (size_t)la
                                       + 2 * (size_t)kChunk);
  const int err = pv::set_smem((const void*)reverb_scan_kernel, smem);
  if (err != 0) return err;
  reverb_scan_kernel<<<n, kReverbThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      table, N, dl, damp, one_minus_damp, g);
  return pv::count_launch(pv::kReverbScanKernel);
}

// sizeof(ReverbRow), for kernels.py's check of its ctypes mirror.
extern "C" int pv_reverb_row_bytes() { return (int)sizeof(ReverbRow); }
