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
//   y[t] = (cx x[t] + cy1 y[t-1]) + cy2 y[t-2].
// What bounds it: the dependent chain of one step (the y[t-1] product and
// two adds in turn) times N; the bytes (S x N read and written) are a few
// hundred KB. A warp owns 32 sources, a lane a source, and a block is one
// warp (S = 256 spreads over 8 SMs). The warp streams [32 sources x
// kBiquadChunk] tiles of x through a ring of kBiquadStages tiles in shared
// memory with cp.async (16-byte copies where N % 4 == 0 and the rows start
// 16-byte aligned, else 4-byte ones), each row read contiguously, so the
// loads coalesce; a tile row is kBiquadChunk + 4 floats (an odd number of
// 16-byte words), so the lanes' float4 reads of their own rows, and of the
// output tiles, meet no bank conflict. The outputs go back through a
// second pair of tiles and are stored along the rows. One chunk's copies
// and the last chunk's stores are spread over its steps, into the chain's
// stalls.
//
// D2 `reverb_scan` replaces planeverb_tpu/dsp/reverb.py::reverb_scan: for
// each row (one channel of one reverb), 4 lowpass-comb lines, each a ring of
// length lc = max(comb delays) read at (pos - d_k) mod lc before the step's
// write at pos mod lc, summed x 0.25, then 2 series allpasses on rings of
// length la, pos wrapping at lcm(lc, la). A launch takes a table of rows (a
// by-value kernel parameter, no copy to the device), a block a row, its
// rings in shared memory (32.6 KB a row at 44.1 kHz, moved in and out with
// bulk asynchronous copies where address and size are 16-byte multiples,
// else with word copies). What bounds it: the one loop-carried chain, each
// comb's damping memory lp = y (1 - d) + lp d, times N. Nothing else is
// serial over short distances: comb k at step t reads what it wrote at
// t - cd_k, allpass j what it wrote at t - ad_j. So the block runs a row in
// chunks of C = min(cd_k) steps (at most kReverbChunk), in which every comb
// read precedes every comb write:
//   1. gather: every thread reads the chunk's 4 x C comb outputs, their
//      sum and the input into shared memory;
//   2. the four damping chains, one a lane of warp 0, beside the two
//      allpasses on the other warps (the allpasses read the sum, not the
//      chains): allpass 0, then allpass 1, in sub-chunks of at most ad_j
//      steps, each first all its ring reads, a barrier, then all its
//      writes, a barrier;
//   3. every thread writes the chunk's comb ring slots and its output.
// Within a chunk (or sub-chunk) every read is of a step at least one delay
// back, hence from before the chunk; the barrier between reads and writes
// is needed all the same, as a later step may overwrite a slot an earlier
// step has yet to read (comb k's slot comes back after lc - cd_k steps,
// allpass j's after la - ad_j).
//
// Numerics: built with -fmad=false and without fast math, every expression
// in the order of the plain versions (dsp/lowpass.py
// process_scan_reference, dsp/reverb.py reverb_scan_reference), so each
// kernel equals its plain version bit for bit; the coefficient divisions
// are IEEE divisions, as PyTorch's tensor-by-tensor division.
//
// Launchers allocate nothing, never synchronise, count their launches
// (common.cuh) and return cudaGetLastError() (0 on success).
// pv_dsp_chain_probe runs each recurrence's chain alone, for chip_smoke.py;
// it is counted nowhere.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kBiquadChunk = 32;   // samples a tile
constexpr int kBiquadStages = 4;   // tiles in the ring: 3 in flight
constexpr int kBiquadRow = kBiquadChunk + 4;   // floats a tile row
constexpr int kBiquadWords = kBiquadChunk / 4;  // 16-byte words a tile row
constexpr int kMaxRows = 32;       // rows a D2 launch (reverb.py MAX_ROWS)
constexpr int kReverbThreads = 256;
constexpr int kApThreads = kReverbThreads - kWarp;   // the allpasses' warps
constexpr int kReverbChunk = 1024;  // the longest chunk of steps
constexpr int kMaxDevices = 64;     // cards whose D2 opt-in is remembered

static_assert(kBiquadRow / 4 % 2 == 1, "a tile row must be an odd number "
              "of 16-byte words");

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------- D1
// kVec: 16-byte copies and stores (N % 4 == 0, x and out 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kWarp)
    biquad_scan_kernel(const float* __restrict__ x,
                       const float* __restrict__ y1_in,
                       const float* __restrict__ y2_in,
                       const float* __restrict__ cutoff,
                       float* __restrict__ out, float* __restrict__ y1_out,
                       float* __restrict__ y2_out, int S, int N, float fs,
                       float two_pi, float sqrt2) {
  __shared__ __align__(16) float tiles[kBiquadStages][kWarp][kBiquadRow];
  __shared__ __align__(16) float otiles[2][kWarp][kBiquadRow];
  const int lane = threadIdx.x;
  const int s0 = blockIdx.x * kWarp;
  const int s = s0 + lane;
  const bool live = s < S;
  float cx = 0.0f, cy1 = 0.0f, cy2 = 0.0f, a = 0.0f, b = 0.0f;
  if (live) {
    // lowpass.py _coefficients_torch, op for op
    const float t = (two_pi * cutoff[s]) / fs;
    const float yy = 1.0f / ((1.0f + sqrt2 * t) + t * t);
    cx = (t * t) * yy;
    cy1 = (2.0f + sqrt2 * t) * yy;
    cy2 = -1.0f * yy;
    a = y1_in[s];
    b = y2_in[s];
  }
  const int chunks = (N + kBiquadChunk - 1) / kBiquadChunk;

  // part g (of kBiquadWords) of tile c's copies, the lanes along the rows:
  // a 16-byte word a lane, 4 rows a warp (kVec), or a word a lane of each
  // of 4 rows
  auto issue = [&](int c, int g) {
    if (c >= chunks) return;
    float(*tile)[kBiquadRow] = tiles[c % kBiquadStages];
    const int t0 = c * kBiquadChunk;
    if (kVec) {
      const int i = g * kWarp + lane;
      const int r = i / kBiquadWords, w = 4 * (i % kBiquadWords);
      if (s0 + r < S && t0 + w < N)
        cp_async16(&tile[r][w], x + (size_t)(s0 + r) * N + t0 + w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * g + k;
        if (s0 + r < S && t0 + lane < N)
          cp_async4(&tile[r][lane], x + (size_t)(s0 + r) * N + t0 + lane);
      }
    }
  };
  // part g of output tile c's stores, along the rows
  auto store = [&](int c, int g) {
    if (c < 0) return;
    float(*tile)[kBiquadRow] = otiles[c & 1];
    const int t0 = c * kBiquadChunk;
    if (kVec) {
      const int i = g * kWarp + lane;
      const int r = i / kBiquadWords, w = 4 * (i % kBiquadWords);
      if (s0 + r < S && t0 + w < N)
        *reinterpret_cast<float4*>(out + (size_t)(s0 + r) * N + t0 + w) =
            *reinterpret_cast<const float4*>(&tile[r][w]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * g + k;
        if (s0 + r < S && t0 + lane < N)
          out[(size_t)(s0 + r) * N + t0 + lane] = tile[r][lane];
      }
    }
  };
  // one chunk of this lane's chain; kFull: all kBiquadChunk steps, else
  // the first m. Copies of tile c + kBiquadStages - 1 and stores of output
  // tile c - 1 ride along.
  auto run = [&](auto full, int c, int m) {
    constexpr bool kFull = decltype(full)::value;
    const float* xt = tiles[c % kBiquadStages][lane];
    float* ot = otiles[c & 1][lane];
#pragma unroll
    for (int g = 0; g < kBiquadWords; ++g) {
      issue(c + kBiquadStages - 1, g);
      store(c - 1, g);
      const float4 v4 = *reinterpret_cast<const float4*>(xt + 4 * g);
      const float xv[4] = {v4.x, v4.y, v4.z, v4.w};
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (kFull || 4 * g + k < m) {
          const float v = (cx * xv[k] + cy1 * a) + cy2 * b;
          o[k] = v;
          b = a;
          a = v;
        }
      }
      *reinterpret_cast<float4*>(ot + 4 * g) = make_float4(o[0], o[1], o[2],
                                                           o[3]);
    }
  };

  for (int c = 0; c < kBiquadStages - 1; ++c) {
#pragma unroll
    for (int g = 0; g < kBiquadWords; ++g) issue(c, g);
    cp_async_commit();    // one group a tile, empty or not
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kBiquadStages - 2>();   // this lane's copies of tile c
    __syncwarp();   // every lane's; tile c - 1 and output tile c - 1 done
    const int m = min(kBiquadChunk, N - c * kBiquadChunk);
    if (m == kBiquadChunk)
      run(std::true_type{}, c, m);
    else
      run(std::false_type{}, c, m);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();
#pragma unroll
  for (int g = 0; g < kBiquadWords; ++g) store(chunks - 1, g);
  if (live) {
    y1_out[s] = a;
    y2_out[s] = b;
  }
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

__device__ __forceinline__ int mod(long long a, int m) {
  const long long r = a % m;
  return (int)(r < 0 ? r + m : r);
}

// the bulk asynchronous copies (one thread issues them) and their barrier
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(gmem), "r"(smem_addr(smem)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the allpasses' warps (1 to 7) meet at named barrier 1
__device__ __forceinline__ void ap_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kApThreads) : "memory");
}

__global__ void __launch_bounds__(kReverbThreads)
    reverb_scan_kernel(const __grid_constant__ ReverbTable table, int N,
                       const Delays dl, float damp, float one_minus_damp,
                       float g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bar_word;
  const ReverbRow& row = table.r[blockIdx.x];
  const int tid = threadIdx.x;
  const int lc = dl.lc, la = dl.la;
  float* ys = smem;                     // [4, kReverbChunk]: y, then lp
  float* ss = ys + 4 * kReverbChunk;    // [kReverbChunk]: the sum, s
  float* xs = ss + kReverbChunk;        // [kReverbChunk]
  float* comb = xs + kReverbChunk;      // [4, lc], 16-byte aligned
  float* ap = comb + 4 * lc;            // [2, la], 16-byte aligned

  // -- the rings in: bulk copies where address and size allow, else words
  const unsigned comb_bytes = 16u * lc, ap_bytes = 8u * la;
  const bool comb_bulk = aligned16(row.comb_in);
  const bool ap_bulk = ap_bytes % 16 == 0 && aligned16(row.ap_in);
  const unsigned bulk_bytes =
      (comb_bulk ? comb_bytes : 0u) + (ap_bulk ? ap_bytes : 0u);
  const unsigned bar = smem_addr(&bar_word);
  if (tid == 0 && bulk_bytes > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && bulk_bytes > 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bulk_bytes)
        : "memory");
    if (comb_bulk) bulk_load(comb, row.comb_in, comb_bytes, bar);
    if (ap_bulk) bulk_load(ap, row.ap_in, ap_bytes, bar);
  }
  if (!comb_bulk)
    for (int i = tid; i < 4 * lc; i += blockDim.x) comb[i] = row.comb_in[i];
  if (!ap_bulk)
    for (int i = tid; i < 2 * la; i += blockDim.x) ap[i] = row.ap_in[i];
  const long long pos0 = *row.pos_in;
  // lane k < 4 of warp 0 carries comb k's damping memory
  float lp = tid < 4 ? row.lp_in[tid] : 0.0f;
  const int cmin = min(min(dl.cd[0], dl.cd[1]), min(dl.cd[2], dl.cd[3]));
  const int chunk = min(cmin, kReverbChunk);
  // the write positions pos mod lc and pos mod la at the chunk's start (lc
  // and la divide the wrap, so they advance by one a step whatever the
  // wrap does)
  int wc = mod(pos0, lc);
  int wa = mod(pos0, la);
  __syncthreads();   // the word copies
  if (bulk_bytes > 0) mbar_wait(bar, 0);

  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int L = min(chunk, N - c0);
    // 1. gather: y_k[t] = comb_k[(pos_t - cd_k) mod lc], their sum, x
    for (int t = tid; t < L; t += blockDim.x) {
      float y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int r = wc + t - dl.cd[k];   // in [-lc, lc): t < L <= cd_k
        if (r < 0) r += lc;
        y[k] = comb[k * lc + r];
        ys[k * kReverbChunk + t] = y[k];
      }
      ss[t] = (((y[0] + y[1]) + y[2]) + y[3]) * 0.25f;
      xs[t] = row.x[c0 + t];
    }
    __syncthreads();
    if (tid < kWarp) {
      // 2a. the damping chains, lp = y (1 - d) + lp d, in place of y; the
      // next 16 values are loaded before this 16's chain
      if (tid < 4) {
        float4* yk = reinterpret_cast<float4*>(ys + tid * kReverbChunk);
        const int l16 = L / 16;
        float4 nx[4];
        if (l16 > 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) nx[i] = yk[i];
        }
        for (int q = 0; q < l16; ++q) {
          float v[16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[4 * i] = nx[i].x;
            v[4 * i + 1] = nx[i].y;
            v[4 * i + 2] = nx[i].z;
            v[4 * i + 3] = nx[i].w;
          }
          if (q + 1 < l16) {
#pragma unroll
            for (int i = 0; i < 4; ++i) nx[i] = yk[4 * (q + 1) + i];
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            lp = v[i] * one_minus_damp + lp * damp;
            v[i] = lp;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            yk[4 * q + i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                        v[4 * i + 3]);
        }
        float* yt = ys + tid * kReverbChunk;
        for (int t = 16 * l16; t < L; ++t) {
          lp = yt[t] * one_minus_damp + lp * damp;
          yt[t] = lp;
        }
      }
    } else {
      // 2b. the allpasses on s, in sub-chunks of at most ad_j steps
      const int at = tid - kWarp;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ad = dl.ad[j];
        const int A = min(ad, kApThreads);
        float* apj = ap + j * la;
        int pa = wa;   // (pos of step a0) mod la
        for (int a0 = 0; a0 < L; a0 += A) {
          const int t = a0 + at;
          const bool on = at < A && t < L;
          int w = 0;
          float bv = 0.0f, sv = 0.0f;
          if (on) {
            w = pa + at;   // at < A <= la
            if (w >= la) w -= la;
            int r = w - ad;
            if (r < 0) r += la;
            bv = apj[r];
            sv = ss[t];
          }
          ap_sync();   // every read of the sub-chunk before its writes
          if (on) {
            apj[w] = sv + bv * g;
            ss[t] = bv - g * sv;
          }
          ap_sync();   // its writes before the next sub-chunk's reads
          pa += A;
          if (pa >= la) pa -= la;
        }
      }
    }
    __syncthreads();
    // 3. the comb writes comb_k[pos_t mod lc] = x + lp_k fb_k, the output
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float fb = row.fb[k];
      for (int t = tid; t < L; t += blockDim.x) {
        int w = wc + t;   // < 2 lc: t < L <= lc
        if (w >= lc) w -= lc;
        comb[k * lc + w] = xs[t] + ys[k * kReverbChunk + t] * fb;
      }
    }
    for (int t = tid; t < L; t += blockDim.x) row.out[c0 + t] = ss[t];
    wc += L;
    if (wc >= lc) wc -= lc;
    wa = (wa + L) % la;
    __syncthreads();   // the writes before the next chunk's gather
  }

  // -- the rings out: bulk copies where address and size allow, else words
  const bool comb_bulk_out = aligned16(row.comb_out);
  const bool ap_bulk_out = ap_bytes % 16 == 0 && aligned16(row.ap_out);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0 && (comb_bulk_out || ap_bulk_out)) {
    if (comb_bulk_out) bulk_store(row.comb_out, comb, comb_bytes);
    if (ap_bulk_out) bulk_store(row.ap_out, ap, ap_bytes);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  if (!comb_bulk_out)
    for (int i = tid; i < 4 * lc; i += blockDim.x) row.comb_out[i] = comb[i];
  if (!ap_bulk_out)
    for (int i = tid; i < 2 * la; i += blockDim.x) row.ap_out[i] = ap[i];
  if (tid < 4) row.lp_out[tid] = lp;
  if (tid == 0) {
    if (row.pos_out != nullptr)
      *row.pos_out = N > 0 ? mod(pos0 + N, dl.wrap) : (int)pos0;
    if (comb_bulk_out || ap_bulk_out)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// -------------------------------------------------------- chain probes
// Each recurrence's loop-carried ops alone, on inputs made in registers
// (off the chain), with no memory traffic in the loop: D1's step (kind 0)
// and D2's damping memory (kind 1), N steps on every lane of every block.
// cycles[block] is its first lane's clock64 count over the loop.
__global__ void __launch_bounds__(kWarp)
    dsp_chain_probe_kernel(int kind, int N, float c0, float c1, float c2,
                           float* out, long long* cycles) {
  const int lane = threadIdx.x;
  float a = 1e-3f * (float)lane, b = 0.0f;
  const float x0 = 0.5f + 1e-3f * (float)(blockIdx.x * kWarp + lane);
  const long long t0 = clock64();
  if (kind == 0) {
#pragma unroll 8
    for (int i = 0; i < N; ++i) {
      const float x = x0 + (float)(i & 255);
      const float v = (c0 * x + c1 * a) + c2 * b;
      b = a;
      a = v;
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < N; ++i) {
      const float y = x0 + (float)(i & 255);
      a = y * c0 + a * c1;
    }
  }
  const long long t1 = clock64();
  out[blockIdx.x * kWarp + lane] = a + b;
  if (lane == 0) cycles[blockIdx.x] = t1 - t0;
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
  const int blocks = (S + kWarp - 1) / kWarp;
  const bool vec = N % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    biquad_scan_kernel<true><<<blocks, kWarp, 0, st>>>(
        x, y1, y2, cutoff, out, y1_out, y2_out, S, N, fs, two_pi, sqrt2);
  else
    biquad_scan_kernel<false><<<blocks, kWarp, 0, st>>>(
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
  const size_t smem = sizeof(float) * (6 * (size_t)kReverbChunk
                                       + 4 * (size_t)lc + 2 * (size_t)la);
  // the opt-in is a per-card attribute of the kernel: set it only when a
  // launch needs more than the card was last given
  static size_t opted[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices || smem > opted[dev]) {
    const int err = pv::set_smem((const void*)reverb_scan_kernel, smem);
    if (err != 0) return err;
    if (dev >= 0 && dev < kMaxDevices) opted[dev] = smem;
  }
  reverb_scan_kernel<<<n, kReverbThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      table, N, dl, damp, one_minus_damp, g);
  return pv::count_launch(pv::kReverbScanKernel);
}

// sizeof(ReverbRow), for kernels.py's check of its ctypes mirror.
extern "C" int pv_reverb_row_bytes() { return (int)sizeof(ReverbRow); }

// The chain probes (chip_smoke.py only, counted nowhere): kind 0 D1's
// step, kind 1 D2's damping memory, N steps on blocks x 32 lanes, with
// coefficients c0, c1, c2; out [blocks x 32] the lanes' last values,
// cycles [blocks] each block's first lane's clock64 cycles over its loop.
extern "C" int pv_dsp_chain_probe(int kind, int blocks, int N, float c0,
                                  float c1, float c2, float* out,
                                  long long* cycles, void* stream) {
  if (kind < 0 || kind > 1 || blocks < 1 || N < 0)
    return (int)cudaErrorInvalidValue;
  dsp_chain_probe_kernel<<<blocks, kWarp, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      kind, N, c0, c1, c2, out, cycles);
  return (int)cudaGetLastError();
}
