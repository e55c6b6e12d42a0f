// RT60 moments (B2) for Hopper: one launch over every recording a device
// holds, a warp a tile of cells streaming its columns through a ring in
// shared memory and taking a chunk's logarithms as independent chains.
//
// B2 `rt60_moments` replaces planeverb_tpu/ops/fdtd_pallas.py::_moments_kernel
// in all its modes: one listener, B listeners (`batched=True`), the shards of
// a sharded pass (parallel/solver_pallas.py's moment sites), float32 or bf16
// recordings (each sample read as float). For each cell of a [T, cells]
// recording, walking t from T-1 down to 0 (ops/_common.py moment_step):
//   edc += p^2  (the suffix sum, accumulated backward),
//   y = ln(max(edc, 1e-37)) * 10/ln10,
//   and where t lies in [onset + dry_n + 1, T - schroeder_off):
//   s0 += y, s1 += (t - start) * y.
//
// What bounds it on this card: one read of the recordings (175 MB at the
// 192x192x1187 headline in float32, half that in bf16: 0.052 / 0.026 ms at
// 3.35 TB/s) and the instructions of one logf per sample (about 27 with
// the max and the scale, without fast math), one a cycle on each of 132
// SMs x 4 schedulers. At the headline the field has 36,864 cells, so a
// design with a thread a cell has 8.7 warps an SM: the earlier one walked
// each column with direct loads and kept too few bytes in flight, and its
// loads and logarithms added up.
//
// The design: a launch takes a table of up to kMaxEntries recordings (a
// by-value kernel parameter: no copy to the device and no host sync), each
// with its onset and s0/s1 outputs, and its grid covers every entry's
// tiles of kTile consecutive cells (ops/fdtd_fused.py moments_table builds
// the tiling). A one-warp block owns a tile, a lane a cell, and walks time
// backward in chunks of kChunk rows:
//   - its own ring of kStages chunks in shared memory, filled by 16-byte
//     cp.async (kStages - 1 chunks in flight while one is read: about 6 KB
//     a warp, 50 KB an SM at the headline), so the bytes in flight are set
//     by the ring and not by the warps; the warp syncs only itself;
//   - the chunk's edc, serial per lane, then the chunk's kChunk logarithms,
//     independent chains that fill the pipeline of the few warps an SM
//     has, then the sums s0 and s1 in order;
//   - the logarithms only of chunks that meet some lane's window (the
//     plain version selects y only inside the window, so the ones taken
//     outside it change no bit).
// Only the three sums and edc stay serial. The other shape tried, a
// 128-thread block a tile whose four warps share the logarithms through
// shared memory, ran its blocks' serial phases in lockstep and was slower
// than either.
//
// Rows that do not start 16-byte aligned (X*Y*4 bytes a row not a multiple
// of 16, as at 29x29 or 459^2; or a recording whose first sample is not
// aligned) are the kernel's own case, not a fallback: a row's tile is copied
// as the 16-byte words that cover it (at most one word more) and read from
// its byte offset in the first word. A word is 16-byte aligned, so it never
// crosses a page: its bytes outside the recording are read, never used.
// The table's `aligned` flag lets a block whose every row is aligned skip
// the offset arithmetic.
//
// Numerics: built with -fmad=false and without fast math, every expression
// in the plain version's order: exact logf (not __logf), the 1e-37 clamp,
// the +inf onset sentinel (a window that never opens). The window test
// t >= start, t < end of the plain version (float t, exact below 2^24) is
// taken as integer bounds, the least t with float(t) >= start (ceil), which
// is the same test. Offsets are 64-bit.
//
// Launchers allocate nothing, never synchronise, count their launches
// (common.cuh; the probe's are counted nowhere) and return
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 32;         // cells a tile: a warp, a lane a cell
constexpr int kChunk = 16;        // rows (time steps) of a ring stage
constexpr int kStages = 4;        // ring stages
constexpr int kMaxEntries = 64;   // recordings a launch
constexpr int kNever = 1 << 30;   // a window bound no t reaches

// One recording of a launch (kernels.py MomentsEntry mirrors it).
struct Entry {
  const void* rec;      // [T, cells], float or __nv_bfloat16
  const float* onset;   // [cells]
  float* s0;            // [cells]
  float* s1;            // [cells]
  long long cells;
  int tile0;            // the launch's first block of this recording
  int aligned;          // every row starts 16-byte aligned
};

struct Table {
  Entry e[kMaxEntries];
  int n;
};

// What a probe runs: everything, the loads and sums without the logarithms,
// or the logarithms and sums on samples made in registers.
enum Mode : int { kFull = 0, kNoLog = 1, kNoLoad = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A probe's sample, made in registers from (t, cell) so the compiler keeps
// every logarithm.
__device__ __forceinline__ float made_sample(int t, int64_t c) {
  const unsigned h = (unsigned)t * 2654435761u ^ (unsigned)c * 40503u;
  return (float)(h >> 20) * 1e-3f;
}

// The block's recording: the last entry whose first block is at or before
// it (the table's tiles are in entry order).
__device__ __forceinline__ const Entry& entry_of(const Table& table,
                                                 int block) {
  int e = 0;
  while (e + 1 < table.n && table.e[e + 1].tile0 <= block) ++e;
  return table.e[e];
}

// The least t >= 0 with (float)t >= x, which is ceil(x) for the integer t
// below 2^24 of a recording; kNever where no t is (x +inf or NaN, for which
// the plain version's comparisons are false).
__device__ __forceinline__ int first_t(float x) {
  if (!(x <= (float)kNever)) return kNever;
  return x <= 0.0f ? 0 : (int)ceilf(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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

// 16-byte words of a ring row: a tile's bytes and one more for a row that
// starts mid-word.
template <typename S>
constexpr int kRowWords = kTile * (int)sizeof(S) / 16 + 1;

template <typename S>
using Ring = uint4[kStages][kChunk][kRowWords<S>];

// Rows [lo, hi) of chunk i: chunk 0 holds the last kChunk rows, the last
// chunk the first T mod kChunk (or kChunk).
__device__ __forceinline__ int chunk_hi(int T, int i) { return T - i * kChunk; }
__device__ __forceinline__ int chunk_lo(int T, int i) {
  return max(chunk_hi(T, i) - kChunk, 0);
}

// Sample `lane` of row t (row k of its stage): the row's first tile sample
// sits (base + t * row_bytes) mod 16 bytes into its first word (32-bit
// arithmetic suffices modulo 16).
template <typename S, bool kAligned>
__device__ __forceinline__ float ring_sample(const uint4* row, int t,
                                             unsigned base, unsigned row_bytes,
                                             int lane) {
  const int off =
      kAligned ? 0 : (int)((base + (unsigned)t * row_bytes) & 15u) /
                         (int)sizeof(S);
  return to_float(reinterpret_cast<const S*>(row)[off + lane]);
}

// The kernel's tile: one warp, a lane a cell, walks the tile's columns
// with a ring of its own (kStages chunks of kChunk rows) and no barrier
// but the warp's own.
template <typename S, int kMode, bool kAligned>
__device__ __forceinline__ void warp_tile(const Entry& en, int tile, int T,
                                          float dry_n1, float end,
                                          float log10_scale, Ring<S>& ring) {
  // the copy: a lane copies word cw of rows cr, cr + R, ... of a chunk
  constexpr int W = kTile * (int)sizeof(S) / 16 + (kAligned ? 0 : 1);
  constexpr int R = 32 / W;
  constexpr int P = (kChunk + R - 1) / R;
  const int lane = threadIdx.x;
  const int cr = lane / W;
  const int cw = lane - cr * W;
  const int64_t cells = en.cells;
  const int64_t c0 = (int64_t)tile * kTile;
  const int n = (int)min((int64_t)kTile, cells - c0);
  const S* rec = static_cast<const S*>(en.rec) + c0;  // row 0's first cell
  const int64_t stride = cells * (int64_t)sizeof(S);  // bytes a row
  const float start = lane < n ? en.onset[c0 + lane] + dry_n1 : INFINITY;
  const int t_lo = first_t(start);  // the window: t_lo <= t < t_hi
  const int t_hi = first_t(end);
  // the rows some lane's window holds: [w_lo, t_hi)
  const int w_lo = __reduce_min_sync(0xffffffffu, t_lo);
  const int n_full = T / kChunk;                    // chunks of kChunk rows
  const int n_chunks = n_full + (T % kChunk != 0);  // and the first rows
  const unsigned base = (unsigned)(uintptr_t)rec;
  const unsigned row_bytes = (unsigned)stride;
  // an aligned row's words past the tile's last cell are not copied
  const bool word_ok =
      lane < R * W && (!kAligned || 16 * cw < n * (int)sizeof(S));

  auto fetch = [&](int i) {
    if (kMode != kNoLoad && i < n_chunks) {
      const int lo = chunk_lo(T, i);
      const int rows = chunk_hi(T, i) - lo;
      uintptr_t a = (uintptr_t)rec + (uintptr_t)((lo + cr) * stride);
#pragma unroll
      for (int m = 0; m < P; ++m) {
        const int k = cr + m * R;
        if (kAligned) {
          if (word_ok && k < rows)
            cp_async16(&ring[i % kStages][k][cw], (const void*)(a + 16 * cw));
        } else {
          const int shift = (int)(a & 15);
          if (word_ok && k < rows && 16 * cw < shift + n * (int)sizeof(S))
            cp_async16(&ring[i % kStages][k][cw],
                       (const void*)((a & ~(uintptr_t)15) + 16 * cw));
        }
        a += (uintptr_t)(R * stride);
      }
    }
    cp_async_commit();  // one group a chunk, empty or not
  };

  float edc = 0.0f;
  float s0 = 0.0f;
  float s1 = 0.0f;
  // chunk i: its rows' edc, then, where some lane's window meets it, their
  // logarithms (independent of one another: they fill the pipeline; the
  // plain version uses y only inside the window, so the others change
  // nothing) and the sums in order, newest row first
  auto chunk = [&](int i, auto full) {
    constexpr bool kFullChunk = decltype(full)::value;
    const int lo = chunk_lo(T, i);
    const int hi = chunk_hi(T, i);
    cp_async_wait<kStages - 1>();  // this lane's copies of chunk i
    __syncwarp();                  // ... and the other lanes'
    float e[kChunk];
#pragma unroll
    for (int k = kChunk - 1; k >= 0; --k) {
      const int t = lo + k;
      if (kFullChunk || t < hi) {
        const float p =
            kMode == kNoLoad
                ? made_sample(t, c0 + lane)
                : ring_sample<S, kAligned>(ring[i % kStages][k], t, base,
                                           row_bytes, lane);
        edc = edc + p * p;  // suffix sum including the current sample
      }
      e[k] = edc;
    }
    __syncwarp();        // every lane has read the stage
    fetch(i + kStages);  // into it
    if (lo < t_hi && hi > w_lo) {
      if (kMode != kNoLog) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          e[k] = logf(fmaxf(e[k], 1e-37f)) * log10_scale;
      }
      const float tf0 = (float)lo;
      if (__all_sync(0xffffffffu, kFullChunk && lo >= t_lo && hi <= t_hi)) {
        // every row inside every lane's window
#pragma unroll
        for (int k = kChunk - 1; k >= 0; --k) {
          s0 = s0 + e[k];
          s1 = s1 + ((tf0 + (float)k) - start) * e[k];
        }
      } else {
#pragma unroll
        for (int k = kChunk - 1; k >= 0; --k) {
          const int t = lo + k;
          if ((kFullChunk || t < hi) && t >= t_lo && t < t_hi) {
            s0 = s0 + e[k];
            s1 = s1 + ((tf0 + (float)k) - start) * e[k];
          }
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages; ++s) fetch(s);
  for (int i = 0; i < n_full; ++i) chunk(i, std::true_type{});
  if (n_chunks > n_full) chunk(n_full, std::false_type{});
  if (lane < n) {
    en.s0[c0 + lane] = s0;
    en.s1[c0 + lane] = s1;
  }
}

template <typename S, int kMode>
__global__ void __launch_bounds__(kTile)
    rt60_moments_kernel(const __grid_constant__ Table table, int T,
                        float dry_n1, float end, float log10_scale) {
  __shared__ Ring<S> ring;
  const Entry& en = entry_of(table, blockIdx.x);
  const int tile = (int)blockIdx.x - en.tile0;
  if (en.aligned)
    warp_tile<S, kMode, true>(en, tile, T, dry_n1, end, log10_scale, ring);
  else
    warp_tile<S, kMode, false>(en, tile, T, dry_n1, end, log10_scale, ring);
}

bool make_table(const void* entries, int n, int tiles, Table* table) {
  if (n < 1 || n > kMaxEntries || tiles < 1) return false;
  memset(table, 0, sizeof(Table));
  memcpy(table->e, entries, (size_t)n * sizeof(Entry));
  table->n = n;
  return true;
}

template <typename S, int kMode>
void launch(const Table& table, int tiles, int T, float dry_n1, float end,
            float log10_scale, cudaStream_t s) {
  rt60_moments_kernel<S, kMode><<<tiles, kTile, 0, s>>>(table, T, dry_n1, end,
                                                        log10_scale);
}

template <typename S>
void launch_mode(int mode, const Table& table, int tiles, int T, float dry_n1,
                 float end, float log10_scale, cudaStream_t s) {
  if (mode == kNoLog)
    launch<S, kNoLog>(table, tiles, T, dry_n1, end, log10_scale, s);
  else if (mode == kNoLoad)
    launch<S, kNoLoad>(table, tiles, T, dry_n1, end, log10_scale, s);
  else
    launch<S, kFull>(table, tiles, T, dry_n1, end, log10_scale, s);
}

}  // namespace

// entries: n (1 .. kMaxEntries) Entry records of [T, cells] recordings, all
// float (bf16 == 0) or all __nv_bfloat16, their onsets and s0/s1 outputs,
// and their first blocks (tile0); tiles: the blocks of the launch, kTile
// cells each.
extern "C" int pv_rt60_moments(const void* entries, int n, int tiles, int T,
                               int bf16, float dry_n1, float end,
                               float log10_scale, void* stream) {
  Table table;
  if (!make_table(entries, n, tiles, &table))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16, kFull>(table, tiles, T, dry_n1, end, log10_scale,
                                 s);
  else
    launch<float, kFull>(table, tiles, T, dry_n1, end, log10_scale, s);
  return pv::count_launch(pv::kRt60MomentsKernel);
}

// The same with a probe's mode (0 everything, 1 no logarithms, 2 no
// loads); counted nowhere. Its s0/s1 equal pv_rt60_moments's in mode 0
// only.
extern "C" int pv_rt60_moments_probe(const void* entries, int n, int tiles,
                                     int T, int bf16, float dry_n1, float end,
                                     float log10_scale, int mode,
                                     void* stream) {
  Table table;
  if (!make_table(entries, n, tiles, &table) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch_mode<__nv_bfloat16>(mode, table, tiles, T, dry_n1, end,
                               log10_scale, s);
  else
    launch_mode<float>(mode, table, tiles, T, dry_n1, end, log10_scale, s);
  return (int)cudaGetLastError();
}

// sizeof(Entry), which kernels.py MomentsEntry mirrors.
extern "C" int pv_moments_entry_bytes() { return (int)sizeof(Entry); }
