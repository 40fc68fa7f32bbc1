// Inclusive segmented cumsum over rows with ascending keys (sm_90a).
//
// Replaces the TPU kernel distillbev_tpu/ops/pallas_segmented.py
// segmented_cumsum_pallas (_seg_scan_kernel, :26; pallas_call :96):
//     out[i, c] = sum of vals[j, c] over j <= i with keys[j] == keys[i],
// keys int32 ascending, vals fp32 or bf16, out fp32, summed in fp32.
//
// The TPU kernel walks 512-row tiles in order on one core, scans each tile
// with one MXU matmul against a 0/1 mask and carries the running row of the
// open segment in VMEM from one grid step to the next.  Hopper blocks run in
// no order, so nothing carries between them: the carry becomes a pass of its
// own.  Three launches on one stream, deterministic, no atomics:
//   1. tile scan: one block per tile of T rows (T * C <= 4096 values, 16
//      rows a thread for C <= 256).  The block copies its tile to shared
//      memory (coalesced, bf16 widened to fp32), each thread scans its rows
//      of one channel in order, a Hillis-Steele scan over the (started,
//      trailing sum) pairs of the row groups joins the groups, and the tile
//      is written out scanned from its own first row.  The tile's pair goes
//      to a small array: the sum of its trailing segment, and whether any
//      segment starts inside it.
//   2. carry scan: one block per channel scans the tile pairs the same way
//      (a serial run per thread, then Hillis-Steele across the threads) and
//      writes each tile's carry: the sum of the segment that is open when
//      the tile begins, over the rows before it.
//   3. fix-up: a tile whose first row continues a segment adds its carry to
//      its leading rows (those before its first segment start); every other
//      tile returns at once.
// A long segment costs what many short ones cost: no thread walks more than
// its 16 rows of it in pass 1, where a design with one thread or warp per
// segment would serialise on it (the dynamic voxel encoder's dropped points
// form one segment of ~246,000 rows).
//
// Bound: memory.  The function must read N*C values and N keys and write
// N*C fp32 values: 128.6 MB at [249,216, 64] fp32, ~38 us at 3.35 TB/s.
// Pass 1 moves exactly that.  Pass 2 moves (N / T) * C floats; pass 3
// rewrites only the leading rows of the tiles that continue a segment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileValues = 4096;

// Thread layout of a tile for C channels: `groups` row groups of `rows`
// consecutive rows, each group covering `cp` channels a pass.
struct Layout {
  int cp;
  int groups;
  int rows;
  int tile;
};

__host__ __device__ inline Layout layout_for(int c) {
  Layout l;
  l.cp = c < kThreads ? c : kThreads;
  l.groups = kThreads / l.cp;
  const int r = kTileValues / (l.groups * c);
  l.rows = r > 0 ? r : 1;
  l.tile = l.groups * l.rows;
  return l;
}

// Rows of the tile starting at row0 (the last tile may be short).
__device__ inline int tile_rows(const Layout& l, int n, int64_t row0) {
  const int64_t left = static_cast<int64_t>(n) - row0;
  return left < l.tile ? static_cast<int>(left) : l.tile;
}

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Inclusive scan over g of the pairs at s_flag/s_sum[g * cp + cl] with
// (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2).  Every thread of the
// block calls it; `active` threads own a pair.
__device__ void pair_scan(int* s_flag, float* s_sum, int g, int cl, int cp,
                          int groups, bool active) {
  const int me = g * cp + cl;
  for (int d = 1; d < groups; d <<= 1) {
    const bool take = active && g >= d;
    int f = 0;
    float v = 0.f;
    if (take) {
      f = s_flag[me - d * cp];
      v = s_sum[me - d * cp];
    }
    __syncthreads();
    if (take && !s_flag[me]) {
      s_sum[me] = v + s_sum[me];
      s_flag[me] = f;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const T* __restrict__ vals, const int32_t* __restrict__ keys,
                 float* __restrict__ out, float* __restrict__ tile_sum,
                 int32_t* __restrict__ tile_started, int n, int c) {
  __shared__ float s_val[kTileValues];
  __shared__ unsigned char s_start[kTileValues];
  __shared__ int s_flag[kThreads];
  __shared__ float s_sum[kThreads];
  const Layout l = layout_for(c);
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * l.tile;
  const int rows = tile_rows(l, n, row0);
  for (int i = tid; i < rows; i += kThreads) {
    const int64_t r = row0 + i;
    s_start[i] = r == 0 || keys[r] != keys[r - 1];
  }
  const int64_t base = row0 * c;
  const int count = rows * c;
  for (int e = tid; e < count; e += kThreads) s_val[e] = to_f32(vals[base + e]);
  __syncthreads();

  const int g = tid / l.cp;
  const int cl = tid - g * l.cp;
  const bool active = g < l.groups;
  const int r_begin = g * l.rows;
  const int r_end = min(r_begin + l.rows, rows);
  for (int c0 = 0; c0 < c; c0 += l.cp) {
    const int ch = c0 + cl;
    const bool on = active && ch < c;
    int started = 0;
    float acc = 0.f;
    if (on) {
      for (int i = r_begin; i < r_end; ++i) {
        const float v = s_val[i * c + ch];
        if (s_start[i]) {
          acc = v;
          started = 1;
        } else {
          acc += v;
        }
        s_val[i * c + ch] = acc;
      }
    }
    if (active) {
      s_flag[tid] = started;
      s_sum[tid] = acc;
    }
    __syncthreads();
    pair_scan(s_flag, s_sum, g, cl, l.cp, l.groups, active);
    if (on && g > 0) {
      // rows before the group's first start continue the segment that is
      // open at the end of the previous groups
      const float carry = s_sum[tid - l.cp];
      for (int i = r_begin; i < r_end && !s_start[i]; ++i) {
        s_val[i * c + ch] += carry;
      }
    }
    if (on && g == l.groups - 1) {
      tile_sum[static_cast<int64_t>(blockIdx.x) * c + ch] = s_sum[tid];
      if (ch == 0) tile_started[blockIdx.x] = s_flag[tid];
    }
    __syncthreads();
  }
  for (int e = tid; e < count; e += kThreads) out[base + e] = s_val[e];
}

// One block per channel: carry[t, ch] = sum over the rows before tile t of
// the segment open at tile t's first row (0 for tile 0).
__global__ void __launch_bounds__(kThreads)
carry_scan_kernel(const float* __restrict__ tile_sum,
                  const int32_t* __restrict__ tile_started,
                  float* __restrict__ carry, int tiles, int c) {
  __shared__ int s_flag[kThreads];
  __shared__ float s_sum[kThreads];
  const int ch = blockIdx.x;
  const int tid = threadIdx.x;
  const int per = (tiles + kThreads - 1) / kThreads;
  const int t_begin = min(tid * per, tiles);
  const int t_end = min(t_begin + per, tiles);
  int started = 0;
  float acc = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const float v = tile_sum[static_cast<int64_t>(t) * c + ch];
    if (tile_started[t]) {
      acc = v;
      started = 1;
    } else {
      acc += v;
    }
  }
  s_flag[tid] = started;
  s_sum[tid] = acc;
  __syncthreads();
  pair_scan(s_flag, s_sum, tid, 0, 1, kThreads, true);
  float run = tid > 0 ? s_sum[tid - 1] : 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int64_t at = static_cast<int64_t>(t) * c + ch;
    carry[at] = run;
    run = tile_started[t] ? tile_sum[at] : run + tile_sum[at];
  }
}

// Block b fixes tile t = b + 1: its leading rows, those with the key of the
// row before the tile, get the tile's carry.
__global__ void __launch_bounds__(kThreads)
carry_fixup_kernel(const int32_t* __restrict__ keys,
                   const float* __restrict__ carry, float* __restrict__ out,
                   int n, int c) {
  const Layout l = layout_for(c);
  const int64_t t = static_cast<int64_t>(blockIdx.x) + 1;
  const int64_t row0 = t * l.tile;
  const int32_t open_key = keys[row0 - 1];
  if (keys[row0] != open_key) return;
  const int rows = tile_rows(l, n, row0);
  const float* cr = carry + t * c;
  float* dst = out + row0 * c;
  for (int e = threadIdx.x; e < rows * c; e += kThreads) {
    const int i = e / c;
    if (keys[row0 + i] != open_key) break;   // keys ascend: a prefix
    dst[e] += cr[e - i * c];
  }
}

template <typename T>
int launch(const T* vals, const int32_t* keys, float* out, float* tile_sum,
           int32_t* tile_started, float* carry, int n, int c, void* stream) {
  if (n <= 0 || c <= 0) return static_cast<int>(cudaGetLastError());
  const Layout l = layout_for(c);
  const int tiles = (n + l.tile - 1) / l.tile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_scan_kernel<T><<<tiles, kThreads, 0, s>>>(vals, keys, out, tile_sum,
                                                 tile_started, n, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  carry_scan_kernel<<<c, kThreads, 0, s>>>(tile_sum, tile_started, carry,
                                           tiles, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_fixup_kernel<<<tiles - 1, kThreads, 0, s>>>(keys, carry, out, n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows per tile for C channels; the caller sizes tile_sum and carry as
// [ceil(n / tile), C] fp32 and tile_started as [ceil(n / tile)] int32.
extern "C" int segmented_scan_tile_rows(int c) { return layout_for(c).tile; }

// vals [n, c] fp32; keys [n] int32 ascending; out [n, c] fp32.  Launches on
// `stream` and returns the first cudaGetLastError() that is not 0.
extern "C" int segmented_scan_f32(const float* vals, const int32_t* keys,
                                  float* out, float* tile_sum,
                                  int32_t* tile_started, float* carry, int n,
                                  int c, void* stream) {
  return launch(vals, keys, out, tile_sum, tile_started, carry, n, c, stream);
}

// As segmented_scan_f32 with vals [n, c] bf16.
extern "C" int segmented_scan_bf16(const void* vals, const int32_t* keys,
                                   float* out, float* tile_sum,
                                   int32_t* tile_started, float* carry, int n,
                                   int c, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(vals), keys, out, tile_sum,
                tile_started, carry, n, c, stream);
}
