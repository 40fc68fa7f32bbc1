// Row scatter-add as a deterministic segment sum (sm_90a).
//
// Replaces three TPU kernels of the JAX package:
//   * distillbev_tpu/ops/pallas_scatter.py scatter_add_rows_batched
//     (_kernel_batched, :51; pallas_call :102), per sample b:
//         out[b, ids[b, r]] += upd[b, r],  fp32, ascending r;
//   * distillbev_tpu/ops/pallas_scatter.py scatter_add_rows (_kernel, :33;
//     pallas_call :249), the same at B = 1, of upd's dtype: a bf16 upd
//     accumulates in bf16, rounded after every add;
//   * tools/analysis_tools/bench_pallas_gather.py pallas_rmw (_rmw_kernel,
//     :63; pallas_call :80), the same at B = 1 in fp32.
// Ids outside [0, size) are dropped.
//
// The TPU design pins the whole accumulator (16,384 x 64 fp32 = 4.2 MB at
// the flagship splat, 23,634 x 128 fp32 = 12.1 MB at the tool's shape) in
// VMEM and walks the rows one by one.  A Hopper block has at most 227 KB of
// shared memory, so that design does not carry over.  Here the caller
// (distillbev_tpu_torch/ops/scatter_rows.py) prepares the row order -- a
// stable sort of each sample's ids and the start of every output row's
// segment -- and this kernel does the summing: one warp owns one output
// row, its lanes span the channels, it adds the row's updates in ascending
// original row order in registers and writes the row once.  Empty rows are
// written as 0; dropped rows lie outside every segment and are never read.
// The adds happen in the TPU kernels' order, so the fp32 result is the
// TPU kernel's sequential chain and bitwise stable from run to run.  For
// bf16 the running sum is rounded to bf16 after every add (fp32 add, then
// round to nearest even), as the TPU kernel's bf16 accumulator does.
//
// Bound: memory.  Each update row is read once, each output row written
// once: at the flagship splat (R = 249,216 rows x 64 fp32, 16,384 cells)
// that is 63.8 MB + 1 MB of ids + 4.2 MB out, about 21 us at 3.35 TB/s; at
// the tool's shape (4,194,304 rows x 128 fp32 into 23,634 rows) 2,176 MB,
// about 0.65 ms.  The sort and the segment search add their own traffic
// outside this kernel.  Reads are 128-byte coalesced per warp (32
// consecutive fp32 channels); rows are loaded kUnroll at a time so several
// loads are in flight per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

// How a row element is read, added to the running sum and written.
template <typename T>
struct Accum;

template <>
struct Accum<float> {
  static __device__ float load(const float* p) { return __ldg(p); }
  static __device__ float add(float s, float v) { return s + v; }
  static __device__ float store(float s) { return s; }
};

template <>
struct Accum<__nv_bfloat16> {
  static __device__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // the running sum is a bf16 value after every add
  static __device__ float add(float s, float v) {
    return __bfloat162float(__float2bfloat16_rn(s + v));
  }
  static __device__ __nv_bfloat16 store(float s) {
    return __float2bfloat16_rn(s);
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_rows_kernel(const T* __restrict__ upd,
                        const int64_t* __restrict__ order,
                        const int32_t* __restrict__ seg_start,
                        T* __restrict__ out, int batch, int rows, int size,
                        int width) {
  using A = Accum<T>;
  const int lane = threadIdx.x & 31;
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (cell >= static_cast<int64_t>(batch) * size) return;
  const int64_t b = cell / size;
  const int64_t c = cell - b * size;
  const int32_t* starts = seg_start + b * (size + 1);
  const int begin = starts[c];
  const int end = starts[c + 1];
  const int64_t* ord = order + b * rows;
  const T* src = upd + b * rows * static_cast<int64_t>(width);
  T* dst = out + cell * width;

  for (int c0 = 0; c0 < width; c0 += 64) {
    const int ch0 = c0 + lane;
    const int ch1 = c0 + 32 + lane;
    const bool ok0 = ch0 < width;
    const bool ok1 = ch1 < width;
    float s0 = 0.f;
    float s1 = 0.f;
    int r = begin;
    for (; r + kUnroll <= end; r += kUnroll) {
      float v0[kUnroll];
      float v1[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* row = src + ord[r + u] * width;
        v0[u] = ok0 ? A::load(row + ch0) : 0.f;
        v1[u] = ok1 ? A::load(row + ch1) : 0.f;
      }
      // the adds stay sequential: ascending original row order
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s0 = A::add(s0, v0[u]);
        s1 = A::add(s1, v1[u]);
      }
    }
    for (; r < end; ++r) {
      const T* row = src + ord[r] * width;
      s0 = A::add(s0, ok0 ? A::load(row + ch0) : 0.f);
      s1 = A::add(s1, ok1 ? A::load(row + ch1) : 0.f);
    }
    if (ok0) dst[ch0] = A::store(s0);
    if (ok1) dst[ch1] = A::store(s1);
  }
}

template <typename T>
int launch(const T* upd, const int64_t* order, const int32_t* seg_start,
           T* out, int batch, int rows, int size, int width, void* stream) {
  const int64_t cells = static_cast<int64_t>(batch) * size;
  if (cells == 0 || width == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_sum_rows_kernel<T><<<static_cast<unsigned int>(blocks),
                               kWarpsPerBlock * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      upd, order, seg_start, out, batch, rows, size, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// upd [batch, rows, width]; order [batch, rows] int64 (each sample's rows
// stably sorted by id); seg_start [batch, size + 1] int32 (first sorted
// position of each id 0..size); out [batch, size, width] of upd's type.
// Launch on `stream` and return cudaGetLastError().
extern "C" int scatter_rows_segment_sum(const float* upd, const int64_t* order,
                                        const int32_t* seg_start, float* out,
                                        int batch, int rows, int size,
                                        int width, void* stream) {
  return launch<float>(upd, order, seg_start, out, batch, rows, size, width,
                       stream);
}

extern "C" int scatter_rows_segment_sum_bf16(const void* upd,
                                             const int64_t* order,
                                             const int32_t* seg_start,
                                             void* out, int batch, int rows,
                                             int size, int width,
                                             void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(upd), order,
                               seg_start, static_cast<__nv_bfloat16*>(out),
                               batch, rows, size, width, stream);
}
