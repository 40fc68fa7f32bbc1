// Per-sample row scatter-add as a deterministic segment sum (sm_90a).
//
// Replaces the TPU kernel distillbev_tpu/ops/pallas_scatter.py
// scatter_add_rows_batched (_kernel_batched, :51; pallas_call :102):
//     out[b, ids[b, r]] += upd[b, r]    for ids in [0, size), else dropped,
// accumulated in fp32 in ascending row order.
//
// The TPU design pins the whole per-sample canvas (16,384 x 64 fp32 =
// 4.2 MB at the flagship) in VMEM and walks the rows one by one.  A Hopper
// block has at most 227 KB of shared memory, so that design does not carry
// over.  Here the caller (distillbev_tpu_torch/ops/scatter_rows.py) prepares
// the row order -- a stable sort of each sample's ids and the start of every
// cell's segment -- and this kernel does the summing: one warp owns one
// output cell, its lanes span the channels, it adds the cell's rows in
// ascending original row order in fp32 registers and writes the cell once.
// Empty cells are written as 0; dropped rows (ids outside [0, size)) lie
// outside every segment and are never read.  The adds happen in the TPU
// kernel's order, so the result is bitwise stable from run to run.
//
// Bound: memory.  Each update row is read once, each output row written
// once: at the flagship (R = 249,216 rows x 64 fp32, 16,384 cells) that is
// 63.8 MB + 1 MB of ids + 4.2 MB out, about 21 us at 3.35 TB/s.  The sort
// and the segment search add their own traffic outside this kernel.
// Reads are 128-byte coalesced per warp (32 consecutive channels); rows
// are loaded kUnroll at a time so several loads are in flight per warp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_rows_kernel(const float* __restrict__ upd,
                        const int64_t* __restrict__ order,
                        const int32_t* __restrict__ seg_start,
                        float* __restrict__ out, int batch, int rows,
                        int size, int width) {
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
  const float* src = upd + b * rows * static_cast<int64_t>(width);
  float* dst = out + cell * width;

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
        const float* row = src + ord[r + u] * width;
        v0[u] = ok0 ? __ldg(row + ch0) : 0.f;
        v1[u] = ok1 ? __ldg(row + ch1) : 0.f;
      }
      // the adds stay sequential: ascending original row order
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s0 += v0[u];
        s1 += v1[u];
      }
    }
    for (; r < end; ++r) {
      const float* row = src + ord[r] * width;
      s0 += ok0 ? __ldg(row + ch0) : 0.f;
      s1 += ok1 ? __ldg(row + ch1) : 0.f;
    }
    if (ok0) dst[ch0] = s0;
    if (ok1) dst[ch1] = s1;
  }
}

}  // namespace

// upd [batch, rows, width] fp32; order [batch, rows] int64 (each sample's
// rows stably sorted by id); seg_start [batch, size + 1] int32 (first
// sorted position of each cell id 0..size); out [batch, size, width] fp32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int scatter_rows_segment_sum(const float* upd, const int64_t* order,
                                        const int32_t* seg_start, float* out,
                                        int batch, int rows, int size,
                                        int width, void* stream) {
  const int64_t cells = static_cast<int64_t>(batch) * size;
  if (cells == 0 || width == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_sum_rows_kernel<<<static_cast<unsigned int>(blocks),
                            kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      upd, order, seg_start, out, batch, rows, size, width);
  return static_cast<int>(cudaGetLastError());
}
