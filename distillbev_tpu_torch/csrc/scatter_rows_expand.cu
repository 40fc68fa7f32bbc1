// Weighted-outer-product row scatter-add as a deterministic segment sum
// (sm_90a).
//
// Replaces the TPU kernel distillbev_tpu/ops/pallas_scatter.py
// scatter_add_rows_expand (_kernel_expand, :119; pallas_call :199), the
// dvalue scatter of the multi-scale deformable-attention backward:
//     out[grp, ids[grp, s, q]] += concat_k(w[grp, q, 4s + k] * g[grp, q])
// for ids in [0, size), else dropped; g rows are the query's C-wide dout
// row, and corner k of a sample owns the channels [kC, (k + 1)C) of the
// 4C-wide output row.  The TPU kernel takes g already tiled to 4C (its
// 128-lane rows); here the kernel reads the compact row once per corner,
// so no tiled copy is made.  Sums are fp32.
//
// The TPU design pins one (batch, head) group's whole supercell
// accumulator (up to 40,401 x 128 fp32 = 20.7 MB) in VMEM and expands
// each query chunk's update rows there.  A Hopper block has at most
// 227 KB of shared memory, so that does not carry over.  Here the caller
// (distillbev_tpu_torch/ops/scatter_rows.py) folds every group into one
// flat key space (key = grp * size + id), sorts the flat rows stably by
// key and finds each output row's segment; this kernel then gives one
// warp to each output row.  The warp walks its segment in ascending flat
// row order r = (grp * lbp + s) * Q + q (sample-major inside a group, the
// order of the TPU kernel's rows within a chunk), expands each update in
// registers from the compact factors -- one corner weight and the C-wide
// g row -- so the [R, 4C] update rows never exist in device memory, and writes
// the output row once (zeros for an empty row).  No atomics: the result
// is bitwise the same from run to run.  The product and the sum are
// rounded separately (__fmul_rn, __fadd_rn), as the plain version's
// materialised rows and index_add_ do.
//
// Bound: memory.  The ids and w once, each C-wide g row once (from L2
// after its first sample), the output written once.  At the BEVFormer-R50
// TSA backward (16 groups, Q = 40,000, lbp = 4, size = 40,401, 4C = 128)
// that is about 0.46 GB, 0.14 ms at 3.35 TB/s.  The sort
// and the segment search add their own traffic outside this kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr int kLanesChannels = 4;  // channels per lane per 128-wide pass

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
expand_segment_sum_kernel(const float* __restrict__ w,
                          const float* __restrict__ g,
                          const int64_t* __restrict__ order,
                          const int32_t* __restrict__ seg_start,
                          float* __restrict__ out, int64_t cells, int lbp,
                          int queries, int width) {
  const int lane = threadIdx.x & 31;
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (cell >= cells) return;
  const int begin = seg_start[cell];
  const int end = seg_start[cell + 1];
  const int corner_width = width / 4;
  const int per_group = lbp * queries;
  const int wstride = 4 * lbp;
  float* dst = out + cell * width;

  for (int c0 = 0; c0 < width; c0 += 32 * kLanesChannels) {
    int ch[kLanesChannels];
    int corner[kLanesChannels];
    int gch[kLanesChannels];  // channel of the compact g row
    bool ok[kLanesChannels];
    float acc[kLanesChannels];
#pragma unroll
    for (int i = 0; i < kLanesChannels; ++i) {
      ch[i] = c0 + 32 * i + lane;
      ok[i] = ch[i] < width;
      corner[i] = ok[i] ? ch[i] / corner_width : 0;
      gch[i] = ok[i] ? ch[i] - corner[i] * corner_width : 0;
      acc[i] = 0.f;
    }
    int j = begin;
    for (; j + kUnroll <= end; j += kUnroll) {
      float wv[kUnroll][kLanesChannels];
      float gv[kUnroll][kLanesChannels];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = static_cast<int>(order[j + u]);
        const int grp = r / per_group;
        const int rem = r - grp * per_group;
        const int s = rem / queries;
        const int64_t row =
            static_cast<int64_t>(grp) * queries + (rem - s * queries);
        const float* wrow = w + row * wstride + 4 * s;
        const float* grow = g + row * corner_width;
#pragma unroll
        for (int i = 0; i < kLanesChannels; ++i) {
          wv[u][i] = ok[i] ? __ldg(wrow + corner[i]) : 0.f;
          gv[u][i] = ok[i] ? __ldg(grow + gch[i]) : 0.f;
        }
      }
      // the adds stay sequential: ascending flat row order
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < kLanesChannels; ++i) {
          acc[i] = __fadd_rn(acc[i], __fmul_rn(wv[u][i], gv[u][i]));
        }
      }
    }
    for (; j < end; ++j) {
      const int r = static_cast<int>(order[j]);
      const int grp = r / per_group;
      const int rem = r - grp * per_group;
      const int s = rem / queries;
      const int64_t row =
          static_cast<int64_t>(grp) * queries + (rem - s * queries);
      const float* wrow = w + row * wstride + 4 * s;
      const float* grow = g + row * corner_width;
#pragma unroll
      for (int i = 0; i < kLanesChannels; ++i) {
        if (ok[i]) {
          acc[i] = __fadd_rn(acc[i],
                             __fmul_rn(__ldg(wrow + corner[i]),
                                       __ldg(grow + gch[i])));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kLanesChannels; ++i) {
      if (ok[i]) dst[ch[i]] = acc[i];
    }
  }
}

}  // namespace

// w [groups, queries, 4 * lbp] fp32; g [groups, queries, width / 4] fp32
// (C = width / 4); order [groups * lbp * queries] int64 (the flat rows stably
// sorted by key); seg_start [groups * size + 1] int32 (first sorted
// position of each key 0..groups*size); out [groups, size, width] fp32.
// The caller guarantees groups * lbp * queries < 2^31.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int scatter_rows_expand_segment_sum(
    const float* w, const float* g, const int64_t* order,
    const int32_t* seg_start, float* out, int groups, int lbp, int queries,
    int size, int width, void* stream) {
  const int64_t cells = static_cast<int64_t>(groups) * size;
  if (cells == 0 || width == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  expand_segment_sum_kernel<<<static_cast<unsigned int>(blocks),
                              kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      w, g, order, seg_start, out, cells, lbp, queries, width);
  return static_cast<int>(cudaGetLastError());
}
