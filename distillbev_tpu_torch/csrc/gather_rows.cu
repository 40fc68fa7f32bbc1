// Row gather with zero rows for indices outside the table (sm_90a).
//
// Replaces the TPU kernel tools/analysis_tools/bench_pallas_gather.py
// pallas_gather (_gather_kernel, :35; pallas_call :48):
//     out[n] = table[idx[n]]                 for idx[n] in [0, rows),
//     out[n] = 0                             otherwise,
// for a table of any element type: the kernel copies bytes.  The TPU kernel
// pins the whole table in VMEM and walks 1,024 indices a grid step, one
// (1, 128) row copy at a time.  On Hopper the table (6 MB at the tool's
// shape, 4.2 MB at the splat backward) stays in L2 after its first touch,
// so the kernel is a plain streaming copy: one thread moves one vector of
// one output row, 16 bytes where the row's bytes and both base addresses
// allow it (4 or 2 otherwise), neighbouring threads on neighbouring
// addresses of the same row; the output is written once, coalesced.
//
// Bound: memory.  The output dominates: at the tool's shape (N = 4,194,304
// rows of 128 bf16) 1,073.7 MB out + 16.8 MB of indices + 6.05 MB of table,
// about 0.327 ms at 3.35 TB/s; at the splat backward (249,216 rows of 64
// fp32) about 69 MB, 0.021 ms.  A copy moves the bits as they are, so the
// result is bitwise equal to any other gather of the same rows.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table, const int32_t* __restrict__ idx,
                   V* __restrict__ out, int64_t n, int64_t rows,
                   int64_t vecs_per_row) {
  const int64_t total = n * vecs_per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t r = t / vecs_per_row;
    const int64_t v = t - r * vecs_per_row;
    const int64_t src = __ldg(idx + r);
    V val;
    if (src >= 0 && src < rows) {
      val = __ldg(table + src * vecs_per_row + v);
    } else {
      val = V{};  // an index outside the table gives a zero row
    }
    out[t] = val;
  }
}

template <typename V>
int launch(const void* table, const int32_t* idx, void* out, int64_t n,
           int64_t rows, int64_t row_bytes, cudaStream_t stream) {
  const int64_t vecs = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t total = n * vecs;
  // enough blocks to fill 132 SMs many times over; the loop takes the rest
  const int64_t blocks =
      std::min<int64_t>((total + kThreads - 1) / kThreads, 132 * 64);
  gather_rows_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          stream>>>(static_cast<const V*>(table), idx,
                                    static_cast<V*>(out), n, rows, vecs);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// table [rows, row_bytes] bytes, idx [n] int32, out [n, row_bytes] bytes.
// row_bytes must be a multiple of 2 (a bf16 or wider element).  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int gather_rows(const void* table, const int32_t* idx, void* out,
                           int64_t n, int64_t rows, int64_t row_bytes,
                           void* stream) {
  if (n == 0 || row_bytes == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && aligned(table, 16) && aligned(out, 16)) {
    return launch<uint4>(table, idx, out, n, rows, row_bytes, s);
  }
  if (row_bytes % 4 == 0 && aligned(table, 4) && aligned(out, 4)) {
    return launch<uint32_t>(table, idx, out, n, rows, row_bytes, s);
  }
  return launch<uint16_t>(table, idx, out, n, rows, row_bytes, s);
}
