// K5: unsorted scatter-add of (N, C <= 16) rows into a small (n_rows, C)
// table, dropping rows whose id lies outside [0, n_rows).
//
// Replaces the TPU kernel dbw_tpu/ops/segment_sum_pallas.py `_small_kernel`
// (launched by `small_table_scatter_add`, reached from
// ops/scatter.py::_gather_bwd): the face-table backward of the env pass's
// row gather. The TPU version contracts a windowed one-hot on the MXU into a
// VMEM-resident accumulator carried across a sequential grid. Plain twin:
// dbw_torch/ops/scatter.py::small_table_scatter_add_plain.
//
// Bound: contention. The fragments of the env pass come in pixel order and
// a few hundred dome faces cover most pixels, so one global atomicAdd per
// value would serialize on a few thousand addresses. Two levels of
// pre-reduction keep the global atomics few:
// 1. in each warp, a segmented inclusive scan over runs of equal ids among
//    its 32 consecutive rows; only the last row of a run adds its sum;
// 2. each block accumulates those sums in shared memory (the whole table,
//    86 KB at the flagship's 1,792 x 12, with the opt-in dynamic shared
//    memory limit) and flushes it with one global atomicAdd per nonzero
//    entry.
// A table too large for shared memory takes the same kernel with the
// run sums added straight into global memory (template SHARED = false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS * 16;
constexpr int MAXC = 16;
constexpr unsigned FULL = 0xffffffffu;

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
small_scatter_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ upd, int N, int C, int ld,
                     int n_rows, float* __restrict__ out) {
  extern __shared__ float acc[];
  const int lane = threadIdx.x & 31;
  const int tsize = n_rows * C;
  if (SHARED) {
    for (int i = threadIdx.x; i < tsize; i += THREADS) acc[i] = 0.0f;
    __syncthreads();
  }
  float* dst = SHARED ? acc : out;

  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int r1 = min(N, r0 + ROWS_PER_BLOCK);
  // warps step through the block's rows 32 at a time; every lane of a warp
  // takes part in each step (rows past r1 carry id -1), so the shuffles
  // below always see the full warp
  for (int base = r0 + (threadIdx.x & ~31); base < r1; base += THREADS) {
    const int n = base + lane;
    int id = -1;
    if (n < r1) {
      id = idx[n];
      if (id < 0 || id >= n_rows) id = -1;
    }
    float v[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      v[c] = (id >= 0 && c < C) ? upd[(size_t)n * ld + c] : 0.0f;

    // runs of equal ids: a head is a lane whose id differs from the lane
    // before it; seg0 is the lane of this lane's head
    const int prev = __shfl_up_sync(FULL, id, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != id);
    const int seg0 = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool take = lane - d >= seg0;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c >= C) break;
        const float o = __shfl_up_sync(FULL, v[c], d);
        if (take) v[c] += o;
      }
    }
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (tail && id >= 0) {
      float* row = dst + (size_t)id * C;
      for (int c = 0; c < C; ++c)
        if (v[c] != 0.0f) atomicAdd(row + c, v[c]);
    }
  }

  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < tsize; i += THREADS) {
      const float a = acc[i];
      if (a != 0.0f) atomicAdd(out + i, a);
    }
  }
}

}  // namespace

// idx: (N,) i32; upd: (N, C) f32 with row stride ld (>= C), C <= 16;
// out: (n_rows, C) f32 contiguous, zeroed by the caller.
extern "C" int dbw_small_scatter(const int32_t* idx, const float* upd, int N,
                                 int C, int ld, int n_rows, float* out,
                                 cudaStream_t stream) {
  if (C < 1 || C > MAXC || ld < C || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || n_rows == 0) return -1;  // nothing to launch
  const int blocks = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const size_t smem = (size_t)n_rows * C * sizeof(float);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem <= (size_t)smem_max) {
    err = cudaFuncSetAttribute(small_scatter_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    small_scatter_kernel<true><<<blocks, THREADS, smem, stream>>>(
        idx, upd, N, C, ld, n_rows, out);
  } else {
    small_scatter_kernel<false><<<blocks, THREADS, 0, stream>>>(
        idx, upd, N, C, ld, n_rows, out);
  }
  return (int)cudaGetLastError();
}
