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
// Bound: the bytes (the ids and the C columns of each row, 52 bytes a row
// at C = 12: 25 MB for the flagship env pass, 7.5 us at 3.35 TB/s), once the
// contention is gone. The rows of the env pass come in pixel order, one
// view at a time, and a few hundred dome faces cover most pixels, so one
// global atomicAdd per value would serialize on a few thousand addresses.
//
// Design: small blocks of 1,024 rows (469 at the flagship shape), each with
// a shared-memory table of only its own window of ids. A block first
// reduces the [lo, hi] range of its valid ids. Where (hi - lo + 1) * C fits
// a 24 KB budget (one view's 448 faces at C = 12 take 21.5 KB), the block
// zeroes, accumulates and flushes only that window; where it does not
// (random ids, a block that straddles two views, a large table), the block
// adds its run sums straight into global memory. The choice is made per
// block on the device. In each warp, a segmented inclusive scan over runs of
// equal ids among 32 consecutive rows pre-reduces before any atomic, and
// only a run's last row adds its sum. Rows are read with 16-byte loads and
// the window is flushed with one float4 atomic per nonzero quad of a row
// (where C, the row strides and the bases allow it). The window is static
// shared memory, so a launch needs no attribute calls.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int ROWS_PER_BLOCK = 1024;
constexpr int STEPS = ROWS_PER_BLOCK / THREADS;  // rows per thread
constexpr int WINDOW = 6144;                     // floats of a block's table (24 KB)
constexpr int MAXC = 16;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool any4(const float4& a) {
  return a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f;
}

// add the C values v into a row of global memory: one float4 atomic per
// nonzero quad where vec, else one atomicAdd per nonzero value
__device__ __forceinline__ void add_row(float* row, const float* v, int C, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < MAXC / 4; ++q) {
      if (4 * q >= C) break;
      const float4 a = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      if (any4(a)) atomicAdd(reinterpret_cast<float4*>(row) + q, a);
    }
  } else {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c >= C) break;
      if (v[c] != 0.0f) atomicAdd(row + c, v[c]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
small_scatter_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ upd, int N, int C, int ld,
                     int n_rows, bool vec_in, bool vec_out,
                     float* __restrict__ out, int ldo) {
  __shared__ __align__(16) float acc[WINDOW];
  __shared__ int warp_lo[NWARP], warp_hi[NWARP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * ROWS_PER_BLOCK;

  // step s takes row r0 + s * THREADS + threadIdx.x: each warp 32
  // consecutive rows; rows past N and ids out of range carry id -1
  int id[STEPS];
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int64_t n = r0 + s * THREADS + threadIdx.x;
    int i = n < N ? idx[n] : -1;
    if (i < 0 || i >= n_rows) i = -1;
    id[s] = i;
    if (i >= 0) {
      lo = min(lo, i);
      hi = max(hi, i);
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (lane == 0) {
    warp_lo[warp] = lo;
    warp_hi[warp] = hi;
  }
  __syncthreads();
  lo = warp_lo[0];
  hi = warp_hi[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) {
    lo = min(lo, warp_lo[w]);
    hi = max(hi, warp_hi[w]);
  }
  if (hi < lo) return;  // no valid row in the block (uniform in the block)
  const bool windowed = (int64_t)(hi - lo + 1) * C <= WINDOW;
  const int wsize = windowed ? (hi - lo + 1) * C : 0;
  for (int i = threadIdx.x; i < wsize; i += THREADS) acc[i] = 0.0f;
  __syncthreads();

#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int i = id[s];
    if (__ballot_sync(FULL, i >= 0) == 0) continue;  // no valid row in the warp
    const int64_t n = r0 + s * THREADS + threadIdx.x;
    float v[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) v[c] = 0.0f;
    if (i >= 0) {
      const float* row = upd + n * ld;
      if (vec_in) {
#pragma unroll
        for (int q = 0; q < MAXC / 4; ++q) {
          if (4 * q >= C) break;
          const float4 a = reinterpret_cast<const float4*>(row)[q];
          v[4 * q] = a.x;
          v[4 * q + 1] = a.y;
          v[4 * q + 2] = a.z;
          v[4 * q + 3] = a.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) v[c] = row[c];
      }
    }

    // runs of equal ids: a head is a lane whose id differs from the lane
    // before it; seg0 is the lane of this lane's head
    const int prev = __shfl_up_sync(FULL, i, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != i);
    const int seg0 = 31 - __clz(heads & (FULL >> (31 - lane)));
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
    if (tail && i >= 0) {
      if (windowed) {
        float* row = acc + (i - lo) * C;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c >= C) break;
          if (v[c] != 0.0f) atomicAdd(row + c, v[c]);
        }
      } else {
        add_row(out + (int64_t)i * ldo, v, C, vec_out);
      }
    }
  }
  if (!windowed) return;

  // flush the window: a float4 atomic per nonzero quad of a row where vec_out
  __syncthreads();
  if (vec_out) {
    const int Q = C >> 2;
    const int units = (hi - lo + 1) * Q;
    for (int u = threadIdx.x; u < units; u += THREADS) {
      const int r = u / Q, q = u - r * Q;
      const float4 a = reinterpret_cast<const float4*>(acc + r * C)[q];
      if (any4(a))
        atomicAdd(reinterpret_cast<float4*>(out + (int64_t)(lo + r) * ldo) + q, a);
    }
  } else {
    for (int u = threadIdx.x; u < wsize; u += THREADS) {
      const float a = acc[u];
      const int r = u / C;
      if (a != 0.0f) atomicAdd(out + (int64_t)(lo + r) * ldo + (u - r * C), a);
    }
  }
}

}  // namespace

// idx: (N,) i32; upd: (N, C) f32 with row stride ld (>= C), C <= 16; out:
// (n_rows, C) f32 with row stride ldo (>= C), zeroed by the caller. The
// float4 paths need C, ld and ldo multiples of 4 and 16-byte aligned bases.
extern "C" int dbw_small_scatter(const int32_t* idx, const float* upd, int N,
                                 int C, int ld, int n_rows, float* out, int ldo,
                                 cudaStream_t stream) {
  if (C < 1 || C > MAXC || ld < C || ldo < C || n_rows < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || n_rows == 0) return -1;  // nothing to launch
  const bool vec_in = C % 4 == 0 && ld % 4 == 0 && reinterpret_cast<uintptr_t>(upd) % 16 == 0;
  const bool vec_out = C % 4 == 0 && ldo % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int blocks = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  small_scatter_kernel<<<blocks, THREADS, 0, stream>>>(idx, upd, N, C, ld, n_rows, vec_in,
                                                       vec_out, out, ldo);
  return (int)cudaGetLastError();
}
