// K4: texture-atlas gradient of the bilinear quad sample.
//
// Replaces dbw_tpu/ops/segment_sum_pallas.py `_kernel` (reached through
// `quad_corner_segment_sums` from render/meshes.py::_quad_maps_grad). The TPU
// version sorts the fragments by base texel, segment-sums 12 weighted
// channels on the MXU and applies the 4-offset stencil afterwards, with the
// bilinear weights quantized to 15 bits to ride the sort. Here each fragment
// adds w_k * g straight into d_maps[id00 + off_k] for the stencil
// off = {0, 1, TW, TW + 1} with atomicAdd: no sort, f32 weights. Corners past
// the end of the atlas are dropped, as the stencil's shifts drop them.
// Plain twin: dbw_torch/ops/texel_grad.py::quad_maps_grad_plain.
//
// Bound: atomics into the (R, 3) atlas gradient; contention is low because
// fragments spread over ~10^6 texels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void add3(float* d, int64_t t, int64_t R, float w,
                                     float g0, float g1, float g2) {
  if (w == 0.0f || t >= R) return;
  float* p = d + t * 3;
  atomicAdd(p, w * g0);
  atomicAdd(p + 1, w * g1);
  atomicAdd(p + 2, w * g2);
}

__global__ void texel_grad_kernel(const int32_t* __restrict__ id00,
                                  const float* __restrict__ wx,
                                  const float* __restrict__ wy,
                                  const float* __restrict__ g, int N, int R,
                                  int TW, float* __restrict__ dmaps) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float g0 = g[3 * (size_t)n], g1 = g[3 * (size_t)n + 1],
              g2 = g[3 * (size_t)n + 2];
  if (g0 == 0.0f && g1 == 0.0f && g2 == 0.0f) return;
  const float fx = wx[n], fy = wy[n];
  const int64_t t = id00[n];
  add3(dmaps, t, R, (1.0f - fx) * (1.0f - fy), g0, g1, g2);
  add3(dmaps, t + 1, R, fx * (1.0f - fy), g0, g1, g2);
  add3(dmaps, t + TW, R, (1.0f - fx) * fy, g0, g1, g2);
  add3(dmaps, t + TW + 1, R, fx * fy, g0, g1, g2);
}

}  // namespace

// id00: (N,) i32 base texel in [0, R); wx, wy: (N,) f32; g: (N, 3) f32;
// dmaps: (R, 3) f32, zeroed by the caller.
extern "C" int dbw_texel_grad(const int32_t* id00, const float* wx,
                              const float* wy, const float* g, int N, int R,
                              int TW, float* dmaps, cudaStream_t stream) {
  if (N == 0) return -1;  // nothing to launch
  const int threads = 256;
  texel_grad_kernel<<<(N + threads - 1) / threads, threads, 0, stream>>>(
      id00, wx, wy, g, N, R, TW, dmaps);
  return (int)cudaGetLastError();
}
