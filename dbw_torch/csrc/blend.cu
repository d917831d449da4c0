// K6: the layered blend, front to back over a pixel's K fragment slots, and
// its backward.
//
// Replaces no TPU kernel: the JAX package's blend (dbw_tpu/render/blend.py
// `layered_blend`) is XLA's `cumprod`, fused into the surrounding program.
// In PyTorch the same formula takes a `cumprod` and a `cumsum` scan, a `cat`
// and a `sum` (and a host sync in the `cumprod` backward's zero test), the
// largest device cost of the step. Plain twin:
// dbw_torch/render/blend.py::layered_blend_plain.
//
// Per pixel, with T_0 = 1 and T_{k+1} = T_k (1 - a_k):
//   rgb = sum_k (T_k a_k) c_k + T_K bg,  A = 1 - T_K.
// The backward is closed form and divides by nothing, so it is exact where
// some a_k is exactly 1. A reverse loop keeps R_k = a_k c_k + (1 - a_k)
// R_{k+1} (R_K = bg) and U_k = (1 - a_k) U_{k+1} (U_K = 1):
//   d c_k = g_rgb (T_k a_k),
//   d a_k = T_k (g_rgb . (c_k - R_{k+1}) + g_A U_{k+1}).
// The forward follows the plain twin's order where a serial loop can: the
// front-to-back product, (T_k a_k) c_k, the sum over k in order, then
// + T_K bg; built with --fmad=false, so no product is fused into a sum.
//
// Bound: the bytes. Forward: colors and alpha read, RGBA written, 176 bytes
// a pixel at K = 10 (422 MB at the protocol's 2.4 M pixels, 0.126 ms at
// 3.35 TB/s); backward: colors, alpha and the RGBA cotangent read, d_colors
// and d_alpha written, 336 bytes a pixel (806 MB, 0.241 ms).
//
// Design: one thread a pixel keeps the running sums and its K values T_k in
// registers (a compile-time K for the shipped 1 and 10; a runtime K up to
// MAX_K otherwise, whose T_k may spill to local memory). A pixel's colour is 12 K bytes (120 at K = 10), so a warp's
// direct loads would be strided; instead a block stages its pixels'
// (P_blk, K, 3) colour tile and (P_blk, K) alpha tile through shared memory
// with coalesced 16-byte loads, and the backward writes d_colors and d_alpha
// back through the same tiles. The background colour comes as three float
// arguments, so no device copy of it is made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 32;
// a block's pixels (its threads): 128, or 64 above K = 16, so that the
// staged tiles (16 K bytes a pixel) stay within 32 KB of shared memory
__host__ __device__ constexpr int block_pixels(int K) { return K <= 16 ? 128 : 64; }

// n floats from global src to shared dst, 16 bytes a load where vec
__device__ __forceinline__ void stage_in(float* dst, const float* __restrict__ src, int n,
                                         bool vec) {
  int i0 = 0;
  if (vec) {
    const int nq = n >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < nq; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    i0 = nq << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// n floats from shared src to global dst, 16 bytes a store where vec
__device__ __forceinline__ void stage_out(float* __restrict__ dst, const float* src, int n,
                                          bool vec) {
  int i0 = 0;
  if (vec) {
    const int nq = n >> 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < nq; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    i0 = nq << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// KT > 0: K = KT at compile time, fully unrolled; KT = 0: K at run time
template <int KT>
__global__ void __launch_bounds__(128)
blend_fwd_kernel(const float* __restrict__ colors, const float* __restrict__ alpha,
                 int P, int K_, float bg0, float bg1, float bg2, bool vec,
                 float4* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int K = KT > 0 ? KT : K_;
  const int nb = blockDim.x;
  const int64_t p0 = (int64_t)blockIdx.x * nb;
  const int np = (int64_t)P - p0 < nb ? (int)(P - p0) : nb;
  float* sc = smem;               // (nb, K, 3)
  float* sa = smem + nb * K * 3;  // (nb, K); 16-byte aligned: nb is a multiple of 32
  stage_in(sc, colors + p0 * K * 3, np * K * 3, vec);
  stage_in(sa, alpha + p0 * K, np * K, vec);
  __syncthreads();
  if (threadIdx.x >= np) return;
  const float* c = sc + threadIdx.x * K * 3;
  const float* a = sa + threadIdx.x * K;
  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
#pragma unroll
  for (int k = 0; k < (KT > 0 ? KT : MAX_K); ++k) {
    if (KT == 0 && k >= K) break;
    const float ak = a[k];
    const float w = T * ak;
    r = r + w * c[3 * k];
    g = g + w * c[3 * k + 1];
    b = b + w * c[3 * k + 2];
    T = T * (1.0f - ak);
  }
  out[p0 + threadIdx.x] = make_float4(r + T * bg0, g + T * bg1, b + T * bg2, 1.0f - T);
}

template <int KT>
__global__ void __launch_bounds__(128)
blend_bwd_kernel(const float* __restrict__ colors, const float* __restrict__ alpha,
                 const float4* __restrict__ gout, int P, int K_, float bg0, float bg1,
                 float bg2, bool vec, float* __restrict__ d_colors,
                 float* __restrict__ d_alpha) {
  extern __shared__ __align__(16) float smem[];
  constexpr int KA = KT > 0 ? KT : MAX_K;
  const int K = KT > 0 ? KT : K_;
  const int nb = blockDim.x;
  const int64_t p0 = (int64_t)blockIdx.x * nb;
  const int np = (int64_t)P - p0 < nb ? (int)(P - p0) : nb;
  float* sc = smem;
  float* sa = smem + nb * K * 3;
  stage_in(sc, colors + p0 * K * 3, np * K * 3, vec);
  stage_in(sa, alpha + p0 * K, np * K, vec);
  __syncthreads();
  if (threadIdx.x < np) {
    // each thread overwrites its own pixel's slots of the tiles with the
    // cotangents, after reading them
    float* c = sc + threadIdx.x * K * 3;
    float* a = sa + threadIdx.x * K;
    const float4 go = gout[p0 + threadIdx.x];
    float Tk[KA];
    float T = 1.0f;
#pragma unroll
    for (int k = 0; k < KA; ++k) {
      if (KT == 0 && k >= K) break;
      Tk[k] = T;
      T = T * (1.0f - a[k]);
    }
    float Rr = bg0, Rg = bg1, Rb = bg2, U = 1.0f;
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      if (KT == 0 && j >= K) break;
      const int k = K - 1 - j;
      const float ak = a[k];
      const float cr = c[3 * k], cg = c[3 * k + 1], cb = c[3 * k + 2];
      const float w = Tk[k] * ak;
      c[3 * k] = go.x * w;
      c[3 * k + 1] = go.y * w;
      c[3 * k + 2] = go.z * w;
      a[k] = Tk[k] * ((go.x * (cr - Rr) + go.y * (cg - Rg) + go.z * (cb - Rb)) + go.w * U);
      const float om = 1.0f - ak;
      Rr = ak * cr + om * Rr;
      Rg = ak * cg + om * Rg;
      Rb = ak * cb + om * Rb;
      U = om * U;
    }
  }
  __syncthreads();
  stage_out(d_colors + p0 * K * 3, sc, np * K * 3, vec);
  stage_out(d_alpha + p0 * K, sa, np * K, vec);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// colors: (P, K, 3) f32, alpha: (P, K) f32, both contiguous, 1 <= K <= 32;
// out: (P, 4) f32 RGBA, 16-byte aligned.
extern "C" int dbw_blend_fwd(const float* colors, const float* alpha, int P, int K,
                             float bg0, float bg1, float bg2, float* out,
                             cudaStream_t stream) {
  if (K < 1 || K > MAX_K || P < 0 || !aligned16(out)) return (int)cudaErrorInvalidValue;
  if (P == 0) return -1;  // nothing to launch
  const int nb = block_pixels(K);
  const int blocks = (int)(((int64_t)P + nb - 1) / nb);
  const size_t smem = (size_t)nb * K * 4 * sizeof(float);
  const bool vec = aligned16(colors) && aligned16(alpha);
  float4* o = reinterpret_cast<float4*>(out);
  if (K == 1)
    blend_fwd_kernel<1><<<blocks, nb, smem, stream>>>(colors, alpha, P, K, bg0, bg1, bg2,
                                                      vec, o);
  else if (K == 10)
    blend_fwd_kernel<10><<<blocks, nb, smem, stream>>>(colors, alpha, P, K, bg0, bg1, bg2,
                                                       vec, o);
  else
    blend_fwd_kernel<0><<<blocks, nb, smem, stream>>>(colors, alpha, P, K, bg0, bg1, bg2,
                                                      vec, o);
  return (int)cudaGetLastError();
}

// colors, alpha as for dbw_blend_fwd; gout: (P, 4) f32 RGBA cotangent,
// 16-byte aligned; d_colors (P, K, 3) and d_alpha (P, K) f32, contiguous.
extern "C" int dbw_blend_bwd(const float* colors, const float* alpha, const float* gout,
                             int P, int K, float bg0, float bg1, float bg2, float* d_colors,
                             float* d_alpha, cudaStream_t stream) {
  if (K < 1 || K > MAX_K || P < 0 || !aligned16(gout)) return (int)cudaErrorInvalidValue;
  if (P == 0) return -1;  // nothing to launch
  const int nb = block_pixels(K);
  const int blocks = (int)(((int64_t)P + nb - 1) / nb);
  const size_t smem = (size_t)nb * K * 4 * sizeof(float);
  const bool vec = aligned16(colors) && aligned16(alpha) && aligned16(d_colors) &&
                   aligned16(d_alpha);
  const float4* g = reinterpret_cast<const float4*>(gout);
  if (K == 1)
    blend_bwd_kernel<1><<<blocks, nb, smem, stream>>>(colors, alpha, g, P, K, bg0, bg1, bg2,
                                                      vec, d_colors, d_alpha);
  else if (K == 10)
    blend_bwd_kernel<10><<<blocks, nb, smem, stream>>>(colors, alpha, g, P, K, bg0, bg1,
                                                       bg2, vec, d_colors, d_alpha);
  else
    blend_bwd_kernel<0><<<blocks, nb, smem, stream>>>(colors, alpha, g, P, K, bg0, bg1, bg2,
                                                      vec, d_colors, d_alpha);
  return (int)cudaGetLastError();
}
