// K7: the LPIPS distance of one VGG16 slice, and its backward.
//
// Replaces no TPU kernel: the JAX package's LPIPS (dbw_tpu/losses/vgg.py
// `LPIPSLoss`) is XLA, fused into the surrounding program. In PyTorch the
// same formula takes a float32 copy of each slice output, the target views
// tiled to every slot, five full-size passes of the unit normalisation a
// side, the squared difference and two means, and autograd replays about
// twice as many passes in the backward: the largest device cost of the
// step at a capture's resolution. Plain twin:
// dbw_torch/losses/vgg.py::lpips_slice_plain.
//
// Per pixel of rendered view v, with f2 its features, f1 those of target
// view v % B, r = |f2|, u1 = f1 / (|f1| + eps), u2 = f2 / (r + eps):
//   d = sum_c w_c (u1_c - u2_c)^2,   out[v] = scale * sum_pixels d,
// scale = 1 / (H W), and w_c = 1 with scale / C for the channel mean. The
// backward is for the rendered side only (the targets carry no gradient).
//
// The backward gives, bit for bit, the gradient that autograd through the
// plain twin gives on the card, rounded to the features' dtype as the plain
// twin's float32 copy rounds it (one round to nearest even), so a run's
// trajectory is the plain twin's and not merely close to it: with
// gm = g_v * fl(1 / HW) and gd_c = gm w_c (gm / C for the mean),
//   gt_c = gd_c (2 t_c),  t_c = u1_c - u2_c,
//   S3 = sum_c gt_c ((f2_c / den2) / den2),  den = |.| + eps,
//   m_c = (S3 / (2 r)) f2_c,   grad f2_c = ((-gt_c / den2) + m_c) + m_c,
// each operation a float32 IEEE operation in the order autograd runs them
// (mean, pow, sub, div, sqrt and mul backward, the two sum_to_size and the
// engine's gradient sums), and each channel sum in the order of PyTorch's
// CUDA reduction for its layout: |f2|^2 over a pixel's contiguous channels
// (32 lanes, 4 values a load from C = 128 on, 4 accumulators, a shuffle-down
// tree), |f1|^2 likewise for one target a render (n = B), and over the
// tiled targets' NCHW copy (n > B) and for S3 strided (rows of 4
// interleaved accumulators and a tree over the rows; how many rows, PyTorch
// decides from the pixels' count, see the wrapper's ``_strided_rows``).
// Those orders are ATen's (Reduce.cuh, as PyTorch 2.11 builds it for the
// card); tests/test_torch_lpips.py holds the gradient bit for bit on the
// card, so a PyTorch whose reductions change shows there.
// Where r = 0 (every channel of the pixel 0, as after a ReLU) the plain
// twin's square-root backward divides 0 by 0 and its gradient is NaN, which
// the ReLU's backward before it then masks; here m = 0 there, and the
// gradient is -gt / eps, the derivative of f / (|f| + eps) at 0. The forward
// only feeds the loss's value; it keeps its own order (a pixel's divisors
// inverted once, the products' sums in a shuffle tree), within about 1e-7
// of the plain twin. Built with --fmad=false, so no product is fused into
// a sum.
//
// Bound: the bytes. Forward: both sides' features read, nothing of their
// size written; backward: both read, the gradient written. At the protocol's
// 540x960, 20 renders and 4 targets of bfloat16, the five slices of the
// renders hold 1.264 G values (2.53 GB) and the targets' a fifth of that:
// 3.03 GB a forward (0.91 ms at 3.35 TB/s) and 5.56 GB a backward (1.66 ms).
// The backward's exact arithmetic costs it instructions: three IEEE
// divisions a value (by one divisor, so each from its inverse by two fmas)
// and the serial strided sums.
//
// Design: the features are read in the layout the trunk leaves them,
// channels last, one pixel's C channels contiguous. A block takes a chunk of
// one target view's pixels and walks the slots whose renders it is compared
// with (views b, b + B, ...), so the targets are shared by index: a target
// value comes from device memory once and from L2 for the other slots, and
// no tiled copy is made. Nothing of a feature map's size is written by the
// forward or kept for the backward, which reads the features again.
// Forward: a group of TP threads (TP = C / 8 for bfloat16, at most a warp)
// holds a pixel's channels of both sides in registers from 16-byte loads,
// the norms are shuffle sums within the group, and the spatial sum is
// deterministic: each block sums its pixels of a view in a fixed order into
// one partial, and a second kernel sums a view's partials in a fixed order;
// no atomics. Backward: a warp a pixel (two at once up to C = 128), lane l
// holding the channels PyTorch's contiguous reduction gives lane l (l and
// l + 32 at C = 64; 128 k + 4 l + i above), the strided sums staged through
// the warp's shared memory; a target pixel's unit vector is made once for
// all the slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int ITERS = 2;  // pixel passes of a block and slot
constexpr float EPS = 1e-10f;

template <typename T, int C>
struct Shape {
  static constexpr int VEC = 16 / (int)sizeof(T);             // values a 16-byte load
  static constexpr int TP = C / VEC < 32 ? C / VEC : 32;      // threads a pixel
  static constexpr int E = C / TP;                            // channels a thread
  static constexpr int NV = E / VEC;                          // loads a thread and side
  static constexpr int PPB = BLOCK / TP;                      // pixels a pass
  static constexpr int CHUNK = PPB * ITERS;                   // pixels a block
};

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// the sum over the TP threads of a pixel's group (aligned lanes of a warp)
template <int TP>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = TP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum, in thread 0
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[BLOCK / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < BLOCK / 32 ? warps[threadIdx.x] : 0.0f;
  __syncthreads();  // warps[] is free for the next call
  if (threadIdx.x < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// this thread's E channels of pixel p of both sides (zeros off the view's
// end), and their channel numbers: load j of lane l holds channels
// (j TP + l) VEC ... + VEC - 1
template <typename T, int C>
__device__ __forceinline__ void load_pixel(const T* __restrict__ a, const T* __restrict__ b,
                                           int64_t p, bool in, int lane, float* x2,
                                           float* x1) {
  using S = Shape<T, C>;
#pragma unroll
  for (int j = 0; j < S::NV; ++j) {
    const int c0 = (j * S::TP + lane) * S::VEC;
    if (in) {
      load16(a + p * C + c0, x2 + j * S::VEC);
      load16(b + p * C + c0, x1 + j * S::VEC);
    } else {
#pragma unroll
      for (int q = 0; q < S::VEC; ++q) x2[j * S::VEC + q] = x1[j * S::VEC + q] = 0.0f;
    }
  }
}

template <typename T, int C, bool LIN>
__device__ __forceinline__ float weight(const float* __restrict__ w, int lane, int e) {
  using S = Shape<T, C>;
  return LIN ? __ldg(w + ((e / S::VEC) * S::TP + lane) * S::VEC + e % S::VEC) : 1.0f;
}

// partial[v * gridDim.x + blockIdx.x]: the sum of d over the block's pixels
// of rendered view v, for the views v = s B + blockIdx.y of every slot s
template <typename T, int C, bool LIN>
__global__ void __launch_bounds__(BLOCK)
lpips_fwd_kernel(const T* __restrict__ f2, const T* __restrict__ f1,
                 const float* __restrict__ w, int n, int B, int64_t HW,
                 float* __restrict__ partial) {
  using S = Shape<T, C>;
  const int lane = threadIdx.x % S::TP;
  const T* b = f1 + (int64_t)blockIdx.y * HW * C;
  const int64_t p0 = (int64_t)blockIdx.x * S::CHUNK;
  for (int v = blockIdx.y; v < n; v += B) {
    const T* a = f2 + (int64_t)v * HW * C;
    float acc = 0.0f;
    // every lane runs every pass (the shuffles need the whole warp)
    for (int it = 0; it < ITERS; ++it) {
      const int64_t p = p0 + it * S::PPB + threadIdx.x / S::TP;
      const bool in = p < HW;
      float x2[S::E], x1[S::E];
      load_pixel<T, C>(a, b, p, in, lane, x2, x1);
      float s2 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int e = 0; e < S::E; ++e) {
        s2 = s2 + x2[e] * x2[e];
        s1 = s1 + x1[e] * x1[e];
      }
      s2 = group_sum<S::TP>(s2);
      s1 = group_sum<S::TP>(s1);
      const float i2 = 1.0f / (sqrtf(s2) + EPS), i1 = 1.0f / (sqrtf(s1) + EPS);
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < S::E; ++e) {
        const float t = x1[e] * i1 - x2[e] * i2;
        d = d + weight<T, C, LIN>(w, lane, e) * (t * t);
      }
      acc = acc + d;  // 0 off the view's end: both sides are 0 there
    }
    acc = block_sum(acc);
    if (threadIdx.x == 0) partial[(int64_t)v * gridDim.x + blockIdx.x] = acc;
  }
}

// out[v] = scale * the sum of view v's partials, in order
__global__ void __launch_bounds__(BLOCK)
lpips_sum_kernel(const float* __restrict__ partial, int nchunk, float scale,
                 float* __restrict__ out) {
  const int v = blockIdx.x;
  float s = 0.0f;
  for (int i = threadIdx.x; i < nchunk; i += BLOCK) s = s + partial[(int64_t)v * nchunk + i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[v] = s * scale;
}

// the backward's lane layout: lane l holds E = C / 32 channels, those of
// PyTorch's contiguous reduction (vec 1 at C = 64, 4 from C = 128 on)
template <int C>
struct Lanes {
  static constexpr int E = C / 32;
  static constexpr int VEC = C >= 128 ? 4 : 1;
  // the channel of this lane's value e
  __device__ static int channel(int lane, int e) {
    return VEC == 1 ? lane + 32 * e : 128 * (e / 4) + 4 * lane + e % 4;
  }
};

template <int E>
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p, int lane, float* x) {
  if (E == 2) {
    x[0] = __bfloat162float(p[lane]);
    x[1] = __bfloat162float(p[lane + 32]);
  } else {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + 128 * k + 4 * lane));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      x[4 * k] = a.x;
      x[4 * k + 1] = a.y;
      x[4 * k + 2] = b.x;
      x[4 * k + 3] = b.y;
    }
  }
}

template <int E>
__device__ __forceinline__ void load_lane(const float* p, int lane, float* x) {
  if (E == 2) {
    x[0] = __ldg(p + lane);
    x[1] = __ldg(p + lane + 32);
  } else {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + 128 * k + 4 * lane));
      x[4 * k] = f.x;
      x[4 * k + 1] = f.y;
      x[4 * k + 2] = f.z;
      x[4 * k + 3] = f.w;
    }
  }
}

template <int E>
__device__ __forceinline__ void store_lane(__nv_bfloat16* p, int lane, const float* x) {
  if (E == 2) {
    p[lane] = __float2bfloat16_rn(x[0]);
    p[lane + 32] = __float2bfloat16_rn(x[1]);
  } else {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      uint2 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
      h[0] = __floats2bfloat162_rn(x[4 * k], x[4 * k + 1]);
      h[1] = __floats2bfloat162_rn(x[4 * k + 2], x[4 * k + 3]);
      *reinterpret_cast<uint2*>(p + 128 * k + 4 * lane) = u;
    }
  }
}

template <int E>
__device__ __forceinline__ void store_lane(float* p, int lane, const float* x) {
  if (E == 2) {
    p[lane] = x[0];
    p[lane + 32] = x[1];
  } else {
#pragma unroll
    for (int k = 0; k < E / 4; ++k)
      *reinterpret_cast<float4*>(p + 128 * k + 4 * lane) =
          make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
  }
}

// a / b rounded to nearest, as the division's IEEE operation gives it, from
// yb = 1 / b rounded to nearest: q = a yb is within an ulp of a / b, its
// remainder a - q b is exact by fma, and one correction with yb rounds the
// quotient correctly (Markstein's theorem), for a and b normal. A quotient
// of 0 keeps its sign.
__device__ __forceinline__ float div_by(float a, float b, float yb) {
  const float q = __fmul_rn(a, yb);
  if (q == 0.0f) return q;
  return __fmaf_rn(__fmaf_rn(-q, b, a), yb, q);
}

// The sums below take P pixels at once (independent chains, so that their
// latencies overlap) and leave each pixel's sum in every lane.

// PyTorch's sum over a pixel's contiguous channels, q in the lane layout:
// each lane's accumulators (4 with vec 4: value i of each load; 4 in turn
// with vec 1), combined in order, then the shuffle-down tree over 32 lanes
template <int C, int P>
__device__ __forceinline__ void sum_contiguous(const float (&q)[P][C / 32], float (&s)[P]) {
  constexpr int E = C / 32;
  float v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e % 4] = acc[e % 4] + q[k][e];
    v[k] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < P; ++k) v[k] = v[k] + __shfl_down_sync(0xffffffffu, v[k], o);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) s[k] = __shfl_sync(0xffffffffu, v[k], 0);
}

// PyTorch's sum over a strided channel dimension (an NCHW tensor), q in the
// lane layout staged through the warp's P C floats sm. PyTorch splits the C
// values over R rows (the ``rows`` of the wrapper, a power of 2: from its
// block's height, set by the pixels' count and its divisibility by 4 and 2):
// row y takes the channels y + R m into its accumulator m % 4, m in turn,
// combines its 4 accumulators in order, and the rows' tree adds row y + o
// into row y for o = R / 2, ..., 1. Here lane 4 y + i holds accumulator i of
// row y (R <= 8), or lane y all four of row y (R = 16, 32)
template <int C, int P>
__device__ __forceinline__ void sum_strided(const float (&q)[P][C / 32], float* sm, int lane,
                                            int R, float (&s)[P]) {
  constexpr int E = C / 32;
#pragma unroll
  for (int k = 0; k < P; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) sm[k * C + Lanes<C>::channel(lane, e)] = q[k][e];
  }
  __syncwarp();
  float r[P];
#pragma unroll
  for (int k = 0; k < P; ++k) r[k] = 0.0f;
  if (R <= 8) {
    if (lane < 4 * R) {
      const int y = lane >> 2;
      for (int m = lane & 3; m < C / R; m += 4) {
#pragma unroll
        for (int k = 0; k < P; ++k) r[k] = r[k] + sm[k * C + y + R * m];
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float a1 = __shfl_down_sync(0xffffffffu, r[k], 1);
      const float a2 = __shfl_down_sync(0xffffffffu, r[k], 2);
      const float a3 = __shfl_down_sync(0xffffffffu, r[k], 3);
      r[k] = ((r[k] + a1) + a2) + a3;
    }
    for (int o = R / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < P; ++k) r[k] = r[k] + __shfl_down_sync(0xffffffffu, r[k], 4 * o);
    }
  } else {
    if (lane < R) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int m = 0; m < C / R; ++m) acc[m & 3] = acc[m & 3] + sm[k * C + lane + R * m];
        r[k] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
      }
    }
    for (int o = R / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < P; ++k) r[k] = r[k] + __shfl_down_sync(0xffffffffu, r[k], o);
    }
  }
  __syncwarp();  // sm is free for the next sum
#pragma unroll
  for (int k = 0; k < P; ++k) s[k] = __shfl_sync(0xffffffffu, r[k], 0);
}

constexpr int BWD_PIXELS = 4;  // target pixels a warp

// the gradient for f2 of the views v = s B + blockIdx.y of every slot s, a
// warp P pixels at a time (2 up to C = 128, else 1): the target's unit
// vector once, then each slot's render; TILED: n > B, the plain twin's
// targets are a tiled NCHW copy
template <typename T, int C, bool LIN, bool TILED>
__global__ void __launch_bounds__(BLOCK)
lpips_bwd_kernel(const T* __restrict__ f2, const T* __restrict__ f1,
                 const float* __restrict__ w, const float* __restrict__ gout, int n, int B,
                 int64_t HW, float inv_hw, int rows, T* __restrict__ grad) {
  constexpr int E = C / 32, WARPS = BLOCK / 32, P = C <= 128 ? 2 : 1;
  __shared__ float stage[WARPS][P * C];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* sm = stage[warp];
  const int64_t p0 = (int64_t)blockIdx.x * WARPS * BWD_PIXELS;
  for (int j = 0; j < BWD_PIXELS; j += P) {
    int64_t p[P];
    bool in[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      p[k] = p0 + (j + k) * WARPS + warp;
      in[k] = p[k] < HW;  // the same for the whole warp
    }
    if (!in[0]) break;
    float u1[P][E], x[P][E], q[P][E], a[P][E], sum[P], r[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (in[k]) {
        load_lane<E>(f1 + ((int64_t)blockIdx.y * HW + p[k]) * C, lane, u1[k]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) u1[k][e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) q[k][e] = u1[k][e] * u1[k][e];
    }
    if (TILED)
      sum_strided<C, P>(q, sm, lane, rows, sum);
    else
      sum_contiguous<C, P>(q, sum);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float den1 = sqrtf(sum[k]) + EPS;
#pragma unroll
      for (int e = 0; e < E; ++e) u1[k][e] = u1[k][e] / den1;
    }
    for (int v = blockIdx.y; v < n; v += B) {
      const float gm = gout[v] * inv_hw;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (in[k]) {
          load_lane<E>(f2 + ((int64_t)v * HW + p[k]) * C, lane, x[k]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) x[k][e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) q[k][e] = x[k][e] * x[k][e];
      }
      sum_contiguous<C, P>(q, sum);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        r[k] = sqrtf(sum[k]);
        const float den2 = r[k] + EPS, y2 = 1.0f / den2;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float u2 = div_by(x[k][e], den2, y2);
          const float gd = LIN ? gm * __ldg(w + Lanes<C>::channel(lane, e)) : gm * (1.0f / C);
          const float gt = gd * (2.0f * (u1[k][e] - u2));
          a[k][e] = div_by(-gt, den2, y2);          // the quotient's own gradient
          q[k][e] = gt * div_by(u2, den2, y2);      // the divisor's, before its channel sum
        }
      }
      sum_strided<C, P>(q, sm, lane, rows, sum);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float gs = r[k] > 0.0f ? sum[k] / (2.0f * r[k]) : 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float m = gs * x[k][e];
          x[k][e] = (a[k][e] + m) + m;
        }
        if (in[k]) store_lane<E>(grad + ((int64_t)v * HW + p[k]) * C, lane, x[k]);
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int64_t chunks(int C, int elem_bytes, int64_t HW) {
  const int vec = 16 / elem_bytes;
  const int tp = C / vec < 32 ? C / vec : 32;
  const int64_t chunk = (int64_t)(BLOCK / tp) * ITERS;
  return (HW + chunk - 1) / chunk;
}

bool valid(const void* f2, const void* f1, int n, int B, int C, int64_t HW, int elem_bytes) {
  return (C == 64 || C == 128 || C == 256 || C == 512) && (elem_bytes == 2 || elem_bytes == 4) &&
         n >= 0 && B >= 1 && B <= 65535 && n % B == 0 && HW >= 1 && aligned16(f2) &&
         aligned16(f1) && chunks(C, elem_bytes, HW) < (int64_t)1 << 31;
}

// one instantiation a (dtype, C, weights) case
#define LPIPS_DISPATCH(LAUNCH)                                                  \
  switch (C) {                                                                  \
    case 64: if (bf16) LAUNCH(__nv_bfloat16, 64) else LAUNCH(float, 64) break;  \
    case 128: if (bf16) LAUNCH(__nv_bfloat16, 128) else LAUNCH(float, 128) break; \
    case 256: if (bf16) LAUNCH(__nv_bfloat16, 256) else LAUNCH(float, 256) break; \
    default: if (bf16) LAUNCH(__nv_bfloat16, 512) else LAUNCH(float, 512) break; \
  }

}  // namespace

// The partials a view of HW pixels takes (the forward's workspace is n of
// them).
extern "C" int dbw_lpips_chunks(int C, int elem_bytes, long long HW) {
  return (int)chunks(C, elem_bytes, HW);
}

// f2: (n, HW, C) rendered features, f1: (B, HW, C) targets, channels last,
// bfloat16 (elem_bytes 2) or float32 (4), 16-byte aligned, C in {64, 128,
// 256, 512}, n a multiple of B; w: (C,) f32 weights or null (the channel
// mean); partial: n * dbw_lpips_chunks(...) f32; out: (n,) f32. scale:
// 1 / HW, over C too for the channel mean.
extern "C" int dbw_lpips_fwd(const void* f2, const void* f1, const float* w, int n, int B, int C,
                             long long HW, int elem_bytes, float scale, float* partial,
                             float* out, cudaStream_t stream) {
  if (!valid(f2, f1, n, B, C, HW, elem_bytes)) return (int)cudaErrorInvalidValue;
  if (n == 0) return -1;  // nothing to launch
  const bool bf16 = elem_bytes == 2;
  const int nchunk = (int)chunks(C, elem_bytes, HW);
  const dim3 grid(nchunk, B);
#define LPIPS_FWD(T, CC)                                                                 \
  {                                                                                      \
    if (w)                                                                               \
      lpips_fwd_kernel<T, CC, true><<<grid, BLOCK, 0, stream>>>(                         \
          (const T*)f2, (const T*)f1, w, n, B, HW, partial);                             \
    else                                                                                 \
      lpips_fwd_kernel<T, CC, false><<<grid, BLOCK, 0, stream>>>(                        \
          (const T*)f2, (const T*)f1, w, n, B, HW, partial);                             \
  }
  LPIPS_DISPATCH(LPIPS_FWD)
#undef LPIPS_FWD
  const int err = (int)cudaGetLastError();
  if (err) return err;
  lpips_sum_kernel<<<n, BLOCK, 0, stream>>>(partial, nchunk, scale, out);
  return (int)cudaGetLastError();
}

// f2, f1, w as for dbw_lpips_fwd; gout: (n,) f32 cotangent of out; grad:
// (n, HW, C) in f2's dtype, channels last, 16-byte aligned. inv_hw: the
// float32 quotient 1 / HW (autograd's mean backward multiplies by it);
// rows: the rows of PyTorch's strided channel sum (a power of 2, at most
// 32 and at most C).
extern "C" int dbw_lpips_bwd(const void* f2, const void* f1, const float* w, const float* gout,
                             int n, int B, int C, long long HW, int elem_bytes, float inv_hw,
                             int rows, void* grad, cudaStream_t stream) {
  if (!valid(f2, f1, n, B, C, HW, elem_bytes) || !aligned16(grad) ||
      rows < 1 || rows > 32 || rows > C || (rows & (rows - 1)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return -1;  // nothing to launch
  const bool bf16 = elem_bytes == 2;
  const int64_t chunk = (int64_t)(BLOCK / 32) * BWD_PIXELS;
  const int64_t nchunk = (HW + chunk - 1) / chunk;
  if (nchunk >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nchunk, B);
#define LPIPS_BWD_CASE(T, CC, LIN, TILED)                                                \
  lpips_bwd_kernel<T, CC, LIN, TILED><<<grid, BLOCK, 0, stream>>>(                       \
      (const T*)f2, (const T*)f1, w, gout, n, B, HW, inv_hw, rows, (T*)grad);
#define LPIPS_BWD(T, CC)                                                                 \
  {                                                                                      \
    if (n > B) {                                                                         \
      if (w) LPIPS_BWD_CASE(T, CC, true, true) else LPIPS_BWD_CASE(T, CC, false, true)   \
    } else {                                                                             \
      if (w) LPIPS_BWD_CASE(T, CC, true, false) else LPIPS_BWD_CASE(T, CC, false, false) \
    }                                                                                    \
  }
  LPIPS_DISPATCH(LPIPS_BWD)
#undef LPIPS_BWD
#undef LPIPS_BWD_CASE
  return (int)cudaGetLastError();
}
