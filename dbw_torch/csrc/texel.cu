// K4: texture-atlas gradient of the bilinear quad sample; K8, the sample's
// forward, is at the end of this file.
//
// Replaces dbw_tpu/ops/segment_sum_pallas.py `_kernel` (reached through
// `quad_corner_segment_sums` from render/meshes.py::_quad_maps_grad). The TPU
// version sorts the fragments by base texel, segment-sums 12 weighted
// channels on the MXU and applies the 4-offset stencil afterwards, with the
// bilinear weights quantized to 15 bits to ride the sort. Here each fragment
// adds w_c * g into d_maps[id00 + off_c] for the stencil
// off = {0, 1, TW, TW + 1}, f32 weights, no sort. Corners past the end of the
// atlas are dropped, as the stencil's shifts drop them; a fragment whose
// cotangent is zero (an empty slot) adds nothing.
// Plain twin: dbw_torch/ops/texel_grad.py::quad_maps_grad_plain.
//
// Bound: the bytes, 24 per fragment read (id00, wx, wy, the RGB cotangent)
// and 12 per texel written: 124 MB for the flagship blocks pass (4.8 M
// fragments, 714,240 texels), 37 us at 3.35 TB/s. What keeps a kernel from
// it is the atomics: each is one operation of an L2 slice, and in the env
// pass the dome and ground texels are magnified, so neighbouring pixels add
// into the same few texels and their atomics serialize.
//
// Design: fragments come in the layout n = pixel * K + slot. A block stages
// a contiguous range of 32 * G whole pixels (all K slots; G * K * 32 <= CHUNK
// fragments) in shared memory with coalesced 16-byte loads. Each warp then
// takes one slot k of 32 consecutive pixels, so that pixels that sample the
// same base texel meet in one warp, and pre-reduces before any atomic: a
// segmented inclusive scan over runs of equal id00 (run heads by
// __ballot_sync, sums of the 12 weighted values by 5 __shfl_up_sync steps,
// as K5 does in scatter.cu). Only a run's last lane adds its sums, one
// float4 atomic (RGB and a pad) per corner with a nonzero sum, into an
// (R, 4) accumulator: a third of the atomic operations of one per channel.
// A second kernel packs the accumulator into the (R, 3) result. A fragment
// with a zero cotangent (an empty slot) takes the id -1, which breaks a run
// and adds nothing; a warp whose 32 fragments are all empty skips the scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int CHUNK = 1024;  // fragments staged by a block (24 KB)
constexpr int MAX_K = 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
texel_grad_kernel(const int32_t* __restrict__ id00,
                  const float* __restrict__ wx, const float* __restrict__ wy,
                  const float* __restrict__ g, int N, int K, int G, int R,
                  int TW, bool vec, float4* __restrict__ acc) {
  __shared__ __align__(16) int sid[CHUNK];
  __shared__ __align__(16) float swx[CHUNK];
  __shared__ __align__(16) float swy[CHUNK];
  __shared__ __align__(16) float sg[3 * CHUNK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int FB = 32 * G * K;  // a multiple of 32: 16-byte aligned offsets
  const int64_t f0 = (int64_t)blockIdx.x * FB;
  if (vec && f0 + FB <= N) {
    for (int i = threadIdx.x; i < FB / 4; i += THREADS) {
      reinterpret_cast<int4*>(sid)[i] = reinterpret_cast<const int4*>(id00 + f0)[i];
      reinterpret_cast<float4*>(swx)[i] = reinterpret_cast<const float4*>(wx + f0)[i];
      reinterpret_cast<float4*>(swy)[i] = reinterpret_cast<const float4*>(wy + f0)[i];
    }
    for (int i = threadIdx.x; i < 3 * FB / 4; i += THREADS)
      reinterpret_cast<float4*>(sg)[i] = reinterpret_cast<const float4*>(g + 3 * f0)[i];
  } else {
    for (int i = threadIdx.x; i < FB; i += THREADS) {
      const int64_t n = f0 + i;
      const bool in = n < N;
      sid[i] = in ? id00[n] : -1;
      swx[i] = in ? wx[n] : 0.0f;
      swy[i] = in ? wy[n] : 0.0f;
    }
    for (int i = threadIdx.x; i < 3 * FB; i += THREADS) {
      const int64_t n = 3 * f0 + i;
      sg[i] = n < 3 * (int64_t)N ? g[n] : 0.0f;
    }
  }
  __syncthreads();

  for (int u = warp; u < G * K; u += NWARP) {
    const int grp = u / K, k = u - grp * K;
    const int i = (grp * 32 + lane) * K + k;
    const float g0 = sg[3 * i], g1 = sg[3 * i + 1], g2 = sg[3 * i + 2];
    const int id = (g0 == 0.0f && g1 == 0.0f && g2 == 0.0f) ? -1 : sid[i];
    if (__ballot_sync(FULL, id >= 0) == 0) continue;  // 32 empty slots
    const float fx = swx[i], fy = swy[i];
    const float w[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                        (1.0f - fx) * fy, fx * fy};
    float v[12];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[3 * c] = id >= 0 ? w[c] * g0 : 0.0f;
      v[3 * c + 1] = id >= 0 ? w[c] * g1 : 0.0f;
      v[3 * c + 2] = id >= 0 ? w[c] * g2 : 0.0f;
    }
    // runs of equal ids: a head is a lane whose id differs from the lane
    // before it; seg0 is the lane of this lane's head
    const int prev = __shfl_up_sync(FULL, id, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != id);
    const int seg0 = 31 - __clz(heads & (FULL >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool take = lane - d >= seg0;
#pragma unroll
      for (int c = 0; c < 12; ++c) {
        const float o = __shfl_up_sync(FULL, v[c], d);
        if (take) v[c] += o;
      }
    }
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (tail && id >= 0) {
      const int64_t offs[4] = {0, 1, TW, TW + 1};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t t = (int64_t)id + offs[c];
        if (t < R && (v[3 * c] != 0.0f || v[3 * c + 1] != 0.0f || v[3 * c + 2] != 0.0f))
          atomicAdd(acc + t, make_float4(v[3 * c], v[3 * c + 1], v[3 * c + 2], 0.0f));
      }
    }
  }
}

__global__ void texel_pack_kernel(const float4* __restrict__ acc, int R,
                                  float* __restrict__ dmaps) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R) return;
  const float4 a = acc[t];
  dmaps[3 * t] = a.x;
  dmaps[3 * t + 1] = a.y;
  dmaps[3 * t + 2] = a.z;
}

}  // namespace

// id00: (N,) i32 base texel in [0, R); wx, wy: (N,) f32; g: (N, 3) f32, in
// the fragment layout n = pixel * K + slot (N a multiple of K, K <= 32);
// acc: (R, 4) f32 scratch, 16-byte aligned and zeroed by the caller; dmaps:
// (R, 3) f32, written.
extern "C" int dbw_texel_grad(const int32_t* id00, const float* wx,
                              const float* wy, const float* g, int N, int K,
                              int R, int TW, float* acc, float* dmaps,
                              cudaStream_t stream) {
  if (K < 1 || K > MAX_K || N % K || reinterpret_cast<uintptr_t>(acc) % 16)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || R == 0) return -1;  // nothing to launch
  const int G = CHUNK / (32 * K) > 0 ? CHUNK / (32 * K) : 1;
  const int FB = 32 * G * K;
  // 16-byte loads need 16-byte aligned bases
  const bool vec = ((reinterpret_cast<uintptr_t>(id00) | reinterpret_cast<uintptr_t>(wx) |
                     reinterpret_cast<uintptr_t>(wy) | reinterpret_cast<uintptr_t>(g)) &
                    15) == 0;
  float4* acc4 = reinterpret_cast<float4*>(acc);
  texel_grad_kernel<<<(N + FB - 1) / FB, THREADS, 0, stream>>>(
      id00, wx, wy, g, N, K, G, R, TW, vec, acc4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  texel_pack_kernel<<<(R + THREADS - 1) / THREADS, THREADS, 0, stream>>>(acc4, R, dmaps);
  return (int)cudaGetLastError();
}

// K8: the bilinear quad texture sample's forward, the colour of each
// fragment from the 2x2 texel neighbourhood at its base texel id00.
//
// Replaces no TPU kernel: in dbw_tpu it is XLA's gather of a quad table
// and weighted sum (render/meshes.py:195 `_quad_forward`); the plain twin is
// dbw_torch/render/meshes.py::quad_forward_plain, which launches 41 PyTorch
// ops over (N, 3) temporaries and int64 indices, ~778 bytes of device
// traffic a fragment.
//
// Bound: the bytes, 12 per fragment read (id00, wx, wy) and 12 written (the
// colour); the four texel rows come from the atlas, a few MB a slot, which
// stays in the 50 MB L2 across the pass's neighbouring fragments. 2.5 GB
// for `campanile`'s blocks pass (103.7 M fragments), 0.74 ms at 3.35 TB/s.
//
// Design: one thread a fragment, no shared state between fragments, so the
// kernel does not depend on K or on the fragment layout. The id00, wx, wy
// reads are coalesced over consecutive fragments; the (N, 3) colours are
// staged in shared memory and stored as coalesced 16-byte words. The
// arithmetic is the plain twin's, in its order: the weights (1-wx)(1-wy),
// wx(1-wy), (1-wx)wy, wx wy, and per channel the sum
// (((0 + q00 w00) + q01 w01) + q10 w10) + q11 w11, each product and sum
// rounded to float32 (the build's --fmad=false keeps them apart), so the
// colours equal the plain twin's bit for bit. As there, row id00 is clamped
// to R - 1 and a corner row at R or beyond reads zero (times its weight).

namespace {

constexpr int QS_THREADS = 256;

// The texel row t of an (R, 3) atlas as PyTorch's indexing reads it: a
// negative t counts from the end; outside [-R, R) it reads zero.
__device__ __forceinline__ void texel_row(const float* __restrict__ maps, int64_t t,
                                          int64_t R, float q[3]) {
  const bool in = t < R && t >= -R;
  const float* p = maps + 3 * (t < 0 ? t + R : t);
  q[0] = in ? __ldg(p) : 0.0f;
  q[1] = in ? __ldg(p + 1) : 0.0f;
  q[2] = in ? __ldg(p + 2) : 0.0f;
}

__global__ void __launch_bounds__(QS_THREADS)
quad_sample_fwd_kernel(const float* __restrict__ maps, const int32_t* __restrict__ id00,
                       const float* __restrict__ wx, const float* __restrict__ wy,
                       int64_t N, int64_t R, int TW, bool vec, float* __restrict__ out) {
  __shared__ __align__(16) float so[3 * QS_THREADS];
  const int64_t n0 = (int64_t)blockIdx.x * QS_THREADS;
  const int64_t n = n0 + threadIdx.x;
  if (n < N) {
    const float fx = wx[n], fy = wy[n];
    const float ax = 1.0f - fx, ay = 1.0f - fy;
    const float w[4] = {ax * ay, fx * ay, ax * fy, fx * fy};
    const int64_t base = id00[n];
    const int64_t offs[4] = {0, 1, TW, TW + 1};
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t t = c == 0 ? (base < R - 1 ? base : R - 1) : base + offs[c];
      float q[3];
      texel_row(maps, t, R, q);
      c0 = c0 + q[0] * w[c];
      c1 = c1 + q[1] * w[c];
      c2 = c2 + q[2] * w[c];
    }
    so[3 * threadIdx.x] = c0;
    so[3 * threadIdx.x + 1] = c1;
    so[3 * threadIdx.x + 2] = c2;
  }
  __syncthreads();
  const int64_t cnt = N - n0 < QS_THREADS ? N - n0 : QS_THREADS;
  float* o = out + 3 * n0;
  if (vec && cnt == QS_THREADS) {
    for (int i = threadIdx.x; i < 3 * QS_THREADS / 4; i += QS_THREADS)
      reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(so)[i];
  } else {
    for (int i = threadIdx.x; i < 3 * cnt; i += QS_THREADS) o[i] = so[i];
  }
}

}  // namespace

// maps: (R, 3) f32 atlas rows; id00: (N,) i32 base texels; wx, wy: (N,)
// f32; out: (N, 3) f32, written.
extern "C" int dbw_quad_sample_fwd(const float* maps, const int32_t* id00, const float* wx,
                                   const float* wy, long long N, long long R, int TW,
                                   float* out, cudaStream_t stream) {
  if (N < 0 || R < 0 || TW < 1 || (N > 0 && R == 0)) return (int)cudaErrorInvalidValue;
  if (N == 0) return -1;  // nothing to launch
  // 16-byte stores need a 16-byte aligned base (a full block's 3072 bytes keep it)
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long blocks = (N + QS_THREADS - 1) / QS_THREADS;
  quad_sample_fwd_kernel<<<(unsigned)blocks, QS_THREADS, 0, stream>>>(
      maps, id00, wx, wy, (int64_t)N, (int64_t)R, TW, vec, out);
  return (int)cudaGetLastError();
}
