// K2 and K3: the fused fragment stage of the soft training renderer.
//
// K2 replaces dbw_tpu/render/fragment_fused.py `_fwd_kernel` (reached through
// `fused_fragment_shade`): per fragment, read its 20-column face row, compute
// the 2D barycentrics and signed squared edge distance, the coverage alpha,
// and the perspective-correct clipped uv as a bilinear base texel id00 plus
// offsets wx, wy. K3 replaces `_bwd_kernel` (reached through `_bwd_vjp`):
// the VJP of the alpha math with respect to the 6 vertex-xy values and the
// face alpha, scatter-added into a (rows, 8) face-table gradient. sigma gets
// no cotangent. Plain twins: dbw_torch/render/fragment.py::frag_fwd_plain
// and ::frag_bwd_plain.
//
// The face table (rows x 20 f32, 256 KB at the flagship blocks pass) is read
// straight from global memory and stays in L2; there is no one-hot window
// gather. The TPU version saves an 8-float residual per fragment (the alpha
// math's 7 inputs, a copy of table columns) for its backward; here K3 reads
// those columns of the table itself, which saves 32 bytes a fragment each
// way. The derivative is written out by hand and follows JAX's conventions
// at ties: min/max/clip pass half the cotangent to each side when the two
// arguments are equal. Built with --fmad=false so the forward rounds like
// the plain PyTorch version.
//
// K2: one thread per fragment. Bound: memory (16 bytes read and 16 written
// per fragment; the face rows come from L2).
// K3: bound by memory (20 bytes read per fragment) once the atomics do not
// contend; without pre-reduction they do, on the few background faces that
// most pixels of the joint scene see. Design, as K4's in texel.cu: the
// fragments come in the layout n = pixel * K + slot. A block stages a
// contiguous range of 32 * G whole pixels (all K slots) in shared memory
// with coalesced 16-byte loads; each warp then takes one slot of 32
// consecutive pixels, so that neighbouring pixels that see the same face
// meet in one warp. Each lane computes its fragment's 7 values, a
// segmented inclusive scan over runs of equal ids sums them, and only a
// run's last lane adds the sums, with two float4 atomics into the (rows, 8)
// gradient (columns 0-3 and 4-7, 7 the zero pad). A fragment with a zero
// cotangent (an empty slot) takes the id -1, which breaks a run and adds
// nothing; a warp whose 32 fragments are all such skips the scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NC = 20;  // face-table columns
constexpr int NR = 8;   // the alpha math's inputs / d-table columns

__device__ __forceinline__ float seg_d2(float ax, float ay, float bx, float by,
                                        float px, float py) {
  float abx = bx - ax, aby = by - ay;
  float apx = px - ax, apy = py - ay;
  float denom = fmaxf(abx * abx + aby * aby, 1e-12f);
  float t = fminf(fmaxf((apx * abx + apy * aby) / denom, 0.0f), 1.0f);
  float dx = apx - t * abx;
  float dy = apy - t * aby;
  return dx * dx + dy * dy;
}

struct AlphaTerms {
  bool inside;
  float dists, soft, a;
  float s01, s12, s20, m1, d2;
};

__device__ __forceinline__ AlphaTerms alpha_math(const float* r, float px,
                                                 float py, float vld,
                                                 float sigma, int clip_inside) {
  const float x0 = r[0], y0 = r[1], x1 = r[2], y1 = r[3], x2 = r[4], y2 = r[5];
  const float fa = r[6];
  AlphaTerms o;
  const float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
  const float inv_area = fabsf(area) > 1e-12f ? 1.0f / area : 0.0f;
  const float w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv_area;
  const float w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv_area;
  const float w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv_area;
  o.inside = fminf(fminf(w0, w1), w2) >= 0.0f;
  o.s01 = seg_d2(x0, y0, x1, y1, px, py);
  o.s12 = seg_d2(x1, y1, x2, y2, px, py);
  o.s20 = seg_d2(x2, y2, x0, y0, px, py);
  o.m1 = fminf(o.s01, o.s12);
  o.d2 = fminf(o.m1, o.s20);
  o.dists = o.inside ? -o.d2 : o.d2;
  const float sig = fmaxf(sigma, 1e-20f);
  if (clip_inside)
    o.soft = expf(-fmaxf(o.dists, 0.0f) / sig);
  else
    o.soft = 1.0f / (1.0f + expf(o.dists / sig));
  const float hard = o.dists <= 0.0f ? 1.0f : 0.0f;
  o.a = (sigma == 0.0f ? hard : o.soft) * vld * fa;
  return o;
}

// JAX's share of the cotangent for the first argument of min/max at `ans`
__device__ __forceinline__ float bal(float x, float ans, float y) {
  return x == ans ? (y == ans ? 0.5f : 1.0f) : 0.0f;
}

// accumulate the VJP of seg_d2(a, b) for cotangent g into (dax, day, dbx, dby)
__device__ __forceinline__ void seg_d2_vjp(float ax, float ay, float bx,
                                           float by, float px, float py,
                                           float g, float& dax, float& day,
                                           float& dbx, float& dby) {
  if (g == 0.0f) return;
  const float abx = bx - ax, aby = by - ay;
  const float apx = px - ax, apy = py - ay;
  const float ss = abx * abx + aby * aby;
  const float denom = fmaxf(ss, 1e-12f);
  const float num = apx * abx + apy * aby;
  const float tr = num / denom;
  const float t1 = fmaxf(tr, 0.0f);
  const float t = fminf(t1, 1.0f);
  const float dx = apx - t * abx;
  const float dy = apy - t * aby;
  const float gx = 2.0f * g * dx;
  const float gy = 2.0f * g * dy;
  float d_apx = gx, d_apy = gy;
  float d_abx = -gx * t, d_aby = -gy * t;
  const float dt = -(gx * abx) - gy * aby;
  const float dt1 = dt * bal(t1, t, 1.0f);
  const float dtr = dt1 * bal(tr, t1, 0.0f);
  const float dnum = dtr / denom;
  const float ddenom = -dtr * num / (denom * denom);
  const float dss = ddenom * bal(ss, denom, 1e-12f);
  d_abx += 2.0f * dss * abx + dnum * apx;
  d_aby += 2.0f * dss * aby + dnum * apy;
  d_apx += dnum * abx;
  d_apy += dnum * aby;
  dax -= d_apx + d_abx;
  day -= d_apy + d_aby;
  dbx += d_abx;
  dby += d_aby;
}

__global__ void frag_fwd_kernel(const float* __restrict__ table,
                                const int32_t* __restrict__ ids,
                                const float* __restrict__ vld,
                                const float* __restrict__ pxs,
                                const float* __restrict__ pys, int N,
                                float sigma, int persp, int clip_bary,
                                int clip_inside, int TH, int TW,
                                int32_t* __restrict__ id00,
                                float* __restrict__ wxo,
                                float* __restrict__ wyo,
                                float* __restrict__ alpha) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* row = table + (size_t)ids[n] * NC;
  float c[NC];
#pragma unroll
  for (int i = 0; i < NC; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + i);
    c[i] = v.x;
    c[i + 1] = v.y;
    c[i + 2] = v.z;
    c[i + 3] = v.w;
  }
  const float px = pxs[n], py = pys[n];
  float r[NR] = {c[0], c[1], c[2], c[3], c[4], c[5], c[9], 0.0f};
  const AlphaTerms at = alpha_math(r, px, py, vld[n], sigma, clip_inside);
  alpha[n] = at.a;

  // texel coordinates (the JAX _uv_math)
  const float x0 = c[0], y0 = c[1], x1 = c[2], y1 = c[3], x2 = c[4], y2 = c[5];
  const float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
  const float inv_area = fabsf(area) > 1e-12f ? 1.0f / area : 0.0f;
  const float w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv_area;
  const float w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv_area;
  const float w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv_area;
  float b0 = w0, b1 = w1, b2 = w2;
  if (persp) {
    const float iw0 = w0 / fmaxf(c[6], 1e-8f);
    const float iw1 = w1 / fmaxf(c[7], 1e-8f);
    const float iw2 = w2 / fmaxf(c[8], 1e-8f);
    const float den = fmaxf(iw0 + iw1 + iw2, 1e-12f);
    b0 = iw0 / den;
    b1 = iw1 / den;
    b2 = iw2 / den;
  }
  if (clip_bary) {
    b0 = fminf(fmaxf(b0, 0.0f), 1.0f);
    b1 = fminf(fmaxf(b1, 0.0f), 1.0f);
    b2 = fminf(fmaxf(b2, 0.0f), 1.0f);
    const float bs = fmaxf(b0 + b1 + b2, 1e-6f);
    b0 = b0 / bs;
    b1 = b1 / bs;
    b2 = b2 / bs;
  }
  const float uv_u = b0 * c[12] + b1 * c[14] + b2 * c[16];
  const float uv_v = b0 * c[13] + b1 * c[15] + b2 * c[17];
  const float u = fminf(fmaxf(uv_u, 0.0f), 1.0f) * (float)(TW - 1);
  const float v = (1.0f - fminf(fmaxf(uv_v, 0.0f), 1.0f)) * (float)(TH - 1);
  const float x0f = floorf(u);
  const float y0f = floorf(v);
  id00[n] = (int32_t)c[18] * (TH * TW) + (int32_t)y0f * TW + (int32_t)x0f;
  wxo[n] = u - x0f;
  wyo[n] = v - y0f;
}

// the VJP of one fragment's alpha for cotangent da, from the alpha math's
// inputs r = [x0 y0 x1 y1 x2 y2 fa 0]: g = d[x0 y0 x1 y1 x2 y2 fa]
__device__ __forceinline__ void alpha_vjp(const float* r, float px, float py,
                                          float v, float da, float sigma,
                                          int clip_inside, float* g) {
  const AlphaTerms at = alpha_math(r, px, py, v, sigma, clip_inside);
  const float A = sigma == 0.0f ? (at.dists <= 0.0f ? 1.0f : 0.0f) : at.soft;
  // alpha = (A * vld) * fa
  g[6] = da * (A * v);
  if (sigma == 0.0f) return;
  const float dA = da * r[6] * v;
  const float sig = fmaxf(sigma, 1e-20f);
  float dd;  // cotangent of dists
  if (clip_inside) {
    const float dq = dA * at.soft;
    dd = -(dq / sig) * bal(at.dists, fmaxf(at.dists, 0.0f), 0.0f);
  } else {
    dd = -(dA * at.soft * (1.0f - at.soft)) / sig;
  }
  const float dd2 = at.inside ? -dd : dd;
  const float dm1 = dd2 * bal(at.m1, at.d2, at.s20);
  const float ds20 = dd2 * bal(at.s20, at.d2, at.m1);
  const float ds01 = dm1 * bal(at.s01, at.m1, at.s12);
  const float ds12 = dm1 * bal(at.s12, at.m1, at.s01);
  seg_d2_vjp(r[0], r[1], r[2], r[3], px, py, ds01, g[0], g[1], g[2], g[3]);
  seg_d2_vjp(r[2], r[3], r[4], r[5], px, py, ds12, g[2], g[3], g[4], g[5]);
  seg_d2_vjp(r[4], r[5], r[0], r[1], px, py, ds20, g[4], g[5], g[0], g[1]);
}

constexpr int BWD_THREADS = 256;
constexpr int BWD_NWARP = BWD_THREADS / 32;
constexpr int BWD_CHUNK = 1024;  // fragments staged by a block (20 KB)
constexpr int MAX_K = 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(BWD_THREADS)
frag_bwd_kernel(const float* __restrict__ table, const int32_t* __restrict__ ids,
                const float* __restrict__ vld, const float* __restrict__ pxs,
                const float* __restrict__ pys, const float* __restrict__ dalpha,
                int N, int K, int G, float sigma, int clip_inside, bool vec,
                float4* __restrict__ dtab) {
  __shared__ __align__(16) int sid[BWD_CHUNK];
  __shared__ __align__(16) float svld[BWD_CHUNK];
  __shared__ __align__(16) float spx[BWD_CHUNK];
  __shared__ __align__(16) float spy[BWD_CHUNK];
  __shared__ __align__(16) float sda[BWD_CHUNK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int FB = 32 * G * K;  // a multiple of 32: 16-byte aligned offsets
  const int64_t f0 = (int64_t)blockIdx.x * FB;
  if (vec && f0 + FB <= N) {
    for (int i = threadIdx.x; i < FB / 4; i += BWD_THREADS) {
      reinterpret_cast<int4*>(sid)[i] = reinterpret_cast<const int4*>(ids + f0)[i];
      reinterpret_cast<float4*>(svld)[i] = reinterpret_cast<const float4*>(vld + f0)[i];
      reinterpret_cast<float4*>(spx)[i] = reinterpret_cast<const float4*>(pxs + f0)[i];
      reinterpret_cast<float4*>(spy)[i] = reinterpret_cast<const float4*>(pys + f0)[i];
      reinterpret_cast<float4*>(sda)[i] = reinterpret_cast<const float4*>(dalpha + f0)[i];
    }
  } else {
    for (int i = threadIdx.x; i < FB; i += BWD_THREADS) {
      const int64_t n = f0 + i;
      const bool in = n < N;
      sid[i] = in ? ids[n] : -1;
      svld[i] = in ? vld[n] : 0.0f;
      spx[i] = in ? pxs[n] : 0.0f;
      spy[i] = in ? pys[n] : 0.0f;
      sda[i] = in ? dalpha[n] : 0.0f;
    }
  }
  __syncthreads();

  for (int u = warp; u < G * K; u += BWD_NWARP) {
    const int grp = u / K, k = u - grp * K;
    const int i = (grp * 32 + lane) * K + k;
    const float da = sda[i], v = svld[i];
    const int id = (da == 0.0f || v == 0.0f) ? -1 : sid[i];
    if (__ballot_sync(FULL, id >= 0) == 0) continue;  // 32 empty slots
    float g[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (id >= 0) {
      // columns 0-5 and 9 of the fragment's face row, from L2
      const float4* row = reinterpret_cast<const float4*>(table + (size_t)id * NC);
      const float4 a = row[0], b = row[1];
      const float r[NR] = {a.x, a.y, a.z, a.w, b.x, b.y, table[(size_t)id * NC + 9], 0.0f};
      alpha_vjp(r, spx[i], spy[i], v, da, sigma, clip_inside, g);
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
      for (int c = 0; c < 7; ++c) {
        const float o = __shfl_up_sync(FULL, g[c], d);
        if (take) g[c] += o;
      }
    }
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (tail && id >= 0) {
      const float4 lo4 = make_float4(g[0], g[1], g[2], g[3]);
      const float4 hi4 = make_float4(g[4], g[5], g[6], 0.0f);
      if (lo4.x != 0.0f || lo4.y != 0.0f || lo4.z != 0.0f || lo4.w != 0.0f)
        atomicAdd(dtab + 2 * (size_t)id, lo4);
      if (hi4.x != 0.0f || hi4.y != 0.0f || hi4.z != 0.0f)
        atomicAdd(dtab + 2 * (size_t)id + 1, hi4);
    }
  }
}

}  // namespace

// table: (rows, 20) f32, 16-byte aligned rows; ids: (N,) i32 rows; vld, px,
// py: (N,) f32. Outputs id00 i32, wx, wy, alpha f32 (N,).
extern "C" int dbw_frag_fwd(const float* table, const int32_t* ids,
                            const float* vld, const float* px, const float* py,
                            int N, float sigma, int persp, int clip_bary,
                            int clip_inside, int TH, int TW, int32_t* id00,
                            float* wx, float* wy, float* alpha,
                            cudaStream_t stream) {
  if (N == 0) return -1;  // nothing to launch
  const int threads = 256;
  frag_fwd_kernel<<<(N + threads - 1) / threads, threads, 0, stream>>>(
      table, ids, vld, px, py, N, sigma, persp, clip_bary, clip_inside, TH, TW,
      id00, wx, wy, alpha);
  return (int)cudaGetLastError();
}

// table: (rows, 20) f32, 16-byte aligned; ids, vld, px, py, dalpha: (N,) in
// the fragment layout n = pixel * K + slot (N a multiple of K, K <= 32);
// dtab: (rows, 8) f32, 16-byte aligned and zeroed by the caller; columns
// [x0 y0 x1 y1 x2 y2 fa 0].
extern "C" int dbw_frag_bwd(const float* table, const int32_t* ids,
                            const float* vld, const float* px, const float* py,
                            const float* dalpha, int N, int K, float sigma,
                            int clip_inside, float* dtab, cudaStream_t stream) {
  if (K < 1 || K > MAX_K || N % K || reinterpret_cast<uintptr_t>(table) % 16 ||
      reinterpret_cast<uintptr_t>(dtab) % 16)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return -1;  // nothing to launch
  const int G = BWD_CHUNK / (32 * K) > 0 ? BWD_CHUNK / (32 * K) : 1;
  const int FB = 32 * G * K;
  // 16-byte staging loads need 16-byte aligned bases
  const bool vec = ((reinterpret_cast<uintptr_t>(ids) | reinterpret_cast<uintptr_t>(vld) |
                     reinterpret_cast<uintptr_t>(px) | reinterpret_cast<uintptr_t>(py) |
                     reinterpret_cast<uintptr_t>(dalpha)) & 15) == 0;
  frag_bwd_kernel<<<(N + FB - 1) / FB, BWD_THREADS, 0, stream>>>(
      table, ids, vld, px, py, dalpha, N, K, G, sigma, clip_inside, vec,
      reinterpret_cast<float4*>(dtab));
  return (int)cudaGetLastError();
}
