// K2 and K3: the fused fragment stage of the soft training renderer.
//
// K2 replaces dbw_tpu/render/fragment_fused.py `_fwd_kernel` (reached through
// `fused_fragment_shade`): per fragment, read its 20-column face row, compute
// the 2D barycentrics and signed squared edge distance, the coverage alpha,
// and the perspective-correct clipped uv as a bilinear base texel id00 plus
// offsets wx, wy; save the 8-float residual [x0 y0 x1 y1 x2 y2 fa 0].
// K3 replaces `_bwd_kernel` (reached through `_bwd_vjp`): the VJP of the
// alpha math with respect to the 6 vertex-xy values and the face alpha,
// scatter-added into a (rows, 8) face-table gradient. sigma gets no
// cotangent. Plain twins: dbw_torch/render/fragment.py::frag_fwd_plain and
// ::frag_bwd_plain.
//
// Design: one thread per fragment. The face table (rows x 20 f32, a few
// hundred KB at the flagship shapes) is read straight from global memory and
// stays in L2; there is no one-hot window gather. K3 writes its 7 values with
// atomicAdd, skipping fragments whose cotangent is zero (empty slots). The
// derivative is written out by hand and follows JAX's conventions at ties:
// min/max/clip pass half the cotangent to each side when the two arguments
// are equal. Built with --fmad=false so the forward rounds like the plain
// PyTorch version.
//
// Bound: memory (K2 moves ~56 bytes per fragment, K3 ~52 bytes plus the
// atomics, which contend on the few hundred background faces that most
// fragments hit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NC = 20;  // face-table columns
constexpr int NR = 8;   // residual columns / d-table columns

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
                                float* __restrict__ alpha,
                                float* __restrict__ res) {
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
  float4* rp = reinterpret_cast<float4*>(res + (size_t)n * NR);
  rp[0] = make_float4(r[0], r[1], r[2], r[3]);
  rp[1] = make_float4(r[4], r[5], r[6], 0.0f);

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

__global__ void frag_bwd_kernel(const int32_t* __restrict__ ids,
                                const float* __restrict__ vld,
                                const float* __restrict__ pxs,
                                const float* __restrict__ pys,
                                const float* __restrict__ res,
                                const float* __restrict__ dalpha, int N,
                                float sigma, int clip_inside,
                                float* __restrict__ dtab) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float da = dalpha[n];
  const float v = vld[n];
  if (da == 0.0f || v == 0.0f) return;
  const float4 ra = reinterpret_cast<const float4*>(res + (size_t)n * NR)[0];
  const float4 rb = reinterpret_cast<const float4*>(res + (size_t)n * NR)[1];
  const float r[NR] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
  const float px = pxs[n], py = pys[n];
  const AlphaTerms at = alpha_math(r, px, py, v, sigma, clip_inside);
  const float A = sigma == 0.0f ? (at.dists <= 0.0f ? 1.0f : 0.0f) : at.soft;

  // alpha = (A * vld) * fa
  const float d_fa = da * (A * v);
  float g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (sigma != 0.0f) {
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
  float* out = dtab + (size_t)ids[n] * NR;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (g[i] != 0.0f) atomicAdd(out + i, g[i]);
  if (d_fa != 0.0f) atomicAdd(out + 6, d_fa);
}

}  // namespace

// table: (rows, 20) f32, 16-byte aligned rows; ids: (N,) i32 rows; vld, px,
// py: (N,) f32. Outputs id00 i32, wx, wy, alpha f32 (N,), res (N, 8) f32.
extern "C" int dbw_frag_fwd(const float* table, const int32_t* ids,
                            const float* vld, const float* px, const float* py,
                            int N, float sigma, int persp, int clip_bary,
                            int clip_inside, int TH, int TW, int32_t* id00,
                            float* wx, float* wy, float* alpha, float* res,
                            cudaStream_t stream) {
  if (N == 0) return -1;  // nothing to launch
  const int threads = 256;
  frag_fwd_kernel<<<(N + threads - 1) / threads, threads, 0, stream>>>(
      table, ids, vld, px, py, N, sigma, persp, clip_bary, clip_inside, TH, TW,
      id00, wx, wy, alpha, res);
  return (int)cudaGetLastError();
}

// dtab: (rows, 8) f32, zeroed by the caller; columns [x0 y0 x1 y1 x2 y2 fa 0].
extern "C" int dbw_frag_bwd(const int32_t* ids, const float* vld,
                            const float* px, const float* py, const float* res,
                            const float* dalpha, int N, float sigma,
                            int clip_inside, float* dtab, cudaStream_t stream) {
  if (N == 0) return -1;  // nothing to launch
  const int threads = 256;
  frag_bwd_kernel<<<(N + threads - 1) / threads, threads, 0, stream>>>(
      ids, vld, px, py, res, dalpha, N, sigma, clip_inside, dtab);
  return (int)cudaGetLastError();
}
