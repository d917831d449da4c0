// K1: per-pixel top-K face selection (soft rasterizer front end).
//
// Replaces the TPU selection kernel dbw_tpu/render/rasterize_pallas.py
// (`_kernel`, launched by `rasterize_pallas_batched`). Contract: for each
// pixel, the K faces with the smallest perspective-correct clipped
// barycentric z among faces that cover the pixel (inside, or squared edge
// distance < blur) with z > z_clip, in ascending (z, face index) order, -1
// for an empty slot. Not differentiated. Plain twin:
// dbw_torch/render/rasterize.py::rasterize_plain.
//
// Design: one thread per pixel, 16x16 pixel tile per block. The block stages
// FCHUNK packed faces at a time in shared memory; a face whose
// blur-inflated bbox misses the tile bbox is flagged off, and a chunk with no
// flagged face is skipped by the whole block. Each pixel keeps its KS best
// (z, face) pairs in registers by insertion; faces are visited in increasing
// index order and compared as (z, index) pairs, so ties go to the lower face
// index. The coverage and depth expressions are those of the TPU kernel,
// evaluated without FMA contraction (built with --fmad=false) so they round
// like the plain PyTorch version.
//
// HARD (blur statically 0, the env pass and the hard renderers): coverage is
// `inside` alone, so the three segment distances and the blur inflation of
// the tile cull drop out (TPU: the `hard` specialization of `_kernel`). With
// K = 1 a pixel keeps one (z, face) pair, a running minimum in the same
// (z, index) order.
//
// Bound: arithmetic (~40 flops per pixel-face pair that survives the tile
// cull); the face table is a few hundred KB and is read once per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NT = TILE * TILE;
constexpr int FCHUNK = NT;
constexpr int NA = 16;  // packed attributes per face (see pack_faces)
constexpr float BIGF = 3.0e38f;

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

template <int KS, bool HARD>
__global__ void __launch_bounds__(NT)
select_kernel(const float* __restrict__ faces, int F, int H, int W, int K,
              float blur, float inflate, float z_clip, int persp,
              int clip_bary, int32_t* __restrict__ out) {
  __shared__ float sf[FCHUNK * NA];
  __shared__ int sflag[FCHUNK];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int c0 = blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  const int col = c0 + threadIdx.x;
  const int row = r0 + threadIdx.y;
  const bool active = col < W && row < H;
  const float s = (float)min(H, W);
  const float Wm1 = (float)W - 1.0f;
  const float Hm1 = (float)H - 1.0f;
  const float px = (Wm1 - 2.0f * (float)col) / s;
  const float py = (Hm1 - 2.0f * (float)row) / s;

  // NDC bbox of the tile (+x at column 0, +y at row 0), inflated by the blur
  // radius plus a margin so the cull stays conservative under rounding
  const float infl = inflate + 1e-5f;
  const float txmax = (Wm1 - 2.0f * (float)c0) / s + infl;
  const float txmin = (Wm1 - 2.0f * (float)(c0 + TILE - 1)) / s - infl;
  const float tymax = (Hm1 - 2.0f * (float)r0) / s + infl;
  const float tymin = (Hm1 - 2.0f * (float)(r0 + TILE - 1)) / s - infl;

  float kz[KS];
  int ki[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    kz[k] = BIGF;
    ki[k] = -1;
  }

  const float* fb = faces + (size_t)b * F * NA;
  for (int f0 = 0; f0 < F; f0 += FCHUNK) {
    const int n = min(FCHUNK, F - f0);
    for (int i = tid; i < n * NA; i += NT) sf[i] = fb[(size_t)f0 * NA + i];
    __syncthreads();
    int flag = 0;
    if (tid < n) {
      const float* a = sf + tid * NA;
      flag = a[9] > 0.5f && a[10] <= txmax && a[11] >= txmin &&
             a[12] <= tymax && a[13] >= tymin;
    }
    sflag[tid] = flag;
    const int any = __syncthreads_or(flag);
    if (any && active) {
      for (int j = 0; j < n; ++j) {
        if (!sflag[j]) continue;
        const float* a = sf + j * NA;
        const float x0 = a[0], y0 = a[1], x1 = a[2], y1 = a[3];
        const float x2 = a[4], y2 = a[5];
        const float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
        const float inv_area = fabsf(area) > 1e-12f ? 1.0f / area : 0.0f;
        const float w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv_area;
        const float w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv_area;
        const float w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv_area;
        bool covered = fminf(fminf(w0, w1), w2) >= 0.0f;
        if (!HARD && !covered) {
          const float d2 = fminf(fminf(seg_d2(x0, y0, x1, y1, px, py),
                                       seg_d2(x1, y1, x2, y2, px, py)),
                                 seg_d2(x2, y2, x0, y0, px, py));
          covered = d2 < blur;
        }
        if (!covered) continue;
        const float z0 = a[6], z1 = a[7], z2 = a[8];
        float b0 = w0, b1 = w1, b2 = w2;
        if (persp) {
          const float iw0 = w0 / fmaxf(z0, 1e-8f);
          const float iw1 = w1 / fmaxf(z1, 1e-8f);
          const float iw2 = w2 / fmaxf(z2, 1e-8f);
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
        float z = b0 * z0 + b1 * z1 + b2 * z2;
        if (!(z > z_clip)) continue;
        int fi = f0 + j;
        if (!(z < kz[KS - 1] || (z == kz[KS - 1] && fi < ki[KS - 1]))) continue;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const bool lt = z < kz[k] || (z == kz[k] && fi < ki[k]);
          if (lt) {
            const float tz = kz[k];
            const int tf = ki[k];
            kz[k] = z;
            ki[k] = fi;
            z = tz;
            fi = tf;
          }
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  int32_t* o = out + (((size_t)b * H + row) * W + col) * K;
#pragma unroll
  for (int k = 0; k < KS; ++k)
    if (k < K) o[k] = ki[k];
}

template <int KS>
cudaError_t launch(const float* faces, int B, int F, int H, int W, int K,
                   float blur, float inflate, float z_clip, int persp,
                   int clip_bary, int hard, int32_t* out,
                   cudaStream_t stream) {
  dim3 block(TILE, TILE);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  if (hard)
    select_kernel<KS, true><<<grid, block, 0, stream>>>(
        faces, F, H, W, K, 0.0f, 0.0f, z_clip, persp, clip_bary, out);
  else
    select_kernel<KS, false><<<grid, block, 0, stream>>>(
        faces, F, H, W, K, blur, inflate, z_clip, persp, clip_bary, out);
  return cudaGetLastError();
}

}  // namespace

// faces: (B, F, 16) f32 packed rows [x0 y0 x1 y1 x2 y2 z0 z1 z2 valid xmin
// xmax ymin ymax pad pad]; out: (B, H, W, K) int32. K <= 32. hard != 0
// takes the blur-0 specialization and needs blur == 0.
extern "C" int dbw_select(const float* faces, int B, int F, int H, int W,
                          int K, float blur, float inflate, float z_clip,
                          int persp, int clip_bary, int hard, int32_t* out,
                          cudaStream_t stream) {
  if (K < 1 || K > 32 || (hard && blur != 0.0f))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return -1;  // nothing to launch
#define DBW_SEL(KS)                                                        \
  if (K <= KS)                                                             \
    return (int)launch<KS>(faces, B, F, H, W, K, blur, inflate, z_clip,    \
                           persp, clip_bary, hard, out, stream);
  DBW_SEL(1)
  DBW_SEL(2)
  DBW_SEL(4)
  DBW_SEL(8)
  DBW_SEL(10)
  DBW_SEL(16)
  DBW_SEL(32)
#undef DBW_SEL
  return (int)cudaErrorInvalidValue;
}
