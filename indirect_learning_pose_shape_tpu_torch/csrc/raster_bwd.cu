// Culled soft-raster class scores, vertex gradient, for Hopper (sm_90a).
//
// Replaces: indirect_learning_pose_shape_tpu/ops/kernels/raster_pallas.py
// `_bwd_kernel` (launched by `_scores4_bwd`). Same math, the VJP of
// csrc/raster_fwd.cu:
//
//   dv[b, :, n] = (1 / sigma^2) * sum over pixels p of
//                 g[b, class(n), p] * exp(-|p - v_n|^2 / (2 sigma^2)) * (p - v_n)
//
// summed over the pixels of the forward kernel's 32x8 tiles that the slot's
// 128-slot block reaches (its bounding box over real slots grown by
// `cutoff`, 6 sigma), clipped to the canvas: the tiles the forward summed
// this block into, by the same test (raster_common.cuh), so this is the
// gradient of the culled forward. Padding slots, and the slots of a block
// that reaches no tile, get exactly 0.
//
// What bounds it on this card: the arithmetic, two FMAs per (pixel, slot)
// pair once the Gaussian is split into its 1-D factors Fy(dy) * Fx(dx); its
// bytes are one read of g inside the boxes and one write of dv. Design:
// - one block per (128-slot block, batch item), one thread per slot: each
//   thread owns its slot's gradient, accumulates it in two registers and
//   writes it once. No atomics and no cross-block reduction, and a fixed
//   order of summation, so the result is bitwise repeatable, as the
//   reference's was (the TPU grid wrote each dv block exactly once too);
// - the block walks the rectangle of tiles, a tile column at a time; per
//   column each thread holds its slot's Fx[32] and Fx*dx[32] in registers
//   (32 expf per slot and column), per row it takes one expf for Fy;
// - each 32x8 tile of g is staged in shared memory with coalesced loads,
//   double-buffered (the next tile's loads are in flight while the current
//   one is summed, one barrier per tile), and read back as 16-byte
//   broadcasts;
// - per row: t1 = sum_x g*Fx*dx, t2 = sum_x g*Fx, then ax += Fy*t1 and
//   ay += Fy*dy*t2. The small quantities dx = p - v and dy stay inside the
//   sums, never sum(g*e*p) - v*sum(g*e): no cancellation (the reference's
//   form), and no float32 chain is longer than a tile row;
// - expf (not __expf), as in the forward, so the result stays within the
//   stated tolerance of the plain twin;
// - ragged S (a class's last block partly filled) and any H, W are masked
//   here, and g is staged per tile, so the width is not limited.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using ilps_raster::kKV;
using ilps_raster::kTH;
using ilps_raster::kTW;
constexpr int kTile = kTW * kTH;  // floats of g per staged tile

__global__ void __launch_bounds__(kKV)
raster_bwd_kernel(const float* __restrict__ verts,  // [B, 2, C*S]
                  const int* __restrict__ real,     // [C] real slots per class
                  const float* __restrict__ bbox,   // [B, C*nb, 4] minx maxx miny maxy
                  const float* __restrict__ g,      // [B, C, H, W]
                  float* __restrict__ dv,           // [B, 2, C*S]
                  int C, int S, int H, int W, float inv2s2, float inv_s2, float cutoff) {
  __shared__ __align__(16) float s_g[2][kTile];

  const int nb = (S + kKV - 1) / kKV;
  const int kv = blockIdx.x;  // block id over (class, slot block)
  const int b = blockIdx.y;
  const int c = kv / nb;
  const int j = kv % nb;
  const int tid = threadIdx.x;
  const int N = C * S;
  const int n = c * S + j * kKV + tid;  // this thread's slot
  const bool in_seg = j * kKV + tid < S;
  const int nreal = ilps_raster::block_real(real, c, j, S);
  const bool is_real = tid < nreal;

  const float* box = bbox + ((size_t)b * C * nb + kv) * 4;
  // The forward's tiles this block is summed into form a rectangle of tiles
  // (the x and y tests are separate); find it with the forward's own test.
  int tx0 = W, tx1 = -1, ty0 = H, ty1 = -1;
  for (int t = 0; t * kTW < W; ++t) {
    if (ilps_raster::x_hits(box, t * kTW, cutoff)) {
      tx0 = min(tx0, t);
      tx1 = t;
    }
  }
  for (int t = 0; t * kTH < H; ++t) {
    if (ilps_raster::y_hits(box, t * kTH, cutoff)) {
      ty0 = min(ty0, t);
      ty1 = t;
    }
  }

  float* dvx = dv + (size_t)b * 2 * N;
  float* dvy = dvx + N;
  if (nreal == 0 || tx0 > tx1 || ty0 > ty1) {  // reaches no tile, uniform across the block
    if (in_seg) {
      dvx[n] = 0.f;
      dvy[n] = 0.f;
    }
    return;
  }

  const float* vxs = verts + (size_t)b * 2 * N;
  const float vx = is_real ? vxs[n] : 0.f;
  const float vy = is_real ? vxs[N + n] : 0.f;
  const float* gc = g + ((size_t)b * C + c) * H * W;

  // Tile i of the rectangle, tile columns outermost: this thread stages
  // elements tid and tid + 128 of it (rows tid/32 and tid/32 + 4).
  const int nty = ty1 - ty0 + 1;
  const int tiles = (tx1 - tx0 + 1) * nty;
  const int sx = tid % kTW, sy = tid / kTW;
  auto fetch = [&](int i, float& lo, float& hi) {
    const int px = (tx0 + i / nty) * kTW + sx;
    const int py = (ty0 + i % nty) * kTH + sy;
    lo = (px < W && py < H) ? gc[(size_t)py * W + px] : 0.f;
    hi = (px < W && py + 4 < H) ? gc[(size_t)(py + 4) * W + px] : 0.f;
  };
  float lo, hi;
  fetch(0, lo, hi);
  s_g[0][tid] = lo;
  s_g[0][tid + kKV] = hi;
  __syncthreads();

  float fx[kTW], fxdx[kTW];
  float ax = 0.f, ay = 0.f;
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) fetch(i + 1, lo, hi);  // in flight while tile i is summed
    if (is_real) {
      const int ox = (tx0 + i / nty) * kTW;
      const int oy = (ty0 + i % nty) * kTH;
      if (i % nty == 0) {  // a new tile column
#pragma unroll
        for (int x = 0; x < kTW; ++x) {
          const float dx = static_cast<float>(ox + x) - vx;
          fx[x] = expf(-(dx * dx) * inv2s2);
          fxdx[x] = fx[x] * dx;
        }
      }
      const float* gt = s_g[i & 1];
#pragma unroll
      for (int r = 0; r < kTH; ++r) {
        const float dy = static_cast<float>(oy + r) - vy;
        const float fy = expf(-(dy * dy) * inv2s2);
        float t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int q = 0; q < kTW / 4; ++q) {
          const float4 g4 = *reinterpret_cast<const float4*>(gt + r * kTW + 4 * q);
          t1 = fmaf(g4.x, fxdx[4 * q], t1);
          t2 = fmaf(g4.x, fx[4 * q], t2);
          t1 = fmaf(g4.y, fxdx[4 * q + 1], t1);
          t2 = fmaf(g4.y, fx[4 * q + 1], t2);
          t1 = fmaf(g4.z, fxdx[4 * q + 2], t1);
          t2 = fmaf(g4.z, fx[4 * q + 2], t2);
          t1 = fmaf(g4.w, fxdx[4 * q + 3], t1);
          t2 = fmaf(g4.w, fx[4 * q + 3], t2);
        }
        ax = fmaf(fy, t1, ax);
        ay = fmaf(fy * dy, t2, ay);
      }
    }
    if (i + 1 < tiles) {
      s_g[(i + 1) & 1][tid] = lo;
      s_g[(i + 1) & 1][tid + kKV] = hi;
    }
    __syncthreads();
  }
  if (in_seg) {
    dvx[n] = is_real ? ax * inv_s2 : 0.f;
    dvy[n] = is_real ? ay * inv_s2 : 0.f;
  }
}

}  // namespace

extern "C" int ilps_raster_bwd(const float* verts, const int* real, const float* bbox,
                               const float* g, float* dv, int B, int C, int S, int H, int W,
                               float inv2s2, float inv_s2, float cutoff, void* stream) {
  const int nb = (S + kKV - 1) / kKV;
  const dim3 grid(C * nb, B);
  raster_bwd_kernel<<<grid, kKV, 0, static_cast<cudaStream_t>(stream)>>>(
      verts, real, bbox, g, dv, C, S, H, W, inv2s2, inv_s2, cutoff);
  return static_cast<int>(cudaGetLastError());
}
