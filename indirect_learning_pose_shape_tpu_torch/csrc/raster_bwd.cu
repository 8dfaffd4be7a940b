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
// 128-slot block reaches (its bounding box grown by `cutoff`, 6 sigma),
// clipped to the canvas: the tiles the forward summed this block into, by the
// same test (raster_common.cuh), so this is the gradient of the culled
// forward. A block that reaches no tile (the sentinel padding included)
// writes exactly 0.
//
// What bounds it on this card: the exponentials. Every surviving
// (pixel, slot) pair costs one expf and ~10 FLOPs; memory traffic is one read
// of g's class channel inside the box and one write of dv. Design:
// - one block per (128-slot block, batch item), one thread per slot: each
//   thread owns its slot's gradient, accumulates it in two registers and
//   writes it once. No atomics and no cross-block reduction, so the result is
//   bitwise repeatable, as the reference's was (the TPU grid wrote each dv
//   block exactly once too);
// - the block walks its pixel range a strip of rows at a time: the strip of g
//   for its class is staged in shared memory with coalesced row reads, then
//   every thread reads it back as broadcasts (one address per warp), so g is
//   read from device memory once per block, not once per slot;
// - the sums are taken as sum(g*e*dx) with dx = p - v, O(sigma) inside the
//   box, never as sum(g*e*p) - v*sum(g*e): no cancellation (the reference's
//   form); each row is summed on its own, then the rows, so no float32
//   chain is longer than the box's width or height;
// - expf (not __expf), as in the forward, so the result stays within the
//   stated tolerance of the plain twin;
// - ragged S (a class's last block partly filled) and any H, W are masked
//   here; the reference's (16, 128) TPU tiles do not carry over, the
//   forward's 32x8 tiles take their place.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using ilps_raster::kKV;
using ilps_raster::kTH;
using ilps_raster::kTW;
constexpr int kStage = 2048;  // floats of g staged per strip (8 KB)

__global__ void __launch_bounds__(kKV)
raster_bwd_kernel(const float* __restrict__ verts,  // [B, 2, C*S]
                  const float* __restrict__ bbox,   // [B, C*nb, 4] minx maxx miny maxy
                  const float* __restrict__ g,      // [B, C, H, W]
                  float* __restrict__ dv,           // [B, 2, C*S]
                  int C, int S, int H, int W, float inv2s2, float inv_s2, float cutoff) {
  __shared__ float s_g[kStage];

  const int nb = (S + kKV - 1) / kKV;
  const int kv = blockIdx.x;  // block id over (class, slot block)
  const int b = blockIdx.y;
  const int c = kv / nb;
  const int j = kv % nb;
  const int tid = threadIdx.x;
  const int N = C * S;
  const int n = c * S + j * kKV + tid;  // this thread's slot
  const bool active = j * kKV + tid < S;

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
  if (tx0 > tx1 || ty0 > ty1) {  // reaches no tile, uniform across the block
    if (active) {
      dvx[n] = 0.f;
      dvy[n] = 0.f;
    }
    return;
  }
  const int x0 = tx0 * kTW, x1 = min(W - 1, tx1 * kTW + kTW - 1);
  const int y0 = ty0 * kTH, y1 = min(H - 1, ty1 * kTH + kTH - 1);
  const int wr = x1 - x0 + 1;            // <= W <= kStage (checked by the wrapper)
  const int rows = kStage / wr;          // whole rows per strip, >= 1

  const float* vxs = verts + (size_t)b * 2 * N;
  const float vx = active ? vxs[n] : 0.f;
  const float vy = active ? vxs[N + n] : 0.f;
  const float* gc = g + ((size_t)b * C + c) * H * W;

  float ax = 0.f, ay = 0.f;
  for (int ys = y0; ys <= y1; ys += rows) {
    const int nr = min(rows, y1 - ys + 1);
    __syncthreads();  // the previous strip is fully consumed
    for (int i = tid; i < nr * wr; i += kKV) {
      s_g[i] = gc[(size_t)(ys + i / wr) * W + x0 + i % wr];
    }
    __syncthreads();
    if (active) {
      for (int r = 0; r < nr; ++r) {
        const float dy = (float)(ys + r) - vy;
        const float* row = s_g + r * wr;
        float rx = 0.f, ry = 0.f;  // per-row partial sums: shorter float32 chains
        for (int x = 0; x < wr; ++x) {
          const float dx = (float)(x0 + x) - vx;
          const float ge = row[x] * expf(-(dx * dx + dy * dy) * inv2s2);
          rx += ge * dx;
          ry += ge * dy;
        }
        ax += rx;
        ay += ry;
      }
    }
  }
  if (active) {
    dvx[n] = ax * inv_s2;
    dvy[n] = ay * inv_s2;
  }
}

}  // namespace

extern "C" int ilps_raster_bwd(const float* verts, const float* bbox, const float* g, float* dv,
                               int B, int C, int S, int H, int W, float inv2s2, float inv_s2,
                               float cutoff, void* stream) {
  const int nb = (S + kKV - 1) / kKV;
  const dim3 grid(C * nb, B);
  raster_bwd_kernel<<<grid, kKV, 0, static_cast<cudaStream_t>(stream)>>>(
      verts, bbox, g, dv, C, S, H, W, inv2s2, inv_s2, cutoff);
  return static_cast<int>(cudaGetLastError());
}
