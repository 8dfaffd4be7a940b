// Culled soft-raster class scores, forward, for Hopper (sm_90a).
//
// Replaces: indirect_learning_pose_shape_tpu/ops/kernels/raster_pallas.py
// `_fwd_kernel` (launched by `_scores4_impl`). Same math:
//
//   out[b, c, y, x] = sum over slots v of class c of
//                     exp(-((x - vx)^2 + (y - vy)^2) / (2 sigma^2))
//
// over class-sorted vertex slots (class c owns slots [c*S, (c+1)*S)), padding
// slots at a 1e6 sentinel. A 128-slot block whose bounding box (computed
// outside, one per block) lies farther than `cutoff` from the pixel tile is
// skipped whole, the same 6-sigma test as the reference (raster_common.cuh,
// shared with the backward kernel).
//
// What bounds it on this card: the exponentials. Every surviving
// (pixel, slot) pair costs one expf and ~6 FLOPs; memory traffic is only the
// score write (B*C*H*W floats) and the slot coordinates. Design:
// - one thread per pixel, a 32x8 pixel tile per block: a warp is one row of
//   32 pixels, so the score stores are 128-byte coalesced;
// - the grid is (x tiles, y tiles, batch); each block loops over classes and
//   over each class's 128-slot blocks in order, so nothing is carried between
//   blocks (the reference's sequential TPU grid accumulated in VMEM; here the
//   accumulator is a register);
// - the bounding-box test is uniform across the block, so a culled slot block
//   costs one compare and no shared-memory traffic; a surviving block is
//   staged once in shared memory (1 KB) and read as broadcasts by all 256
//   threads;
// - expf (not __expf) keeps each term within a few ulp of the plain twin, so
//   the stated 1e-4 tolerance holds; the sentinel and far-off-canvas slots
//   give exactly 0 (their blocks are culled, and expf underflows if not);
// - ragged edges of H, W and S are masked here, so any shape is accepted.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using ilps_raster::kKV;
using ilps_raster::kTH;
using ilps_raster::kTW;

__global__ void __launch_bounds__(kTW * kTH)
raster_fwd_kernel(const float* __restrict__ verts,  // [B, 2, C*S]
                  const float* __restrict__ bbox,   // [B, C*nb, 4] minx maxx miny maxy
                  float* __restrict__ out,          // [B, C, H, W]
                  int C, int S, int H, int W, float inv2s2, float cutoff) {
  __shared__ float s_x[kKV];
  __shared__ float s_y[kKV];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const int tid = threadIdx.y * kTW + threadIdx.x;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);

  const int nb = (S + kKV - 1) / kKV;
  const int N = C * S;
  const float* vxs = verts + (size_t)b * 2 * N;
  const float* vys = vxs + N;
  const float* bb = bbox + (size_t)b * C * nb * 4;
  const bool inside = x < W && y < H;

  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    for (int j = 0; j < nb; ++j) {
      const float* box = bb + (size_t)(c * nb + j) * 4;
      // A slot block overlaps iff its box grown by the cutoff meets the tile.
      if (!(ilps_raster::x_hits(box, x0, cutoff) && ilps_raster::y_hits(box, y0, cutoff))) {
        continue;  // uniform across the block
      }
      const int base = c * S + j * kKV;
      const int n = min(kKV, S - j * kKV);
      __syncthreads();  // previous block's slots fully consumed
      if (tid < n) {
        s_x[tid] = vxs[base + tid];
        s_y[tid] = vys[base + tid];
      }
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const float dx = px - s_x[k];
        const float dy = py - s_y[k];
        acc += expf(-(dx * dx + dy * dy) * inv2s2);
      }
    }
    if (inside) out[(((size_t)b * C + c) * H + y) * W + x] = acc;
  }
}

}  // namespace

extern "C" int ilps_raster_fwd(const float* verts, const float* bbox, float* out, int B,
                               int C, int S, int H, int W, float inv2s2, float cutoff,
                               void* stream) {
  const dim3 block(kTW, kTH);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  raster_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      verts, bbox, out, C, S, H, W, inv2s2, cutoff);
  return static_cast<int>(cudaGetLastError());
}
