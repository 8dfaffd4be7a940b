// Culled soft-raster class scores, forward, for Hopper (sm_90a).
//
// Replaces: indirect_learning_pose_shape_tpu/ops/kernels/raster_pallas.py
// `_fwd_kernel` (launched by `_scores4_impl`). Same math:
//
//   out[b, c, y, x] = sum over real slots v of class c of
//                     exp(-((x - vx)^2 + (y - vy)^2) / (2 sigma^2))
//
// over class-sorted vertex slots (class c owns slots [c*S, (c+1)*S), its
// real[c] real slots first, padding after). A 128-slot block is summed into
// a 32x8 pixel tile only when its bounding box over real slots (computed
// outside, one per block), grown by `cutoff` (6 sigma), meets the tile: the
// test of raster_common.cuh, shared with the backward kernel. Padding slots
// are never read, so they score exactly 0 whatever their coordinate.
//
// What bounds it on this card: the score write, B*C*H*W floats (201 MB at
// B=32, 24 classes, 256^2: 0.061 ms at 3.35 TB/s), most of it zeros. The
// arithmetic is small once the Gaussian is split into its two 1-D factors,
// exp(-(dx^2 + dy^2)/2s^2) = Fy(dy) * Fx(dx): one FMA per (pixel, slot)
// pair. Design:
// - a 128-thread block owns one class's 64x32 pixel region, eight 32x8
//   culling tiles; each warp owns a row of two tiles (lanes 0-15 the left,
//   16-31 the right), so the culling test stays per tile and uniform over
//   each half-warp. The grid is (batch x class, x regions, y regions): the
//   work of the regions a body covers spreads over many blocks, where one
//   block walking every class in turn was latency-bound (PERF.md);
// - per surviving slot block, in chunks of 64 slots, the factor tables
//   Fx[slot][64 columns] and Fy[slot][32 rows] are built in shared memory
//   (24 KB), 3 expf per (slot, lane) instead of 1 per (slot, pixel). Each
//   warp loads the coordinates of its 16 slots of the chunk and passes them
//   round by shuffles;
// - each lane owns two adjacent columns and 8 rows, 16 accumulators in
//   registers; per slot it loads its two Fx values (one 8-byte load,
//   conflict-free) and its warp's 8 Fy values as two 16-byte broadcasts,
//   then does 16 FMAs, so shared-memory loads stay below the FMA rate;
// - each class's region is written once, 256-byte coalesced rows, zeros
//   where every slot block was culled;
// - float32 FMAs on the CUDA cores, not tensor cores: scores reach ~69, and
//   TF32 or bf16 inputs would break the 1e-4 tolerance; expf (not __expf)
//   keeps each factor within a few ulp, so Fy*Fx is within a few ulp of the
//   twin's exp of the sum;
// - ragged edges of H, W and S are masked here, so any shape is accepted.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using ilps_raster::kKV;
using ilps_raster::kTH;
using ilps_raster::kTW;
constexpr int kWarps = 4;
constexpr int kRows = kWarps * kTH;  // pixel rows of a block's region
constexpr int kCols = 2 * kTW;       // pixel columns: two culling tiles per warp
constexpr int kChunk = 64;           // slots per table build

__global__ void __launch_bounds__(kWarps * 32)
raster_fwd_kernel(const float* __restrict__ verts,  // [B, 2, C*S]
                  const int* __restrict__ real,     // [C] real slots per class
                  const float* __restrict__ bbox,   // [B, C*nb, 4] minx maxx miny maxy
                  float* __restrict__ out,          // [B, C, H, W]
                  int C, int S, int H, int W, float inv2s2, float cutoff) {
  __shared__ __align__(16) float s_fx[kChunk * kCols];  // [slot][column]
  __shared__ __align__(16) float s_fy[kChunk * kRows];  // [slot][row]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const int x0 = blockIdx.y * kCols;
  const int y0 = blockIdx.z * kRows;
  const int ty = y0 + warp * kTH;           // this warp's row of tiles
  const int right = lane >> 4;              // the left (0) or right (1) tile
  const int x = x0 + 2 * lane;              // this lane's columns x, x + 1
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y0 + lane);  // region row `lane`, for Fy

  const int nb = (S + kKV - 1) / kKV;
  const int N = C * S;
  const float* vxs = verts + (size_t)b * 2 * N + c * S;
  const float* vys = vxs + N;
  const float* bb = bbox + ((size_t)b * C + c) * nb * 4;

  float a0[kTH], a1[kTH];  // columns x and x + 1, rows ty .. ty + 7
#pragma unroll
  for (int r = 0; r < kTH; ++r) a0[r] = a1[r] = 0.f;

  for (int j = 0; j < nb; ++j) {
    const float* box = bb + j * 4;
    const int n = ilps_raster::block_real(real, c, j, S);
    if (n == 0) continue;
    // Block-uniform: skip a slot block that meets none of the eight tiles.
    const bool hit_l = ilps_raster::x_hits(box, x0, cutoff);
    const bool hit_r = ilps_raster::x_hits(box, x0 + kTW, cutoff);
    if (!(hit_l || hit_r)) continue;
    bool any = false;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) any |= ilps_raster::y_hits(box, y0 + w * kTH, cutoff);
    if (!any) continue;
    // This lane's tile passes the test (uniform over each half-warp).
    const bool mine = ilps_raster::y_hits(box, ty, cutoff) && (right ? hit_r : hit_l);

    for (int s0 = 0; s0 < n; s0 += kChunk) {
      const int m = min(kChunk, n - s0);
      // Warp w builds the table rows of chunk slots [k0, k0 + nk).
      const int k0 = warp * (kChunk / kWarps);
      const int nk = min(kChunk / kWarps, m - k0);  // warp-uniform, may be <= 0
      const float vx = lane < nk ? vxs[j * kKV + s0 + k0 + lane] : 0.f;
      const float vy = lane < nk ? vys[j * kKV + s0 + k0 + lane] : 0.f;
      __syncthreads();  // the previous chunk's tables are consumed
      for (int i = 0; i < nk; ++i) {
        const float sx = __shfl_sync(0xffffffffu, vx, i);
        const float sy = __shfl_sync(0xffffffffu, vy, i);
        const float d0 = px - sx, d1 = px + 1.f - sx, dy = py - sy;
        *reinterpret_cast<float2*>(s_fx + (k0 + i) * kCols + 2 * lane) =
            make_float2(expf(-(d0 * d0) * inv2s2), expf(-(d1 * d1) * inv2s2));
        s_fy[(k0 + i) * kRows + lane] = expf(-(dy * dy) * inv2s2);
      }
      __syncthreads();
      if (mine) {
        const float* fy = s_fy + warp * kTH;
#pragma unroll 4
        for (int k = 0; k < m; ++k) {
          const float2 f = *reinterpret_cast<const float2*>(s_fx + k * kCols + 2 * lane);
          const float4 g0 = *reinterpret_cast<const float4*>(fy + k * kRows);
          const float4 g1 = *reinterpret_cast<const float4*>(fy + k * kRows + 4);
          a0[0] = fmaf(g0.x, f.x, a0[0]); a1[0] = fmaf(g0.x, f.y, a1[0]);
          a0[1] = fmaf(g0.y, f.x, a0[1]); a1[1] = fmaf(g0.y, f.y, a1[1]);
          a0[2] = fmaf(g0.z, f.x, a0[2]); a1[2] = fmaf(g0.z, f.y, a1[2]);
          a0[3] = fmaf(g0.w, f.x, a0[3]); a1[3] = fmaf(g0.w, f.y, a1[3]);
          a0[4] = fmaf(g1.x, f.x, a0[4]); a1[4] = fmaf(g1.x, f.y, a1[4]);
          a0[5] = fmaf(g1.y, f.x, a0[5]); a1[5] = fmaf(g1.y, f.y, a1[5]);
          a0[6] = fmaf(g1.z, f.x, a0[6]); a1[6] = fmaf(g1.z, f.y, a1[6]);
          a0[7] = fmaf(g1.w, f.x, a0[7]); a1[7] = fmaf(g1.w, f.y, a1[7]);
        }
      }
    }
  }
  float* o = out + (((size_t)b * C + c) * H + ty) * W + x;
#pragma unroll
  for (int r = 0; r < kTH; ++r) {
    if (ty + r >= H) break;
    if (x + 1 < W && (W & 1) == 0) {
      *reinterpret_cast<float2*>(o + (size_t)r * W) = make_float2(a0[r], a1[r]);
    } else {
      if (x < W) o[(size_t)r * W] = a0[r];
      if (x + 1 < W) o[(size_t)r * W + 1] = a1[r];
    }
  }
}

}  // namespace

extern "C" int ilps_raster_fwd(const float* verts, const int* real, const float* bbox, float* out,
                               int B, int C, int S, int H, int W, float inv2s2, float cutoff,
                               void* stream) {
  const dim3 grid(B * C, (W + kCols - 1) / kCols, (H + kRows - 1) / kRows);
  raster_fwd_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      verts, real, bbox, out, C, S, H, W, inv2s2, cutoff);
  return static_cast<int>(cudaGetLastError());
}
