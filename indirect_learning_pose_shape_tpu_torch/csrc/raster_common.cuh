// Shared by raster_fwd.cu and raster_bwd.cu: the pixel tile, the slot block
// and the culling test. The forward sums a 128-slot block into a 32x8 pixel
// tile only when the block's bounding box over its real slots, grown by the
// cutoff, meets the tile; the backward visits exactly the tiles that pass the
// same test, evaluated by the same code, so it is the gradient of the culled
// forward (as the reference's Pallas pair was, with its own tiles).

#pragma once

namespace ilps_raster {

constexpr int kTW = 32;   // pixel tile width (one warp row in the forward)
constexpr int kTH = 8;    // pixel tile height
constexpr int kKV = 128;  // slots per culling block (raster_cuda.KV)

// box = (minx, maxx, miny, maxy) of one slot block; x0, y0 = tile origin.
__device__ __forceinline__ bool x_hits(const float* box, int x0, float cutoff) {
  return box[0] <= x0 + (kTW - 1) + cutoff && box[1] >= x0 - cutoff;
}

__device__ __forceinline__ bool y_hits(const float* box, int y0, float cutoff) {
  return box[2] <= y0 + (kTH - 1) + cutoff && box[3] >= y0 - cutoff;
}

// Real slots of block j of class c: a class's real slots come first in its
// segment of S slots, `real[c]` of them; the rest is padding, never read.
__device__ __forceinline__ int block_real(const int* real, int c, int j, int S) {
  return max(0, min(min(real[c], S) - j * kKV, kKV));
}

}  // namespace ilps_raster
