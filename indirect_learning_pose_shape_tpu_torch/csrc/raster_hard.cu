// Hard (z-buffered) part-label raster, dense mode, for Hopper (sm_90a).
//
// Replaces the eager dense z-buffer of ops/raster_hard.py `hard_raster`
// (k_faces=None) on the card. The reference has no Pallas kernel for it: its
// `hard_raster` is a lax.scan over face chunks. The face coefficients come
// from the same torch prologue (`_face_coeffs`): per (image, face) 13
// float32s, edge functions w_i = a_i x + b_i y + c_i (inside: every w_i >= 0),
// the depth plane z = az x + bz y + cz (larger is nearer) and a flat shade,
// plus `ok` (false for a degenerate face, which is never inside).
//
// Result, bitwise the eager dense path's:
//   zbuf  = max(-3e38, z of every face inside at the pixel)
//   label = max(class + 1) over the inside faces whose z equals zbuf,
//   shade = max(0, shade) over the same faces; label and shade 0 and
//   silhouette 0 unless zbuf > -1.5e38 (the eager `covered`).
// Each plane is evaluated as the eager path does, (a·px) + (b·py) + c with
// three separately rounded operations (no FMA contraction), and
// min(w0, w1, w2) >= 0 is tested as w0 >= 0 && w1 >= 0 && w2 >= 0, which
// also rejects NaN as torch.minimum does. The eager two passes (max-reduce
// the depth, then the largest class among the faces at that depth) become
// one pass over the faces with order-free updates: a strictly nearer face
// resets the label and shade, an equally near one raises them; a NaN depth
// sticks, as torch's NaN-propagating max does, and leaves the pixel
// uncovered. The face order therefore does not matter.
//
// What bounds it: the outputs, 16 bytes a pixel (134 MB at B=32, 256^2:
// 0.04 ms at 3.35 TB/s) and the coefficients, 52 bytes a face (23 MB).
// Design:
// - a 256-thread block owns one image's 32x32 pixel tile; a thread owns
//   one column and four rows of it; a warp owns a 16x8 patch;
// - the block streams the image's faces in rounds of 256, one a thread,
//   and keeps a face only if it may be inside somewhere in the tile
//   (`may_cover`). The test is on the edge functions themselves, not on
//   the vertices' box: it bounds the float32 evaluation's rounding, so it
//   never drops a face that the per-pixel evaluation finds inside, even a
//   sliver whose rounded edge functions reach past its box. Kept faces are
//   compacted (warp ballots) into shared memory;
// - each warp tests the kept faces against its patch, 32 at a time (one a
//   lane), and evaluates only the ones that pass, at its 4 x 32 pixels;
// - the next round's coefficients are loaded while this round is
//   evaluated; each pixel's state stays in registers and is written once.
// Nothing is allocated here, nothing is read back: one launch, capturable
// in a CUDA graph. Ragged edges (W or the band's H not a multiple of 32)
// are masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;            // tile side, pixels
constexpr int kThreads = 256;        // per block: 8 warps
constexpr int kRows = 4;             // rows a thread owns
constexpr int kPatchW = 16;          // a warp's patch: 16 columns ...
constexpr int kPatchH = 2 * kRows;   // ... by 8 rows (two lanes a column)
constexpr int kWarps = kThreads / 32;
constexpr int kCoeffs = 13;
constexpr float kNeg = -3.0e38f;     // empty-pixel depth (ops/raster_hard._NEG)
constexpr float kCovered = -1.5e38f; // covered iff zbuf > _NEG / 2
// A face is dropped from a pixel rectangle only if an edge function's
// maximum there, evaluated in float32, is below -(kRel·M + kAbs), where
// M = |a|·x1 + |b|·y1 + |c| bounds every term. Three roundings of the
// per-pixel evaluation and three of the test's each stray by at most
// 2^-24·M (unit roundoff u): 6u·M together, well inside kRel = 16u; kAbs
// covers underflow.
constexpr float kRel = 1.0f / (1 << 20);
constexpr float kAbs = 1e-30f;

static_assert(kTile % kPatchW == 0 && kTile % kPatchH == 0, "patches tile the tile");
static_assert((kTile / kPatchW) * (kTile / kPatchH) == kWarps, "one patch a warp");

// May the evaluated w = (a·px) + (b·py) + c be >= 0 at some pixel of
// [x0, x1] x [y0, y1] (non-negative coordinates)? NaN or infinite
// coefficients always may.
__device__ __forceinline__ bool edge_may_pass(float a, float b, float c, float x0, float x1, float y0,
                                              float y1) {
  const float hi = __fadd_rn(__fadd_rn(__fmul_rn(a, a >= 0.f ? x1 : x0), __fmul_rn(b, b >= 0.f ? y1 : y0)), c);
  const float m = fabsf(a) * x1 + fabsf(b) * y1 + fabsf(c);
  return !(hi < -(kRel * m + kAbs));
}

__device__ __forceinline__ bool may_cover(const float4& e0, const float4& e1, const float4& e2, float x0,
                                          float x1, float y0, float y1) {
  // e0 = (a0, b0, c0, a1), e1 = (b1, c1, a2, b2), e2 = (c2, az, bz, cz)
  return edge_may_pass(e0.x, e0.y, e0.z, x0, x1, y0, y1) && edge_may_pass(e0.w, e1.x, e1.y, x0, x1, y0, y1) &&
         edge_may_pass(e1.z, e1.w, e2.x, x0, x1, y0, y1);
}

// torch.maximum: NaN propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float plane(float ax, float b, float py, float c) {
  return __fadd_rn(__fadd_rn(ax, __fmul_rn(b, py)), c);
}

__global__ void __launch_bounds__(kThreads)
raster_hard_kernel(const float* __restrict__ coeffs,     // [B, F, 13]
                   const uint8_t* __restrict__ ok,       // [B, F]
                   const int* __restrict__ face_class,   // [F]
                   int* __restrict__ labels,             // [B, H, W]
                   float* __restrict__ silhouette,       // [B, H, W]
                   float* __restrict__ zbuf,             // [B, H, W]
                   float* __restrict__ shade,            // [B, H, W] or null
                   int F, int H, int W, int row0) {
  // The round's kept faces, one slot each: the three edge functions, the
  // depth plane, then (shade, label bits).
  __shared__ float4 s_e0[kThreads], s_e1[kThreads], s_e2[kThreads], s_sl[kThreads];
  __shared__ int s_kept[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const int tx = blockIdx.x * kTile;  // tile origin: column, band row
  const int ty = blockIdx.y * kTile;
  const int wx = tx + (warp % (kTile / kPatchW)) * kPatchW;  // patch origin
  const int wy = ty + (warp / (kTile / kPatchW)) * kPatchH;
  const int x = wx + (lane % kPatchW);
  const int y = wy + (lane / kPatchW) * kRows;  // band row of this thread's first row
  const float px = static_cast<float>(x);

  // Pixel rectangles of the tile and the patch, clipped to the canvas, in
  // canvas coordinates.
  const float bx0 = tx, bx1 = min(tx + kTile, W) - 1;
  const float by0 = row0 + ty, by1 = row0 + min(ty + kTile, H) - 1;
  const bool patch_live = wx < W && wy < H;
  const float qx0 = wx, qx1 = min(wx + kPatchW, W) - 1;
  const float qy0 = row0 + wy, qy1 = row0 + min(wy + kPatchH, H) - 1;

  float zmax[kRows], shd[kRows];
  int lab[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    zmax[r] = kNeg;
    shd[r] = 0.f;
    lab[r] = 0;
  }

  const float* cb = coeffs + (size_t)b * F * kCoeffs;
  const uint8_t* okb = ok + (size_t)b * F;
  const bool with_shade = shade != nullptr;

  // This thread's face of the current round, loaded a round ahead.
  float c[kCoeffs] = {};
  int cls = 0;
  bool live = false;
  auto load = [&](int f) {
    live = f < F && okb[f] != 0;
    if (live) {
#pragma unroll
      for (int i = 0; i < kCoeffs; ++i) c[i] = __ldg(cb + (size_t)f * kCoeffs + i);
      cls = __ldg(face_class + f);
    }
  };
  load(threadIdx.x);

  for (int base = 0; base < F; base += kThreads) {
    const float4 e0 = make_float4(c[0], c[1], c[2], c[3]);
    const float4 e1 = make_float4(c[4], c[5], c[6], c[7]);
    const float4 e2 = make_float4(c[8], c[9], c[10], c[11]);
    const bool keep = live && may_cover(e0, e1, e2, bx0, bx1, by0, by1);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_kept[warp] = __popc(ballot);
    __syncthreads();
    int n = 0, slot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int k = s_kept[w];
      slot += w < warp ? k : 0;
      n += k;
    }
    if (keep) {
      slot += __popc(ballot & ((1u << lane) - 1u));
      s_e0[slot] = e0;
      s_e1[slot] = e1;
      s_e2[slot] = e2;
      s_sl[slot] = make_float4(with_shade ? c[12] : 0.f, __int_as_float(cls + 1), 0.f, 0.f);
    }
    load(base + kThreads + threadIdx.x);  // in flight while this round is evaluated
    __syncthreads();

    if (patch_live) {
      for (int g = 0; g < n; g += 32) {
        const int k = g + lane;
        const bool hit = k < n && may_cover(s_e0[k], s_e1[k], s_e2[k], qx0, qx1, qy0, qy1);
        unsigned todo = __ballot_sync(0xffffffffu, hit);
        while (todo) {
          const int j = g + __ffs(todo) - 1;
          todo &= todo - 1;
          const float4 f0 = s_e0[j], f1 = s_e1[j], f2 = s_e2[j], f3 = s_sl[j];
          const float ax0 = __fmul_rn(f0.x, px), ax1 = __fmul_rn(f0.w, px);
          const float ax2 = __fmul_rn(f1.z, px), axz = __fmul_rn(f2.y, px);
          const int L = __float_as_int(f3.y);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float py = static_cast<float>(row0 + y + r);
            const float w0 = plane(ax0, f0.y, py, f0.z);
            const float w1 = plane(ax1, f1.x, py, f1.y);
            const float w2 = plane(ax2, f1.w, py, f2.x);
            if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
              const float z = plane(axz, f2.z, py, f2.w);
              if (z > zmax[r] || z != z) {
                zmax[r] = z;
                lab[r] = L;
                shd[r] = max_nan(0.f, f3.x);
              } else if (z == zmax[r]) {
                lab[r] = max(lab[r], L);
                shd[r] = max_nan(shd[r], f3.x);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the slots and counts are rewritten next round
  }

  if (x >= W) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (y + r >= H) break;
    const size_t i = ((size_t)b * H + y + r) * W + x;
    const bool covered = zmax[r] > kCovered;
    labels[i] = covered ? lab[r] : 0;
    silhouette[i] = covered ? 1.f : 0.f;
    zbuf[i] = zmax[r];
    if (with_shade) shade[i] = covered ? shd[r] : 0.f;
  }
}

}  // namespace

extern "C" int ilps_raster_hard(const float* coeffs, const uint8_t* ok, const int* face_class, int* labels,
                                float* silhouette, float* zbuf, float* shade, int B, int F, int H, int W,
                                int row0, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  raster_hard_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coeffs, ok, face_class, labels, silhouette, zbuf, shade, F, H, W, row0);
  return static_cast<int>(cudaGetLastError());
}
