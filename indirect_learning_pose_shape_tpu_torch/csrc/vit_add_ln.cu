// Residual add, drop-path scale, LayerNorm and bf16 cast of the ViT blocks
// (models/vit.py `_block`), forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no ViT. Added because the
// eager chain at each of a block's two LayerNorm sites (a bf16 branch widened
// to float32, scaled by the sample's drop-path factor, added to the float32
// residual stream, normalised in float32, cast to bf16) is five kernels
// forward and about as many backward, each a full pass over the
// [B·N, D] stream; here it is one pass each way.
//
// Per row r of the residual stream (R = B·N tokens, sample b = r / N):
//   forward   x' = x + float(y)·s_b     (y bf16; no s: x + float(y); no y: x' = x)
//             h  = bf16(LN(x'; γ, β, eps)),  and the row's mean and rstd
//   backward  g  = dres + LNᵀ(dh)        (dres: x'’s gradient from its next
//                                          residual use; none without y)
//             dx = g,  dy = bf16(g·s_b)
//             dγ = Σ_r dh·x̂,  dβ = Σ_r dh
// x' is bitwise the eager `x + y.float() * s`: the product is rounded before
// the add (__fmul_rn, __fadd_rn), so nvcc's FMA contraction cannot change the
// residual stream. Only the LayerNorm's reduction order differs from eager.
//
// What bounds it: bytes. Forward reads x (4 B) and y (2 B) and writes x'
// (4 B) and h (2 B) an element; backward reads x', dh and dres and writes dx
// and dy, 16 B an element. At ViT-H's [48·192, 1280] that is 141.6 MB and
// 188.7 MB: 42 µs and 56 µs at 3.35 TB/s.
// Design:
// - one warp a row; a lane holds 8-element vectors lane, lane + 32, ... of
//   the row in registers (VPT of them, VPT = ceil(D / 256), rows up to 1536
//   wide), loaded with 16-byte loads, so x' is read from device memory once;
// - the statistics are two warp reductions (butterfly shuffles, which leave
//   the same sum in every lane), mean then the centred variance;
// - backward: a block of kBwdWarps warps strides over the rows, a warp a
//   row at a time; each warp adds its rows' dγ/dβ terms into its own slice
//   of shared memory (registers hold the row: 115 at D = 1280, so four
//   blocks fit an SM), the block adds its warps' slices in warp order and
//   writes one row of partials, and a second kernel sums the partials column
//   by column in a fixed order. No atomics: every launch sums in the same
//   order, so the result is bitwise repeatable (and a CUDA graph's replay is
//   its eager call). The wrapper fixes the grid at min(ceil(R / kBwdWarps),
//   528), one wave of four blocks on each of an H100's 132 SMs. Measured at
//   [9216, 1280] (H100, 700 W): 77 µs, against 110–130 µs with the partials
//   in registers (178 registers, one block an SM).
// Nothing is allocated here: one launch forward, two backward, capturable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdWarps = 4;                  // rows of a forward block, one a warp
constexpr int kBwdWarps = 4;                  // warps of a backward block
constexpr int kMaxVpt = 6;                    // 8-element vectors a lane holds at most
// Widest row: 1536, where the backward's kBwdWarps·2·D float32 partials
// fill the 48 KB of shared memory a block has without opting in.
constexpr int kMaxD = 32 * 8 * kMaxVpt;
static_assert(kBwdWarps * 2 * kMaxD * sizeof(float) <= 48 * 1024, "backward partials exceed 48 KB");
constexpr int kReduceRows = 8;                // thread rows of the partials' reduction

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Eight bf16 (one 16-byte word) widened to float32, exactly.
__device__ __forceinline__ void unpack8(const uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);  // round to nearest even, a in the low half
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

template <int VPT>
__global__ void __launch_bounds__(kFwdWarps * 32) vit_add_ln_fwd_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ y, const float* __restrict__ s,
    int s_stride, int tokens, const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ xo, __nv_bfloat16* __restrict__ h, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const size_t off = static_cast<size_t>(row) * D;
  const float scale = s ? s[static_cast<size_t>(row / tokens) * s_stride] : 1.f;
  float v[VPT][8];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (lane + 32 * k) * 8;
    if (c < D) {
      load8(x + off + c, v[k]);
      if (y) {
        float t[8];
        unpack8(*reinterpret_cast<const uint4*>(y + off + c), t);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[k][j] = __fadd_rn(v[k][j], s ? __fmul_rn(t[j], scale) : t[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[k][j];
    }
  }
  const float fd = static_cast<float>(D);
  const float mean = warp_sum(sum) / fd;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if ((lane + 32 * k) * 8 < D) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[k][j] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / fd + eps);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int c = (lane + 32 * k) * 8;
    if (c < D) {
      if (xo) store8(xo + off + c, v[k]);
      float g[8], b[8], o[8];
      load8(gamma + c, g);
      load8(beta + c, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = fmaf((v[k][j] - mean) * rstd, g[j], b[j]);
      store8(h + off + c, o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Dynamic shared memory: acc [kBwdWarps][2][D], each warp's own Σ dh·x̂ and
// Σ dh over its rows, so the partial sums take no registers.
template <int VPT>
__global__ void __launch_bounds__(kBwdWarps * 32) vit_add_ln_bwd_kernel(
    const __nv_bfloat16* __restrict__ dh, const float* __restrict__ dres, const float* __restrict__ xo,
    const float* __restrict__ mean, const float* __restrict__ rstd, const float* __restrict__ gamma,
    const float* __restrict__ s, int s_stride, int tokens, float* __restrict__ dx,
    __nv_bfloat16* __restrict__ dy, float* __restrict__ part, int R, int D) {
  extern __shared__ float acc[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float fd = static_cast<float>(D);
  float* mine = acc + static_cast<size_t>(warp) * 2 * D;
  for (int i = lane; i < 2 * D; i += 32) mine[i] = 0.f;
  __syncwarp();
  for (int row = blockIdx.x * kBwdWarps + warp; row < R; row += gridDim.x * kBwdWarps) {
    const size_t off = static_cast<size_t>(row) * D;
    const float mu = mean[row], rs = rstd[row];
    float xh[VPT][8];
    uint4 dhp[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = (lane + 32 * k) * 8;
      if (c < D) {
        float xv[8], g[8], ga[8], pg[8], pb[8];
        load8(xo + off + c, xv);
        dhp[k] = *reinterpret_cast<const uint4*>(dh + off + c);
        unpack8(dhp[k], g);
        load8(gamma + c, ga);
        load8(mine + c, pg);
        load8(mine + D + c, pb);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xh[k][j] = (xv[j] - mu) * rs;
          const float a = g[j] * ga[j];
          s1 += a;
          s2 = fmaf(a, xh[k][j], s2);
          pg[j] = fmaf(g[j], xh[k][j], pg[j]);
          pb[j] += g[j];
        }
        store8(mine + c, pg);
        store8(mine + D + c, pb);
      }
    }
    const float c1 = warp_sum(s1) / fd;
    const float c2 = warp_sum(s2) / fd;
    const float scale = s ? s[static_cast<size_t>(row / tokens) * s_stride] : 1.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = (lane + 32 * k) * 8;
      if (c < D) {
        float g[8], ga[8], r[8], o[8];
        unpack8(dhp[k], g);
        load8(gamma + c, ga);
        if (dres) {
          load8(dres + off + c, r);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) r[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = r[j] + rs * (g[j] * ga[j] - c1 - xh[k][j] * c2);
        store8(dx + off + c, o);
        if (dy) {
          if (s) {
#pragma unroll
            for (int j = 0; j < 8; ++j) o[j] = __fmul_rn(o[j], scale);
          }
          store8(dy + off + c, o);
        }
      }
    }
  }
  // The block's partials: the warps' sums added in warp order.
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * D;
  for (int i = threadIdx.x; i < 2 * D; i += blockDim.x) {
    float t = acc[i];
    for (int w = 1; w < kBwdWarps; ++w) t += acc[static_cast<size_t>(w) * 2 * D + i];
    out[i] = t;
  }
}

// part [G, 2, D] -> dgamma [D] = Σ_g part[g, 0], dbeta [D] = Σ_g part[g, 1]:
// a block of 32 x kReduceRows threads owns 32 of the 2·D columns; thread
// row t sums the partial rows t, t + kReduceRows, ... and row 0 adds the
// kReduceRows sums in order.
__global__ void __launch_bounds__(32 * kReduceRows) vit_add_ln_bwd_reduce_kernel(
    const float* __restrict__ part, int G, int D, float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float acc[kReduceRows][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int n = 2 * D;
  float v = 0.f;
  if (col < n) {
    for (int g = threadIdx.y; g < G; g += kReduceRows) v += part[static_cast<size_t>(g) * n + col];
  }
  acc[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
    float t = acc[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kReduceRows; ++i) t += acc[i][threadIdx.x];
    if (col < D) {
      dgamma[col] = t;
    } else {
      dbeta[col - D] = t;
    }
  }
}

}  // namespace

#define ILPS_VPT_SWITCH(VPT_VALUE, LAUNCH) \
  switch (VPT_VALUE) {                    \
    case 1: LAUNCH(1); break;             \
    case 2: LAUNCH(2); break;             \
    case 3: LAUNCH(3); break;             \
    case 4: LAUNCH(4); break;             \
    case 5: LAUNCH(5); break;             \
    case 6: LAUNCH(6); break;             \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// x, xo [R, D] float32; y, h [R, D] bf16; s: a float32 scale a sample at
// stride s_stride, `tokens` rows a sample; gamma, beta [D]; mean, rstd [R].
// y, s and xo may be null (no add; no scale; x' not written).
extern "C" int ilps_vit_add_ln_fwd(const float* x, const void* y, const float* s, int s_stride, int tokens,
                                   const float* gamma, const float* beta, float* xo, void* h, float* mean,
                                   float* rstd, int R, int D, float eps, void* stream) {
  if (R <= 0) return 0;
  if (D <= 0 || D % 8 || D > kMaxD || tokens <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + kFwdWarps - 1) / kFwdWarps);
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ILPS_FWD(V) \
  vit_add_ln_fwd_kernel<V><<<grid, kFwdWarps * 32, 0, st>>>(x, yb, s, s_stride, tokens, gamma, beta, xo, hb, \
                                                             mean, rstd, R, D, eps)
  ILPS_VPT_SWITCH((D + 255) / 256, ILPS_FWD)
#undef ILPS_FWD
  return static_cast<int>(cudaGetLastError());
}

// dh [R, D] bf16; dres [R, D] float32 or null; xo, mean, rstd, gamma, s as
// the forward's; dx [R, D] float32; dy [R, D] bf16 or null; part [blocks, 2,
// D] float32 scratch; dgamma, dbeta [D]. Two launches on `stream`.
extern "C" int ilps_vit_add_ln_bwd(const void* dh, const float* dres, const float* xo, const float* mean,
                                   const float* rstd, const float* gamma, const float* s, int s_stride, int tokens,
                                   float* dx, void* dy, float* part, float* dgamma, float* dbeta, int blocks, int R,
                                   int D, void* stream) {
  if (D <= 0 || D % 8 || D > kMaxD || tokens <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* dhb = static_cast<const __nv_bfloat16*>(dh);
  auto* dyb = static_cast<__nv_bfloat16*>(dy);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(kBwdWarps) * 2 * D * sizeof(float);
#define ILPS_BWD(V)                                                                                            \
  vit_add_ln_bwd_kernel<V><<<blocks, kBwdWarps * 32, smem, st>>>(dhb, dres, xo, mean, rstd, gamma, s, s_stride, \
                                                                 tokens, dx, dyb, part, R, D)
  ILPS_VPT_SWITCH((D + 255) / 256, ILPS_BWD)
#undef ILPS_BWD
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  vit_add_ln_bwd_reduce_kernel<<<(2 * D + 31) / 32, dim3(32, kReduceRows), 0, st>>>(part, blocks, D, dgamma, dbeta);
  return static_cast<int>(cudaGetLastError());
}
