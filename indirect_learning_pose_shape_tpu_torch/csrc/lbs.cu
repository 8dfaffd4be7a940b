// Fused SMPL blendshapes + linear blend skinning, forward, for Hopper (sm_90a).
//
// Replaces: indirect_learning_pose_shape_tpu/ops/kernels/lbs_pallas.py `_kernel`
// (launched by `_fwd_planar`). Same math and the same planar layouts:
//
//   v_posed[c] = v_template_p[c] + sum_k betas[k]*shapedirs_p[c*kbp+k]
//                                 + sum_k pf[k]*posedirs_p[c*kpp+k]
//   T[r]       = sum_j rel[j][r] * weights_p[j]              (r < 12)
//   verts[i]   = sum_c T[3i+c]*v_posed[c] + T[9+i]
//
// with verts, v_posed and T written planar ([B, 3|12, Vp]) as the residuals
// of the backward.
//
// What bounds it on this card: memory. The pose-corrective basis posedirs_p
// is 624 x 6912 float32 = 17.3 MB and every batch item reads all of it; the
// arithmetic is ~1 FMA per byte read. Design:
// - one thread per (batch item, vertex); the planar rows are vertex-minor, so
//   the 32 threads of a warp read 128 contiguous bytes of every row;
// - a block stages its batch item's betas, pose features and 24x12 rigid
//   transforms in shared memory (2 KB), read as broadcasts;
// - the batch item is blockIdx.x, the fastest-varying block index, so the
//   blocks of one vertex tile for all batch items are scheduled together and
//   the tile's 2.6 KB of each basis row is served from L2 after the first
//   read: HBM traffic for the bases is ~1x, not Bx;
// - the [12, J] x [J, VT] skinning product runs as 288 FMAs per thread in
//   full float32 (no tensor cores, no TF32), like the reference's HIGHEST.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lbs_forward_kernel(const float* __restrict__ betas,     // [B, Kb]
                   const float* __restrict__ pf,        // [B, Kp]
                   const float* __restrict__ rel,       // [B, J, 12]
                   const float* __restrict__ vt_p,      // [3, Vp]
                   const float* __restrict__ sd_p,      // [3*kbp, Vp]
                   const float* __restrict__ pd_p,      // [3*kpp, Vp]
                   const float* __restrict__ w_p,       // [J, Vp]
                   float* __restrict__ verts,           // [B, 3, Vp]
                   float* __restrict__ vposed,          // [B, 3, Vp]
                   float* __restrict__ T,               // [B, 12, Vp]
                   int Vp, int Kb, int kbp, int Kp, int kpp, int J) {
  extern __shared__ float smem[];
  float* s_beta = smem;           // Kb
  float* s_pf = s_beta + Kb;      // Kp
  float* s_rel = s_pf + Kp;       // J*12

  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < Kb; i += blockDim.x) s_beta[i] = betas[b * Kb + i];
  for (int i = threadIdx.x; i < Kp; i += blockDim.x) s_pf[i] = pf[b * Kp + i];
  for (int i = threadIdx.x; i < J * 12; i += blockDim.x) s_rel[i] = rel[b * J * 12 + i];
  __syncthreads();

  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= Vp) return;

  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = vt_p[c * Vp + v];
    const float* sd = sd_p + (size_t)(c * kbp) * Vp + v;
    for (int k = 0; k < Kb; ++k) acc = fmaf(s_beta[k], sd[(size_t)k * Vp], acc);
    const float* pd = pd_p + (size_t)(c * kpp) * Vp + v;
#pragma unroll 8
    for (int k = 0; k < Kp; ++k) acc = fmaf(s_pf[k], pd[(size_t)k * Vp], acc);
    p[c] = acc;
  }

  float t[12];
#pragma unroll
  for (int r = 0; r < 12; ++r) t[r] = 0.f;
  for (int j = 0; j < J; ++j) {
    const float w = w_p[(size_t)j * Vp + v];
#pragma unroll
    for (int r = 0; r < 12; ++r) t[r] = fmaf(s_rel[j * 12 + r], w, t[r]);
  }

  const size_t o3 = (size_t)b * 3 * Vp + v;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    verts[o3 + (size_t)i * Vp] = t[3 * i] * p[0] + t[3 * i + 1] * p[1] + t[3 * i + 2] * p[2] + t[9 + i];
    vposed[o3 + (size_t)i * Vp] = p[i];
  }
  const size_t o12 = (size_t)b * 12 * Vp + v;
#pragma unroll
  for (int r = 0; r < 12; ++r) T[o12 + (size_t)r * Vp] = t[r];
}

}  // namespace

extern "C" int ilps_lbs_forward(const float* betas, const float* pf, const float* rel,
                                const float* vt_p, const float* sd_p, const float* pd_p,
                                const float* w_p, float* verts, float* vposed, float* T,
                                int B, int Vp, int Kb, int kbp, int Kp, int kpp, int J,
                                void* stream) {
  const dim3 grid(B, (Vp + kThreads - 1) / kThreads);
  const size_t smem = sizeof(float) * (size_t)(Kb + Kp + J * 12);
  lbs_forward_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      betas, pf, rel, vt_p, sd_p, pd_p, w_p, verts, vposed, T, Vp, Kb, kbp, Kp, kpp, J);
  return static_cast<int>(cudaGetLastError());
}
