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
// verts is written planar [B, 3, Vp]; with `residuals` set, v_posed [B, 3, Vp]
// and T [B, 12, Vp] too, for the backward. Without it (no autograd: serving,
// the synthetic batch) only verts is written.
//
// The blend is three products [B, K] x [K, Vp] (K = Kb + Kp = 217 rows per
// component for SMPL) over a 19 MB basis (18.7 MB of it over the V = 6890
// real vertices, what the bounds below count); the skinning adds 288 FMAs per
// (item, vertex), ~950 FMAs in all. What bounds it on an H100 (3.35 TB/s,
// 33.5e12 float32 FMA/s), and what the design does about it:
// - B=1: the basis read (bound ~5.7 us). The card needs ~3.3 MB in
//   flight to reach its rate; one thread per (item, vertex) walking ~675
//   dependent loads kept ~0.2 MB. Here 216 blocks (Vp / 32) each keep two
//   12 KB chunks in flight, ~40 KB an SM. What is left is latency: the first
//   chunk (~2 us) and the epilogue (~1.5 us) on top of the stream.
// - B=32: still bytes by the bound (basis + 13.2 MB of residuals, ~10.3 us;
//   ~6.4 us without them), but the blend's FMAs read shared memory at 3.5
//   wavefronts per 12 FMA instructions of a thread row, near the SM's rate
//   of 1 to 4, so those reads, not the bytes, set the time (~2.5x the bound).
// - B=128: bytes and FMAs alike (~25 us each). Re-reading the basis per
//   item from L2 (B x 19 MB) cost 0.26 ms; here each basis float is read
//   from memory once per block and applied to 128 items from registers.
//   The blend's FMAs alone run near the card's rate; its shared reads and
//   the skinning epilogue (an item at a time, two barriers each) add the
//   rest, and 216 blocks on 132 SMs leave 84 SMs two blocks.
// Design:
// - a block owns 32 vertices x a tile of 16*IPT batch items (IPT = 1, 2, 4
//   or 8, chosen by the wrapper from B); the batch tiles of one vertex tile
//   are the fastest block index, so they run together and the basis is read
//   from HBM once and from L2 at most ceil(B / (16*IPT)) times;
// - the basis rows of the tile (3 components x 32 rows a chunk) and the
//   matching coefficients of the block's items (each item's row copied as
//   contiguous floats) stream through a 3-stage ring in shared memory with
//   cp.async; each thread copies the same rows of every chunk, so the
//   copies cost few instructions beside the FMAs;
// - thread (tx, ty) holds a register tile of 2 vertices x IPT items x 3
//   components: per basis row one float2 of basis per component (the two
//   item rows of a warp read the same addresses: one wavefront), and the
//   coefficients of its items as float4s over 4 rows, then 6*IPT float32
//   FMAs per row;
// - the epilogue stages the rigid rows [J, 12] of one item per thread row
//   at a time in the freed ring (double-buffered cp.async), forms the 12
//   skinning rows from them and the weight tile [J, 32] staged at the start,
//   and writes float2 along v, so a warp's stores are 128-byte rows;
// - float32 FMAs on the CUDA cores (no tensor cores, no TF32) in a fixed
//   order per (item, vertex), and no atomics: bitwise repeatable.

#include <cuda_runtime.h>

namespace {

// kVT, kTY and the ipt cases of ilps_lbs_forward are mirrored by
// ops/kernels/lbs_cuda.py (VT, ITEM_ROWS, IPTS), which makes the plan.
constexpr int kThreads = 256;
constexpr int kVT = 32;                // vertices per block
constexpr int kTX = kVT / 2;           // threads along the vertex tile, 2 vertices each
constexpr int kTY = kThreads / kTX;    // item rows of threads, IPT items each
constexpr int kKC = 32;                // basis rows per component in one chunk
constexpr int kCS = kKC + 4;           // an item's coefficient row in a stage (padded, see kGS)
constexpr int kStages = 3;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies global -> shared; with `valid` false the destination
// is filled with zeros and nothing is read.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const float* betas;  // [B, Kb]
  const float* pf;     // [B, Kp]
  const float* rel;    // [B, J, 12]
  const float* vt_p;   // [3, Vp]
  const float* sd_p;   // [3*kbp, Vp]
  const float* pd_p;   // [3*kpp, Vp]
  const float* w_p;    // [J, Vp]
  float* verts;        // [B, 3, Vp]
  float* vposed;       // [B, 3, Vp] or null
  float* T;            // [B, 12, Vp] or null
  int B, Vp, Kb, kbp, Kp, kpp, J, residuals;
};

// One chunk of blend rows [r0, r0 + kKC) into a ring stage:
// basis [3][kKC][kVT] (rows past K zero), then the coefficients of the
// block's items (items past B and rows past K zero), item b0 + ty*IPT + i
// at ty*kGS + i*kCS, so the two thread rows of a warp read other banks.
// Blend row r is betas row r for r < Kb, else pose-feature row r - Kb.
// Each thread's rows are fixed, so its source row is chosen once a chunk.
template <int IPT>
__device__ __forceinline__ void load_chunk(const Args& a, float* stage, int r0, int b0, int v0) {
  static_assert(kKC == 32 && kVT == 32 && kThreads == 256, "the copy mapping below");
  constexpr int BT = kTY * IPT, kGS = IPT * kCS + 4;
  const int K = a.Kb + a.Kp;
  {  // basis: thread t copies 16 bytes (q = t % 8) of row k = t / 8 of each component
    const int k = threadIdx.x >> 3, q = threadIdx.x & 7, r = r0 + k;
    const bool ok = r < K, sd = r < a.Kb;
    const float* src = (sd ? a.sd_p + (size_t)r * a.Vp : a.pd_p + (size_t)(r - a.Kb) * a.Vp) + v0 + 4 * q;
    const size_t cstride = (size_t)(sd ? a.kbp : a.kpp) * a.Vp;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cp_async16(stage + (c * kKC + k) * kVT + 4 * q, ok ? src + c * cstride : a.sd_p, ok);
  }
  {  // coefficients: the lane is the row, the warps walk the items
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r = r0 + lane;
    const bool rk = r < K, sd = r < a.Kb;
    const float* src = sd ? a.betas + r : a.pf + (r - a.Kb);
    const int stride = sd ? a.Kb : a.Kp;
    float* sc = stage + 3 * kKC * kVT + lane;
#pragma unroll
    for (int n = 0; n < BT / (kThreads / 32); ++n) {
      const int i = warp + n * (kThreads / 32), b = b0 + i;
      const bool ok = rk && b < a.B;
      cp_async4(sc + (i / IPT) * kGS + (i % IPT) * kCS, ok ? src + (size_t)b * stride : a.betas, ok);
    }
  }
}

// The rigid rows of items b0 + ty*IPT + ii (ty < kTY) into `slot`, one
// padded row of rs floats per item row ty (items past B zero).
template <int IPT>
__device__ __forceinline__ void load_rel(const Args& a, float* slot, int rs, int b0, int ii) {
  const int n4 = a.J * 3;  // 16-byte vectors in one item's [J, 12]
  for (int e = threadIdx.x; e < kTY * n4; e += kThreads) {
    const int q = e % n4, t = e / n4;
    const int b = b0 + t * IPT + ii;
    const bool ok = b < a.B;
    cp_async16(slot + t * rs + 4 * q, ok ? a.rel + (size_t)b * a.J * 12 + 4 * q : a.rel, ok);
  }
}

// One item's epilogue: its skinning rows T from its rigid rows `rb` (in
// shared memory) and the weight tile, then verts = R(T) v_posed + t(T), and
// v_posed and T with the residuals.
__device__ __forceinline__ void finish_item(const Args& a, const float* s_w, const float4* rb,
                                            const float (&p)[3][2], int b, int v, int tx) {
  float t[2][12];
#pragma unroll
  for (int r = 0; r < 12; ++r) { t[0][r] = 0.f; t[1][r] = 0.f; }
#pragma unroll 4
  for (int j = 0; j < a.J; ++j) {
    const float2 w = *reinterpret_cast<const float2*>(s_w + j * kVT + 2 * tx);
    const float4 q0 = rb[3 * j], q1 = rb[3 * j + 1], q2 = rb[3 * j + 2];
    const float rr[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
#pragma unroll
    for (int r = 0; r < 12; ++r) {
      t[0][r] = fmaf(rr[r], w.x, t[0][r]);
      t[1][r] = fmaf(rr[r], w.y, t[1][r]);
    }
  }
  const size_t o3 = (size_t)b * 3 * a.Vp + v;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float2 out;
    out.x = t[0][3 * c] * p[0][0] + t[0][3 * c + 1] * p[1][0] + t[0][3 * c + 2] * p[2][0] + t[0][9 + c];
    out.y = t[1][3 * c] * p[0][1] + t[1][3 * c + 1] * p[1][1] + t[1][3 * c + 2] * p[2][1] + t[1][9 + c];
    *reinterpret_cast<float2*>(a.verts + o3 + (size_t)c * a.Vp) = out;
  }
  if (a.residuals) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      *reinterpret_cast<float2*>(a.vposed + o3 + (size_t)c * a.Vp) = make_float2(p[c][0], p[c][1]);
    const size_t o12 = (size_t)b * 12 * a.Vp + v;
#pragma unroll
    for (int r = 0; r < 12; ++r)
      *reinterpret_cast<float2*>(a.T + o12 + (size_t)r * a.Vp) = make_float2(t[0][r], t[1][r]);
  }
}

template <int IPT>
__global__ void __launch_bounds__(kThreads)
lbs_forward_kernel(const Args a) {
  constexpr int BT = kTY * IPT;
  constexpr int kGS = IPT * kCS + 4;
  constexpr int kStageFloats = 3 * kKC * kVT + kTY * kGS;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                 // [J][kVT]
  float* ring = smem + a.J * kVT;    // kStages x kStageFloats

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int b0 = blockIdx.x * BT, v0 = blockIdx.y * kVT;
  const int v = v0 + 2 * tx;
  const int ib = b0 + ty * IPT;  // this thread's first item
  const int nchunks = (a.Kb + a.Kp + kKC - 1) / kKC;

  // The weight tile joins the first chunk's copy group.
  for (int e = threadIdx.x; e < a.J * (kVT / 4); e += kThreads) {
    const int q = e % (kVT / 4), j = e / (kVT / 4);
    cp_async16(s_w + j * kVT + 4 * q, a.w_p + (size_t)j * a.Vp + v0 + 4 * q, true);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk<IPT>(a, ring + s * kStageFloats, s * kKC, b0, v0);
    cp_async_commit();
  }

  float acc[IPT][3][2];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float2 t0 = *reinterpret_cast<const float2*>(a.vt_p + (size_t)c * a.Vp + v);
#pragma unroll
    for (int i = 0; i < IPT; ++i) { acc[i][c][0] = t0.x; acc[i][c][1] = t0.y; }
  }

  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch has landed for all; stage (ch-1) % kStages is free
    const int nx = ch + kStages - 1;
    if (nx < nchunks) load_chunk<IPT>(a, ring + (nx % kStages) * kStageFloats, nx * kKC, b0, v0);
    cp_async_commit();
    if (ib < a.B) {
      const float* sb = ring + (ch % kStages) * kStageFloats;
      const float* sc = sb + 3 * kKC * kVT + ty * kGS;
#pragma unroll
      for (int k4 = 0; k4 < kKC; k4 += 4) {
        float4 cf[IPT];
#pragma unroll
        for (int i = 0; i < IPT; ++i) cf[i] = *reinterpret_cast<const float4*>(sc + i * kCS + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float2 bv =
                *reinterpret_cast<const float2*>(sb + (c * kKC + k4 + kk) * kVT + 2 * tx);
#pragma unroll
            for (int i = 0; i < IPT; ++i) {
              const float f = kk == 0 ? cf[i].x : kk == 1 ? cf[i].y : kk == 2 ? cf[i].z : cf[i].w;
              acc[i][c][0] = fmaf(f, bv.x, acc[i][c][0]);
              acc[i][c][1] = fmaf(f, bv.y, acc[i][c][1]);
            }
          }
        }
      }
    }
  }

  // Epilogue, one item of each thread row at a time: the rows' rigid
  // transforms are staged in the (now free) ring, double-buffered; then
  // the skinning rows, verts (and the residuals).
  const int rs = a.J * 12 + 4;  // padded: the two item rows of a warp hit other banks
  float* slots[2] = {ring, ring + kTY * rs};
  cp_async_wait<0>();
  __syncthreads();
  load_rel<IPT>(a, slots[0], rs, b0, 0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    if (i + 1 < IPT) load_rel<IPT>(a, slots[(i + 1) & 1], rs, b0, i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (ib + i < a.B)
      finish_item(a, s_w, reinterpret_cast<const float4*>(slots[i & 1] + ty * rs), acc[i], ib + i, v, tx);
    __syncthreads();  // slot (i & 1) is refilled next
  }
}

template <int IPT>
int launch(const Args& a, int b_tiles, int v_tiles, cudaStream_t stream) {
  const size_t ring = (size_t)kStages * (3 * kKC * kVT + kTY * (IPT * kCS + 4));
  const size_t rel_slots = (size_t)2 * kTY * (a.J * 12 + 4);
  const size_t smem = sizeof(float) * ((size_t)a.J * kVT + (ring > rel_slots ? ring : rel_slots));
  // Above 48 KB of dynamic shared memory the kernel has to opt in, once per
  // device and size (not during a graph capture's replays: the first call
  // of a size sets it).
  constexpr int kMaxDevices = 64;
  static size_t opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (opted[dev] < smem) {
    e = cudaFuncSetAttribute(lbs_forward_kernel<IPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = smem;
  }
  lbs_forward_kernel<IPT><<<dim3(b_tiles, v_tiles), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `ipt`, `b_tiles`, `v_tiles`: the launch plan (ops/kernels/lbs_cuda.py
// `launch_plan`): 16*ipt items and 32 vertices a block, grid
// (b_tiles, v_tiles). Returns cudaErrorInvalidValue for a plan that does not
// cover [B, Vp] exactly, or residuals without their outputs.
extern "C" int ilps_lbs_forward(const float* betas, const float* pf, const float* rel,
                                const float* vt_p, const float* sd_p, const float* pd_p,
                                const float* w_p, float* verts, float* vposed, float* T,
                                int B, int Vp, int Kb, int kbp, int Kp, int kpp, int J,
                                int ipt, int b_tiles, int v_tiles, int residuals,
                                void* stream) {
  const int bt = kTY * ipt;
  if (B < 1 || Vp % kVT != 0 || v_tiles * kVT != Vp || (b_tiles - 1) * bt >= B ||
      b_tiles * bt < B || (residuals && (vposed == nullptr || T == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{betas, pf, rel, vt_p, sd_p, pd_p, w_p, verts, vposed, T,
               B, Vp, Kb, kbp, Kp, kpp, J, residuals};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ipt) {
    case 1: return launch<1>(a, b_tiles, v_tiles, s);
    case 2: return launch<2>(a, b_tiles, v_tiles, s);
    case 4: return launch<4>(a, b_tiles, v_tiles, s);
    case 8: return launch<8>(a, b_tiles, v_tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
