// Forward render pass of a vanilla NeRF (kernel B3) and of a T-NeRF
// (kernel B4, forward mode) for Hopper.
//
// Replaces swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel in
// forward-only, from-rays mode (param_grads=False), arch "vanilla" (B3) or
// "tnerf" (B4: act="elu", rgb_relu, the [embed(xyz) | embed(t)] input). Per
// sample: pts = o + d*z, Fourier encoding (with the ray's frame time for
// B4), the D-layer ReLU (B4: ELU) trunk with one skip, feature + alpha
// heads, the view layer and the rgb head (B4: ReLU on the logits before the
// compositor's sigmoid). One body serves both families through the traits
// of mlp_common.cuh. Per ray: alpha =
// 1 - exp(-relu(sigma + noise) * dist), T = exp(exclusive prefix sum of
// log(max(1 - alpha + 1e-10, 1e-10))), w = alpha * T, and the rgb / acc /
// depth maps with optional white background. The plain twin is
// swnerf_torch/ops/kernels/render_pass.py::render_pass_plain.
// B3's pts mode (render_pass_pts_launch; the Pallas kernel's ``pts=`` path,
// render_fused.py:349-356, used by the D-NeRF eval pass and the shared
// coarse pass of its train step) takes the sample positions pts [N, S, 3]
// in place of o + d*z: a compile-time switch (PTS), so the from-rays
// instantiations are the code they were. At the MultiRes widths (levels 0-2
// of the test render, run_multires.py:148 with models/dnerf.py:294-306;
// raymarch.py:49-59 takes inputs up to 128 columns) the pts mode runs the
// VanillaWide traits: 128 padded position rows and 128 view rows, where the
// narrow family has 64 and 32. Its fp32 tiles at W=256 take 225,280 of the
// 232,448 bytes of shared memory a block may opt into, which bounds S at
// 256 (launch() refuses more).
//
// Bound on the card: operations (~1.19 MFLOP of MLP per sample at D=8,
// W=256; ~0.33 MFLOP for T-NeRF at D=8, W=128; against ~1 KB of per-ray
// input). Two bodies:
//  - bf16 (B3 from rays, pts, pts wide; B4): tc_render.cuh on the tensor
//    cores (tc_chunk.cuh: bf16 wgmma, an async weight ring, 128 rows per
//    pass over the weights, a persistent grid), about 9.4 KB of weights
//    from L2 per row (9.9 KB wide), half the SIMT body's. B4 runs it at
//    W=128 with its time columns encoded in the block and ELU in the
//    epilogues.
//  - fp32 (the parity mode) and the ordered bf16 pts launch (the
//    training path's, which B9's recomputed forward matches bit for bit:
//    the tensor cores round each k16 step toward zero, tc_rounding.py, and
//    B9's gradients then leave the twin's bar): the SIMT body below, fp32
//    FMAs in order. One block of 256 threads owns whole rays and runs the
//    MLP over 64-row chunks of their samples (mlp_common.cuh): the chunk's
//    embedding and its two ping-pong activation buffers live in shared
//    memory, and weights stream from global memory (they stay L2-resident)
//    through a 16-row shared tile.
// Only the 4 raw lanes of each sample are kept, in shared memory; then one
// thread per ray composites in order (mlp_common.cuh::composite).
// Operands are fp32 (parity mode) or bf16 (rounded exactly where the plain
// twin rounds); accumulation, biases and compositing are fp32.
//
// No --use_fast_math (see ops/kernels/build.py): sinf/cosf stay accurate at
// the 2^9-frequency arguments (2^19 at MultiRes level 0), and the
// transmittance floor is not folded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "mlp_common.cuh"
#include "tc_render.cuh"

namespace {

template <typename T, int W, typename A, bool PTS = false>
__global__ void __launch_bounds__(NT)
render_pass_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                   const float* __restrict__ times, const float* __restrict__ vemb, int cv, const float* __restrict__ z,
                   const float* __restrict__ dist, const float* __restrict__ noise,
                   const T* __restrict__ wts, const float* __restrict__ bias, int D, int skip, int L,
                   int white, int N, int S, int rays_per_block, float* __restrict__ rgb_out,
                   float* __restrict__ acc_out, float* __restrict__ depth_out, float* __restrict__ w_out) {
  constexpr int LDA = Op<T>::LDA;
  constexpr int WH = W / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long ray0 = (long long)blockIdx.x * rays_per_block;
  const int nr = (int)min((long long)rays_per_block, (long long)N - ray0);
  const int rows = nr * S;

  float* raw_s = reinterpret_cast<float*>(smem_raw);  // [rays_per_block * S][4]
  float* red = raw_s + rays_per_block * S * 4;         // [4][CH][3]
  T* actA = reinterpret_cast<T*>(red + NRED);          // [W][LDA]
  T* actB = actA + W * LDA;                            // [W][LDA]
  T* emb = actB + W * LDA;                             // [A::CIN][LDA]
  T* vemb_s = emb + A::CIN * LDA;                      // [A::CV][LDA]
  T* Ws = vemb_s + A::CV * LDA;                        // [KT][W]

  const float* b_views = bias + (D + 1) * W;
  const float* b_rgb = b_views + WH;
  const float b_alpha = b_rgb[3];
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;

  for (int row0 = 0; row0 < rows; row0 += CH) {
    encode_chunk<T, A, PTS>(emb, vemb_s, row0, rows, ray0, S, L, cv, origins, dirs, times, z, vemb);
    const T* wp = wts;
    const float* bp = bias;
    T* h = actA;
    T* g = actB;
    {
      float acc[8][W / 32];
      zero(acc);
      mm_acc<T, W>(acc, emb, A::CIN, wp, Ws);
      wp += A::CIN * W;
      store_act<T, W, A::ACT>(acc, bp, h);
      bp += W;
    }
    for (int i = 1; i < D; ++i) {
      float acc[8][W / 32];
      zero(acc);
      if (i == skip + 1) {  // cat([emb, h]) @ W == emb @ W_emb + h @ W_h
        mm_acc<T, W>(acc, emb, A::CIN, wp, Ws);
        wp += A::CIN * W;
      }
      mm_acc<T, W>(acc, h, W, wp, Ws);
      wp += W * W;
      store_act<T, W, A::ACT>(acc, bp, g);
      bp += W;
      T* t = h;
      h = g;
      g = t;
    }
    {  // feature head (no activation) -> g
      float acc[8][W / 32];
      zero(acc);
      mm_acc<T, W>(acc, h, W, wp, Ws);
      wp += W * W;
      store_act<T, W, Act::None>(acc, bp, g);
    }
    {  // alpha head: one dot of length W per row, 4 threads per row
      float s = 0.f;
      for (int k = p; k < W; k += 4) s = fmaf(Op<T>::f(h[k * LDA + r]), Op<T>::f(wp[k]), s);
      red[p * CH + r] = s;
      __syncthreads();
      if (p == 0 && row0 + r < rows)
        raw_s[(row0 + r) * 4 + 3] = ((red[r] + red[CH + r]) + red[2 * CH + r]) + red[3 * CH + r] + b_alpha;
      wp += W;
    }
    {  // view layer on cat([feature, view embedding]) -> h
      float acc[8][WH / 32];
      zero(acc);
      mm_acc<T, WH>(acc, g, W, wp, Ws);
      wp += W * WH;
      mm_acc<T, WH>(acc, vemb_s, A::CV, wp, Ws);
      wp += A::CV * WH;
      store_act<T, WH, A::ACT>(acc, b_views, h);
    }
    __syncthreads();
    {  // rgb head: three dots of length W/2 per row
      float s[3] = {0.f, 0.f, 0.f};
      for (int k = p; k < WH; k += 4) {
        const float hv = Op<T>::f(h[k * LDA + r]);
#pragma unroll
        for (int c = 0; c < 3; ++c) s[c] = fmaf(hv, Op<T>::f(wp[k * 3 + c]), s[c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) red[(p * CH + r) * 3 + c] = s[c];
      __syncthreads();
      if (p == 0 && row0 + r < rows) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          raw_s[(row0 + r) * 4 + c] = ((red[r * 3 + c] + red[(CH + r) * 3 + c]) + red[(2 * CH + r) * 3 + c]) +
                                      red[(3 * CH + r) * 3 + c] + b_rgb[c];
      }
    }
  }
  __syncthreads();

  // Composite: one thread per ray, samples in order (raw2outputs).
  if ((int)threadIdx.x < nr) {
    const int t = threadIdx.x;
    const long long ray = ray0 + t;
    float c0, c1, c2, acc, dep;
    composite<A>(raw_s + t * S * 4, S, z + ray * S, dist + ray * S, noise ? noise + ray * S : nullptr, white,
                 w_out + ray * S, nullptr, c0, c1, c2, acc, dep);
    rgb_out[ray * 3 + 0] = c0;
    rgb_out[ray * 3 + 1] = c1;
    rgb_out[ray * 3 + 2] = c2;
    acc_out[ray] = acc;
    depth_out[ray] = dep;
  }
}

template <typename T, int W, typename A, bool PTS = false>
int launch_simt(const float* origins, const float* dirs, const float* times, const float* vemb, int cv, const float* z,
                const float* dist, const float* noise, const void* wts, const float* bias, int D, int skip,
                int L, int white, int N, int S, float* rgb, float* acc, float* depth, float* w_out,
                cudaStream_t stream) {
  const int rays_per_block = std::max(1, CH / S);
  // The wide family in fp32 at W=256 takes 225,280 bytes of tiles, which
  // leaves S <= 256 (render_pass_max_samples; the wrapper refuses more first).
  const size_t smem = render_smem<T, W, A, 4>(S);
  if (smem > SMEM_OPTIN) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = render_pass_kernel<T, W, A, PTS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = ((long long)N + rays_per_block - 1) / rays_per_block;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(origins, dirs, times, vemb, cv, z, dist, noise,
                                                static_cast<const T*>(wts), bias, D, skip, L, white, N, S,
                                                rays_per_block, rgb, acc, depth, w_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W, typename A, bool PTS = false>
int launch(const float* origins, const float* dirs, const float* times, const float* vemb, int cv, const float* z,
           const float* dist, const float* noise, const void* wts, const float* bias, int D, int skip,
           int L, int white, int N, int S, float* rgb, float* acc, float* depth, float* w_out, void* img,
           long long img_bytes, bool ordered, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {  // bf16: the tensor-core body, unless ordered
    if (!ordered)
      return tc::render_launch<W, A, PTS>(origins, dirs, times, vemb, cv, z, dist, noise, wts, bias, D, skip, L, white,
                                          N, S, rgb, acc, depth, w_out, img, img_bytes, stream);
  }
  return launch_simt<T, W, A, PTS>(origins, dirs, times, vemb, cv, z, dist, noise, wts, bias, D, skip, L, white, N, S,
                                   rgb, acc, depth, w_out, stream);
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most samples per ray render_pass_launch (tnerf) and
// render_pass_pts_launch (wide) take: the block's shared memory.
int render_pass_max_samples(int tnerf, int bf16, int wide, int W) {
  const int simt = render_max_samples<4>(tnerf, bf16, wide, W);  // fp32, bf16 ordered
  return bf16 && simt > 0 ? std::min(simt, tc::max_samples(tnerf, wide, W)) : simt;
}

// Bytes of the weight image render_pass_launch and render_pass_pts_launch
// read for these weights (tc_render.cuh::render_plan): 0 where the SIMT
// body runs (fp32) or for an unsupported width.
long long render_pass_image_bytes(int tnerf, int bf16, int wide, int W, int D, int skip) {
  if (!bf16 || (W != 128 && W != 256)) return 0;
  if (tnerf) return W == 256 ? tc::render_plan<256, TNerf>(D, skip).bytes : tc::render_plan<128, TNerf>(D, skip).bytes;
  if (wide)
    return W == 256 ? tc::render_plan<256, VanillaWide>(D, skip).bytes
                    : tc::render_plan<128, VanillaWide>(D, skip).bytes;
  return W == 256 ? tc::render_plan<256, Vanilla>(D, skip).bytes : tc::render_plan<128, Vanilla>(D, skip).bytes;
}

// With a device buffer of 3 x (blocks) int64, the next bf16 tensor-core
// launches record per block the clock cycles of the composite (beside the
// products), of the narrow heads and of the whole block
// (tc_chunk.cuh::g_prof); null stops it.
void render_pass_profile(void* buf) { tc::g_prof = static_cast<long long*>(buf); }

// tnerf: 0 for a vanilla field (B3), 1 for a T-NeRF (B4). origins, dirs
// [N, 3]; times [N] (B4 only, else null); vemb [N, cv]; z, dist, noise
// (nullable) [N, S]; wts / bias: the packed buffers of
// ops/kernels/render_pass.py::pack_params / pack_tnerf_params (bf16 != 0:
// bf16 operands, else fp32); outputs rgb [N, 3], acc [N], depth [N],
// w_out [N, S]; img: img_bytes of scratch for the bf16 body's weight image
// (render_pass_image_bytes; null where that is 0).
// All contiguous.
int render_pass_launch(int tnerf, int bf16, int W, const float* origins, const float* dirs, const float* times,
                       const float* vemb, int cv, const float* z, const float* dist, const float* noise,
                       const void* wts, const float* bias, int D, int skip, int L, int white, int N, int S,
                       float* rgb, float* acc, float* depth, float* w_out, void* img, long long img_bytes,
                       void* stream) {
  if (N == 0) return 0;
  if (tnerf ? (times == nullptr || TNerf::cin(L) > TNerf::CIN) : Vanilla::cin(L) > Vanilla::CIN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_LAUNCH(T, WW, AA)                                                                                  \
  launch<T, WW, AA>(origins, dirs, times, vemb, cv, z, dist, noise, wts, bias, D, skip, L, white, N, S, rgb, acc, \
                    depth, w_out, img, img_bytes, false, st)
  if (tnerf) {
    if (bf16) {
      if (W == 256) return SWNERF_LAUNCH(__nv_bfloat16, 256, TNerf);
      if (W == 128) return SWNERF_LAUNCH(__nv_bfloat16, 128, TNerf);
    } else {
      if (W == 256) return SWNERF_LAUNCH(float, 256, TNerf);
      if (W == 128) return SWNERF_LAUNCH(float, 128, TNerf);
    }
  } else if (bf16) {
    if (W == 256) return SWNERF_LAUNCH(__nv_bfloat16, 256, Vanilla);
    if (W == 128) return SWNERF_LAUNCH(__nv_bfloat16, 128, Vanilla);
  } else {
    if (W == 256) return SWNERF_LAUNCH(float, 256, Vanilla);
    if (W == 128) return SWNERF_LAUNCH(float, 128, Vanilla);
  }
#undef SWNERF_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// B3's pts mode (the D-NeRF canonical pass, vanilla field): the sample
// positions pts [N, S, 3] are given (o + d*z, plus the deformation) and
// encoded in-block; z and dist still drive the depth and the compositing.
// wide != 0 takes weights packed at the MultiRes widths (128 / 128 padded
// rows, VanillaWide), else the narrow pads (64 / 32). ordered != 0 (bf16:
// the training path's launch) runs the SIMT body, whose fp32 FMAs in order
// B9's recomputed forward shares, so that the two agree bit for bit; fp32
// runs it either way. Other arguments as render_pass_launch's.
int render_pass_pts_launch(int bf16, int wide, int W, const float* pts, const float* vemb, int cv, const float* z,
                           const float* dist, const float* noise, const void* wts, const float* bias, int D, int skip,
                           int L, int white, int N, int S, float* rgb, float* acc, float* depth, float* w_out,
                           void* img, long long img_bytes, int ordered, void* stream) {
  if (N == 0) return 0;
  if (wide ? (VanillaWide::cin(L) > VanillaWide::CIN || cv > VanillaWide::CV)
           : (Vanilla::cin(L) > Vanilla::CIN || cv > Vanilla::CV))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_LAUNCH(T, WW, AA)                                                                                  \
  launch<T, WW, AA, true>(pts, nullptr, nullptr, vemb, cv, z, dist, noise, wts, bias, D, skip, L, white, N, S, rgb, \
                          acc, depth, w_out, img, img_bytes, ordered != 0, st)
  if (wide) {
    if (bf16) {
      if (W == 256) return SWNERF_LAUNCH(__nv_bfloat16, 256, VanillaWide);
      if (W == 128) return SWNERF_LAUNCH(__nv_bfloat16, 128, VanillaWide);
    } else {
      if (W == 256) return SWNERF_LAUNCH(float, 256, VanillaWide);
      if (W == 128) return SWNERF_LAUNCH(float, 128, VanillaWide);
    }
  } else if (bf16) {
    if (W == 256) return SWNERF_LAUNCH(__nv_bfloat16, 256, Vanilla);
    if (W == 128) return SWNERF_LAUNCH(__nv_bfloat16, 128, Vanilla);
  } else {
    if (W == 256) return SWNERF_LAUNCH(float, 256, Vanilla);
    if (W == 128) return SWNERF_LAUNCH(float, 128, Vanilla);
  }
#undef SWNERF_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
