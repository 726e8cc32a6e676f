// Forward render pass of a vanilla NeRF (kernel B3) for Hopper.
//
// Replaces swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel in
// forward-only, from-rays, vanilla mode (param_grads=False). Per sample:
// pts = o + d*z, Fourier encoding, the D-layer ReLU trunk with one skip,
// feature + alpha heads, the view layer and the rgb head. Per ray: alpha =
// 1 - exp(-relu(sigma + noise) * dist), T = exp(exclusive prefix sum of
// log(max(1 - alpha + 1e-10, 1e-10))), w = alpha * T, and the rgb / acc /
// depth maps with optional white background. The plain twin is
// swnerf_torch/ops/kernels/render_pass.py::render_pass_plain.
//
// Bound on the card: operations (~1.19 MFLOP of MLP per sample at D=8,
// W=256, against ~1 KB of per-ray input). Design: one block of 256 threads
// owns whole rays and runs the MLP over 64-row chunks of their samples. The
// chunk's embedding and its two ping-pong activation buffers live in shared
// memory (k-major, padded rows so the epilogue's column-wise stores are
// conflict-free); weights stream from global memory (they stay L2-resident)
// through a 16-row shared tile, and each thread accumulates an 8-row x
// W/32-column register tile in fp32. Only the 4 raw lanes of each sample are
// kept, in shared memory; then one thread per ray composites in order.
// Operands are fp32 (parity mode) or bf16 (rounded exactly where the plain
// twin rounds); accumulation, biases and compositing are fp32. This is a
// SIMT kernel: tensor cores (mma/wgmma) and TMA are later work.
//
// No --use_fast_math (see ops/kernels/build.py): sinf/cosf stay accurate at
// the 2^9-frequency arguments, and the transmittance floor is not folded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int CH = 64;    // sample rows per MLP chunk
constexpr int NT = 256;   // threads per block: 8 warps x 8 rows = CH rows
constexpr int KT = 16;    // weight rows per shared-memory tile
constexpr int CIN = 64;   // padded position-embedding width
constexpr int CV = 32;    // padded view-embedding width
constexpr int NRED = 4 * CH * 3;

template <typename T> struct Op;
template <> struct Op<float> {
  static constexpr int LDA = CH + 4;
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float q(float x) { return x; }
  static __device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};
template <> struct Op<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int LDA = CH + 8;
  static __device__ __forceinline__ float f(T x) { return __bfloat162float(x); }
  static __device__ __forceinline__ T q(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// acc[i][j] += sum_k A[k][row_i] * Wg[k][col_j] over K (a multiple of KT).
// A: shared, k-major [K][LDA]; Wg: global, row-major [K][NC]. Thread (warp
// ty, lane) owns rows ty*8 .. ty*8+7 and columns j*32 + lane.
template <typename T, int NC>
__device__ __forceinline__ void mm_acc(float (&acc)[8][NC / 32], const T* __restrict__ A, int K,
                                       const T* __restrict__ Wg, T* __restrict__ Ws) {
  constexpr int CPT = NC / 32;
  constexpr int LDA = Op<T>::LDA;
  constexpr int NV = KT * NC * (int)sizeof(T) / 16;
  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();  // the previous tile (and any earlier writer of A) is done
    const uint4* src = reinterpret_cast<const uint4*>(Wg + (size_t)k0 * NC);
    uint4* dst = reinterpret_cast<uint4*>(Ws);
    for (int v = threadIdx.x; v < NV; v += NT) dst[v] = __ldg(src + v);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float a[8];
      Op<T>::load8(A + (k0 + kk) * LDA + ty * 8, a);
      float w[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) w[j] = Op<T>::f(Ws[kk * NC + j * 32 + lane]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
}

// out[col][row] = q(act(acc + bias[col])), k-major for the next layer.
template <typename T, int NC, bool RELU>
__device__ __forceinline__ void store_act(const float (&acc)[8][NC / 32], const float* __restrict__ bias,
                                          T* __restrict__ out) {
  constexpr int LDA = Op<T>::LDA;
  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NC / 32; ++j) {
    const int col = j * 32 + lane;
    const float b = bias[col];
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float z = acc[i][j] + b;
      v[i] = RELU ? fmaxf(z, 0.f) : z;
    }
    Op<T>::store8(out + col * LDA + ty * 8, v);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
}

// Positions and view embeddings of rows row0 .. row0+CH-1 of this block
// into shared memory (k-major). Rows past the block's samples get x = 0.
template <typename T>
__device__ __forceinline__ void encode_chunk(T* __restrict__ emb, T* __restrict__ vemb_s, int row0, int rows,
                                             long long ray0, int S, int L, int cv,
                                             const float* __restrict__ origins, const float* __restrict__ dirs,
                                             const float* __restrict__ z, const float* __restrict__ vemb) {
  constexpr int LDA = Op<T>::LDA;
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;  // 4 parts share a row
  const int g = row0 + r;
  const bool valid = g < rows;
  const long long ray = ray0 + (valid ? g / S : 0);
  float x[3] = {0.f, 0.f, 0.f};
  if (valid) {
    const float zz = z[ray * S + g % S];
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = __fadd_rn(origins[ray * 3 + a], __fmul_rn(dirs[ray * 3 + a], zz));
  }
  if (p == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) emb[a * LDA + r] = Op<T>::q(x[a]);
    for (int k = 3 + 6 * L; k < CIN; ++k) emb[k * LDA + r] = Op<T>::q(0.f);
  }
  for (int f = p; f < L; f += 4) {
    const float scale = (float)(1 << f);  // exact: x * 2^f rounds nothing
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t = x[a] * scale;
      emb[(3 + 6 * f + a) * LDA + r] = Op<T>::q(sinf(t));
      emb[(6 + 6 * f + a) * LDA + r] = Op<T>::q(cosf(t));
    }
  }
  for (int k = p; k < CV; k += 4)
    vemb_s[k * LDA + r] = Op<T>::q((valid && k < cv) ? vemb[ray * cv + k] : 0.f);
}

template <typename T, int W>
__global__ void __launch_bounds__(NT)
render_pass_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                   const float* __restrict__ vemb, int cv, const float* __restrict__ z,
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
  T* emb = actB + W * LDA;                             // [CIN][LDA]
  T* vemb_s = emb + CIN * LDA;                         // [CV][LDA]
  T* Ws = vemb_s + CV * LDA;                           // [KT][W]

  const float* b_views = bias + (D + 1) * W;
  const float* b_rgb = b_views + WH;
  const float b_alpha = b_rgb[3];
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;

  for (int row0 = 0; row0 < rows; row0 += CH) {
    encode_chunk<T>(emb, vemb_s, row0, rows, ray0, S, L, cv, origins, dirs, z, vemb);
    const T* wp = wts;
    const float* bp = bias;
    T* h = actA;
    T* g = actB;
    {
      float acc[8][W / 32];
      zero(acc);
      mm_acc<T, W>(acc, emb, CIN, wp, Ws);
      wp += CIN * W;
      store_act<T, W, true>(acc, bp, h);
      bp += W;
    }
    for (int i = 1; i < D; ++i) {
      float acc[8][W / 32];
      zero(acc);
      if (i == skip + 1) {  // cat([emb, h]) @ W == emb @ W_emb + h @ W_h
        mm_acc<T, W>(acc, emb, CIN, wp, Ws);
        wp += CIN * W;
      }
      mm_acc<T, W>(acc, h, W, wp, Ws);
      wp += W * W;
      store_act<T, W, true>(acc, bp, g);
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
      store_act<T, W, false>(acc, bp, g);
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
      mm_acc<T, WH>(acc, vemb_s, CV, wp, Ws);
      wp += CV * WH;
      store_act<T, WH, true>(acc, b_views, h);
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
    const float* zr = z + ray * S;
    const float* dr = dist + ray * S;
    const float* nz = noise ? noise + ray * S : nullptr;
    float* wr = w_out + ray * S;
    float log_t = 0.f, acc = 0.f, dep = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* rw = raw_s + (t * S + s) * 4;
      const float sigma = nz ? rw[3] + nz[s] : rw[3];
      const float alpha = 1.f - expf(-fmaxf(sigma, 0.f) * dr[s]);
      // The max() floor keeps log() finite at alpha == 1 whatever the
      // compiler does to (1 - alpha) + 1e-10 (render_fused.py:372-377).
      const float safe = fmaxf(1.f - alpha + 1e-10f, 1e-10f);
      const float w = alpha * expf(log_t);
      log_t += logf(safe);
      wr[s] = w;
      acc += w;
      dep += w * zr[s];
      c0 += w * (1.f / (1.f + expf(-rw[0])));
      c1 += w * (1.f / (1.f + expf(-rw[1])));
      c2 += w * (1.f / (1.f + expf(-rw[2])));
    }
    if (white) {
      c0 += 1.f - acc;
      c1 += 1.f - acc;
      c2 += 1.f - acc;
    }
    rgb_out[ray * 3 + 0] = c0;
    rgb_out[ray * 3 + 1] = c1;
    rgb_out[ray * 3 + 2] = c2;
    acc_out[ray] = acc;
    depth_out[ray] = dep;
  }
}

template <typename T, int W>
int launch(const float* origins, const float* dirs, const float* vemb, int cv, const float* z,
           const float* dist, const float* noise, const void* wts, const float* bias, int D, int skip,
           int L, int white, int N, int S, float* rgb, float* acc, float* depth, float* w_out,
           cudaStream_t stream) {
  constexpr int LDA = Op<T>::LDA;
  const int rays_per_block = std::max(1, CH / S);
  const size_t smem = sizeof(float) * ((size_t)rays_per_block * S * 4 + NRED) +
                      sizeof(T) * ((size_t)(2 * W + CIN + CV) * LDA + KT * W);
  auto kern = render_pass_kernel<T, W>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = ((long long)N + rays_per_block - 1) / rays_per_block;
  kern<<<(unsigned)blocks, NT, smem, stream>>>(origins, dirs, vemb, cv, z, dist, noise,
                                                static_cast<const T*>(wts), bias, D, skip, L, white, N, S,
                                                rays_per_block, rgb, acc, depth, w_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// origins, dirs [N, 3]; vemb [N, cv]; z, dist, noise (nullable) [N, S];
// wts / bias: the packed buffers of ops/kernels/render_pass.py::pack_params
// (bf16 != 0: bf16 operands, else fp32); outputs rgb [N, 3], acc [N],
// depth [N], w_out [N, S]. All contiguous.
int render_pass_launch(int bf16, int W, const float* origins, const float* dirs, const float* vemb,
                       int cv, const float* z, const float* dist, const float* noise, const void* wts,
                       const float* bias, int D, int skip, int L, int white, int N, int S, float* rgb,
                       float* acc, float* depth, float* w_out, void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_LAUNCH(T, WW) \
  launch<T, WW>(origins, dirs, vemb, cv, z, dist, noise, wts, bias, D, skip, L, white, N, S, rgb, acc, depth, w_out, st)
  if (bf16) {
    if (W == 256) return SWNERF_LAUNCH(__nv_bfloat16, 256);
    if (W == 128) return SWNERF_LAUNCH(__nv_bfloat16, 128);
  } else {
    if (W == 256) return SWNERF_LAUNCH(float, 256);
    if (W == 128) return SWNERF_LAUNCH(float, 128);
  }
#undef SWNERF_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
