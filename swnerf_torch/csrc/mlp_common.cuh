// Device code shared by the render kernels B1/B3/B5 (vanilla) and B4
// (T-NeRF) in render_pass.cu and render_loss.cu, the deformation MLP B6 in
// time_net.cu and the field trunks B7, B7' and B8 in trunk.cu: operand-type
// traits, the field families of the render kernels, the 64-row SIMT MLP
// chunk product, the activation epilogue, the in-block Fourier encoding and
// its backward, and the per-ray composite of the tensor-core B3.
//
// The SIMT chunk product (mm_acc) serves every fp32 instantiation (the
// parity mode) and, in bf16, B1, B4's train-mode forward, B5, B7', B9, the
// train-mode forwards of B7 and B8 and the training path's B3 launch
// (ordered); bf16 B3 otherwise, B4's forward-only launch, B6's forward and
// B7's and B8's forward-only launch run tc_chunk.cuh's tensor-core product
// instead.
// A block of NT threads runs the MLP over CH sample rows at a time. The
// chunk's activations live in shared memory k-major ([feature][LDA], rows
// padded so the epilogue's column-wise stores are conflict-free); weights
// stream from global memory through a KT-row shared tile, and each thread
// accumulates an 8-row x NC/32-column register tile in fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 64;    // sample rows per MLP chunk
constexpr int NT = 256;   // threads per block: 8 warps x 8 rows = CH rows
constexpr int KT = 16;    // weight rows per shared-memory tile
constexpr int NRED = 4 * CH * 3;

enum class Act { None, Relu, Elu };

// The field families of the one body (render_fused.py: act, rgb_relu,
// and the combined [embed(xyz) | embed(t)] constants of
// raymarch.py::build_embed_consts_xt). CIN is the padded input width: a
// multiple of KT with room for B1's column of ones after the live columns;
// CV the padded view-embedding width.
struct Vanilla {
  static constexpr int CIN = 64;          // embed(xyz): 3 + 6L <= 63
  static constexpr int CV = 32;           // embed(viewdirs): 3 + 6L' <= 27
  static constexpr Act ACT = Act::Relu;   // trunk and view layer
  static constexpr bool TIME = false;
  static constexpr bool RGB_RELU = false;
  static __host__ __device__ int cin(int L) { return 3 + 6 * L; }
};
// A vanilla field at the MultiRes widths (raymarch.py:49-59: inputs up to
// 128 columns): B3's pts mode and B9 on levels 0-2, (20, 20) and (10, 10)
// frequencies, 123 / 123 and 63 / 63 columns.
struct VanillaWide {
  static constexpr int CIN = 128;         // embed(xyz): 3 + 6L <= 127
  static constexpr int CV = 128;          // embed(viewdirs) <= 128
  static constexpr Act ACT = Act::Relu;
  static constexpr bool TIME = false;
  static constexpr bool RGB_RELU = false;
  static __host__ __device__ int cin(int L) { return 3 + 6 * L; }
};
struct TNerf {
  static constexpr int CIN = 96;          // [embed(xyz) | embed(t)]: 4 + 8L <= 95
  static constexpr int CV = 32;
  static constexpr Act ACT = Act::Elu;
  static constexpr bool TIME = true;
  static constexpr bool RGB_RELU = true;  // rgb = sigmoid(max(logit, 0))
  static __host__ __device__ int cin(int L) { return 4 + 8 * L; }
};

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

// Dynamic shared memory of one block of the SIMT render body (render_pass.cu's
// forward, render_loss.cu's train-mode forward), as both launchers size it:
// LANES floats per sample of the block's rays (4: the raw lanes; 5 in train
// mode, with the log-transmittances, whose run is padded to a multiple of 4
// floats so the tiles after it stay 16-byte aligned), the reduction buffer,
// and the tiles: two activation buffers, the embeddings and the weight
// tile, CH rows + pad.
constexpr size_t SMEM_OPTIN = 232448;  // bytes a block may opt into on Hopper

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

template <typename T, int W, typename A, int LANES>
size_t render_smem(int S) {
  const int rays_per_block = S < CH ? CH / S : 1;
  return sizeof(float) * ((size_t)rays_per_block * S * 4 + (size_t)(LANES - 4) * pad4(rays_per_block * S) + NRED) +
         sizeof(T) * ((size_t)(2 * W + A::CIN + A::CV) * Op<T>::LDA + KT * W);
}

// The most samples per ray (at most 1024) whose block fits SMEM_OPTIN, for
// the family of tnerf / wide at width W (128 or 256; else 0). Binding only
// for the wide family in fp32 at W=256: 256 forward only, 204 in train mode.
template <int LANES>
int render_max_samples(int tnerf, int bf16, int wide, int W) {
  int S = 1024;
  for (; S > 0; --S) {
    size_t smem = 0;
#define SWNERF_SMEM(AA)                                                                                  \
  (bf16 ? (W == 256 ? render_smem<__nv_bfloat16, 256, AA, LANES>(S) : render_smem<__nv_bfloat16, 128, AA, LANES>(S)) \
        : (W == 256 ? render_smem<float, 256, AA, LANES>(S) : render_smem<float, 128, AA, LANES>(S)))
    if (W != 128 && W != 256) return 0;
    smem = tnerf ? SWNERF_SMEM(TNerf) : wide ? SWNERF_SMEM(VanillaWide) : SWNERF_SMEM(Vanilla);
#undef SWNERF_SMEM
    if (smem <= SMEM_OPTIN) break;
  }
  return S;
}

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

// ELU as jax.nn.elu and F.elu write it (expm1, not exp - 1).
__device__ __forceinline__ float elu(float z) { return z > 0.f ? z : expm1f(z); }

// ELU's derivative from its stored output h (h = expm1(z) for z <= 0), in
// fp32 from h in the operand type, as _act_grad takes it.
__device__ __forceinline__ float elu_grad(float h) { return h > 0.f ? 1.f : h + 1.f; }

template <Act A>
__device__ __forceinline__ float act(float z) {
  if (A == Act::Relu) return fmaxf(z, 0.f);
  if (A == Act::Elu) return elu(z);
  return z;
}

// out[col][row] = q(act(acc + bias[col])), k-major for the next layer.
template <typename T, int NC, Act A>
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
      v[i] = act<A>(z);
    }
    Op<T>::store8(out + col * LDA + ty * 8, v);
  }
}

// The colour the compositor takes from an rgb logit: sigmoid, after a ReLU
// for B4 (fp32, as the twins keep it).
template <typename A>
__device__ __forceinline__ float rgb_of(float logit) {
  const float l = A::RGB_RELU ? fmaxf(logit, 0.f) : logit;
  return 1.f / (1.f + expf(-l));
}

// Composite one ray's S samples in order (raw2outputs): raw [S][4] holds
// each sample's rgb logits and sigma, zr / dr / nz (nullable) its z, dist
// and noise. Writes the weights wr [S] and, with lt, each sample's
// log-transmittance before it; returns the colour (white-composited when
// asked), acc and depth.
template <typename A>
__device__ __forceinline__ void composite(const float* __restrict__ raw, int S, const float* __restrict__ zr,
                                          const float* __restrict__ dr, const float* __restrict__ nz, int white,
                                          float* __restrict__ wr, float* __restrict__ lt, float& c0, float& c1,
                                          float& c2, float& acc, float& dep) {
  float log_t = 0.f;
  acc = 0.f;
  dep = 0.f;
  c0 = 0.f;
  c1 = 0.f;
  c2 = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* rw = raw + s * 4;
    const float sigma = nz ? rw[3] + nz[s] : rw[3];
    const float alpha = 1.f - expf(-fmaxf(sigma, 0.f) * dr[s]);
    // The max() floor keeps log() finite at alpha == 1 whatever the
    // compiler does to (1 - alpha) + 1e-10 (render_fused.py:372-377).
    const float safe = fmaxf(1.f - alpha + 1e-10f, 1e-10f);
    const float w = alpha * expf(log_t);
    if (lt) lt[s] = log_t;
    log_t += logf(safe);
    wr[s] = w;
    acc += w;
    dep += w * zr[s];
    c0 += w * rgb_of<A>(rw[0]);
    c1 += w * rgb_of<A>(rw[1]);
    c2 += w * rgb_of<A>(rw[2]);
  }
  if (white) {
    c0 += 1.f - acc;
    c1 += 1.f - acc;
    c2 += 1.f - acc;
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
// sin and cos are sinf/cosf of the exact product x * 2^f (no fast math).
// With A::TIME the ray's frame time t follows at column dpos = 3 + 6L as
// positional_encoding(t, L) orders it: t, then sin(2^i t), cos(2^i t) at
// dpos + 1 + 2i and dpos + 2 + 2i. t is per ray, constant along it. The
// columns from A::cin(L) to A::CIN are zero. With PTS (B3's pts mode, B5,
// B6, B8) the positions are given: ``origins`` then holds them, [ray][S][3],
// and dirs and z are not read. With VEMB the per-ray view embeddings (vemb
// [ray][cv], computed outside) follow into vemb_s, padded with zeros to
// A::CV rows; B8 encodes its view directions with a second call instead.
template <typename T, typename A, bool PTS = false, bool VEMB = true>
__device__ __forceinline__ void encode_chunk(T* __restrict__ emb, T* __restrict__ vemb_s, int row0, int rows,
                                             long long ray0, int S, int L, int cv,
                                             const float* __restrict__ origins, const float* __restrict__ dirs,
                                             const float* __restrict__ times, const float* __restrict__ z,
                                             const float* __restrict__ vemb) {
  constexpr int LDA = Op<T>::LDA;
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;  // 4 parts share a row
  const int g = row0 + r;
  const bool valid = g < rows;
  const long long ray = ray0 + (valid ? g / S : 0);
  const int dpos = 3 + 6 * L;
  float x[3] = {0.f, 0.f, 0.f};
  float t = 0.f;
  if (valid) {
    if (PTS) {
      const long long row = ray * S + g % S;
#pragma unroll
      for (int a = 0; a < 3; ++a) x[a] = origins[row * 3 + a];
    } else {
      const float zz = z[ray * S + g % S];
#pragma unroll
      for (int a = 0; a < 3; ++a) x[a] = __fadd_rn(origins[ray * 3 + a], __fmul_rn(dirs[ray * 3 + a], zz));
    }
    if (A::TIME) t = times[ray];
  }
  if (p == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) emb[a * LDA + r] = Op<T>::q(x[a]);
    if (A::TIME) emb[dpos * LDA + r] = Op<T>::q(t);
    for (int k = A::cin(L); k < A::CIN; ++k) emb[k * LDA + r] = Op<T>::q(0.f);
  }
  for (int f = p; f < L; f += 4) {
    const float scale = (float)(1 << f);  // exact: x * 2^f rounds nothing
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float u = x[a] * scale;
      emb[(3 + 6 * f + a) * LDA + r] = Op<T>::q(sinf(u));
      emb[(6 + 6 * f + a) * LDA + r] = Op<T>::q(cosf(u));
    }
    if (A::TIME) {
      const float u = t * scale;
      emb[(dpos + 1 + 2 * f) * LDA + r] = Op<T>::q(sinf(u));
      emb[(dpos + 2 + 2 * f) * LDA + r] = Op<T>::q(cosf(u));
    }
  }
  if (VEMB)
    for (int k = p; k < A::CV; k += 4)
      vemb_s[k * LDA + r] = Op<T>::q((valid && k < cv) ? vemb[ray * cv + k] : 0.f);
}

// d/dx [P][3] from the cotangent demb [P][cin] (fp32) of x's Fourier
// encode (raymarch.py::_embed_bwd): the identity columns, then per
// frequency f the derivative 2^f cos(2^f x) of the sin column and
// -2^f sin(2^f x) of the cos column, x in fp32. The Pallas kernel takes the
// latter as 2^f cos(2^f x + pi/2) (ROADMAP Queue C). B5 chains its position
// cotangent through it; B8 its position and view-direction cotangents.
__global__ void encode_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ demb, int cin, int L,
                                  long long P, float* __restrict__ dpts) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * 3) return;
  const long long p = idx / 3;
  const int a = (int)(idx - p * 3);
  const float x = pts[idx];
  const float* g = demb + p * cin;
  float s = g[a];
  for (int f = 0; f < L; ++f) {
    const float scale = (float)(1 << f);  // exact: x * 2^f rounds nothing
    const float u = x * scale;
    s += scale * (cosf(u) * g[3 + 6 * f + a] - sinf(u) * g[6 + 6 * f + a]);
  }
  dpts[idx] = s;
}

}  // namespace
