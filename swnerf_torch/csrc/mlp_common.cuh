// Device code shared by the render kernels B1/B3/B5 (vanilla) and B4
// (T-NeRF) in render_pass.cu and render_loss.cu, the deformation MLP B6 in
// time_net.cu and the field trunks B7, B7' and B8 in trunk.cu: operand-type
// traits, the field families of the render kernels, the two SIMT chunk
// products, the activation epilogues, the in-block Fourier encoding and its
// backward, and the per-ray composite.
//
// Both SIMT products keep one fp32 accumulator per output, which starts at
// +0 and takes fmaf over k in ascending order (pad rows included): the
// outputs are those of fp32 FMAs in order, bit for bit, which the
// tensor cores' k16 steps (rounded toward zero, tc_rounding.py) are not.
// A block runs the MLP over CH = 64 sample rows at a time; thread (warp ty,
// lane) owns rows ty*8 .. ty*8+7 of every layer, so a warp reads only the
// rows it wrote.
//  - mm_acc: B3's ordered and fp32 launches (render_pass.cu) and B6's SIMT
//    body (time_net.cu). Activations in the operand type, k-major ([k][LDA]);
//    weights stream from L2 through a 16-row tile, loaded and then read
//    between two block barriers; thread columns j*32 + lane.
//  - mm_ring (the train-mode forwards of B5, B7, B7' at W=256, B8 and B9,
//    render_loss.cu's and trunk.cu's fp32 instantiations): the weights as an
//    fp32 image (the operand values widened, exact), copied by one thread
//    of a producer warpgroup with cp.async.bulk into a ring of RSTAGES tiles
//    of RT rows, each with a full and an empty mbarrier; the ring runs
//    across layers and row chunks, so the next layer's tiles land while this
//    one's FMAs run, and no block barrier waits on a tile. The producer
//    warpgroup gives its registers to the two consumer warpgroups
//    (setmaxnreg). Activations are fp32 tiles (TileF: the rounded values,
//    exact) with 16-byte row groups swizzled by k. Per k step a thread loads
//    its 8 rows (two 16-byte broadcasts, at immediate offsets within four k)
//    and its columns (contiguous runs of four: 16-byte loads), with no
//    conversion, then 8 x NC/32 FMAs: 64 FMAs to 4 loads at W=256. Its
//    bound is the card's fp32 FMA rate (132 SMs x 128 lanes x 2 x the SM
//    clock: 66.9 TFLOP/s at 1.98 GHz), not the tensor cores'; the epilogue
//    writes the layer's spill to global memory from the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Where a chunk's k-major tiles keep feature k of row r. TileT<T> is
// mm_acc's: operand type T, rows padded to Op<T>::LDA. TileF<T> is
// mm_ring's: fp32 (values already rounded to T, so exact), CH floats a
// feature, and each 16-byte group of four rows at group (r / 4) ^ swz(k).
// The eight lanes of a 16-byte store phase write one row group for eight
// columns 4 apart (mm_ring's epilogue at 128 and 256 columns), whose
// swz(k) = (k / 4) % 8 differ: distinct banks. swz is constant over four
// k, so the product's loads take an immediate offset within each four.
template <typename T>
struct TileT {
  using S = T;
  static __device__ __forceinline__ int at(int k, int r) { return k * Op<T>::LDA + r; }
  static __device__ __forceinline__ void put(T* p, int k, int r, float x) { p[at(k, r)] = Op<T>::q(x); }
  static __device__ __forceinline__ T get(const T* p, int k, int r) { return p[at(k, r)]; }
};

__host__ __device__ constexpr int swz(int k) { return (k >> 2) & 7; }

template <typename T>
struct TileF {
  using S = float;
  static __device__ __forceinline__ int at(int k, int r) { return k * CH + (((r >> 2) ^ swz(k)) << 2) + (r & 3); }
  static __device__ __forceinline__ void put(float* p, int k, int r, float x) { p[at(k, r)] = Op<T>::f(Op<T>::q(x)); }
  static __device__ __forceinline__ T get(const float* p, int k, int r) { return Op<T>::q(p[at(k, r)]); }
};

// ---- PTX wrappers (sm_90a): the mbarriers and bulk copies of the weight
// rings, tc_chunk.cuh's (tensor cores) and mm_ring's ----
namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Waits for the phase of the given parity to complete. A wait of more than
// ~2^35 cycles (about 20 s) can only be a broken ring: it traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) t0 = clock64();
    else if ((spin & 1023) == 0 && clock64() - t0 > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

}  // namespace tc

// Dynamic shared memory of one block of mm_acc's render body (render_pass.cu's
// SIMT forward), as its launcher sizes it: the raw lanes of the block's
// rays (4 floats a sample), the reduction buffer, and the tiles: two
// activation buffers, the embeddings and the weight tile, CH rows + pad.
constexpr size_t SMEM_OPTIN = 232448;  // bytes a block may opt into on Hopper

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

template <typename T, int W, typename A>
size_t render_smem(int S) {
  const int rays_per_block = S < CH ? CH / S : 1;
  return sizeof(float) * ((size_t)rays_per_block * S * 4 + NRED) +
         sizeof(T) * ((size_t)(2 * W + A::CIN + A::CV) * Op<T>::LDA + KT * W);
}

// The most samples per ray (at most 1024) whose block fits SMEM_OPTIN, for
// the family of tnerf / wide at width W (128 or 256; else 0). Binding only
// for the wide family in fp32 at W=256: 256.
inline int render_max_samples(int tnerf, int bf16, int wide, int W) {
  if (W != 128 && W != 256) return 0;
  int S = 1024;
  for (; S > 0; --S) {
#define SWNERF_SMEM(AA)                                                                                  \
  (bf16 ? (W == 256 ? render_smem<__nv_bfloat16, 256, AA>(S) : render_smem<__nv_bfloat16, 128, AA>(S)) \
        : (W == 256 ? render_smem<float, 256, AA>(S) : render_smem<float, 128, AA>(S)))
    const size_t smem = tnerf ? SWNERF_SMEM(TNerf) : wide ? SWNERF_SMEM(VanillaWide) : SWNERF_SMEM(Vanilla);
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

// The loss of one composited ray and its reverse over the samples
// (render_fused.py:428-473), after composite() with lt: the squared error of
// (c0, c1, c2) against target[ray] into sqerr[ray], d loss / d rgb_map =
// loss_scale * 2 * err (white: d / d acc = -sum_c); or, EXT (B9), the
// caller's cotangent gct[ray] = d loss / d (rgb_map after the white
// background, acc, depth). Then from the last sample: d alpha from the
// suffix sum of dL/dw_c * w_c, and the raw cotangent, out(s, d, dsig): d
// [3] the rgb logits' through the sigmoid (masked by B4's colour ReLU),
// dsig d sigma. raw [S][4] and lt [S] (each sample's log-transmittance
// before it) as composite() left them; out may overwrite sample s's raw
// lanes, which are read before it.
template <typename A, bool EXT, typename Out>
__device__ __forceinline__ void ray_reverse(const float* raw, const float* __restrict__ lt, int S,
                                            const float* __restrict__ zr, const float* __restrict__ dr,
                                            const float* __restrict__ nz, int white, float c0, float c1, float c2,
                                            long long ray, const float* __restrict__ target,
                                            const float* __restrict__ gct, float loss_scale,
                                            float* __restrict__ sqerr_out, Out&& out) {
  float g0, g1, g2, gacc, gdep = 0.f;
  if (EXT) {
    // B9: the caller's cotangent (render_fused.py:428-440): d loss /
    // d rgb_map after the white background, d acc and d depth. White:
    // rgb_map holds + (1 - acc), so d / d acc also takes -sum_c.
    const float* gr = gct + ray * 5;
    g0 = gr[0];
    g1 = gr[1];
    g2 = gr[2];
    gacc = white ? gr[3] - ((g0 + g1) + g2) : gr[3];
    gdep = gr[4];
  } else {
    const float e0 = c0 - target[ray * 3 + 0];
    const float e1 = c1 - target[ray * 3 + 1];
    const float e2 = c2 - target[ray * 3 + 2];
    sqerr_out[ray] = (e0 * e0 + e1 * e1) + e2 * e2;
    // d loss / d rgb_map = loss_scale * 2 * err; white: d / d acc = -sum_c.
    const float gs = loss_scale * 2.f;
    g0 = gs * e0;
    g1 = gs * e1;
    g2 = gs * e2;
    gacc = white ? -((g0 + g1) + g2) : 0.f;
  }
  float suff = 0.f;  // sum over later samples of dL/dw_c * w_c
  for (int s = S - 1; s >= 0; --s) {
    const float* rw = raw + s * 4;
    const float sigma = nz ? rw[3] + nz[s] : rw[3];
    const float ex = expf(-fmaxf(sigma, 0.f) * dr[s]);
    const float alpha = 1.f - ex;
    const float safe = fmaxf(1.f - alpha + 1e-10f, 1e-10f);
    const float tr = expf(lt[s]);
    const float w = alpha * tr;
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rgb_of<A>(rw[c]);
    float dldw = ((g0 * rgb[0] + g1 * rgb[1]) + g2 * rgb[2]) + gacc;
    if (EXT) dldw += gdep * zr[s];  // depth = sum_s w_s z_s
    const float dalpha = dldw * tr - suff / safe;
    suff += dldw * w;
    const float dsig = sigma > 0.f ? dalpha * dr[s] * ex : 0.f;
    const float gcol[3] = {g0, g1, g2};
    float d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d[c] = w * gcol[c] * rgb[c] * (1.f - rgb[c]);
      if (A::RGB_RELU && !(rw[c] > 0.f)) d[c] = 0.f;  // the colour ReLU's mask
    }
    out(s, d, dsig);
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
template <typename T, typename A, bool PTS = false, bool VEMB = true, typename Tile = TileT<T>>
__device__ __forceinline__ void encode_chunk(typename Tile::S* __restrict__ emb, typename Tile::S* __restrict__ vemb_s,
                                             int row0, int rows,
                                             long long ray0, int S, int L, int cv,
                                             const float* __restrict__ origins, const float* __restrict__ dirs,
                                             const float* __restrict__ times, const float* __restrict__ z,
                                             const float* __restrict__ vemb) {
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
    for (int a = 0; a < 3; ++a) Tile::put(emb, a, r, x[a]);
    if (A::TIME) Tile::put(emb, dpos, r, t);
    for (int k = A::cin(L); k < A::CIN; ++k) Tile::put(emb, k, r, 0.f);
  }
  for (int f = p; f < L; f += 4) {
    const float scale = (float)(1 << f);  // exact: x * 2^f rounds nothing
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float u = x[a] * scale;
      Tile::put(emb, 3 + 6 * f + a, r, sinf(u));
      Tile::put(emb, 6 + 6 * f + a, r, cosf(u));
    }
    if (A::TIME) {
      const float u = t * scale;
      Tile::put(emb, dpos + 1 + 2 * f, r, sinf(u));
      Tile::put(emb, dpos + 2 + 2 * f, r, cosf(u));
    }
  }
  if (VEMB)
    for (int k = p; k < A::CV; k += 4)
      Tile::put(vemb_s, k, r, (valid && k < cv) ? vemb[ray * cv + k] : 0.f);
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

// ---- mm_ring: the SIMT chunk product on an asynchronous weight ring ----

constexpr int RT = 8;          // weight rows per ring tile
constexpr int RSTAGES = 3;     // tiles in flight
constexpr int NTR = NT + 128;  // threads of a ring block: two consumer warpgroups, then the producer warpgroup

// The consumers' barrier: the producer warpgroup never waits on it.
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Floats of the packed weights the products read, layer 0 through the
// view layer's view rows (render_pass.py::weight_layout); the rgb head's
// 3 columns follow them.
__host__ __device__ constexpr long long ring_weight_floats(int W, int D, int cin_pad, int cv_pad) {
  return 2LL * cin_pad * W + (long long)D * W * W + W + (long long)W * (W / 2) + (long long)cv_pad * (W / 2);
}

// Shared memory of a ring block before its per-sample lanes: the head
// reduction, the ring, two activation tiles, the embeddings' tiles (fp32,
// CH floats a feature) and the ring's 2 x RSTAGES mbarriers.
template <int W, typename A>
constexpr size_t ring_tiles_bytes() {
  return sizeof(float) * ((size_t)NRED + (size_t)RSTAGES * RT * W + (size_t)(2 * W + A::CIN + A::CV) * CH) +
         2 * RSTAGES * sizeof(uint64_t);
}

// render_loss.cu's train-mode block: a unit's raw lanes twice (4 floats a
// sample; the compositor reads one unit's while the consumers write the
// next's) and its log-transmittances (padded to 4 floats, so the tiles
// after them stay 16-byte aligned), the ring block's tiles, and the two
// buffers' full and empty mbarriers.
template <int W, typename A>
size_t ring_render_smem(int S) {
  const int lanes = (S < CH ? CH / S : 1) * S;
  return sizeof(float) * ((size_t)8 * lanes + pad4(lanes)) + ring_tiles_bytes<W, A>() + 4 * sizeof(uint64_t);
}

// The most samples per ray (at most 1024) whose train-mode block fits
// SMEM_OPTIN for the family of tnerf / wide at width W (128 or 256; else 0):
// binding only for the wide family at W=256 (225).
inline int ring_max_samples(int tnerf, int wide, int W) {
  if (W != 128 && W != 256) return 0;
  int S = 1024;
  for (; S > 0; --S) {
#define SWNERF_SMEM(AA) (W == 256 ? ring_render_smem<256, AA>(S) : ring_render_smem<128, AA>(S))
    const size_t smem = tnerf ? SWNERF_SMEM(TNerf) : wide ? SWNERF_SMEM(VanillaWide) : SWNERF_SMEM(Vanilla);
#undef SWNERF_SMEM
    if (smem <= SMEM_OPTIN) break;
  }
  return S;
}

// The bf16 operands widened into the fp32 image the ring copies (exact).
__global__ void widen_kernel(const __nv_bfloat16* __restrict__ w, long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __bfloat162float(w[i]);
}

struct WRing {
  float* tiles;     // [RSTAGES][stride]
  uint64_t* full;   // [RSTAGES]: the tile landed
  uint64_t* empty;  // [RSTAGES]: every consumer warp is done with it
  int stride;       // floats a stage: RT * W
  int st, ph;       // the next tile's stage and the parity of its fill
  __device__ __forceinline__ void next() {
    if (++st == RSTAGES) {
      st = 0;
      ph ^= 1;
    }
  }
};

// f(offset, K, NC) for each product of one pass over the field's packed
// weights, in the order the bodies run them: layer 0, the skip layer's
// embedding rows before its h rows, the feature head, then the view layer's
// feature rows and view rows (the alpha head's column between them, and
// the rgb head's after, are read by the heads themselves).
template <int W, typename F>
__device__ __forceinline__ void field_segments(int D, int skip, int cin_pad, int cv_pad, F&& f) {
  long long off = 0;
  auto seg = [&](int k, int nc) {
    f(off, k, nc);
    off += (long long)k * nc;
  };
  seg(cin_pad, W);
  for (int i = 1; i < D; ++i) {
    if (i == skip + 1) seg(cin_pad, W);
    seg(W, W);
  }
  seg(W, W);
  off += W;
  seg(W, W / 2);
  seg(cv_pad, W / 2);
}

// The producer (one thread): every tile of ``passes`` passes over the
// field, each RT rows of a [K][NC] product (contiguous in the image: one
// bulk copy of RT * NC floats), into the next stage once every consumer
// warp has released it; then it waits until the consumers release the last
// tiles, so no copy is in flight when it leaves.
template <int W>
__device__ void produce_field(const float* __restrict__ img, int D, int skip, int cin_pad, int cv_pad, int passes,
                              WRing& r) {
  for (int p = 0; p < passes; ++p)
    field_segments<W>(D, skip, cin_pad, cv_pad, [&](long long off, int k, int nc) {
      const uint32_t bytes = (uint32_t)(RT * nc * sizeof(float));
      for (int k0 = 0; k0 < k; k0 += RT) {
        tc::mbar_wait(&r.empty[r.st], r.ph ^ 1);
        tc::mbar_expect_tx(&r.full[r.st], bytes);
        tc::bulk_load(tc::smem_u32(r.tiles + r.st * r.stride), img + off + (long long)k0 * nc, bytes, &r.full[r.st]);
        r.next();
      }
    });
  for (int i = 0; i < RSTAGES; ++i) {
    tc::mbar_wait(&r.empty[r.st], r.ph ^ 1);
    r.next();
  }
}

// A thread's columns of an NC-wide product: V = min(NC/32, 4) contiguous
// columns per 16- (or 8-) byte load, run q of them at q*32*V + lane*V, so a
// warp's load covers 32*V contiguous floats (no bank conflict). Column j of
// the thread's accumulators is q*32*V + lane*V + c for j = q*V + c.
template <int NC>
__device__ __forceinline__ int ring_col(int j, int lane) {
  constexpr int V = NC / 32 < 4 ? NC / 32 : 4;
  return (j / V) * 32 * V + lane * V + j % V;
}

// acc[i][j] = fmaf(A[k][row_i], Wimg[k][col_j], acc[i][j]) for k = 0 ..
// K-1 in order (K a multiple of RT): A an fp32 TileF tile, the weight rows
// from the ring, consumed in the order the producer sends them.
template <int NC>
__device__ __forceinline__ void mm_ring(float (&acc)[8][NC / 32], const float* __restrict__ A, int K, WRing& r) {
  constexpr int CPT = NC / 32;
  constexpr int V = CPT < 4 ? CPT : 4;
  static_assert(V == 4 || V == 2, "64 to 256 columns");
  static_assert(RT % 4 == 0, "whole runs of four k share a swizzle");
  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll 1  // a tile at a time: unrolled at the narrow pads' constant K, the loads of every tile go live at once
  for (int k0 = 0; k0 < K; k0 += RT) {
    tc::mbar_wait(&r.full[r.st], r.ph);
    const float* ws = r.tiles + r.st * r.stride + lane * V;
#pragma unroll
    for (int k4 = 0; k4 < RT; k4 += 4) {
      const int o0 = ((2 * ty) ^ swz(k0 + k4)) << 2;  // rows ty*8 .. +3; o0 ^ 4: rows +4 .. +7
      const float* ak = A + (k0 + k4) * CH;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(ak + kk * CH + o0);
        const float4 a1 = *reinterpret_cast<const float4*>(ak + kk * CH + (o0 ^ 4));
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float w[CPT];
#pragma unroll
        for (int q = 0; q < CPT / V; ++q) {
          const float* wq = ws + (k4 + kk) * NC + q * 32 * V;
          if constexpr (V == 4) {
            const float4 v = *reinterpret_cast<const float4*>(wq);
            w[q * 4] = v.x;
            w[q * 4 + 1] = v.y;
            w[q * 4 + 2] = v.z;
            w[q * 4 + 3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(wq);
            w[q * 2] = v.x;
            w[q * 2 + 1] = v.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&r.empty[r.st]);
    r.next();
  }
}

__device__ __forceinline__ void gput(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void gput(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void gput(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void gput(__nv_bfloat16* p, float a, float b, float c, float d) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = u;
}

// The layer's outputs q(act(acc + bias)), as store_act forms them, into the
// fp32 TileF tile out (8 rows of a column: two 16-byte stores) and, with g,
// into rows p0 + row of a row-major [.][ld] buffer in the operand type
// (rows < nvalid; V contiguous columns a store; with ones, column NC of each
// row is 1): the spill, straight from the registers. acc is overwritten.
template <typename T, int NC, Act A>
__device__ __forceinline__ void store_ring(float (&acc)[8][NC / 32], const float* __restrict__ bias,
                                           float* __restrict__ out, T* __restrict__ g, int ld, long long p0,
                                           int nvalid, bool ones) {
  constexpr int CPT = NC / 32;
  constexpr int V = CPT < 4 ? CPT : 4;
  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int col = ring_col<NC>(j, lane);
    const float b = bias[col];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = Op<T>::f(Op<T>::q(act<A>(acc[i][j] + b)));
    float* o = out + col * CH;
    const int sc = swz(col);
    *reinterpret_cast<float4*>(o + (((2 * ty) ^ sc) << 2)) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(o + (((2 * ty + 1) ^ sc) << 2)) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
  if (g == nullptr) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (ty * 8 + i >= nvalid) break;
    T* gr = g + (p0 + ty * 8 + i) * ld + lane * V;
#pragma unroll
    for (int q = 0; q < CPT / V; ++q) {
      if constexpr (V == 4)
        gput(gr + q * 128, acc[i][q * 4], acc[i][q * 4 + 1], acc[i][q * 4 + 2], acc[i][q * 4 + 3]);
      else
        gput(gr + q * 64, acc[i][q * 2], acc[i][q * 2 + 1]);
    }
  }
  if (ones && lane < 8 && ty * 8 + lane < nvalid) g[(p0 + ty * 8 + lane) * ld + NC] = Op<T>::q(1.f);
}

}  // namespace
