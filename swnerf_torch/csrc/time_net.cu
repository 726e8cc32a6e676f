// The D-NeRF deformation MLP (kernel B6) for Hopper: the forward dx, and the
// backward to every parameter gradient.
//
// Replaces swnerf_tpu/ops/pallas/raymarch.py::_fwd_kernel_plain (:470) and
// _bwd_kernel_plain (:480), reached through fused_time_net (:819) and its
// custom VJP (_plain_call, :925-948): dx = MLP([embed(x) | embed(t)]), D
// ReLU layers of width W, the skip layer taking embed(x) only (the packed
// embed(t) rows of its embedding block are zero, ops/kernels/time_net.py::
// pack_time_params), and a 3-wide linear head. The Pallas kernel takes the
// embedded rows from HBM; this one encodes in-block from the positions
// pts [N, S, 3] and the per-ray times [N] (encode_xt below), with Lx
// position and Lt time frequencies: 3 + 6 Lx + 1 + 2 Lt live columns, padded
// to CIN rows. CIN = 96 holds D-NeRF's multires 10 (84 columns) and the
// MultiRes levels (10, 4) (72) and the identity level (Lx = Lt = 0: [x | t],
// 4); CIN = 144 holds MultiRes level 0's (20, 8) (140). Each keeps a row for
// the dW column of ones. That in-block encode is also what B11
// (raymarch.py::_fwd_kernel_plain_raw :505, fused_time_net_pts :851)
// computes, so B11's forward is B6's launch. The product callers feed the
// positions detached (fused_step.py:478-481, 499-503; models/dnerf.py:264-268)
// and form no input cotangent: time_net_bwd_launch. B11's backward
// (_bwd_kernel_plain_raw :519, need_input_grads) is
// time_net_bwd_din_launch: the same sweep, which also forms the embedding's
// cotangent demb = dz_{skip+1} W_emb^T + dz_0 W_0^T over the live
// [embed(x) | embed(t)] columns in fp32 (the skip's embed(t) rows are zero,
// so the position columns take two contributions and the time columns one),
// then encode_xt_bwd_kernel chains it through the encode to d pts [M, 3]
// and per-row d t, and ray_sum_kernel adds those over each ray's S samples,
// in order, into d times [N]. The plain twin is
// swnerf_torch/ops/kernels/time_net.py::time_net_plain / time_net_plain_bwd
// (need_input_grads for B11).
//
// Bound on the card: operations. At D=8, W=256, 84 input columns the
// forward is 497,152 multiply-adds per row and the backward's dW and dH
// products about twice that, against 16 bytes of input per row. Design:
//  1. The forward in bf16 (both modes): time_net_tc_kernel on the tensor
//     cores (tc_chunk.cuh): a persistent grid over 128-row chunks, bf16
//     wgmma into fp32 accumulators, the weights (an image of 1.05 MB, 1.12 MB
//     at 144 input rows) streamed by a producer warpgroup through a ring of
//     32 KB slabs, about 8.2 KB per row from L2; activations in place in
//     shared memory; the 3-wide head an m64n8 product. In fp32 (the parity
//     mode) time_net_fwd_kernel: one 256-thread block per 64-row chunk, B3's
//     SIMT chunk product (weights streamed from L2 through a 16-row shared
//     tile, activations ping-pong in shared memory) and the head as three
//     dots per row. With a scratch buffer (train mode) either spills the
//     embedding and every layer's output, each with a column of ones, as B1
//     does.
//  2. time_net_bwd_launch, once the cotangent g = d loss / d dx is known:
//     dW_out = h_{D-1}^T q(g), db_out = sum(g) in fp32 (as _trunk_backward's
//     jnp.sum(g)), dz_{D-1} = q((q(g) W_out^T) * [h_{D-1} > 0]), then B1's
//     trunk sweep (gemm_common.cuh::trunk_reverse): fixed-order dW splits,
//     no atomics, bit-equal repeats. In bf16 each layer's dW and dH run on
//     the tensor cores (tc_gemm.cuh; the bias rows as dz's fp32 column
//     sums), and so, in B11's backward (time_net_bwd_din_launch), does
//     demb: tc_demb's product over the whole 96- or 144-column pad (one
//     m64n96 or m64n144 wgmma per k16 step; the pad rows of W_emb and W_0
//     are zero), the skip layer's stored in fp32, layer 0's added to it,
//     the live columns kept. The 3-wide head's products and the fp32
//     parity mode keep gemm_kernel's SIMT product.
// Operands fp32 (parity mode) or bf16, rounded where the plain twin rounds
// (the embedding, each layer's output, q(g), every dz); products accumulate
// in fp32; gradients are fp32. No
// --use_fast_math (ops/kernels/build.py): at Lx = 20 the encode's arguments
// reach 2^19 |x|, where sinf/cosf take their slow, exact reduction path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "gemm_common.cuh"
#include "mlp_common.cuh"
#include "tc_chunk.cuh"

namespace {

__host__ __device__ int cin_of(int Lx, int Lt) { return 3 + 6 * Lx + 1 + 2 * Lt; }

// Positions and per-ray times of rows row0 .. row0+CH-1 into shared memory
// (k-major), in positional_encoding's order: x, then sin(2^f x), cos(2^f x)
// at 3 + 6f and 6 + 6f for f < Lx; t at dpos = 3 + 6 Lx, then sin(2^f t),
// cos(2^f t) at dpos + 1 + 2f and dpos + 2 + 2f for f < Lt. The columns from
// cin_of(Lx, Lt) to CIN are zero; rows past M get x = t = 0. sin and cos are
// sinf/cosf of the exact product x * 2^f (no fast math).
template <typename T, int CIN>
__device__ __forceinline__ void encode_xt(T* __restrict__ emb, int row0, int M, int S, int Lx, int Lt,
                                          const float* __restrict__ pts, const float* __restrict__ times) {
  constexpr int LDA = Op<T>::LDA;
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;  // 4 parts share a row
  const int g = row0 + r;
  const int dpos = 3 + 6 * Lx;
  float x[3] = {0.f, 0.f, 0.f};
  float t = 0.f;
  if (g < M) {
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = pts[(size_t)g * 3 + a];
    t = times[g / S];
  }
  if (p == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) emb[a * LDA + r] = Op<T>::q(x[a]);
    emb[dpos * LDA + r] = Op<T>::q(t);
    for (int k = cin_of(Lx, Lt); k < CIN; ++k) emb[k * LDA + r] = Op<T>::q(0.f);
  }
  for (int f = p; f < Lx; f += 4) {
    const float scale = (float)(1 << f);  // exact: x * 2^f rounds nothing
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float u = x[a] * scale;
      emb[(3 + 6 * f + a) * LDA + r] = Op<T>::q(sinf(u));
      emb[(6 + 6 * f + a) * LDA + r] = Op<T>::q(cosf(u));
    }
  }
  for (int f = p; f < Lt; f += 4) {
    const float u = t * (float)(1 << f);
    emb[(dpos + 1 + 2 * f) * LDA + r] = Op<T>::q(sinf(u));
    emb[(dpos + 2 + 2 * f) * LDA + r] = Op<T>::q(cosf(u));
  }
}

template <typename T, int W, int CIN, bool STORE>
__global__ void __launch_bounds__(NT)
time_net_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ times, const T* __restrict__ wts,
                    const float* __restrict__ bias, int D, int skip, int Lx, int Lt, int S, int M,
                    float* __restrict__ dx_out, T* __restrict__ emb_g, T* __restrict__ h_g, size_t hstride) {
  constexpr int LDA = Op<T>::LDA;
  constexpr int LDW = W + PADC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row0 = blockIdx.x * CH;
  const int nvalid = min(CH, M - row0);

  float* red = reinterpret_cast<float*>(smem_raw);  // [4][CH][3]
  T* actA = reinterpret_cast<T*>(red + NRED);        // [W][LDA]
  T* actB = actA + W * LDA;                          // [W][LDA]
  T* emb = actB + W * LDA;                           // [CIN][LDA]
  T* Ws = emb + CIN * LDA;                           // [KT][W]
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;

  // Rows are global: ray = row / S, the positions at pts[row].
  encode_xt<T, CIN>(emb, row0, M, S, Lx, Lt, pts, times);
  if (STORE) {
    __syncthreads();
    spill<T>(emb, cin_of(Lx, Lt), emb_g, CIN, row0, nvalid, true);
  }
  const T* wp = wts;
  const float* bp = bias;
  T* h = actA;
  T* g = actB;
  {
    float acc[8][W / 32];
    zero(acc);
    mm_acc<T, W>(acc, emb, CIN, wp, Ws);
    wp += CIN * W;
    store_act<T, W, Act::Relu>(acc, bp, h);
    bp += W;
    if (STORE) {
      __syncthreads();
      spill<T>(h, W, h_g, LDW, row0, nvalid, true);
    }
  }
  for (int i = 1; i < D; ++i) {
    float acc[8][W / 32];
    zero(acc);
    if (i == skip + 1) {  // cat([embed(x), h]) @ W == emb @ W_emb + h @ W_h (W_emb's time rows are 0)
      mm_acc<T, W>(acc, emb, CIN, wp, Ws);
      wp += CIN * W;
    }
    mm_acc<T, W>(acc, h, W, wp, Ws);
    wp += W * W;
    store_act<T, W, Act::Relu>(acc, bp, g);
    bp += W;
    T* t = h;
    h = g;
    g = t;
    if (STORE) {
      __syncthreads();
      spill<T>(h, W, h_g + i * hstride, LDW, row0, nvalid, true);
    }
  }
  __syncthreads();
  {  // the head: three dots of length W per row, 4 threads per row
    float s[3] = {0.f, 0.f, 0.f};
    for (int k = p; k < W; k += 4) {
      const float hv = Op<T>::f(h[k * LDA + r]);
#pragma unroll
      for (int c = 0; c < 3; ++c) s[c] = fmaf(hv, Op<T>::f(wp[k * 3 + c]), s[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) red[(p * CH + r) * 3 + c] = s[c];
    __syncthreads();
    if (p == 0 && r < nvalid) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        dx_out[(size_t)(row0 + r) * 3 + c] = ((red[r * 3 + c] + red[(CH + r) * 3 + c]) + red[(2 * CH + r) * 3 + c]) +
                                             red[(3 * CH + r) * 3 + c] + bp[c];
    }
  }
}

// encode_xt for the tensor-core forward: the 64 rows of one consumer
// warpgroup (tid 0..127, two threads a row) into its swizzled tile (columns
// cin .. atoms(CIN) * 64 zero), in encode_xt's order and arithmetic. With
// eg (train mode) each valid row's cin rounded columns, then a 1, also go
// to eg [M][CIN].
template <int CIN>
__device__ __forceinline__ void encode_xt_tile(unsigned char* emb, int tid, int row0, int M, int S, int Lx, int Lt,
                                               const float* __restrict__ pts, const float* __restrict__ times,
                                               __nv_bfloat16* __restrict__ eg) {
  const int r = tid & 63;
  const int part = tid >> 6;  // two threads share a row
  const int g = row0 + r;
  const int dpos = 3 + 6 * Lx;
  const int cin = cin_of(Lx, Lt);
  float x[3] = {0.f, 0.f, 0.f};
  float t = 0.f;
  __nv_bfloat16* e = nullptr;
  if (g < M) {
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = pts[(size_t)g * 3 + a];
    t = times[g / S];
    if (eg != nullptr) e = eg + (size_t)g * CIN;
  }
  auto col = [&](int c, float v) {
    const __nv_bfloat16 q = tc::put(emb, r, c, v);
    if (e != nullptr) e[c] = q;
  };
  if (part == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) col(a, x[a]);
    col(dpos, t);
  } else {
    for (int c = cin; c < tc::atoms(CIN) * 64; ++c) tc::put(emb, r, c, 0.f);
    if (e != nullptr) e[cin] = __float2bfloat16_rn(1.f);
  }
  for (int f = part; f < Lx; f += 2) {
    const float scale = (float)(1 << f);  // exact: x * 2^f rounds nothing
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float u = x[a] * scale;
      col(3 + 6 * f + a, sinf(u));
      col(6 + 6 * f + a, cosf(u));
    }
  }
  for (int f = part; f < Lt; f += 2) {
    const float u = t * (float)(1 << f);
    col(dpos + 1 + 2 * f, sinf(u));
    col(dpos + 2 + 2 * f, cosf(u));
  }
}

// Stages of the weight ring, and the tensor-core forward's shared memory:
// the ring, each consumer's activation and embedding tiles, the barriers.
constexpr int TC_STAGES = 3;

template <int W, int CIN>
constexpr size_t tc_smem() {
  return 1024 + (size_t)TC_STAGES * tc::STAGE_BYTES + 2 * (size_t)(W / 64 + tc::atoms(CIN)) * tc::ATOM_BYTES +
         tc::BAR_BYTES;
}

// B6's forward in bf16 on the tensor cores (tc_chunk.cuh): a persistent
// grid over 128-row chunks; per chunk each consumer warpgroup encodes its 64
// rows, runs the D layers (the skip layer as two products into the same
// accumulators) in place in its activation tile, and the 3-wide head as an
// m64n8 product. With STORE (train mode) the embedding and every layer's
// output, each with its column of ones, also go to the scratch, as
// time_net_fwd_kernel spills them.
template <int W, int CIN, bool STORE>
__global__ void __launch_bounds__(tc::NTHREADS, 1)
time_net_tc_kernel(const float* __restrict__ pts, const float* __restrict__ times, const __grid_constant__ tc::Plan plan,
                   const unsigned char* __restrict__ img, const float* __restrict__ bias, int D, int skip, int Lx,
                   int Lt, int S, int M, float* __restrict__ dx_out, __nv_bfloat16* __restrict__ emb_g,
                   __nv_bfloat16* __restrict__ h_g, size_t hstride, long long* __restrict__ prof) {
  constexpr int LDW = W + PADC;
  constexpr int KE = tc::atoms(CIN);
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned_smem: 1024
  unsigned char* sm = tc::aligned_smem(smem_raw);
  unsigned char* act_s = sm + TC_STAGES * tc::STAGE_BYTES;   // [2][W / 64 atoms]
  unsigned char* emb_s = act_s + 2 * (W / 64) * tc::ATOM_BYTES;  // [2][KE atoms]
  uint64_t* bars = reinterpret_cast<uint64_t*>(emb_s + 2 * KE * tc::ATOM_BYTES);
  tc::init_ring(bars, TC_STAGES);
  const int chunks = (M + tc::ROWS - 1) / tc::ROWS;
  const int wg = threadIdx.x / tc::WGT;

  if (wg == 0) {  // the producer
    tc::set_regs<tc::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int st = 0, ph = 0;
      for (int c = blockIdx.x; c < chunks; c += gridDim.x)
        tc::produce(plan, img, tc::smem_u32(sm), bars, bars + TC_STAGES, TC_STAGES, st, ph);
    }
  } else {
    tc::set_regs<tc::CONSUMER_REGS>();
    const int w = wg - 1;
    const int tid = threadIdx.x - wg * tc::WGT;
    unsigned char* act = act_s + w * (W / 64) * tc::ATOM_BYTES;
    unsigned char* emb = emb_s + w * KE * tc::ATOM_BYTES;
    const uint32_t act_a = tc::smem_u32(act), emb_a = tc::smem_u32(emb);
    tc::Ring ring{tc::smem_u32(sm), bars, bars + TC_STAGES, TC_STAGES, 0, 0, -1};
    const bool timer = prof != nullptr && tid == 0 && w == 0;
    if (timer) tc::start_clock(prof);
    for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
      float acc[W / 2];  // dead, its registers free, outside a layer's products (wgmma_zero)
      const int row0 = c * tc::ROWS + w * 64;
      const int nvalid = max(0, min(64, M - row0));
      encode_xt_tile<CIN>(emb, tid, row0, M, S, Lx, Lt, pts, times, STORE ? emb_g : nullptr);
      tc::publish(w);
      const float* bp = bias;
      for (int i = 0; i < D; ++i) {
        if (i == 0 || i == skip + 1) {
          tc::mma<W, true>(acc, emb_a, CIN, ring);  // cat([embed(x), h]) @ W == emb @ W_emb + h @ W_h
          if (i > 0) tc::mma<W, false>(acc, act_a, W, ring);
        } else {
          tc::mma<W, true>(acc, act_a, W, ring);
        }
        tc::mma_done<W>(acc, ring, w);
        tc::epilogue<W, Act::Relu>(acc, bp, act, tid, STORE ? h_g + i * hstride : nullptr, LDW, row0, nvalid, true);
        tc::publish(w);
        bp += W;
      }
      const long long th = timer ? clock64() : 0;
      {  // the head: an m64n8 product on the zero-padded [W][8] weights
        tc::mma<8, true>(acc, act_a, W, ring);
        tc::mma_done<8>(acc, ring, w);
        const int lane = tid & 31;
        const int r = (tid >> 5) * 16 + (lane >> 2);
        const int c0 = 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (r + 8 * h >= nvalid) continue;
          float* out = dx_out + (size_t)(row0 + r + 8 * h) * 3;
          if (c0 < 3) out[c0] = acc[2 * h] + bp[c0];
          if (c0 + 1 < 3) out[c0 + 1] = acc[2 * h + 1] + bp[c0 + 1];
        }
      }
      if (timer) tc::add_clock(prof, 1, th);
    }
    if (timer) tc::add_clock(prof, 2, 0);
  }
}

// The image of B6's packed weights (tc_chunk.cuh): the trunk, then the head
// [W][3] padded to 8 columns.
tc::Plan time_net_plan(int W, int CIN, int D, int skip) {
  tc::Plan p{};
  const long long o = tc::add_trunk(p, D, skip, CIN, W, CIN);
  tc::add_seg(p, o, W, 3, W, 8);
  return p;
}

// gq[m] = (q(g[m][0..2]), 0): the cotangent in the operand type.
template <typename T>
__global__ void round_cotangent_kernel(const float* __restrict__ g, long long M, T* __restrict__ gq) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * 4) return;
  const long long m = idx / 4;
  const int c = (int)(idx - m * 4);
  gq[idx] = Op<T>::q(c < 3 ? g[m * 3 + c] : 0.f);
}

// The train-mode scratch: the spilled embedding [M][CIN], D layer outputs
// [M][W + PADC], the dz ping-pong [M][W], q(g) [M][4], the split partials.
template <typename T>
struct Scratch {
  T* emb;
  T* h;
  size_t hstride;
  T* dz[2];
  T* gq;
  float* part;
};

template <typename T>
Scratch<T> carve(void* scratch, int CIN, int W, int D, long long M) {
  Carver cv{static_cast<unsigned char*>(scratch)};
  Scratch<T> sc;
  sc.emb = cv.take<T>(M * CIN);
  sc.hstride = align256(sizeof(T) * M * (W + PADC)) / sizeof(T);
  sc.h = cv.take<T>(sc.hstride * D);
  sc.dz[0] = cv.take<T>(M * W);
  sc.dz[1] = cv.take<T>(M * W);
  sc.gq = cv.take<T>(M * 4);
  sc.part = cv.take<float>(part_floats(W));
  return sc;
}

// B11's extra scratch, after the train-mode scratch: demb [M][cin] and the
// per-row d t [M], fp32.
struct DinScratch {
  float* demb;
  float* dt_rows;
};

DinScratch carve_din(void* scratch, size_t base, int cin, long long M) {
  Carver cv{static_cast<unsigned char*>(scratch) + base};
  DinScratch d;
  d.demb = cv.take<float>(M * cin);
  d.dt_rows = cv.take<float>(M);
  return d;
}

template <typename T>
size_t scratch_bytes(int CIN, int W, int D, long long M) {
  size_t b = 0;
  b += align256(sizeof(T) * M * CIN);
  b += align256(sizeof(T) * M * (W + PADC)) * D;
  b += align256(sizeof(T) * M * W) * 2;
  b += align256(sizeof(T) * M * 4);
  b += align256(sizeof(float) * part_floats(W));
  return b;
}

size_t din_scratch_bytes(int cin, long long M) {
  return align256(sizeof(float) * M * cin) + align256(sizeof(float) * M);
}

// B11: d pts [M][3] and the per-row d t [M] from demb [M][cin], the
// cotangent of [embed(x) | embed(t)] (encode_xt's columns): the identity
// columns, then per frequency f the derivative 2^f cos(2^f x) of the sin
// column and -2^f sin(2^f x) of the cos column (raymarch.py::_embed_bwd,
// which takes the latter as 2^f cos(2^f x + pi/2)). One thread per (row,
// lane): lanes 0-2 the position, lane 3 the time.
__global__ void encode_xt_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ times,
                                     const float* __restrict__ demb, int cin, int Lx, int Lt, int S, long long M,
                                     float* __restrict__ dpts, float* __restrict__ dt_rows) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * 4) return;
  const long long m = idx / 4;
  const int a = (int)(idx - m * 4);
  const float* g = demb + m * cin;
  if (a < 3) {
    const float x = pts[m * 3 + a];
    float s = g[a];
    for (int f = 0; f < Lx; ++f) {
      const float scale = (float)(1 << f);  // exact: x * 2^f rounds nothing
      const float u = x * scale;
      s += scale * (cosf(u) * g[3 + 6 * f + a] - sinf(u) * g[6 + 6 * f + a]);
    }
    dpts[m * 3 + a] = s;
  } else {
    const int dpos = 3 + 6 * Lx;
    const float t = times[m / S];
    float s = g[dpos];
    for (int f = 0; f < Lt; ++f) {
      const float scale = (float)(1 << f);
      const float u = t * scale;
      s += scale * (cosf(u) * g[dpos + 1 + 2 * f] - sinf(u) * g[dpos + 2 + 2 * f]);
    }
    dt_rows[m] = s;
  }
}

// d times [N]: each ray's S per-row d t, added in sample order.
__global__ void ray_sum_kernel(const float* __restrict__ dt_rows, int S, int N, float* __restrict__ dtimes) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= N) return;
  const float* r = dt_rows + (size_t)ray * S;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += r[k];
  dtimes[ray] = s;
}

// The fp32 forward (the parity mode): SIMT, 64-row chunks.
template <int W, int CIN>
int fwd(const float* pts, const float* times, const void* wts, const float* bias, int D, int skip, int Lx, int Lt,
        int S, int M, float* dx, void* scratch, void*, long long, cudaStream_t st) {
  using T = float;
  constexpr int LDA = Op<T>::LDA;
  const size_t smem = sizeof(float) * NRED + sizeof(T) * ((size_t)(2 * W + CIN) * LDA + KT * W);
  Scratch<T> sc{};
  if (scratch) sc = carve<T>(scratch, CIN, W, D, M);
  auto kern = scratch ? time_net_fwd_kernel<T, W, CIN, true> : time_net_fwd_kernel<T, W, CIN, false>;
  SWNERF_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  kern<<<ceil_div(M, CH), NT, smem, st>>>(pts, times, static_cast<const T*>(wts), bias, D, skip, Lx, Lt, S, M, dx,
                                          sc.emb, sc.h, sc.hstride);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forward: the weight image into img, then the tensor-core kernel.
template <int W, int CIN>
int fwd_tc(const float* pts, const float* times, const void* wts, const float* bias, int D, int skip, int Lx, int Lt,
           int S, int M, float* dx, void* scratch, void* img, long long img_bytes, cudaStream_t st) {
  using T = __nv_bfloat16;
  const tc::Plan plan = time_net_plan(W, CIN, D, skip);
  if (img == nullptr || img_bytes < plan.bytes) return static_cast<int>(cudaErrorInvalidValue);
  Scratch<T> sc{};
  if (scratch) sc = carve<T>(scratch, CIN, W, D, M);
  SWNERF_CHECK(tc::pack(wts, plan, img, st));
  constexpr size_t smem = tc_smem<W, CIN>();
  auto kern = scratch ? time_net_tc_kernel<W, CIN, true> : time_net_tc_kernel<W, CIN, false>;
  SWNERF_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  kern<<<tc::grid_for(ceil_div(M, tc::ROWS)), tc::NTHREADS, smem, st>>>(
      pts, times, plan, static_cast<const unsigned char*>(img), bias, D, skip, Lx, Lt, S, M, dx, sc.emb, sc.h,
      sc.hstride, tc::g_prof);
  return static_cast<int>(cudaGetLastError());
}

// The backward: the parameter gradients and, with din (B11), demb through
// trunk_reverse, then d pts and d times.
template <typename T>
int bwd(int CIN, int W, const void* wts_v, int D, int skip, int Lx, int Lt, int M, const float* g, float* gw,
        float* gb, void* scratch, cudaStream_t st, const DinScratch* din = nullptr, const float* pts = nullptr,
        const float* times = nullptr, int S = 1, float* dpts = nullptr, float* dtimes = nullptr) {
  const T* wts = static_cast<const T*>(wts_v);
  const int LDW = W + PADC;
  Scratch<T> sc = carve<T>(scratch, CIN, W, D, M);
  auto hl = [&](int i) { return static_cast<const T*>(sc.h + (size_t)i * sc.hstride); };
  size_t off_w[16], off_wemb = 0;
  const size_t off_out = trunk_offsets(D, skip, CIN, W, off_w, &off_wemb);

  round_cotangent_kernel<T><<<ceil_div((long long)M * 4, 256), 256, 0, st>>>(g, M, sc.gq);
  SWNERF_CHECK(cudaGetLastError());
  SWNERF_RUN(gemm_reduce<T>(gemm_args(hl(D - 1), 1, LDW, sc.gq, 4, 1, W, 3, M), sc.part, W, 3,
                            Region{gw + off_out, 3, nullptr}, Region{nullptr, 0, nullptr}, st));
  SWNERF_RUN(colsum(g, 3, 3, M, sc.part, gb + (size_t)D * W, st));
  {  // dz_{D-1} = q((q(g) W_out^T) * [h_{D-1} > 0]); W_out is [W][3]
    GemmArgs a = gemm_args(sc.gq, 4, 1, wts + off_out, 1, 3, M, W, 3);
    a.mask = hl(D - 1);
    a.ldm = LDW;
    a.C = sc.dz[(D - 1) & 1];
    a.ldc = W;
    SWNERF_RUN((gemm_act<T, false>(a, st)));
  }
  const int cin = cin_of(Lx, Lt);
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // bf16: the tensor-core sweep (tc_gemm.cuh), demb too (tc_demb over the
  // 96- or 144-column pad); fp32: gemm_kernel
  SWNERF_RUN((trunk_reverse<T, false, decltype(hl), BF16>(wts, off_w, off_wemb, sc.emb, CIN, cin, hl, sc.dz, D, skip,
                                                          W, M, gw, gb, sc.part, din ? din->demb : nullptr, st)));
  if (din) {
    encode_xt_bwd_kernel<<<ceil_div((long long)M * 4, 256), 256, 0, st>>>(pts, times, din->demb, cin, Lx, Lt, S, M,
                                                                        dpts, din->dt_rows);
    SWNERF_CHECK(cudaGetLastError());
    const int N = M / S;
    ray_sum_kernel<<<ceil_div(N, 256), 256, 0, st>>>(din->dt_rows, S, N, dtimes);
    SWNERF_CHECK(cudaGetLastError());
  }
  return 0;
}

// The padded input widths: D-NeRF's and MultiRes levels 1-3's, and level 0's.
bool cin_pad_ok(int cin_pad) { return cin_pad == 96 || cin_pad == 144; }

bool shape_ok(int cin_pad, int W, int D, int skip, int Lx, int Lt, long long M) {
  // cin < CIN leaves room for the column of ones of the embedding's dW.
  return cin_pad_ok(cin_pad) && (W == 128 || W == 256) && D >= 2 && D <= 16 && skip >= 0 && skip + 1 < D &&
         Lx >= 0 && Lt >= 0 && Lx < 31 && Lt < 31 && cin_of(Lx, Lt) < cin_pad && M * (W + PADC) < (1LL << 31);
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of train-mode scratch for M rows, or -1 for an unsupported shape.
long long time_net_scratch_bytes(int bf16, int cin_pad, int W, int D, long long M) {
  if ((W != 128 && W != 256) || !cin_pad_ok(cin_pad)) return -1;
  return (long long)(bf16 ? scratch_bytes<__nv_bfloat16>(cin_pad, W, D, M) : scratch_bytes<float>(cin_pad, W, D, M));
}

// Bytes of the bf16 forward's weight image (time_net_plan); 0 in fp32, whose
// forward runs the SIMT body, or for an unsupported shape.
long long time_net_image_bytes(int bf16, int cin_pad, int W, int D, int skip) {
  if (!bf16 || (W != 128 && W != 256) || !cin_pad_ok(cin_pad)) return 0;
  return time_net_plan(W, cin_pad, D, skip).bytes;
}

// dx [N*S, 3] of the deformation MLP at pts [N, S, 3] and per-ray times
// [N], with Lx position and Lt time frequencies (0: the identity); wts /
// bias: the packed buffers of ops/kernels/time_net.py::pack_time_params,
// input padded to cin_pad (96 or 144) rows (bf16 != 0: bf16 operands, else
// fp32). scratch (train mode, time_net_scratch_bytes) or null: with it the
// forward keeps what the backward needs. img: img_bytes of scratch for the
// bf16 forward's weight image (time_net_image_bytes; null in
// fp32). All contiguous.
int time_net_fwd_launch(int bf16, int W, int cin_pad, const float* pts, const float* times, const void* wts,
                        const float* bias, int D, int skip, int Lx, int Lt, int N, int S, float* dx, void* scratch,
                        void* img, long long img_bytes, void* stream) {
  const long long M = (long long)N * S;
  if (M == 0) return 0;
  if (!shape_ok(cin_pad, W, D, skip, Lx, Lt, M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_FWD(F, WW, CC) \
  F<WW, CC>(pts, times, wts, bias, D, skip, Lx, Lt, S, (int)M, dx, scratch, img, img_bytes, st)
  if (cin_pad == 96) {
    if (bf16) return W == 256 ? SWNERF_FWD(fwd_tc, 256, 96) : SWNERF_FWD(fwd_tc, 128, 96);
    return W == 256 ? SWNERF_FWD(fwd, 256, 96) : SWNERF_FWD(fwd, 128, 96);
  }
  if (bf16) return W == 256 ? SWNERF_FWD(fwd_tc, 256, 144) : SWNERF_FWD(fwd_tc, 128, 144);
  return W == 256 ? SWNERF_FWD(fwd, 256, 144) : SWNERF_FWD(fwd, 128, 144);
#undef SWNERF_FWD
}

// The parameter gradients of sum(g * dx) for the cotangent g [M, 3] (fp32),
// from the scratch of the train-mode forward on the same weights: gw / gb
// in the packed layouts, which the caller zeroes.
int time_net_bwd_launch(int bf16, int W, int cin_pad, const void* wts, int D, int skip, int Lx, int Lt, long long M,
                        const float* g, float* gw, float* gb, void* scratch, void* stream) {
  if (M == 0) return 0;
  if (!shape_ok(cin_pad, W, D, skip, Lx, Lt, M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(cin_pad, W, wts, D, skip, Lx, Lt, (int)M, g, gw, gb, scratch, st)
              : bwd<float>(cin_pad, W, wts, D, skip, Lx, Lt, (int)M, g, gw, gb, scratch, st);
}

// With a device buffer of 3 x (blocks) int64, the next bf16 forwards
// record per block the clock cycles of the head and of the whole block
// (tc_chunk.cuh::g_prof); null stops it.
void time_net_profile(void* buf) { tc::g_prof = static_cast<long long*>(buf); }

// B11's scratch: time_net_scratch_bytes' and demb, d t, or -1.
long long time_net_din_scratch_bytes(int bf16, int cin_pad, int W, int D, int Lx, int Lt, long long M) {
  const long long base = time_net_scratch_bytes(bf16, cin_pad, W, D, M);
  if (base < 0) return -1;
  return base + (long long)din_scratch_bytes(cin_of(Lx, Lt), M);
}

// B11's backward (fused_time_net_pts with need_input_grads): as
// time_net_bwd_launch, after a train-mode forward on a scratch of
// time_net_din_scratch_bytes, and also d pts [N, S, 3] and d times [N] of
// sum(g * dx), fp32, at the forward's pts [N, S, 3] and times [N].
int time_net_bwd_din_launch(int bf16, int W, int cin_pad, const void* wts, int D, int skip, int Lx, int Lt, int N,
                            int S, const float* pts, const float* times, const float* g, float* gw, float* gb,
                            float* dpts, float* dtimes, void* scratch, void* stream) {
  const long long M = (long long)N * S;
  if (M == 0) return 0;
  if (!shape_ok(cin_pad, W, D, skip, Lx, Lt, M) || (long long)M * cin_pad >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t base = (size_t)time_net_scratch_bytes(bf16, cin_pad, W, D, M);
  const DinScratch din = carve_din(scratch, base, cin_of(Lx, Lt), M);
  return bf16 ? bwd<__nv_bfloat16>(cin_pad, W, wts, D, skip, Lx, Lt, (int)M, g, gw, gb, scratch, st, &din, pts, times,
                                   S, dpts, dtimes)
              : bwd<float>(cin_pad, W, wts, D, skip, Lx, Lt, (int)M, g, gw, gb, scratch, st, &din, pts, times, S,
                           dpts, dtimes);
}

}  // extern "C"
