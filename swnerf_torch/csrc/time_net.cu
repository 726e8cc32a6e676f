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
// pts [N, S, 3] and the per-ray times [N], with B4's [embed(xyz) |
// embed(t)] layout (84 live columns of 96 at multires 10; the TimeNet traits
// of mlp_common.cuh). That in-block encode is also what B11
// (fused_time_net_pts) computes. The input cotangent is not formed: every
// caller feeds the positions detached (fused_step.py:478-481, 499-503). The
// plain twin is swnerf_torch/ops/kernels/time_net.py::time_net_plain /
// time_net_plain_bwd.
//
// Bound on the card: operations. At D=8, W=256, 84 input columns the
// forward is 497,152 multiply-adds per row and the backward's dW and dH
// products about twice that, against 16 bytes of input per row. Design:
//  1. time_net_fwd_kernel: one 256-thread block per 64-row chunk, B3's chunk
//     product (weights streamed from L2 through a 16-row shared tile,
//     activations ping-pong in shared memory) and the 3-wide head as three
//     dots per row. With a scratch buffer (train mode) it spills the
//     embedding and every layer's output, each with a column of ones, as B1
//     does.
//  2. time_net_bwd_launch, once the cotangent g = d loss / d dx is known:
//     dW_out = h_{D-1}^T q(g), db_out = sum(g) in fp32 (as _trunk_backward's
//     jnp.sum(g)), dz_{D-1} = q((q(g) W_out^T) * [h_{D-1} > 0]), then B1's
//     trunk sweep (gemm_common.cuh::trunk_reverse): fixed-order dW splits,
//     no atomics, bit-equal repeats.
// Operands fp32 (parity mode) or bf16, rounded where the plain twin rounds
// (the embedding, each layer's output, q(g), every dz); products accumulate
// in fp32; gradients are fp32. SIMT only: mma/wgmma are later work. No
// --use_fast_math (ops/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gemm_common.cuh"
#include "mlp_common.cuh"

namespace {

using Net = TimeNet;

template <typename T, int W, bool STORE>
__global__ void __launch_bounds__(NT)
time_net_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ times, const T* __restrict__ wts,
                    const float* __restrict__ bias, int D, int skip, int L, int S, int M, float* __restrict__ dx_out,
                    T* __restrict__ emb_g, T* __restrict__ h_g, size_t hstride) {
  constexpr int LDA = Op<T>::LDA;
  constexpr int LDW = W + PADC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row0 = blockIdx.x * CH;
  const int nvalid = min(CH, M - row0);

  float* red = reinterpret_cast<float*>(smem_raw);  // [4][CH][3]
  T* actA = reinterpret_cast<T*>(red + NRED);        // [W][LDA]
  T* actB = actA + W * LDA;                          // [W][LDA]
  T* emb = actB + W * LDA;                           // [Net::CIN][LDA]
  T* vemb_s = emb + Net::CIN * LDA;                  // [CV][LDA] (unused: no view input)
  T* Ws = vemb_s + CV * LDA;                         // [KT][W]
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;

  // Rows are global: ray = row / S, the positions at pts[row].
  encode_chunk<T, Net, true>(emb, vemb_s, row0, M, 0, S, L, 0, pts, nullptr, times, nullptr, nullptr);
  if (STORE) {
    __syncthreads();
    spill<T>(emb, Net::cin(L), emb_g, Net::CIN, row0, nvalid, true);
  }
  const T* wp = wts;
  const float* bp = bias;
  T* h = actA;
  T* g = actB;
  {
    float acc[8][W / 32];
    zero(acc);
    mm_acc<T, W>(acc, emb, Net::CIN, wp, Ws);
    wp += Net::CIN * W;
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
      mm_acc<T, W>(acc, emb, Net::CIN, wp, Ws);
      wp += Net::CIN * W;
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
Scratch<T> carve(void* scratch, int W, int D, long long M) {
  Carver cv{static_cast<unsigned char*>(scratch)};
  Scratch<T> sc;
  sc.emb = cv.take<T>(M * Net::CIN);
  sc.hstride = align256(sizeof(T) * M * (W + PADC)) / sizeof(T);
  sc.h = cv.take<T>(sc.hstride * D);
  sc.dz[0] = cv.take<T>(M * W);
  sc.dz[1] = cv.take<T>(M * W);
  sc.gq = cv.take<T>(M * 4);
  sc.part = cv.take<float>(part_floats(W));
  return sc;
}

template <typename T>
size_t scratch_bytes(int W, int D, long long M) {
  size_t b = 0;
  b += align256(sizeof(T) * M * Net::CIN);
  b += align256(sizeof(T) * M * (W + PADC)) * D;
  b += align256(sizeof(T) * M * W) * 2;
  b += align256(sizeof(T) * M * 4);
  b += align256(sizeof(float) * part_floats(W));
  return b;
}

template <typename T, int W>
int fwd(const float* pts, const float* times, const void* wts, const float* bias, int D, int skip, int L, int S, int M,
        float* dx, void* scratch, cudaStream_t st) {
  constexpr int LDA = Op<T>::LDA;
  const size_t smem = sizeof(float) * NRED + sizeof(T) * ((size_t)(2 * W + Net::CIN + CV) * LDA + KT * W);
  Scratch<T> sc{};
  if (scratch) sc = carve<T>(scratch, W, D, M);
  auto kern = scratch ? time_net_fwd_kernel<T, W, true> : time_net_fwd_kernel<T, W, false>;
  SWNERF_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  kern<<<ceil_div(M, CH), NT, smem, st>>>(pts, times, static_cast<const T*>(wts), bias, D, skip, L, S, M, dx, sc.emb,
                                          sc.h, sc.hstride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(int W, const void* wts_v, int D, int skip, int L, int M, const float* g, float* gw, float* gb, void* scratch,
        cudaStream_t st) {
  const T* wts = static_cast<const T*>(wts_v);
  const int LDW = W + PADC;
  Scratch<T> sc = carve<T>(scratch, W, D, M);
  auto hl = [&](int i) { return static_cast<const T*>(sc.h + (size_t)i * sc.hstride); };
  size_t off_w[16], off_wemb = 0;
  const size_t off_out = trunk_offsets(D, skip, Net::CIN, W, off_w, &off_wemb);

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
  return trunk_reverse<T, false>(wts, off_w, off_wemb, sc.emb, Net::CIN, Net::cin(L), hl, sc.dz, D, skip, W, M, gw, gb,
                                 sc.part, nullptr, st);
}

bool shape_ok(int W, int D, int skip, int L, long long M) {
  // cin < CIN leaves room for the column of ones of the embedding's dW.
  return (W == 128 || W == 256) && D >= 2 && D <= 16 && skip >= 0 && skip + 1 < D && Net::cin(L) < Net::CIN &&
         M * (W + PADC) < (1LL << 31);
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of train-mode scratch for M rows, or -1 for an unsupported shape.
long long time_net_scratch_bytes(int bf16, int W, int D, long long M) {
  if (W != 128 && W != 256) return -1;
  return (long long)(bf16 ? scratch_bytes<__nv_bfloat16>(W, D, M) : scratch_bytes<float>(W, D, M));
}

// dx [N*S, 3] of the deformation MLP at pts [N, S, 3] and per-ray times
// [N]; wts / bias: the packed buffers of ops/kernels/time_net.py::
// pack_time_params (bf16 != 0: bf16 operands, else fp32). scratch (train
// mode, time_net_scratch_bytes) or null: with it the forward keeps what the
// backward needs. All contiguous.
int time_net_fwd_launch(int bf16, int W, const float* pts, const float* times, const void* wts, const float* bias,
                        int D, int skip, int L, int N, int S, float* dx, void* scratch, void* stream) {
  const long long M = (long long)N * S;
  if (M == 0) return 0;
  if (!shape_ok(W, D, skip, L, M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (W == 256) return fwd<__nv_bfloat16, 256>(pts, times, wts, bias, D, skip, L, S, (int)M, dx, scratch, st);
    return fwd<__nv_bfloat16, 128>(pts, times, wts, bias, D, skip, L, S, (int)M, dx, scratch, st);
  }
  if (W == 256) return fwd<float, 256>(pts, times, wts, bias, D, skip, L, S, (int)M, dx, scratch, st);
  return fwd<float, 128>(pts, times, wts, bias, D, skip, L, S, (int)M, dx, scratch, st);
}

// The parameter gradients of sum(g * dx) for the cotangent g [M, 3] (fp32),
// from the scratch of the train-mode forward on the same weights: gw / gb
// in the packed layouts, which the caller zeroes.
int time_net_bwd_launch(int bf16, int W, const void* wts, int D, int skip, int L, long long M, const float* g,
                        float* gw, float* gb, void* scratch, void* stream) {
  if (M == 0) return 0;
  if (!shape_ok(W, D, skip, L, M)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(W, wts, D, skip, L, (int)M, g, gw, gb, scratch, st)
              : bwd<float>(W, wts, D, skip, L, (int)M, g, gw, gb, scratch, st);
}

}  // extern "C"
