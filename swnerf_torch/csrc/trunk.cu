// The NeRF field trunk on embedded inputs (kernel B7) for Hopper: the
// forward raw [P, 4], and the backward to every parameter gradient and the
// position embedding's cotangent.
//
// Replaces swnerf_tpu/ops/pallas/raymarch.py::_fwd_kernel (:435) and
// _bwd_kernel (:446), reached through fused_trunk (:700) and its custom VJP
// (_trunk_call, :739-768): raw = field(emb, vemb) for a position embedding
// emb [P, cin <= 127] and a view embedding vemb [P, cv <= 128] computed
// outside (models/dnerf.py: the canonical network queried at the embedded
// x + dx), D layers of width W with the skip as a split product
// (cat([emb, h]) @ W == emb @ W_emb + h @ W_h), the feature head (no
// activation), the alpha head, the view layer on cat([feature, vemb]) and
// the rgb head; raw = (rgb logits, alpha), fp32 (_trunk_forward,
// raymarch.py:251-290). The backward takes the cotangent g [P, 4] and
// returns the parameter gradients and, where asked, demb [P, cin] (fp32,
// the D-NeRF path's gradient into the deformation net) and dvemb [P, cv].
// The plain twin is swnerf_torch/ops/kernels/trunk.py::trunk_plain /
// trunk_plain_bwd.
//
// The field family is a traits parameter (Trunk below: ReLU, no colour
// ReLU, what fused_trunk runs). fused_tnerf (raymarch.py:1094) is the same
// body with ELU and the colour ReLU: a second traits struct, not wired yet.
//
// Bound on the card: operations. At D=8, W=256 and MultiRes level 0's
// widths (cin = cv = 123) the forward is 636,416 multiply-adds per row and
// the backward about twice that, against ~1 KB of fp32 input per row.
// Design, B1's without the compositor:
//  1. trunk_fwd_kernel: one 256-thread block per 64-row chunk; the block
//     reads its rows of emb and vemb (contiguous, coalesced) into shared
//     memory rounded to the operand type, runs the chunk product of
//     mlp_common.cuh layer by layer and the three heads, and writes raw.
//     With a scratch buffer (train mode) it spills the embedding (with a
//     column of ones), vemb, every layer's output, feat and hv, as B1 does.
//     Shared memory at fp32, W=256: (2 W + CIN + CV) rows of 68 floats plus
//     the weight tile and the head reduction, 228,352 of the 232,448 bytes a
//     block may take.
//  2. trunk_bwd_launch: the cotangent in the operand type (and q(d alpha)
//     next to d feat), then gemm_common.cuh::field_reverse, B1's reverse
//     sweep: fixed-order dW splits, no atomics, bit-equal repeats; demb as
//     dz_{skip+1} W_emb^T + dz_0 W_0^T over the live columns, in fp32 (the
//     Pallas backward rounds it to the compute dtype, raymarch.py:765).
// Operands fp32 (parity mode) or bf16, rounded where the plain twin rounds;
// products accumulate in fp32; gradients are fp32. SIMT only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gemm_common.cuh"
#include "mlp_common.cuh"

namespace {

// B7's field family: the ReLU trunk of fused_trunk, an embedded position
// input padded to CIN rows (cin < CIN: room for the dW column of ones) and a
// view embedding padded to CV rows.
struct Trunk {
  static constexpr int CIN = 128;
  static constexpr int CV = 128;
  static constexpr Act ACT = Act::Relu;
  static constexpr bool RGB_RELU = false;
};

template <typename T>
struct Scratch {
  T* emb;    // [P][A::CIN], column cin = 1
  T* vemb;   // [P][A::CV]
  T* h;      // D x [P][W + PADC], column W = 1, layer i at h + i * hstride
  size_t hstride;
  T* feat;   // [P][W + PADC]
  T* hv;     // [P][W/2 + PADC]
  T* dfa;    // [P][W + PADC]: d feat (columns < W), d alpha (column W)
  T* dz[2];  // [P][W]
  T* dhv_c;  // [P][W/2]
  T* gq;     // [P][4]: the cotangent in the operand type
  float* dhv32;  // [P][W/2]
  float* part;
};

template <typename T, typename A>
Scratch<T> carve(void* scratch, int W, int D, long long P) {
  const int WH = W / 2;
  Carver cv{static_cast<unsigned char*>(scratch)};
  Scratch<T> sc;
  sc.emb = cv.take<T>(P * A::CIN);
  sc.vemb = cv.take<T>(P * A::CV);
  sc.hstride = align256(sizeof(T) * P * (W + PADC)) / sizeof(T);
  sc.h = cv.take<T>(sc.hstride * D);
  sc.feat = cv.take<T>(P * (W + PADC));
  sc.hv = cv.take<T>(P * (WH + PADC));
  sc.dfa = cv.take<T>(P * (W + PADC));
  sc.dz[0] = cv.take<T>(P * W);
  sc.dz[1] = cv.take<T>(P * W);
  sc.dhv_c = cv.take<T>(P * WH);
  sc.gq = cv.take<T>(P * 4);
  sc.dhv32 = cv.take<float>(P * WH);
  sc.part = cv.take<float>(part_floats(W));
  return sc;
}

template <typename T, typename A>
size_t scratch_bytes(int W, int D, long long P) {
  const int WH = W / 2;
  size_t b = 0;
  b += align256(sizeof(T) * P * A::CIN);
  b += align256(sizeof(T) * P * A::CV);
  b += align256(sizeof(T) * P * (W + PADC)) * D;
  b += align256(sizeof(T) * P * (W + PADC));   // feat
  b += align256(sizeof(T) * P * (WH + PADC));  // hv
  b += align256(sizeof(T) * P * (W + PADC));   // dfa
  b += align256(sizeof(T) * P * W) * 2;        // dz ping-pong
  b += align256(sizeof(T) * P * WH);           // dhv_c
  b += align256(sizeof(T) * P * 4);            // gq
  b += align256(sizeof(float) * P * WH);       // dhv32
  b += align256(sizeof(float) * part_floats(W));
  return b;
}

// Rows row0 .. row0+nvalid-1 of a row-major fp32 [.][ncols] input into
// shared memory, k-major [npad][LDA] and rounded to the operand type; the
// columns past ncols and the rows past nvalid are zero. The chunk's rows are
// contiguous, so neighbouring threads read neighbouring words.
template <typename T>
__device__ __forceinline__ void load_rows(T* __restrict__ s, const float* __restrict__ g, int ncols, int npad,
                                          long long row0, int nvalid) {
  constexpr int LDA = Op<T>::LDA;
  const float* src = g + row0 * ncols;
  for (int idx = threadIdx.x; idx < CH * npad; idx += NT) {
    const int r = idx / npad, k = idx - r * npad;
    s[k * LDA + r] = Op<T>::q((r < nvalid && k < ncols) ? src[(size_t)r * ncols + k] : 0.f);
  }
}

template <typename T, int W, typename A, bool STORE>
__global__ void __launch_bounds__(NT)
trunk_fwd_kernel(const float* __restrict__ emb_in, int cin, const float* __restrict__ vemb_in, int cv,
                 const T* __restrict__ wts, const float* __restrict__ bias, int D, int skip, long long M,
                 float* __restrict__ raw, Scratch<T> sc) {
  constexpr int LDA = Op<T>::LDA;
  constexpr int WH = W / 2;
  constexpr int LDW = W + PADC;
  constexpr int LDH = WH + PADC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long row0 = (long long)blockIdx.x * CH;
  const int nvalid = (int)min((long long)CH, M - row0);

  float* red = reinterpret_cast<float*>(smem_raw);  // [4][CH][3]
  T* actA = reinterpret_cast<T*>(red + NRED);        // [W][LDA]
  T* actB = actA + W * LDA;                          // [W][LDA]
  T* emb = actB + W * LDA;                           // [A::CIN][LDA]
  T* vemb_s = emb + A::CIN * LDA;                    // [A::CV][LDA]
  T* Ws = vemb_s + A::CV * LDA;                      // [KT][W]
  const float* b_views = bias + (D + 1) * W;
  const float* b_rgb = b_views + WH;
  const float b_alpha = b_rgb[3];
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;

  load_rows<T>(emb, emb_in, cin, A::CIN, row0, nvalid);
  load_rows<T>(vemb_s, vemb_in, cv, A::CV, row0, nvalid);
  __syncthreads();
  if (STORE) {
    spill<T>(emb, cin, sc.emb, A::CIN, row0, nvalid, true);
    spill<T>(vemb_s, cv, sc.vemb, A::CV, row0, nvalid, false);
  }
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
    if (STORE) {
      __syncthreads();
      spill<T>(h, W, sc.h, LDW, row0, nvalid, true);
    }
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
    if (STORE) {
      __syncthreads();
      spill<T>(h, W, sc.h + i * sc.hstride, LDW, row0, nvalid, true);
    }
  }
  {  // feature head (no activation) -> g
    float acc[8][W / 32];
    zero(acc);
    mm_acc<T, W>(acc, h, W, wp, Ws);
    wp += W * W;
    store_act<T, W, Act::None>(acc, bp, g);
    __syncthreads();
    if (STORE) spill<T>(g, W, sc.feat, LDW, row0, nvalid, false);
  }
  {  // alpha head: one dot of length W per row, 4 threads per row
    float s = 0.f;
    for (int k = p; k < W; k += 4) s = fmaf(Op<T>::f(h[k * LDA + r]), Op<T>::f(wp[k]), s);
    red[p * CH + r] = s;
    __syncthreads();
    if (p == 0 && r < nvalid)
      raw[(row0 + r) * 4 + 3] = ((red[r] + red[CH + r]) + red[2 * CH + r]) + red[3 * CH + r] + b_alpha;
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
  if (STORE) spill<T>(h, WH, sc.hv, LDH, row0, nvalid, false);
  {  // rgb head: three dots of length W/2 per row (logits: no sigmoid)
    float s[3] = {0.f, 0.f, 0.f};
    for (int k = p; k < WH; k += 4) {
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
        raw[(row0 + r) * 4 + c] = ((red[r * 3 + c] + red[(CH + r) * 3 + c]) + red[(2 * CH + r) * 3 + c]) +
                                  red[(3 * CH + r) * 3 + c] + b_rgb[c];
    }
  }
}

// gq = q(g); column W of dfa = q(d alpha).
template <typename T>
__global__ void cotangent_kernel(const float* __restrict__ g, long long P, int W, T* __restrict__ gq,
                                 T* __restrict__ dfa) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * 4) return;
  const T v = Op<T>::q(g[idx]);
  gq[idx] = v;
  if ((idx & 3) == 3) dfa[(idx >> 2) * (W + PADC) + W] = v;
}

template <typename T, int W, typename A>
int fwd(const float* emb, int cin, const float* vemb, int cv, const void* wts, const float* bias, int D, int skip,
        long long M, float* raw, void* scratch, cudaStream_t st) {
  constexpr int LDA = Op<T>::LDA;
  const size_t smem = sizeof(float) * NRED + sizeof(T) * ((size_t)(2 * W + A::CIN + A::CV) * LDA + KT * W);
  Scratch<T> sc{};
  if (scratch) sc = carve<T, A>(scratch, W, D, M);
  auto kern = scratch ? trunk_fwd_kernel<T, W, A, true> : trunk_fwd_kernel<T, W, A, false>;
  SWNERF_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  kern<<<ceil_div(M, CH), NT, smem, st>>>(emb, cin, vemb, cv, static_cast<const T*>(wts), bias, D, skip, M, raw, sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W, typename A>
int bwd(const void* wts_v, int D, int skip, int cin, int cv, long long P, const float* g, float* gw, float* gb,
        float* demb, float* dvemb, void* scratch, cudaStream_t st) {
  static_assert(!A::RGB_RELU, "the colour ReLU's mask is not formed here");
  const T* wts = static_cast<const T*>(wts_v);
  Scratch<T> sc = carve<T, A>(scratch, W, D, P);
  cotangent_kernel<T><<<ceil_div(P * 4, 256), 256, 0, st>>>(g, P, W, sc.gq, sc.dfa);
  SWNERF_CHECK(cudaGetLastError());
  auto hl = [&](int i) { return static_cast<const T*>(sc.h + (size_t)i * sc.hstride); };
  FieldTape<T, decltype(hl)> tape{sc.emb, sc.vemb, hl, sc.feat, sc.hv, sc.dfa, sc.gq, g, sc.dz, sc.dhv_c,
                                  sc.dhv32, sc.part};
  return field_reverse<T, W, A::ACT>(wts, D, skip, A::CIN, cin, A::CV, cv, P, tape, gw, gb, demb, dvemb, st);
}

bool shape_ok(int W, int D, int skip, int cin, int cv, long long P) {
  return (W == 128 || W == 256) && D >= 2 && D <= 16 && skip >= 0 && skip + 1 < D && cin >= 1 &&
         cin < Trunk::CIN && cv >= 1 && cv <= Trunk::CV && P * (W + PADC) < (1LL << 31);
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of train-mode scratch for P rows, or -1 for an unsupported width.
long long trunk_scratch_bytes(int bf16, int W, int D, long long P) {
  if (W != 128 && W != 256) return -1;
  return (long long)(bf16 ? scratch_bytes<__nv_bfloat16, Trunk>(W, D, P) : scratch_bytes<float, Trunk>(W, D, P));
}

// raw [P, 4] (rgb logits, alpha) of the field at emb [P, cin] and vemb
// [P, cv] (fp32, contiguous); wts / bias: the packed buffers of
// ops/kernels/trunk.py::pack_trunk_params (bf16 != 0: bf16 operands, else
// fp32). scratch (train mode, trunk_scratch_bytes) or null: with it the
// forward keeps what the backward needs.
int trunk_fwd_launch(int bf16, int W, const float* emb, int cin, const float* vemb, int cv, const void* wts,
                     const float* bias, int D, int skip, long long P, float* raw, void* scratch, void* stream) {
  if (P == 0) return 0;
  if (!shape_ok(W, D, skip, cin, cv, P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_FWD(T, WW) fwd<T, WW, Trunk>(emb, cin, vemb, cv, wts, bias, D, skip, P, raw, scratch, st)
  if (bf16) return W == 256 ? SWNERF_FWD(__nv_bfloat16, 256) : SWNERF_FWD(__nv_bfloat16, 128);
  return W == 256 ? SWNERF_FWD(float, 256) : SWNERF_FWD(float, 128);
#undef SWNERF_FWD
}

// The gradients of sum(g * raw) for the cotangent g [P, 4] (fp32), from the
// scratch of the train-mode forward on the same weights: gw / gb in the
// packed layouts, which the caller zeroes; demb [P, cin] and dvemb [P, cv]
// (fp32) where not null.
int trunk_bwd_launch(int bf16, int W, const void* wts, int D, int skip, int cin, int cv, long long P,
                     const float* g, float* gw, float* gb, float* demb, float* dvemb, void* scratch, void* stream) {
  if (P == 0) return 0;
  if (!shape_ok(W, D, skip, cin, cv, P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_BWD(T, WW) bwd<T, WW, Trunk>(wts, D, skip, cin, cv, P, g, gw, gb, demb, dvemb, scratch, st)
  if (bf16) return W == 256 ? SWNERF_BWD(__nv_bfloat16, 256) : SWNERF_BWD(__nv_bfloat16, 128);
  return W == 256 ? SWNERF_BWD(float, 256) : SWNERF_BWD(float, 128);
#undef SWNERF_BWD
}

}  // extern "C"
