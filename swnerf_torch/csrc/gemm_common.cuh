// The backward machinery shared by the train-mode render kernels B1/B4/B5
// (render_loss.cu), the deformation MLP's backward B6 (time_net.cu) and the
// field trunk's backward B7 (trunk.cu): activation spills, a 64x64 SIMT GEMM
// with two epilogues, the fixed-order split reduction for dW, column sums,
// the scratch carver, the trunk's reverse sweep and the whole field's
// (heads, then trunk).
//
// dW = X^T dZ runs as partial products over a fixed split of the rows, which
// reduce_kernel adds in split order: no atomics, so two launches on the same
// inputs give bit-equal gradients. dH = dZ W^T runs row-parallel with the
// activation's derivative and the rounding to the operand type (or, for the
// input cotangent of B5, an fp32 store or accumulate) in its epilogue. Under
// the sweeps' TC switch (bf16 B1 and B4, B6 without input cotangents, B7)
// the two large products of each layer, and B7's input cotangent, run on
// the tensor cores instead (tc_gemm.cuh: tc_reduce, tc_act, tc_demb), with
// the same split reduction.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "mlp_common.cuh"
#include "tc_gemm.cuh"

namespace {

constexpr int PADC = 8;    // extra columns of a spilled activation row
constexpr int GT = 64;     // GEMM output tile (rows and columns)
constexpr int GK = 16;     // GEMM reduction tile
constexpr int GEMM_BLOCKS = 1056;  // dW split target: 8 blocks per SM

// Rows 0..nvalid-1 of a k-major shared chunk (columns 0..ncopy-1) into
// global rows p0.. of a row-major [.][ld] buffer; with ones, column ncopy
// of each row is set to 1.
template <typename T>
__device__ __forceinline__ void spill(const T* __restrict__ s, int ncopy, T* __restrict__ g, int ld,
                                      long long p0, int nvalid, bool ones) {
  constexpr int LDA = Op<T>::LDA;
  for (int idx = threadIdx.x; idx < CH * ncopy; idx += NT) {
    const int r = idx / ncopy, k = idx - r * ncopy;
    if (r < nvalid) g[(p0 + r) * ld + k] = s[k * LDA + r];
  }
  if (ones)
    for (int r = threadIdx.x; r < nvalid; r += NT) g[(p0 + r) * ld + ncopy] = Op<T>::q(1.f);
}

// C[M, N] = sum_t A(m, t) B(t, n), A(m, t) = A[m*sam + t*sat] and
// B(t, n) = B[t*sbt + n*sbn]. blockIdx.z is a split of t.
struct GemmArgs {
  const void* A;
  long long sam, sat;
  const void* B;
  long long sbt, sbn;
  int M, N, K, kchunk;
  float* part;        // partial mode: [splits][M][N] fp32
  void* C;            // epilogue mode: q(act) into C[m*ldc + n]
  long long ldc;
  const void* mask;   // epilogue: times act'(mask(m, n)), the activation output
  long long ldm;
  const void* u;      // epilogue: + u[m*su] * v[n] before the mask
  long long su;
  const void* v;
};

// ELU: the epilogue's act' is ELU's (else ReLU's [mask > 0]). F32: 0 rounds
// into C in the operand type; 1 stores the fp32 value into the float C; 2
// adds it to the float C. Template parameters, so the instantiations B1
// was measured with stay the code they were.
template <typename T, bool PARTIAL, bool ELU = false, int F32 = 0>
__global__ void __launch_bounds__(256) gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) float As[GK][GT + 4];
  __shared__ __align__(16) float Bs[GK][GT + 4];
  const T* A = static_cast<const T*>(g.A);
  const T* B = static_cast<const T*>(g.B);
  const int m0 = blockIdx.x * GT, n0 = blockIdx.y * GT;
  const int kb = blockIdx.z * g.kchunk;
  const int ke = min(g.K, kb + g.kchunk);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool a_m_fast = g.sam == 1, b_n_fast = g.sbn == 1;
  float acc[4][4];
  zero(acc);
  for (int k0 = kb; k0 < ke; k0 += GK) {
    // Neighbouring threads walk the operand's contiguous dimension.
    for (int e = threadIdx.x; e < GT * GK; e += 256) {
      int mm, tt;
      if (a_m_fast) { tt = e / GT; mm = e % GT; } else { mm = e / GK; tt = e % GK; }
      const int m = m0 + mm, t = k0 + tt;
      As[tt][mm] = (m < g.M && t < ke) ? Op<T>::f(A[m * g.sam + t * g.sat]) : 0.f;
      int nn;
      if (b_n_fast) { tt = e / GT; nn = e % GT; } else { nn = e / GK; tt = e % GK; }
      const int n = n0 + nn, t2 = k0 + tt;
      Bs[tt][nn] = (n < g.N && t2 < ke) ? Op<T>::f(B[t2 * g.sbt + n * g.sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.N) continue;
      if (PARTIAL) {
        g.part[((size_t)blockIdx.z * g.M + m) * g.N + n] = acc[i][j];
      } else if (F32) {
        float* c = static_cast<float*>(g.C) + (size_t)m * g.ldc + n;
        *c = F32 == 2 ? *c + acc[i][j] : acc[i][j];
      } else {
        float val = acc[i][j];
        if (g.u)
          val += Op<T>::f(static_cast<const T*>(g.u)[m * g.su]) * Op<T>::f(static_cast<const T*>(g.v)[n]);
        if (ELU) {
          if (g.mask) val *= elu_grad(Op<T>::f(static_cast<const T*>(g.mask)[m * g.ldm + n]));
        } else if (g.mask && !(Op<T>::f(static_cast<const T*>(g.mask)[m * g.ldm + n]) > 0.f)) {
          val = 0.f;
        }
        static_cast<T*>(g.C)[m * g.ldc + n] = Op<T>::q(val);
      }
    }
  }
}

// Where a reduced [M, N] product lands: rows < Mw are weight rows, row Mw
// (when M > Mw) the bias; columns < split go to region a, the rest to b.
struct Region {
  float* w;
  int wcols;
  float* b;
};

__global__ void reduce_kernel(const float* __restrict__ part, int splits, int M, int N, int Mw, int split,
                              Region a, Region b) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long MN = (long long)M * N;
  if (idx >= MN) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * MN + idx];  // fixed order: deterministic
  const int m = (int)(idx / N), n = (int)(idx % N);
  const Region& rg = n < split ? a : b;
  const int c = n < split ? n : n - split;
  if (m < Mw) {
    if (rg.w) rg.w[(size_t)m * rg.wcols + c] = s;
  } else if (rg.b) {
    rg.b[c] = s;
  }
}

// Per-split column sums of an fp32 [rows][ld] buffer (columns < ncol).
__global__ void colsum_kernel(const float* __restrict__ src, long long ld, int ncol, long long rows,
                              long long rchunk, float* __restrict__ part) {
  const int col = threadIdx.x;
  if (col >= ncol) return;
  const long long r0 = blockIdx.x * rchunk;
  const long long r1 = min(rows, r0 + rchunk);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += src[r * ld + col];
  part[(size_t)blockIdx.x * ncol + col] = s;
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

size_t part_floats(int W) {
  const int tiles = ceil_div(W + 1, GT) * ceil_div(W + 1, GT);
  return (size_t)(GEMM_BLOCKS + tiles) * GT * GT;
}

struct Carver {
  unsigned char* p;
  template <typename X>
  X* take(size_t count) {
    X* out = reinterpret_cast<X*>(p);
    p += align256(sizeof(X) * count);
    return out;
  }
};

#define SWNERF_CHECK(expr)                           \
  do {                                               \
    const cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// dW-style product: split over t, then the fixed-order reduction.
template <typename T>
int gemm_reduce(GemmArgs g, float* part, int Mw, int split_col, Region ra, Region rb, cudaStream_t st) {
  const int tm = ceil_div(g.M, GT), tn = ceil_div(g.N, GT);
  int splits = std::max(1, std::min(ceil_div(GEMM_BLOCKS, tm * tn), ceil_div(g.K, GK)));
  g.kchunk = ceil_div(ceil_div(g.K, splits), GK) * GK;
  splits = ceil_div(g.K, g.kchunk);
  g.part = part;
  gemm_kernel<T, true><<<dim3(tm, tn, splits), 256, 0, st>>>(g);
  SWNERF_CHECK(cudaGetLastError());
  const long long MN = (long long)g.M * g.N;
  reduce_kernel<<<ceil_div(MN, 256), 256, 0, st>>>(part, splits, g.M, g.N, Mw, split_col, ra, rb);
  return static_cast<int>(cudaGetLastError());
}

// dH-style product: row-parallel, masked and rounded in the epilogue (or,
// with F32, stored or accumulated in fp32).
template <typename T, bool ELU = false, int F32 = 0>
int gemm_act(GemmArgs g, cudaStream_t st) {
  g.kchunk = ceil_div(g.K, GK) * GK;
  gemm_kernel<T, false, ELU, F32><<<dim3(ceil_div(g.M, GT), ceil_div(g.N, GT), 1), 256, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

int colsum(const float* src, long long ld, int ncol, long long rows, float* part, float* dst, cudaStream_t st) {
  const int splits = std::max(1, std::min(GEMM_BLOCKS, ceil_div(rows, 64)));
  const long long rchunk = ceil_div(rows, splits);
  const int used = ceil_div(rows, rchunk);
  colsum_kernel<<<used, 256, 0, st>>>(src, ld, ncol, rows, rchunk, part);
  SWNERF_CHECK(cudaGetLastError());
  reduce_kernel<<<ceil_div(ncol, 256), 256, 0, st>>>(part, used, 1, ncol, 0, ncol, Region{nullptr, 0, dst},
                                                     Region{nullptr, 0, nullptr});
  return static_cast<int>(cudaGetLastError());
}

// gemm_reduce on the tensor cores (bf16; tc_gemm.cuh::sweep_dw_kernel):
// dW = X^T dZ for the M weight rows, X [K][ldx] (columns < mx read), dZ
// [K][ldz] N wide (64, 128 or 256); with bias the row of ones' product
// (dZ's column sums) after them, with extra the column N of dZ as one more
// output column. Split so that one wave fills the card, at most cap
// partial floats; then reduce_kernel as gemm_reduce's.
template <typename T>
int tc_reduce(const T* x, long long ldx, int mx, int M, const T* z, long long ldz, int N, long long K, bool bias,
              bool extra, float* part, size_t cap, Region ra, Region rb, cudaStream_t st) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor-core sweep is bf16 only");
  const int Mr = M + (bias ? 1 : 0), Nr = N + (extra ? 1 : 0);
  const int mblocks = ceil_div(M, 128);
  int splits = std::max(1, std::min({tc::grid_for(1LL << 30) / mblocks, (int)(cap / ((size_t)Mr * Nr)),
                                     ceil_div(K, tc::SWEEP_KT)}));
  tc::DwArgs g{x, ldx, mx, z, ldz, M, K, 0, bias ? 1 : 0, extra ? 1 : 0, part};
  g.kchunk = (long long)ceil_div(ceil_div(K, splits), tc::SWEEP_KT) * tc::SWEEP_KT;
  splits = ceil_div(K, g.kchunk);
  SWNERF_CHECK(N == 256   ? tc::dw_launch<256>(g, splits, st)
               : N == 128 ? tc::dw_launch<128>(g, splits, st)
               : N == 64  ? tc::dw_launch<64>(g, splits, st)
                          : cudaErrorInvalidValue);
  reduce_kernel<<<ceil_div((long long)Mr * Nr, 256), 256, 0, st>>>(part, splits, Mr, Nr, M, N, ra, rb);
  return static_cast<int>(cudaGetLastError());
}

// gemm_act on the tensor cores (bf16; tc_gemm.cuh::sweep_dh_kernel): c =
// q(([dz w^T](m, n) + u[m su] v[n]) * act'(mask(m, n))) over P rows, act'
// ReLU's [mask > 0] or (ELU) elu_grad(mask), dz [P][lda] K wide, w the
// packed [N][K] matrix; mask and u nullable.
template <typename T, bool ELU = false>
int tc_act(const T* dz, long long lda, const T* w, int K, int N, long long P, const T* mask, long long ldm, const T* u,
           long long su, const T* v, T* c, long long ldc, cudaStream_t st) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor-core sweep is bf16 only");
  constexpr tc::Epi E = ELU ? tc::Epi::Elu : tc::Epi::Relu;
  const tc::DhArgs g{dz, lda, w, P, mask, ldm, u, su, v, c, ldc, nullptr, 0};
  if (N == 256 && K == 256) return static_cast<int>(tc::dh_launch<256, 256, E>(g, st));
  if (N == 256 && K == 128) return static_cast<int>(tc::dh_launch<256, 128, E>(g, st));
  if (N == 128 && K == 128) return static_cast<int>(tc::dh_launch<128, 128, E>(g, st));
  if (N == 128 && K == 64) return static_cast<int>(tc::dh_launch<128, 64, E>(g, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The input cotangent's product on the tensor cores (B7): demb [P][cin]
// fp32 = (add ? demb + : ) dz w_emb^T over the live columns n < cin, dz
// [P][W], w_emb the packed [CIN][W] embedding rows (CIN = 128: the product
// runs all 128 columns, whose pad rows are zero, and stores the live ones).
template <typename T>
int tc_demb(const T* dz, int W, const T* w_emb, int CIN, int cin, long long P, float* demb, bool add,
            cudaStream_t st) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "the tensor-core sweep is bf16 only");
  const tc::DhArgs g{dz, W, w_emb, P, nullptr, 0, nullptr, 0, nullptr, nullptr, cin, demb, cin};
  if (CIN != 128 || (W != 256 && W != 128)) return static_cast<int>(cudaErrorInvalidValue);
  if (W == 256)
    return static_cast<int>(add ? tc::dh_launch<128, 256, tc::Epi::Add32>(g, st)
                                : tc::dh_launch<128, 256, tc::Epi::Store32>(g, st));
  return static_cast<int>(add ? tc::dh_launch<128, 128, tc::Epi::Add32>(g, st)
                              : tc::dh_launch<128, 128, tc::Epi::Store32>(g, st));
}

GemmArgs gemm_args(const void* A, long long sam, long long sat, const void* B, long long sbt, long long sbn, int M,
                   int N, int K) {
  GemmArgs g{};
  g.A = A; g.sam = sam; g.sat = sat;
  g.B = B; g.sbt = sbt; g.sbn = sbn;
  g.M = M; g.N = N; g.K = K;
  return g;
}

#define SWNERF_RUN(expr)              \
  do {                                \
    const int c_ = (expr);            \
    if (c_ != 0) return c_;           \
  } while (0)

// Offsets of a trunk's packed matrices (ops/kernels/render_pass.py::
// weight_layout): layer i at off_w[i], the skip layer's embedding rows at
// off_wemb; returns the offset past the trunk.
size_t trunk_offsets(int D, int skip, int cin_pad, int W, size_t* off_w, size_t* off_wemb) {
  size_t o = 0;
  off_w[0] = o;
  o += (size_t)cin_pad * W;
  for (int i = 1; i < D; ++i) {
    if (i == skip + 1) {
      *off_wemb = o;
      o += (size_t)cin_pad * W;
    }
    off_w[i] = o;
    o += (size_t)W * W;
  }
  return o;
}

// The trunk's reverse sweep over P rows, from dz of the top layer (in
// dz[(D-1) & 1]) down: per layer its dW with the bias row (the spilled
// inputs carry a column of ones), then dz of the layer below. emb is the
// spilled input [P][CIN] (cin live columns, then the ones); h(i) layer i's
// spilled output [P][W + PADC]. With demb (B5), the input cotangent over the
// cin live columns, fp32 [P][cin]: dz_{skip+1} W_emb^T, then + dz_0 W_0^T.
// TC (bf16): dW, dH (ELU' or ReLU's mask in its epilogue) and demb on the
// tensor cores (tc_reduce, tc_act, tc_demb), the bias rows as dz's column
// sums.
template <typename T, bool ELU, typename H, bool TC = false>
int trunk_reverse(const T* wts, const size_t* off_w, size_t off_wemb, const T* emb, int CIN, int cin, H h, T* const* dz,
                  int D, int skip, int W, long long P, float* gw, float* gb, float* part, float* demb,
                  cudaStream_t st) {
  const int LDW = W + PADC;
  const Region none{nullptr, 0, nullptr};
  for (int i = D - 1; i >= 0; --i) {
    const T* dzi = dz[i & 1];
    if (i == 0 || i == skip + 1) {  // embedding rows, with the bias row
      const size_t off = i == 0 ? off_w[0] : off_wemb;
      const Region out{gw + off, W, gb + (size_t)i * W};
      if constexpr (TC) {
        SWNERF_RUN(tc_reduce<T>(emb, CIN, CIN, cin, dzi, W, W, P, true, false, part, part_floats(W), out, none, st));
      } else {
        SWNERF_RUN(gemm_reduce<T>(gemm_args(emb, 1, CIN, dzi, W, 1, cin + 1, W, (int)P), part, cin, W, out, none,
                                  st));
      }
      if (demb) {  // d emb = dz W_emb^T over the live columns; W_emb is [CIN][W]
        if constexpr (TC) {
          SWNERF_RUN(tc_demb<T>(dzi, W, wts + off, CIN, cin, P, demb, i == 0, st));
        } else {
          GemmArgs g = gemm_args(dzi, W, 1, wts + off, 1, W, (int)P, cin, W);
          g.C = demb;
          g.ldc = cin;
          SWNERF_RUN(i == 0 ? (gemm_act<T, false, 2>(g, st)) : (gemm_act<T, false, 1>(g, st)));
        }
      }
    }
    if (i > 0) {
      const bool bias_here = i != skip + 1;
      const Region out{gw + off_w[i], W, bias_here ? gb + (size_t)i * W : nullptr};
      if constexpr (TC) {
        SWNERF_RUN(tc_reduce<T>(h(i - 1), LDW, W, W, dzi, W, W, P, bias_here, false, part, part_floats(W), out, none,
                                st));
        SWNERF_RUN((tc_act<T, ELU>(dzi, W, wts + off_w[i], W, W, P, h(i - 1), LDW, nullptr, 0, nullptr,
                                   dz[(i - 1) & 1], W, st)));
      } else {
        SWNERF_RUN(gemm_reduce<T>(gemm_args(h(i - 1), 1, LDW, dzi, W, 1, bias_here ? W + 1 : W, W, (int)P), part,
                                  W, W, out, none, st));
        GemmArgs g = gemm_args(dzi, W, 1, wts + off_w[i], 1, W, (int)P, W, W);
        g.mask = h(i - 1);
        g.ldm = LDW;
        g.C = dz[(i - 1) & 1];
        g.ldc = W;
        SWNERF_RUN((gemm_act<T, ELU>(g, st)));
      }
    }
  }
  return 0;
}

// d hv = (q(g_rgb) @ W_rgb^T) * act'(hv), in fp32 and rounded.
template <typename T, int WH, Act A>
__global__ void head_bwd_kernel(const T* __restrict__ gq, const T* __restrict__ hv, int ldh,
                                const T* __restrict__ w_rgb, long long P, float* __restrict__ dhv32,
                                T* __restrict__ dhv_c) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * WH) return;
  const long long p = idx / WH;
  const int j = (int)(idx - p * WH);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) s = fmaf(Op<T>::f(gq[p * 4 + c]), Op<T>::f(w_rgb[j * 3 + c]), s);
  const float h = Op<T>::f(hv[p * ldh + j]);
  const float d = A == Act::Elu ? s * elu_grad(h) : (h > 0.f ? s : 0.f);
  dhv32[idx] = d;
  dhv_c[idx] = Op<T>::q(d);
}

// What the field's reverse sweep reads and writes, over P rows: the spilled
// forward (emb [P][CIN] with its column of ones, vemb [P][CVP], the trunk
// layers through h, feat [P][W + PADC], hv [P][W/2 + PADC]), the raw
// cotangent (gq [P][4] in the operand type, graw [P][4] fp32, and
// q(d sigma) already in column W of dfa [P][W + PADC]), and the work
// buffers (dz ping-pong [P][W], dhv_c [P][W/2], dhv32 [P][W/2] fp32, the
// split partials).
template <typename T, typename H>
struct FieldTape {
  const T* emb;
  const T* vemb;
  H h;
  const T* feat;
  const T* hv;
  T* dfa;
  const T* gq;
  const float* graw;
  T* const* dz;
  T* dhv_c;
  float* dhv32;
  float* part;
};

// The field's reverse sweep from the raw cotangent (B1, B4, B5 after their
// composite backward; B7 from its given cotangent), in the packed layout of
// ops/kernels/render_pass.py::weight_layout with the input padded to CIN and
// the view embedding to CVP rows: the rgb head and the view layer, d feat
// next to d sigma, the feature + alpha product, then the trunk
// (trunk_reverse). gw / gb are the packed fp32 gradients (zeroed by the
// caller); demb [P][cin] (B5, B7) and dvemb [P][cv] (B7) are the input
// cotangents in fp32, formed where not null. TC (bf16 B1, B4, B7): the view
// layer's two dW, d feat, the feature + alpha dW (its d sigma column and
// bias row beside the product) and dz_{D-1} on the tensor cores, then the
// trunk's with demb (dvemb, which no tensor-core caller's main path asks
// for, stays a SIMT product).
template <typename T, int W, Act ACT, typename H, bool TC = false>
int field_reverse(const T* wts, int D, int skip, int CIN, int cin, int CVP, int cv, long long P,
                  const FieldTape<T, H>& tp, float* gw, float* gb, float* demb, float* dvemb, cudaStream_t st) {
  constexpr bool ELU = ACT == Act::Elu;
  constexpr int WH = W / 2;
  constexpr int LDW = W + PADC;
  constexpr int LDH = WH + PADC;
  size_t off_w[16], off_wemb = 0;
  const size_t o = trunk_offsets(D, skip, CIN, W, off_w, &off_wemb);
  const size_t off_feat = o, off_alpha = o + (size_t)W * W;
  const size_t off_vf = off_alpha + W, off_vv = off_vf + (size_t)W * WH, off_rgb = off_vv + (size_t)CVP * WH;
  float* gb_feat = gb + (size_t)D * W;
  float* gb_views = gb_feat + W;
  float* gb_rgb = gb_views + WH;
  float* gb_alpha = gb_rgb + 3;
  const Region none{nullptr, 0, nullptr};

  // rgb head and view layer
  head_bwd_kernel<T, WH, ACT><<<ceil_div(P * WH, 256), 256, 0, st>>>(tp.gq, tp.hv, LDH, wts + off_rgb, P, tp.dhv32,
                                                                     tp.dhv_c);
  SWNERF_CHECK(cudaGetLastError());
  SWNERF_RUN(gemm_reduce<T>(gemm_args(tp.hv, 1, LDH, tp.gq, 4, 1, WH, 4, (int)P), tp.part, WH, 3,
                            Region{gw + off_rgb, 3, nullptr}, none, st));
  SWNERF_RUN(colsum(tp.graw, 4, 3, P, tp.part, gb_rgb, st));
  SWNERF_RUN(colsum(tp.dhv32, WH, WH, P, tp.part, gb_views, st));
  if constexpr (TC) {
    SWNERF_RUN(tc_reduce<T>(tp.feat, LDW, W, W, tp.dhv_c, WH, WH, P, false, false, tp.part, part_floats(W),
                            Region{gw + off_vf, WH, nullptr}, none, st));
    SWNERF_RUN(tc_reduce<T>(tp.vemb, CVP, CVP, cv, tp.dhv_c, WH, WH, P, false, false, tp.part, part_floats(W),
                            Region{gw + off_vv, WH, nullptr}, none, st));
  } else {
    SWNERF_RUN(gemm_reduce<T>(gemm_args(tp.feat, 1, LDW, tp.dhv_c, WH, 1, W, WH, (int)P), tp.part, W, WH,
                              Region{gw + off_vf, WH, nullptr}, none, st));
    SWNERF_RUN(gemm_reduce<T>(gemm_args(tp.vemb, 1, CVP, tp.dhv_c, WH, 1, cv, WH, (int)P), tp.part, cv, WH,
                              Region{gw + off_vv, WH, nullptr}, none, st));
  }
  if (dvemb) {  // d vemb = dhv W_vv^T over the live columns; W_vv is [CVP][W/2]
    GemmArgs g = gemm_args(tp.dhv_c, WH, 1, wts + off_vv, 1, WH, (int)P, cv, WH);
    g.C = dvemb;
    g.ldc = cv;
    SWNERF_RUN((gemm_act<T, false, 1>(g, st)));
  }

  // d feat = q(dhv @ W_vf^T) next to the d sigma column, then the feature +
  // alpha product's dW (its ones row gives both biases)
  if constexpr (TC) {
    SWNERF_RUN(tc_act<T>(tp.dhv_c, WH, wts + off_vf, WH, W, P, nullptr, 0, nullptr, 0, nullptr, tp.dfa, LDW, st));
    SWNERF_RUN(tc_reduce<T>(tp.h(D - 1), LDW, W, W, tp.dfa, LDW, W, P, true, true, tp.part, part_floats(W),
                            Region{gw + off_feat, W, gb_feat}, Region{gw + off_alpha, 1, gb_alpha}, st));
    // dz_{D-1} = q((dfeat @ W_feat^T + dsigma * w_alpha^T) * act'(h_{D-1}))
    SWNERF_RUN((tc_act<T, ELU>(tp.dfa, LDW, wts + off_feat, W, W, P, tp.h(D - 1), LDW, tp.dfa + W, LDW,
                               wts + off_alpha, tp.dz[(D - 1) & 1], W, st)));
    return trunk_reverse<T, ELU, H, TC>(wts, off_w, off_wemb, tp.emb, CIN, cin, tp.h, tp.dz, D, skip, W, P, gw, gb,
                                        tp.part, demb, st);
  }
  {
    GemmArgs g = gemm_args(tp.dhv_c, WH, 1, wts + off_vf, 1, WH, (int)P, W, WH);
    g.C = tp.dfa;
    g.ldc = LDW;
    SWNERF_RUN(gemm_act<T>(g, st));
  }
  SWNERF_RUN(gemm_reduce<T>(gemm_args(tp.h(D - 1), 1, LDW, tp.dfa, LDW, 1, W + 1, W + 1, (int)P), tp.part, W, W,
                            Region{gw + off_feat, W, gb_feat}, Region{gw + off_alpha, 1, gb_alpha}, st));
  {  // dz_{D-1} = q((dfeat @ W_feat^T + dsigma * w_alpha^T) * act'(h_{D-1}))
    GemmArgs g = gemm_args(tp.dfa, LDW, 1, wts + off_feat, 1, W, (int)P, W, W);
    g.u = tp.dfa + W;
    g.su = LDW;
    g.v = wts + off_alpha;
    g.mask = tp.h(D - 1);
    g.ldm = LDW;
    g.C = tp.dz[(D - 1) & 1];
    g.ldc = W;
    SWNERF_RUN((gemm_act<T, ELU>(g, st)));
  }

  // the trunk, from the top (with the input cotangent where asked)
  return trunk_reverse<T, ELU>(wts, off_w, off_wemb, tp.emb, CIN, cin, tp.h, tp.dz, D, skip, W, P, gw, gb, tp.part,
                               demb, st);
}

}  // namespace
