// The NeRF field trunk on embedded inputs (kernel B7), its ELU T-NeRF
// instantiation (B7') and its instantiation with the encode in the block
// (B8) for Hopper: the forward raw [P, 4], and the backward to every
// parameter gradient and the inputs' cotangents.
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
// The field family is a traits parameter, one instantiation each:
//  - Trunk (B7): the ReLU trunk of fused_trunk, as above.
//  - TrunkElu (B7'): fused_tnerf (raymarch.py:1094-1129), the same bodies
//    with act="elu" and rgb_relu=True: the T-NeRF field on [embed(x) |
//    embed(t)] and embed(d) (render_pass.py::pack_tnerf_params's layout),
//    ELU in the trunk and the view layer (ELU' from the stored output, as
//    B4), and raw rgb = max(u, 0) for the colour logits u. The backward
//    masks the colour cotangent by u > 0 (raymarch.py:364-368), from u kept
//    by the train-mode forward; the rgb bias gradient sums the masked fp32
//    cotangent.
//  - TrunkRaw (B8): fused_field_raw (raymarch.py:956-1020, bodies
//    _fwd_kernel_raw :556 and _bwd_kernel_raw :569), B7 on positions and
//    per-row view directions [P, 3] (fp32): the block encodes both straight
//    into the shared-memory embedding tiles with B3's in-block encode
//    (mlp_common.cuh::encode_chunk, true cos), so the embeddings are born in
//    shared memory and take no room B7 does not. Its backward forms demb and
//    dvemb in fp32 scratch and chains them through B5's encode backward
//    (mlp_common.cuh::encode_bwd_kernel) to d pts and d viewdirs [P, 3].
// The flags are compile-time: B7's instantiation is the code it was.
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
//     In bf16 only the train-mode forward runs it: the forward-only launch
//     of B7 and B8 runs trunk_tc_kernel (3.), and B7' keeps this body.
//  2. trunk_bwd_launch: the cotangent in the operand type (and q(d alpha)
//     next to d feat), then gemm_common.cuh::field_reverse, B1's reverse
//     sweep: fixed-order dW splits, no atomics, bit-equal repeats; demb as
//     dz_{skip+1} W_emb^T + dz_0 W_0^T over the live columns, in fp32 (the
//     Pallas backward rounds it to the compute dtype, raymarch.py:765). B7
//     in bf16 runs the sweep's large products and demb on the tensor cores
//     (tc_gemm.cuh, as B1: dW, dH with ReLU's mask, demb as an fp32 store
//     then add over its 128-column pad); dvemb, B7' and B8 stay SIMT.
//  3. trunk_tc_kernel (bf16, B7 and B8 without a scratch: the mesh sweep,
//     the no-grad field routes): tc_render.cuh's field product on the
//     tensor cores, 128 rows per pass over the weight image.
// Operands fp32 (parity mode) or bf16, rounded where the plain twin rounds;
// products accumulate in fp32; gradients are fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "gemm_common.cuh"
#include "mlp_common.cuh"
#include "tc_render.cuh"

namespace {

// B7's field family: the ReLU trunk of fused_trunk, an embedded position
// input padded to CIN rows (cin < CIN: room for the dW column of ones) and a
// view embedding padded to CV rows.
struct Trunk {
  static constexpr int CIN = 128;
  static constexpr int CV = 128;
  static constexpr Act ACT = Act::Relu;
  static constexpr bool RGB_RELU = false;
  static constexpr bool RAW = false;
};

// B7': the T-NeRF family (B4's TNerf traits' activation and colour ReLU) on
// the same padded widths.
struct TrunkElu {
  static constexpr int CIN = 128;
  static constexpr int CV = 128;
  static constexpr Act ACT = Act::Elu;
  static constexpr bool RGB_RELU = true;
  static constexpr bool RAW = false;
};

// B8: B7 with both encodes in the block. encode_chunk reads TIME and cin(L);
// the view encode uses the same traits (CV == CIN).
struct TrunkRaw {
  static constexpr int CIN = 128;
  static constexpr int CV = 128;
  static constexpr Act ACT = Act::Relu;
  static constexpr bool RGB_RELU = false;
  static constexpr bool RAW = true;
  static constexpr bool TIME = false;
  static __host__ __device__ int cin(int L) { return 3 + 6 * L; }
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
  float* u;      // B7': [P][4], the colour logits before the ReLU
  float* gm;     // B7': [P][4], the cotangent with the colour masked
  float* demb;   // B8: [P][cin], fp32
  float* dvemb;  // B8: [P][cv], fp32
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
  if (A::RGB_RELU) {
    sc.u = cv.take<float>(P * 4);
    sc.gm = cv.take<float>(P * 4);
  }
  if (A::RAW) {
    sc.demb = cv.take<float>(P * A::CIN);
    sc.dvemb = cv.take<float>(P * A::CV);
  }
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
  if (A::RGB_RELU) b += 2 * align256(sizeof(float) * P * 4);  // u, gm
  if (A::RAW) b += align256(sizeof(float) * P * A::CIN) + align256(sizeof(float) * P * A::CV);  // demb, dvemb
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

  if constexpr (A::RAW) {  // B8: emb_in / vemb_in are pts / viewdirs [M][3]; cin = 3 + 6L, cv = 3 + 6Lv
    encode_chunk<T, A, true, false>(emb, nullptr, 0, nvalid, row0, 1, (cin - 3) / 6, 0, emb_in, nullptr, nullptr,
                                    nullptr, nullptr);
    encode_chunk<T, A, true, false>(vemb_s, nullptr, 0, nvalid, row0, 1, (cv - 3) / 6, 0, vemb_in, nullptr,
                                    nullptr, nullptr, nullptr);
  } else {
    load_rows<T>(emb, emb_in, cin, A::CIN, row0, nvalid);
    load_rows<T>(vemb_s, vemb_in, cv, A::CV, row0, nvalid);
  }
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
      for (int c = 0; c < 3; ++c) {
        float v = ((red[r * 3 + c] + red[(CH + r) * 3 + c]) + red[(2 * CH + r) * 3 + c]) +
                  red[(3 * CH + r) * 3 + c] + b_rgb[c];
        if constexpr (A::RGB_RELU) {  // B7': rgb = max(u, 0); the backward's mask is u > 0
          if (STORE) sc.u[(row0 + r) * 4 + c] = v;
          v = fmaxf(v, 0.f);
        }
        raw[(row0 + r) * 4 + c] = v;
      }
    }
  }
}

// B7's and B8's bf16 forward-only launch on the tensor cores (tc_chunk.cuh,
// the body tc_render.cuh::field_rows that B3 runs): a persistent grid over
// 128-row chunks; per chunk each consumer warpgroup fills its embedding
// tiles for its 64 rows, then runs the field. The tiles take KE = A::CIN /
// 64 and KV = A::CV / 64 atoms: one each at the narrow pads (cin, cv <= 64:
// the mesh tile's 63 / 27), two at the wide ones (MultiRes level 0's
// 123 / 123), the weights' 128-row pads read that far only (tc_fwd's plan).
//  - B7: rows of emb [M][cin] and vemb [M][cv] (fp32, each chunk's rows
//    contiguous, read in order) into the tiles, rounded to bf16 where
//    trunk.py::_padded rounds; the pad columns are zeroed once, rows past M
//    are zero.
//  - B8 (RAW): pts and viewdirs [M][3] encoded in the block at
//    (cin - 3) / 6 and (cv - 3) / 6 frequencies (tc_render.cuh::encode_row).
// raw [M][4] (fp32) comes straight from the heads' epilogues. The
// train-mode forward, whose spilled activations the backward reads, stays
// on trunk_fwd_kernel: the tensor cores round each k16 step's sum toward
// zero (tc_rounding.py), and the backward's gradients are held to the
// twin's fp32-order bar.
constexpr int TC_STAGES = 3;

// B7 / B8's narrow tiles: one atom for each embedding.
struct TrunkNarrow {
  static constexpr int CIN = 64;
  static constexpr int CV = 64;
  static constexpr Act ACT = Act::Relu;
};

template <int W, typename A>
constexpr size_t trunk_tc_smem() {
  return 1024 + (size_t)TC_STAGES * tc::STAGE_BYTES +
         2 * (size_t)(W / 64 + tc::atoms(A::CIN) + tc::atoms(A::CV)) * tc::ATOM_BYTES + tc::BAR_BYTES;
}
static_assert(trunk_tc_smem<256, VanillaWide>() <= SMEM_OPTIN, "the wide W=256 block fits");

// Rows row0 .. row0+63 of a row-major fp32 [.][n] input into a tile's
// columns 0 .. n-1, rounded to bf16 (rows past nvalid: zero). The rows are
// contiguous in memory, so the warpgroup reads them word by word.
__device__ __forceinline__ void load_tile(unsigned char* t, int tid, const float* __restrict__ g, int n,
                                          long long row0, int nvalid) {
  const float* src = g + row0 * n;
  const int live = nvalid * n;
  for (int i = tid; i < 64 * n; i += tc::WGT) {
    const int r = i / n;
    tc::put(t, r, i - r * n, i < live ? __ldg(src + i) : 0.f);
  }
}

template <int W, typename A, bool RAW>
__global__ void __launch_bounds__(tc::NTHREADS, 1)
trunk_tc_kernel(const float* __restrict__ in0, int cin, const float* __restrict__ in1, int cv,
                const __grid_constant__ tc::Plan plan, const unsigned char* __restrict__ img,
                const float* __restrict__ bias, int D, int skip, long long M, float* __restrict__ raw) {
  constexpr int KE = tc::atoms(A::CIN), KV = tc::atoms(A::CV);
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned_smem: 1024
  unsigned char* sm = tc::aligned_smem(smem_raw);
  unsigned char* act_s = sm + TC_STAGES * tc::STAGE_BYTES;       // [2][W / 64 atoms]
  unsigned char* emb_s = act_s + 2 * (W / 64) * tc::ATOM_BYTES;  // [2][KE atoms]
  unsigned char* vemb_s = emb_s + 2 * KE * tc::ATOM_BYTES;       // [2][KV atoms]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vemb_s + 2 * KV * tc::ATOM_BYTES);
  tc::init_ring(bars, TC_STAGES);
  const long long chunks = (M + tc::ROWS - 1) / tc::ROWS;
  const int wg = threadIdx.x / tc::WGT;

  if (wg == 0) {  // the producer
    tc::set_regs<tc::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int st = 0, ph = 0;
      for (long long c = blockIdx.x; c < chunks; c += gridDim.x)
        tc::produce(plan, img, tc::smem_u32(sm), bars, bars + TC_STAGES, TC_STAGES, st, ph);
    }
  } else {
    tc::set_regs<tc::CONSUMER_REGS>();
    const int w = wg - 1;
    const int tid = threadIdx.x - wg * tc::WGT;
    unsigned char* act = act_s + w * (W / 64) * tc::ATOM_BYTES;
    unsigned char* emb = emb_s + w * KE * tc::ATOM_BYTES;
    unsigned char* vt = vemb_s + w * KV * tc::ATOM_BYTES;
    tc::Ring ring{tc::smem_u32(sm), bars, bars + TC_STAGES, TC_STAGES, 0, 0, -1};
    if constexpr (!RAW) {  // the pad columns, which no chunk writes
      for (int i = tid; i < 64 * KE * 64; i += tc::WGT) tc::put(emb, i / (KE * 64), i % (KE * 64), 0.f);
      for (int i = tid; i < 64 * KV * 64; i += tc::WGT) tc::put(vt, i / (KV * 64), i % (KV * 64), 0.f);
    }
    for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
      const long long row0 = c * tc::ROWS + w * 64;
      const int nvalid = (int)max(0LL, min(64LL, M - row0));
      if constexpr (RAW) {  // two threads a row, as B3's encode
        const int r = tid & 63, part = tid >> 6;
        float x[3] = {0.f, 0.f, 0.f}, v[3] = {0.f, 0.f, 0.f};
        if (r < nvalid)
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            x[a] = in0[(row0 + r) * 3 + a];
            v[a] = in1[(row0 + r) * 3 + a];
          }
        tc::encode_row(emb, r, part, x, (cin - 3) / 6, cin, KE * 64);
        tc::encode_row(vt, r, part, v, (cv - 3) / 6, cv, KV * 64);
      } else {
        load_tile(emb, tid, in0, cin, row0, nvalid);
        load_tile(vt, tid, in1, cv, row0, nvalid);
      }
      tc::publish(w);
      tc::field_rows<W, A>(act, tc::smem_u32(emb), tc::smem_u32(vt), bias, D, skip, tid, w, ring, raw + row0 * 4,
                           nvalid, nullptr);
    }
  }
}

// The tiles a launch takes: narrow where both embeddings fit one atom.
inline bool narrow(int cin, int cv) { return cin <= 64 && cv <= 64; }

// The weight image of B7 / B8's packed buffers (ops/kernels/trunk.py: both
// embeddings on 128-row pads) for the tensor-core launch's tiles.
template <int W>
tc::Plan trunk_tc_plan(int D, int skip, int cin, int cv) {
  return narrow(cin, cv) ? tc::render_plan<W, TrunkNarrow>(D, skip, Trunk::CIN, Trunk::CV)
                         : tc::render_plan<W, VanillaWide>(D, skip, Trunk::CIN, Trunk::CV);
}

// Packs the image into img (img_bytes long) and launches trunk_tc_kernel
// on a persistent grid.
template <int W, bool RAW>
int tc_fwd(const float* in0, int cin, const float* in1, int cv, const void* wts, const float* bias, int D, int skip,
           long long M, float* raw, void* img, long long img_bytes, cudaStream_t st) {
  const tc::Plan plan = trunk_tc_plan<W>(D, skip, cin, cv);
  if (img == nullptr || img_bytes < plan.bytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = tc::pack(wts, plan, img, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto go = [&](auto kern, size_t smem) {
    SWNERF_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    kern<<<tc::grid_for((M + tc::ROWS - 1) / tc::ROWS), tc::NTHREADS, smem, st>>>(
        in0, cin, in1, cv, plan, static_cast<const unsigned char*>(img), bias, D, skip, M, raw);
    return static_cast<int>(cudaGetLastError());
  };
  if (narrow(cin, cv)) return go(trunk_tc_kernel<W, TrunkNarrow, RAW>, trunk_tc_smem<W, TrunkNarrow>());
  return go(trunk_tc_kernel<W, VanillaWide, RAW>, trunk_tc_smem<W, VanillaWide>());
}

// gq = q(g); column W of dfa = q(d alpha). With MASK (B7'), the colour
// columns first take the ReLU's mask u > 0, and gm keeps the masked fp32
// cotangent.
template <typename T, bool MASK>
__global__ void cotangent_kernel(const float* __restrict__ g, const float* __restrict__ u, long long P, int W,
                                 T* __restrict__ gq, T* __restrict__ dfa, float* __restrict__ gm) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P * 4) return;
  float x = g[idx];
  if (MASK) {
    if ((idx & 3) != 3 && !(u[idx] > 0.f)) x = 0.f;
    gm[idx] = x;
  }
  const T v = Op<T>::q(x);
  gq[idx] = v;
  if ((idx & 3) == 3) dfa[(idx >> 2) * (W + PADC) + W] = v;
}

// The bf16 forward-only launch of B7 and B8 runs on the tensor cores.
template <typename T, typename A>
constexpr bool on_tc() {
  return sizeof(T) == 2 && !A::RGB_RELU;
}

// The forward: with scratch, train mode on trunk_fwd_kernel; without it,
// the forward-only launch (B7 / B8 in bf16: tc_fwd, which takes the weight
// image img; else trunk_fwd_kernel).
template <typename T, int W, typename A>
int fwd(const float* emb, int cin, const float* vemb, int cv, const void* wts, const float* bias, int D, int skip,
        long long M, float* raw, void* scratch, void* img, long long img_bytes, cudaStream_t st) {
  constexpr int LDA = Op<T>::LDA;
  const size_t smem = sizeof(float) * NRED + sizeof(T) * ((size_t)(2 * W + A::CIN + A::CV) * LDA + KT * W);
  auto launch = [&](auto kern, Scratch<T> sc) {
    SWNERF_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    kern<<<ceil_div(M, CH), NT, smem, st>>>(emb, cin, vemb, cv, static_cast<const T*>(wts), bias, D, skip, M, raw,
                                            sc);
    return static_cast<int>(cudaGetLastError());
  };
  if (scratch) return launch(trunk_fwd_kernel<T, W, A, true>, carve<T, A>(scratch, W, D, M));
  if constexpr (on_tc<T, A>())
    return tc_fwd<W, A::RAW>(emb, cin, vemb, cv, wts, bias, D, skip, M, raw, img, img_bytes, st);
  else
    return launch(trunk_fwd_kernel<T, W, A, false>, Scratch<T>{});
}

// The backward from the train-mode forward's scratch. demb / dvemb: B7 and
// B7' write the embeddings' fp32 cotangents there where not null; B8 writes
// d pts / d viewdirs [P][3] there, from x / xv (its inputs).
template <typename T, int W, typename A>
int bwd(const void* wts_v, int D, int skip, int cin, int cv, long long P, const float* x, const float* xv,
        const float* g, float* gw, float* gb, float* demb, float* dvemb, void* scratch, cudaStream_t st) {
  const T* wts = static_cast<const T*>(wts_v);
  Scratch<T> sc = carve<T, A>(scratch, W, D, P);
  cotangent_kernel<T, A::RGB_RELU><<<ceil_div(P * 4, 256), 256, 0, st>>>(g, sc.u, P, W, sc.gq, sc.dfa, sc.gm);
  SWNERF_CHECK(cudaGetLastError());
  auto hl = [&](int i) { return static_cast<const T*>(sc.h + (size_t)i * sc.hstride); };
  FieldTape<T, decltype(hl)> tape{sc.emb, sc.vemb, hl, sc.feat, sc.hv, sc.dfa, sc.gq, A::RGB_RELU ? sc.gm : g,
                                  sc.dz, sc.dhv_c, sc.dhv32, sc.part};
  if constexpr (A::RAW) {
    SWNERF_RUN((field_reverse<T, W, A::ACT>(wts, D, skip, A::CIN, cin, A::CV, cv, P, tape, gw, gb,
                                            demb ? sc.demb : nullptr, dvemb ? sc.dvemb : nullptr, st)));
    if (demb) {
      encode_bwd_kernel<<<ceil_div(P * 3, 256), 256, 0, st>>>(x, sc.demb, cin, (cin - 3) / 6, P, demb);
      SWNERF_CHECK(cudaGetLastError());
    }
    if (dvemb) {
      encode_bwd_kernel<<<ceil_div(P * 3, 256), 256, 0, st>>>(xv, sc.dvemb, cv, (cv - 3) / 6, P, dvemb);
      SWNERF_CHECK(cudaGetLastError());
    }
    return 0;
  } else {
    constexpr bool TC = std::is_same<T, __nv_bfloat16>::value && std::is_same<A, Trunk>::value;  // B7
    return field_reverse<T, W, A::ACT, decltype(hl), TC>(wts, D, skip, A::CIN, cin, A::CV, cv, P, tape, gw, gb, demb,
                                                         dvemb, st);
  }
}

// Calls f(Tag<T>, W, Tag<A>) for the operand type, the width and the field
// family (0: B7, 1: B7', 2: B8).
template <typename X>
struct Tag {
  using type = X;
};
template <int V>
using WTag = std::integral_constant<int, V>;

template <typename F>
auto dispatch(int arch, int bf16, int W, F f) {
  auto by_w = [&](auto t, auto a) { return W == 256 ? f(t, WTag<256>{}, a) : f(t, WTag<128>{}, a); };
  auto by_t = [&](auto a) { return bf16 ? by_w(Tag<__nv_bfloat16>{}, a) : by_w(Tag<float>{}, a); };
  if (arch == 2) return by_t(Tag<TrunkRaw>{});
  if (arch == 1) return by_t(Tag<TrunkElu>{});
  return by_t(Tag<Trunk>{});
}

bool shape_ok(int arch, int W, int D, int skip, int cin, int cv, long long P) {
  const bool encodes = arch != 2 || ((cin - 3) % 6 == 0 && (cv - 3) % 6 == 0 && cin >= 3 && cv >= 3);
  return arch >= 0 && arch <= 2 && encodes && (W == 128 || W == 256) && D >= 2 && D <= 16 && skip >= 0 &&
         skip + 1 < D && cin >= 1 && cin < Trunk::CIN && cv >= 1 && cv <= Trunk::CV &&
         P * (W + PADC) < (1LL << 31);
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of train-mode scratch for P rows of field family ``arch`` (0: B7,
// 1: B7', 2: B8), or -1 for an unsupported width or family.
long long trunk_scratch_bytes(int arch, int bf16, int W, int D, long long P) {
  if ((W != 128 && W != 256) || arch < 0 || arch > 2) return -1;
  return dispatch(arch, bf16, 128, [&](auto t, auto, auto a) {
    return (long long)scratch_bytes<typename decltype(t)::type, typename decltype(a)::type>(W, D, P);
  });
}

// Bytes of the weight image that the forward-only launch of family arch
// takes (B7 and B8 in bf16: the tensor-core kernel), else 0; -1 for an
// unsupported shape.
long long trunk_image_bytes(int arch, int bf16, int W, int D, int skip, int cin, int cv) {
  if (!shape_ok(arch, W, D, skip, cin, cv, 1)) return -1;
  if (!bf16 || arch == 1) return 0;
  return W == 256 ? trunk_tc_plan<256>(D, skip, cin, cv).bytes : trunk_tc_plan<128>(D, skip, cin, cv).bytes;
}

// raw [P, 4] of field family ``arch``: B7 (0) and B7' (1) at emb [P, cin]
// and vemb [P, cv] (fp32, contiguous; B7': rgb after the colour ReLU); B8
// (2) at positions emb [P, 3] and view directions vemb [P, 3], encoded in
// the block to cin = 3 + 6L and cv = 3 + 6Lv columns. wts / bias: the
// packed buffers of ops/kernels/trunk.py (bf16 != 0: bf16 operands, else
// fp32). scratch (train mode, trunk_scratch_bytes) or null: with it the
// forward keeps what the backward needs. img (img_bytes long): the
// forward-only launch's weight image where trunk_image_bytes is not 0.
int trunk_fwd_launch(int arch, int bf16, int W, const float* emb, int cin, const float* vemb, int cv, const void* wts,
                     const float* bias, int D, int skip, long long P, float* raw, void* scratch, void* img,
                     long long img_bytes, void* stream) {
  if (P == 0) return 0;
  if (!shape_ok(arch, W, D, skip, cin, cv, P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(arch, bf16, W, [&](auto t, auto w, auto a) {
    return fwd<typename decltype(t)::type, decltype(w)::value, typename decltype(a)::type>(
        emb, cin, vemb, cv, wts, bias, D, skip, P, raw, scratch, img, img_bytes, st);
  });
}

// The gradients of sum(g * raw) for the cotangent g [P, 4] (fp32), from the
// scratch of the train-mode forward on the same weights and inputs: gw / gb
// in the packed layouts, which the caller zeroes; where not null, demb
// [P, cin] and dvemb [P, cv] (fp32) for B7 and B7', and for B8 d pts and
// d viewdirs [P, 3] there, from its inputs x (positions) and xv (view
// directions).
int trunk_bwd_launch(int arch, int bf16, int W, const void* wts, int D, int skip, int cin, int cv, long long P,
                     const float* x, const float* xv, const float* g, float* gw, float* gb, float* demb,
                     float* dvemb, void* scratch, void* stream) {
  if (P == 0) return 0;
  if (!shape_ok(arch, W, D, skip, cin, cv, P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(arch, bf16, W, [&](auto t, auto w, auto a) {
    return bwd<typename decltype(t)::type, decltype(w)::value, typename decltype(a)::type>(
        wts, D, skip, cin, cv, P, x, xv, g, gw, gb, demb, dvemb, scratch, st);
  });
}

}  // extern "C"
