// Train-mode render pass of a vanilla NeRF (kernel B1) and of a T-NeRF
// (kernel B4, train mode) for Hopper: forward, per-ray squared error,
// compositing backward and every parameter gradient.
//
// Replaces swnerf_tpu/ops/pallas/render_fused.py::_render_loss_kernel in
// train mode (param_grads=True, from_rays; :341-478 with _trunk_reverse
// :184-268), arch "vanilla" (B1) or "tnerf" (B4). B4 differs from B1 in the
// traits of mlp_common.cuh: the [embed(xyz) | embed(t)] input (96 padded
// rows), ELU in the trunk and the view layer, whose derivative the reverse
// sweep takes from the stored post-activation h (h > 0 ? 1 : h + 1, in
// fp32 from h in the operand type, raymarch.py:242-248), and a ReLU on the
// rgb logits before the sigmoid, whose mask [logit > 0] multiplies the
// colour cotangent. The plain twin is
// swnerf_torch/ops/kernels/render_loss.py::render_loss_plain.
//
// B5 (render_loss_pts_launch; render_fused.py's input_grads=True in pts
// mode, :317-323 and :475-487) is B1 on given sample positions pts [N, S, 3]
// (the D-NeRF canonical pass at x + dx), plus d loss / d pts: the trunk
// sweep also forms the embedding's cotangent demb = dz_{skip+1} W_emb^T +
// dz_0 W_0^T over the live columns in fp32 (gemm_common.cuh::trunk_reverse),
// and mlp_common.cuh::encode_bwd_kernel chains it through the Fourier
// encode. Both are compile-time switches (PTS): B1's and B4's
// instantiations are the code they were.
//
// B9 (render_loss_ext_launch; render_fused.py's ext_ct=True, :313-314 and
// :428-453, behind train/fused_step.py::make_render_outputs' backward) is
// B5 with a second compile-time switch (EXT): the per-ray cotangent comes
// from the caller, gct [N, 5] = d loss / d (rgb_map after the white
// background, acc, depth), in place of the squared error's, so that
// dL/dw = sum_c g_c rgb_c + g_acc + g_depth z, with g_acc = gct[3] -
// sum_c g_c on a white background. It serves MultiRes' fused phase 2, whose
// pyramid reconstruction couples the levels, at the narrow widths (the
// identity level) and at the wide ones (VanillaWide: 128 / 128 padded rows,
// levels 0-2); there the fp32 tiles at W=256 leave S <= 204 within the
// 232,448 bytes of shared memory a block may opt into.
//
// Bound on the card: operations. At D=8, W=256 the forward is 593,408
// multiply-adds per sample and the backward's dX and dW products about twice
// that (T-NeRF at D=8, W=128: 162,816 and 465,216 in all), against ~1 KB of
// per-ray input. The TPU kernel keeps a tile's
// activations in VMEM and rematerialises the gaps; a Hopper SM has 227 KB of
// shared memory, less than one fine ray's activations (192 x 256 x 4 B per
// layer). So this kernel stores them instead:
//
//  1. render_loss_fwd_kernel: B3's forward (mlp_common.cuh: whole rays per
//     256-thread block, 64-row chunks, weights streamed from L2), which also
//     spills the embedding, every layer's post-activation, feat and hv to a
//     global scratch buffer, row-major with a column of ones after the last
//     feature (so dW's bias row falls out of the same product). One thread
//     per ray then composites, forms the loss cotangent and sweeps the ray
//     backwards for the raw cotangent [P, 4] (d rgb logits, d sigma).
//  2. gemm_common.cuh::field_reverse (shared with B7, trunk.cu), from the
//     raw cotangent: head_bwd_kernel, d hv through the rgb head and the view
//     layer's activation;
//  3. per layer from the top: dH = dZ W^T with the activation's derivative
//     and the rounding to the operand type in its epilogue (row-parallel over
//     samples), and dW = X^T dZ as partial sums over a fixed split of the
//     samples. reduce_kernel adds the partials in split order and scatters
//     them into the packed gradient buffers; colsum_kernel does the same for
//     the fp32 bias sums of the heads. No atomics: two launches on the same
//     inputs give bit-equal gradients. B1 and B4 in bf16 run both products
//     of every layer, the view layer's dW and d feat on the tensor cores
//     (tc_gemm.cuh: bf16 wgmma into fp32, dW with both operands MN-major;
//     the bias rows and the d sigma column in fp32 beside the product; B4's
//     ELU' from the stored output in the dH epilogue, its 96-column spilled
//     embedding read as two 64-wide blocks whose last 32 columns the copy
//     zero-fills); the fp32 parity mode, B5 and B9 keep gemm_kernel's SIMT
//     product.
//
// Operands are fp32 (parity mode) or bf16, rounded where the plain twin and
// _trunk_reverse round them (embedding, activations, dz, g_rgb, dhv, dfa);
// products accumulate in fp32, and the gradients are fp32. The per-sample
// colour stays fp32 (the TPU kernel rounds it in bf16 mode). SIMT: fp32
// FMAs in order, the body B3's ordered pts launch runs (render_pass.cu), so
// that B9's recomputed forward equals the training path's B3 launch bit for
// bit. On the tensor cores (tc_render.cuh), whose products round each k16
// step toward zero (tc_rounding.py), B9's bf16 gradients left the twin's
// bar at MultiRes level 0, and an unbiased fold of each step did not keep
// them inside it on every seeded case; this body shares the twin's fp32
// order up to the skip layer. So every forward here stays SIMT, and only
// B1's and B4's reverse sweeps moved to the tensor cores (their masks and
// ELU' come from the stored activations, which that product does not
// rewrite); B5's and B9's backward on the tensor cores are later work. No
// --use_fast_math
// (ops/kernels/build.py):
// sinf/cosf stay accurate at the 2^9-frequency arguments, and the
// transmittance floor max(1 - alpha + 1e-10, 1e-10), which is also the
// divisor of d alpha, is not folded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "gemm_common.cuh"
#include "mlp_common.cuh"

namespace {

template <typename T>
struct Scratch {
  T* emb;    // [P][A::CIN], column A::cin(L) = 1
  T* vemb;   // [P][A::CV]
  T* h;      // D x [P][W + PADC], column W = 1, layer i at h + i * hstride
  size_t hstride;
  T* feat;   // [P][W + PADC]
  T* hv;     // [P][W/2 + PADC]
  T* dfa;    // [P][W + PADC]: d feat (columns < W), d sigma (column W)
  T* gq;     // [P][4]: the raw cotangent in the operand type
  float* graw;  // [P][4]
};

template <typename T, int W, typename A, bool PTS = false, bool EXT = false>
__global__ void __launch_bounds__(NT)
render_loss_fwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                       const float* __restrict__ times, const float* __restrict__ vemb, int cv,
                       const float* __restrict__ z,
                       const float* __restrict__ dist, const float* __restrict__ noise,
                       const float* __restrict__ target, const float* __restrict__ gct, const T* __restrict__ wts,
                       const float* __restrict__ bias, int D, int skip, int L, int white, float loss_scale,
                       int N, int S, int rays_per_block, float* __restrict__ rgb_out,
                       float* __restrict__ acc_out, float* __restrict__ depth_out,
                       float* __restrict__ sqerr_out, float* __restrict__ w_out, Scratch<T> sc) {
  constexpr int LDA = Op<T>::LDA;
  constexpr int WH = W / 2;
  constexpr int LDW = W + PADC;
  constexpr int LDH = WH + PADC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long ray0 = (long long)blockIdx.x * rays_per_block;
  const int nr = (int)min((long long)rays_per_block, (long long)N - ray0);
  const int rows = nr * S;
  const long long p0 = ray0 * S;
  const int cin = A::cin(L);

  float* raw_s = reinterpret_cast<float*>(smem_raw);  // [rays_per_block * S][4]
  float* lt_s = raw_s + rays_per_block * S * 4;        // [rays_per_block * S], padded to 4 (render_smem)
  float* red = lt_s + pad4(rays_per_block * S);        // [4][CH][3]
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
    const int nvalid = min(CH, rows - row0);
    const long long pr = p0 + row0;
    encode_chunk<T, A, PTS>(emb, vemb_s, row0, rows, ray0, S, L, cv, origins, dirs, times, z, vemb);
    __syncthreads();
    spill<T>(emb, cin, sc.emb, A::CIN, pr, nvalid, true);
    spill<T>(vemb_s, cv, sc.vemb, A::CV, pr, nvalid, false);
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
      __syncthreads();
      spill<T>(h, W, sc.h, LDW, pr, nvalid, true);
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
      __syncthreads();
      spill<T>(h, W, sc.h + i * sc.hstride, LDW, pr, nvalid, true);
    }
    {  // feature head (no activation) -> g
      float acc[8][W / 32];
      zero(acc);
      mm_acc<T, W>(acc, h, W, wp, Ws);
      wp += W * W;
      store_act<T, W, Act::None>(acc, bp, g);
      __syncthreads();
      spill<T>(g, W, sc.feat, LDW, pr, nvalid, false);
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
    spill<T>(h, WH, sc.hv, LDH, pr, nvalid, false);
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

  // One thread per ray: composite in order (raw2outputs), the loss, then a
  // reverse sweep for the raw cotangent (render_fused.py:442-473).
  if ((int)threadIdx.x < nr) {
    const int t = threadIdx.x;
    const long long ray = ray0 + t;
    const float* zr = z + ray * S;
    const float* dr = dist + ray * S;
    const float* nz = noise ? noise + ray * S : nullptr;
    float* wr = w_out + ray * S;
    float* lt = lt_s + t * S;
    float log_t = 0.f, acc = 0.f, dep = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* rw = raw_s + (t * S + s) * 4;
      const float sigma = nz ? rw[3] + nz[s] : rw[3];
      const float alpha = 1.f - expf(-fmaxf(sigma, 0.f) * dr[s]);
      const float safe = fmaxf(1.f - alpha + 1e-10f, 1e-10f);
      const float w = alpha * expf(log_t);
      lt[s] = log_t;
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
    rgb_out[ray * 3 + 0] = c0;
    rgb_out[ray * 3 + 1] = c1;
    rgb_out[ray * 3 + 2] = c2;
    acc_out[ray] = acc;
    depth_out[ray] = dep;
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
      const float* rw = raw_s + (t * S + s) * 4;
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
      const long long pp = ray * S + s;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float d = w * gcol[c] * rgb[c] * (1.f - rgb[c]);
        if (A::RGB_RELU && !(rw[c] > 0.f)) d = 0.f;  // the colour ReLU's mask
        sc.graw[pp * 4 + c] = d;
        sc.gq[pp * 4 + c] = Op<T>::q(d);
      }
      sc.graw[pp * 4 + 3] = dsig;
      sc.gq[pp * 4 + 3] = Op<T>::q(dsig);
      sc.dfa[pp * LDW + W] = Op<T>::q(dsig);
    }
  }
}

template <typename T, typename A, bool PTS = false>
size_t scratch_bytes(int W, int D, long long P) {
  const int WH = W / 2;
  size_t b = 0;
  b += align256(sizeof(T) * P * A::CIN);
  b += align256(sizeof(T) * P * A::CV);
  b += align256(sizeof(T) * P * (W + PADC)) * D;
  b += align256(sizeof(T) * P * (W + PADC));        // feat
  b += align256(sizeof(T) * P * (WH + PADC));       // hv
  b += align256(sizeof(T) * P * (W + PADC));        // dfa
  b += align256(sizeof(T) * P * W) * 2;             // dz ping-pong
  b += align256(sizeof(T) * P * WH);                // dhv_c
  b += align256(sizeof(T) * P * 4);                 // gq
  b += align256(sizeof(float) * P * 4);             // graw
  b += align256(sizeof(float) * P * WH);            // dhv32
  b += align256(sizeof(float) * part_floats(W));    // split partials
  if (PTS) b += align256(sizeof(float) * P * A::CIN);  // demb (B5, B9)
  return b;
}

// With PTS (B5), origins holds the sample positions [N][S][3] and dpts
// [N][S][3] receives d(loss_scale * sum sqerr) / d pts. With EXT (B9, PTS
// too) the cotangent is the caller's gct [N][5] in place of the squared
// error's (target, loss_scale and sqerr are unused).
template <typename T, int W, typename A, bool PTS = false, bool EXT = false>
int launch(const float* origins, const float* dirs, const float* times, const float* vemb, int cv, const float* z,
           const float* dist, const float* noise, const float* target, const float* gct, const void* wts_v,
           const float* bias, int D,
           int skip, int L, int white, float loss_scale, int N, int S, float* rgb, float* acc, float* depth,
           float* sqerr, float* w_out, float* gw, float* gb, float* dpts, void* scratch, cudaStream_t st) {
  constexpr int CIN = A::CIN;
  constexpr int WH = W / 2;
  constexpr int LDW = W + PADC;
  constexpr int LDH = WH + PADC;
  const T* wts = static_cast<const T*>(wts_v);
  const long long P = (long long)N * S;
  const int cin = A::cin(L);

  Carver cv_{static_cast<unsigned char*>(scratch)};
  Scratch<T> sc;
  sc.emb = cv_.take<T>(P * CIN);
  sc.vemb = cv_.take<T>(P * A::CV);
  sc.hstride = align256(sizeof(T) * P * LDW) / sizeof(T);
  sc.h = cv_.take<T>(sc.hstride * D);
  sc.feat = cv_.take<T>(P * LDW);
  sc.hv = cv_.take<T>(P * LDH);
  sc.dfa = cv_.take<T>(P * LDW);
  T* dz[2] = {cv_.take<T>(P * W), cv_.take<T>(P * W)};
  T* dhv_c = cv_.take<T>(P * WH);
  sc.gq = cv_.take<T>(P * 4);
  sc.graw = cv_.take<float>(P * 4);
  float* dhv32 = cv_.take<float>(P * WH);
  float* part = cv_.take<float>(part_floats(W));
  float* demb = PTS ? cv_.take<float>(P * CIN) : nullptr;
  auto hl = [&](int i) { return sc.h + (size_t)i * sc.hstride; };

  // 1. forward, loss and the composite backward
  const int rays_per_block = std::max(1, CH / S);
  // The wide family in fp32 at W=256 leaves S <= 204 (render_loss_max_samples).
  const size_t smem = render_smem<T, W, A, 5>(S);
  if (smem > SMEM_OPTIN) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = render_loss_fwd_kernel<T, W, A, PTS, EXT>;
  SWNERF_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const long long blocks = ((long long)N + rays_per_block - 1) / rays_per_block;
  kern<<<(unsigned)blocks, NT, smem, st>>>(origins, dirs, times, vemb, cv, z, dist, noise, target, gct, wts, bias, D,
                                            skip, L, white, loss_scale, N, S, rays_per_block, rgb, acc, depth,
                                            sqerr, w_out, sc);
  SWNERF_CHECK(cudaGetLastError());

  // 2-4. the heads, d feat next to d sigma, the trunk (with B5's input
  //      cotangent): gemm_common.cuh::field_reverse; bf16 B1's and B4's
  //      large products on the tensor cores (TC)
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value &&
                      (std::is_same<A, Vanilla>::value || std::is_same<A, TNerf>::value) && !PTS && !EXT;
  FieldTape<T, decltype(hl)> tape{sc.emb, sc.vemb, hl, sc.feat, sc.hv, sc.dfa, sc.gq, sc.graw, dz, dhv_c, dhv32, part};
  SWNERF_RUN((field_reverse<T, W, A::ACT, decltype(hl), TC>(wts, D, skip, CIN, cin, A::CV, cv, P, tape, gw, gb, demb,
                                                            nullptr, st)));
  if (PTS) {  // 5. B5, B9: through the encode to the positions
    encode_bwd_kernel<<<ceil_div(P * 3, 256), 256, 0, st>>>(origins, demb, cin, L, P, dpts);
    SWNERF_CHECK(cudaGetLastError());
  }
  return 0;
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most samples per ray render_loss_launch (tnerf) and
// render_loss_ext_launch (wide) take: the train-mode block's shared memory.
int render_loss_max_samples(int tnerf, int bf16, int wide, int W) {
  return render_max_samples<5>(tnerf, bf16, wide, W);
}

// Bytes of scratch render_loss_launch needs, or -1 for an unsupported width.
long long render_loss_scratch_bytes(int tnerf, int bf16, int W, int D, int N, int S) {
  if (W != 128 && W != 256) return -1;
  const long long P = (long long)N * S;
  if (tnerf)
    return (long long)(bf16 ? scratch_bytes<__nv_bfloat16, TNerf>(W, D, P) : scratch_bytes<float, TNerf>(W, D, P));
  return (long long)(bf16 ? scratch_bytes<__nv_bfloat16, Vanilla>(W, D, P) : scratch_bytes<float, Vanilla>(W, D, P));
}

// tnerf: 0 for a vanilla field (B1), 1 for a T-NeRF (B4). origins, dirs
// [N, 3]; times [N] (B4 only, else null); vemb [N, cv]; z, dist, noise
// (nullable) [N, S]; target [N, 3]; wts / bias: the packed buffers of
// ops/kernels/render_pass.py::pack_params / pack_tnerf_params (bf16 != 0:
// bf16 operands, else fp32). Outputs rgb [N, 3], acc, depth, sqerr [N],
// w_out [N, S]; gw / gb: fp32 gradients of loss_scale * sum(sqerr) in the
// packed layouts, which the caller zeroes (padded rows stay 0). scratch:
// render_loss_scratch_bytes.
int render_loss_launch(int tnerf, int bf16, int W, const float* origins, const float* dirs, const float* times,
                       const float* vemb, int cv, const float* z, const float* dist, const float* noise,
                       const float* target, const void* wts, const float* bias, int D, int skip, int L, int white,
                       float loss_scale, int N, int S, float* rgb, float* acc, float* depth, float* sqerr,
                       float* w_out, float* gw, float* gb, void* scratch, void* stream) {
  if (N == 0) return 0;
  // cin < CIN leaves room for the column of ones of the embedding's dW.
  const bool cin_ok = tnerf ? times != nullptr && TNerf::cin(L) < TNerf::CIN : Vanilla::cin(L) < Vanilla::CIN;
  if (D < 2 || D > 16 || skip < 0 || skip + 1 >= D || !cin_ok || cv > Vanilla::CV || cv > TNerf::CV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_LAUNCH(T, WW, AA)                                                                               \
  launch<T, WW, AA>(origins, dirs, times, vemb, cv, z, dist, noise, target, nullptr, wts, bias, D, skip, L, white, \
                    loss_scale, N, S, rgb, acc, depth, sqerr, w_out, gw, gb, nullptr, scratch, st)
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

// B5's scratch bytes, or -1 for an unsupported width.
long long render_loss_pts_scratch_bytes(int bf16, int W, int D, int N, int S) {
  if (W != 128 && W != 256) return -1;
  const long long P = (long long)N * S;
  return (long long)(bf16 ? scratch_bytes<__nv_bfloat16, Vanilla, true>(W, D, P)
                          : scratch_bytes<float, Vanilla, true>(W, D, P));
}

// B5 (the D-NeRF canonical train pass, vanilla field): B1 on given sample
// positions pts [N, S, 3] (encoded in-block), and dpts [N, S, 3] = d(loss_scale
// * sum sqerr) / d pts through the encode. Other arguments as
// render_loss_launch's; scratch: render_loss_pts_scratch_bytes.
int render_loss_pts_launch(int bf16, int W, const float* pts, const float* vemb, int cv, const float* z,
                           const float* dist, const float* noise, const float* target, const void* wts,
                           const float* bias, int D, int skip, int L, int white, float loss_scale, int N, int S,
                           float* rgb, float* acc, float* depth, float* sqerr, float* w_out, float* gw, float* gb,
                           float* dpts, void* scratch, void* stream) {
  if (N == 0) return 0;
  if (D < 2 || D > 16 || skip < 0 || skip + 1 >= D || Vanilla::cin(L) >= Vanilla::CIN || cv > Vanilla::CV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_LAUNCH(T, WW)                                                                                      \
  launch<T, WW, Vanilla, true>(pts, nullptr, nullptr, vemb, cv, z, dist, noise, target, nullptr, wts, bias, D, skip, \
                               L, white, loss_scale, N, S, rgb, acc, depth, sqerr, w_out, gw, gb, dpts, scratch, st)
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

// B9's scratch bytes (wide != 0: the MultiRes widths, VanillaWide), or -1
// for an unsupported width.
long long render_loss_ext_scratch_bytes(int bf16, int wide, int W, int D, int N, int S) {
  if (W != 128 && W != 256) return -1;
  const long long P = (long long)N * S;
  if (wide)
    return (long long)(bf16 ? scratch_bytes<__nv_bfloat16, VanillaWide, true>(W, D, P)
                            : scratch_bytes<float, VanillaWide, true>(W, D, P));
  return (long long)(bf16 ? scratch_bytes<__nv_bfloat16, Vanilla, true>(W, D, P)
                          : scratch_bytes<float, Vanilla, true>(W, D, P));
}

// B9 (train/fused_step.py::make_render_outputs' backward; the MultiRes fused
// phase 2): B5's body on given positions pts [N, S, 3] with the caller's
// per-ray cotangent gct [N, 5] (d loss / d rgb_map after the white
// background, d acc, d depth) in place of the squared error's. It recomputes
// the forward (rgb, acc, depth, w_out as B3's pts mode gives them) and
// writes the fp32 parameter gradients gw / gb (zeroed by the caller) and
// dpts [N, S, 3]. wide as render_pass_pts_launch's; scratch:
// render_loss_ext_scratch_bytes.
int render_loss_ext_launch(int bf16, int wide, int W, const float* pts, const float* vemb, int cv, const float* z,
                           const float* dist, const float* noise, const float* gct, const void* wts,
                           const float* bias, int D, int skip, int L, int white, int N, int S, float* rgb, float* acc,
                           float* depth, float* w_out, float* gw, float* gb, float* dpts, void* scratch,
                           void* stream) {
  if (N == 0) return 0;
  const bool shape_ok = wide ? VanillaWide::cin(L) < VanillaWide::CIN && cv <= VanillaWide::CV
                             : Vanilla::cin(L) < Vanilla::CIN && cv <= Vanilla::CV;
  if (D < 2 || D > 16 || skip < 0 || skip + 1 >= D || L < 0 || !shape_ok || gct == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_LAUNCH(T, WW, AA)                                                                                  \
  launch<T, WW, AA, true, true>(pts, nullptr, nullptr, vemb, cv, z, dist, noise, nullptr, gct, wts, bias, D, skip, \
                                L, white, 0.f, N, S, rgb, acc, depth, nullptr, w_out, gw, gb, dpts, scratch, st)
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
