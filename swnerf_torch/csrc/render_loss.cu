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
// levels 0-2); there the ring block's fp32 tiles at W=256 leave S <= 225
// within the 232,448 bytes of shared memory a block may opt into.
//
// Bound on the card: operations. At D=8, W=256 the forward is 593,408
// multiply-adds per sample and the backward's dX and dW products about twice
// that (T-NeRF at D=8, W=128: 162,816 and 465,216 in all), against ~1 KB of
// per-ray input. The TPU kernel keeps a tile's
// activations in VMEM and rematerialises the gaps; a Hopper SM has 227 KB of
// shared memory, less than one fine ray's activations (192 x 256 x 4 B per
// layer). So this kernel stores them instead:
//
//  1. the forward, which also stores the embedding, the view embedding,
//     every layer's post-activation, feat and hv in a global scratch
//     buffer, row-major with a column of ones after the last feature (so
//     dW's bias row falls out of the same product). One thread per ray then
//     composites, forms the loss cotangent and sweeps the ray backwards for
//     the raw cotangent [P, 4] (d rgb logits, d sigma;
//     mlp_common.cuh::ray_reverse). In bf16, B1 and B4 at W=128 run it on
//     the tensor cores: tc_render.cuh::render_loss_tc_kernel, B3's body
//     (the same products and composite, so rgb, acc, depth and the weights
//     equal the bf16 render_pass launch bit for bit), each tile copied to
//     the scratch while the next product reads it, the composite, loss and
//     reverse on the producer warpgroup's three spare warps beside the next
//     unit's products. Otherwise render_loss_fwd_kernel: a persistent grid
//     over units of whole rays, 64-row chunks of their samples on
//     mlp_common.cuh's mm_ring (two consumer warpgroups; one producer thread
//     streams an fp32 image of the weights, widened once a launch in bf16,
//     into a 3-stage mbarrier ring with cp.async.bulk, across layers, chunks
//     and units), each layer's spill written from the epilogue's registers;
//     a compositor warp composites and sweeps unit i's rays, a lane a ray,
//     while the consumers run unit i + 1. Bound: the fp32 FMA rate (66.9
//     TFLOP/s at 1.98 GHz: 1.703 ms for B5's 500 x 192, 1.247 ms for B9
//     wide's 1,024 x 64), because this forward keeps the fp32 FMA order
//     (below). Its outputs equal B3's ordered SIMT launch bit for bit.
//  2. gemm_common.cuh::field_reverse (shared with B7, trunk.cu), from the
//     raw cotangent: head_bwd_kernel, d hv through the rgb head and the view
//     layer's activation;
//  3. per layer from the top: dH = dZ W^T with the activation's derivative
//     and the rounding to the operand type in its epilogue (row-parallel over
//     samples), and dW = X^T dZ as partial sums over a fixed split of the
//     samples. reduce_kernel adds the partials in split order and scatters
//     them into the packed gradient buffers; colsum_kernel does the same for
//     the fp32 bias sums of the heads. No atomics: two launches on the same
//     inputs give bit-equal gradients. In bf16, B1, B4, B5 and B9 run both
//     products of every layer, the view layer's dW and d feat, and B5's and
//     B9's input cotangent on the tensor cores (tc_gemm.cuh: bf16 wgmma
//     into fp32, dW with both operands MN-major; the bias rows and the d
//     sigma column in fp32 beside the product; B4's ELU' from the stored
//     output in the dH epilogue, its 96-column spilled embedding read as
//     two 64-wide blocks whose last 32 columns the copy zero-fills; demb
//     over the 64-column pad of B5 and narrow B9 or the 128-column pad of
//     wide B9, stored in fp32 for the skip layer, added to for layer 0);
//     the fp32 parity mode keeps gemm_kernel's SIMT product.
//
// Operands are fp32 (parity mode) or bf16, rounded where the plain twin and
// _trunk_reverse round them (embedding, activations, dz, g_rgb, dhv, dfa);
// products accumulate in fp32, and the gradients are fp32. The per-sample
// colour stays fp32 (the TPU kernel rounds it in bf16 mode). The tensor
// cores round each k16 step of a product toward zero (tc_rounding.py), and
// a forward on them moves the stored activations, and with them the masks
// and ELU' of the whole sweep. B1's and B4's train-mode forwards moved:
// with the forward, composite and sweep on that rounding model their
// gradients stay within 5e-3 of the twin's (tests/test_torch_tc_backward.py;
// on the card within 1e-2). These keep fp32 FMAs in order, one accumulator
// an output from +0 over k ascending (mm_ring, in mm_acc's order: the same
// outputs bit for bit, and so the same gradients): B9's recomputed forward,
// which must equal the training path's B3 launch (the ordered pts launch,
// render_pass.cu, still on mm_acc) bit for bit and whose gradients left the
// twin's bar at MultiRes level 0 on the tensor cores; B5's, whose
// gradients with the forward on the model land 1.04e-2 from the twin
// (tc_rounding.py --backward b5), and which equals the same launch; the
// T-NeRF at W=256 (no configuration trains one), whose card test case moves
// two colour-ReLU masks under the rounding and lands 3.5e-2 from the twin,
// as the model predicts; and fp32.
// No --use_fast_math
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
#include "tc_render.cuh"

namespace {

// B1's and B4's bf16 train-mode forward runs tc_render.cuh's tensor-core
// body (render_loss_tc_kernel); fp32, B5 (PTS), B9 (EXT) and the T-NeRF at
// W=256 keep render_loss_fwd_kernel (the header says why).
template <typename T, int W, typename A, bool PTS, bool EXT>
constexpr bool tc_forward() {
  return std::is_same<T, __nv_bfloat16>::value &&
         (std::is_same<A, Vanilla>::value || (std::is_same<A, TNerf>::value && W == 128)) && !PTS && !EXT;
}

// Bytes of the tensor-core forward's weight image (tc::render_plan). The
// skip's place does not change its size: one embedding product at skip + 1
// < D, which the launchers require.
template <typename A>
long long image_bytes(int W, int D) {
  return W == 256 ? tc::render_plan<256, A>(D, 0).bytes : tc::render_plan<128, A>(D, 0).bytes;
}

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

// The rays of unit u: rays_per_block, but the last unit's rest.
__device__ __forceinline__ int unit_rays(int u, int rays_per_block, int N) {
  return min(rays_per_block, N - u * rays_per_block);
}

// A persistent grid over units of rays_per_block whole rays (one ray at S >=
// 64), in blocks of NTR threads. In the producer warpgroup, warp 8 streams
// the weight image img through the ring once per 64-row chunk of every
// unit, and warp 9 composites and sweeps unit i's rays, a lane a ray, while
// the two consumer warpgroups run the field on unit i + 1's chunks (wts,
// the operand buffer, feeds the heads) and leave each unit's raw lanes in
// one of two buffers. Two mbarriers a buffer hand it over: full (every
// consumer thread arrives after its raw writes) and empty (every
// compositor lane after its reads).
template <typename T, int W, typename A, bool PTS = false, bool EXT = false>
__global__ void __launch_bounds__(NTR, 1)
render_loss_fwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                       const float* __restrict__ times, const float* __restrict__ vemb, int cv,
                       const float* __restrict__ z,
                       const float* __restrict__ dist, const float* __restrict__ noise,
                       const float* __restrict__ target, const float* __restrict__ gct, const T* __restrict__ wts,
                       const float* __restrict__ img, const float* __restrict__ bias, int D, int skip, int L,
                       int white, float loss_scale, int N, int S, int rays_per_block, float* __restrict__ rgb_out,
                       float* __restrict__ acc_out, float* __restrict__ depth_out,
                       float* __restrict__ sqerr_out, float* __restrict__ w_out, Scratch<T> sc) {
  using TL = TileF<T>;
  constexpr int LDW = W + PADC;
  constexpr int WH = W / 2;
  constexpr int LDH = WH + PADC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lanes = rays_per_block * S;  // samples a unit
  const int units = (N + rays_per_block - 1) / rays_per_block;
  const int cin = A::cin(L);

  float* raw_s = reinterpret_cast<float*>(smem_raw);  // [2][lanes][4]: a unit's raw, two buffers
  float* lt_s = raw_s + 2 * lanes * 4;                 // [lanes], padded to 4 (ring_render_smem)
  float* red = lt_s + pad4(lanes);                     // [4][CH][3]
  float* tiles = red + NRED;                           // [RSTAGES][RT * W]: the ring
  float* actA = tiles + RSTAGES * RT * W;              // [W][CH]
  float* actB = actA + W * CH;                         // [W][CH]
  float* emb = actB + W * CH;                          // [A::CIN][CH]
  float* vemb_s = emb + A::CIN * CH;                   // [A::CV][CH]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vemb_s + A::CV * CH);  // the ring's, then raw full[2], empty[2]
  uint64_t* raw_full = bars + 2 * RSTAGES;
  uint64_t* raw_empty = raw_full + 2;
  if (threadIdx.x == 0)
    for (int b = 0; b < 2; ++b) {
      tc::mbar_init(&raw_full[b], NT);
      tc::mbar_init(&raw_empty[b], 32);
    }
  tc::init_ring(bars, RSTAGES);  // fences the inits above too
  WRing ring{tiles, bars, bars + RSTAGES, RT * W, 0, 0};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= NT / 32) {  // the producer warpgroup
    tc::set_regs<tc::TRAIN_PRODUCER_REGS>();  // 72: room for the compositor warp's composite and reverse
    if (warp == NT / 32) {  // the producer: one pass over the weights per chunk
      if (lane == 0) {
        int passes = 0;
        for (int u = blockIdx.x; u < units; u += gridDim.x)
          passes += (unit_rays(u, rays_per_block, N) * S + CH - 1) / CH;
        produce_field<W>(img, D, skip, A::CIN, A::CV, passes, ring);
      }
      return;
    }
    if (warp > NT / 32 + 1) return;  // idle
    // the compositor
    int i = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
      const int b = i & 1;
      tc::mbar_wait(&raw_full[b], (i >> 1) & 1);
      const float* raw_u = raw_s + b * lanes * 4;
      const int nr = unit_rays(u, rays_per_block, N);
      // One lane per ray: composite in order (raw2outputs), the loss, then a
      // reverse sweep for the raw cotangent (render_fused.py:442-473).
      for (int t = lane; t < nr; t += 32) {
        const long long ray = (long long)u * rays_per_block + t;
        const float* zr = z + ray * S;
        const float* dr = dist + ray * S;
        const float* nz = noise ? noise + ray * S : nullptr;
        float* wr = w_out + ray * S;
        float* lt = lt_s + t * S;
        float log_t = 0.f, acc = 0.f, dep = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
        for (int s = 0; s < S; ++s) {
          const float* rw = raw_u + (t * S + s) * 4;
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
        ray_reverse<A, EXT>(raw_u + t * S * 4, lt, S, zr, dr, nz, white, c0, c1, c2, ray, target, gct, loss_scale,
                            sqerr_out, [&](int s, const float (&d)[3], float dsig) {
                              const long long pp = ray * S + s;
#pragma unroll
                              for (int c = 0; c < 3; ++c) {
                                sc.graw[pp * 4 + c] = d[c];
                                sc.gq[pp * 4 + c] = Op<T>::q(d[c]);
                              }
                              sc.graw[pp * 4 + 3] = dsig;
                              sc.gq[pp * 4 + 3] = Op<T>::q(dsig);
                              sc.dfa[pp * LDW + W] = Op<T>::q(dsig);
                            });
      }
      __syncwarp();
      tc::mbar_arrive(&raw_empty[b]);
    }
    return;
  }
  tc::set_regs<tc::TRAIN_CONSUMER_REGS>();

  const float* b_views = bias + (D + 1) * W;
  const float* b_rgb = b_views + WH;
  const float b_alpha = b_rgb[3];
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;
  int i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int b = i & 1;
    const long long ray0 = (long long)u * rays_per_block;
    const int rows = unit_rays(u, rays_per_block, N) * S;
    const long long p0 = ray0 * S;
    float* raw_u = raw_s + b * lanes * 4;
    tc::mbar_wait(&raw_empty[b], ((i >> 1) & 1) ^ 1);  // the compositor is done with unit i - 2
    for (int row0 = 0; row0 < rows; row0 += CH) {
      const int nvalid = min(CH, rows - row0);
      const long long pr = p0 + row0;
      encode_chunk<T, A, PTS, true, TL>(emb, vemb_s, row0, rows, ray0, S, L, cv, origins, dirs, times, z, vemb);
      consumer_sync();
      spill<T, TL>(emb, cin, sc.emb, A::CIN, pr, nvalid, true);
      spill<T, TL>(vemb_s, cv, sc.vemb, A::CV, pr, nvalid, false);
      // Each warp's products read only the rows its own epilogues wrote: a
      // warp barrier between layers, a consumer barrier where the heads
      // read every row.
      const float* bp = bias;
      float* h = actA;
      float* g = actB;
      {
        float acc[8][W / 32];
        zero(acc);
        mm_ring<W>(acc, emb, A::CIN, ring);
        store_ring<T, W, A::ACT>(acc, bp, h, sc.h, LDW, pr, nvalid, true);
        bp += W;
        __syncwarp();
      }
      for (int l = 1; l < D; ++l) {
        float acc[8][W / 32];
        zero(acc);
        if (l == skip + 1) mm_ring<W>(acc, emb, A::CIN, ring);  // cat([emb, h]) @ W == emb @ W_emb + h @ W_h
        mm_ring<W>(acc, h, W, ring);
        store_ring<T, W, A::ACT>(acc, bp, g, sc.h + l * sc.hstride, LDW, pr, nvalid, true);
        bp += W;
        float* t = h;
        h = g;
        g = t;
        __syncwarp();
      }
      {  // feature head (no activation) -> g
        float acc[8][W / 32];
        zero(acc);
        mm_ring<W>(acc, h, W, ring);
        store_ring<T, W, Act::None>(acc, bp, g, sc.feat, LDW, pr, nvalid, false);
      }
      consumer_sync();
      {  // alpha head: one dot of length W per row, 4 threads per row
        const T* wa = wts + 2LL * A::CIN * W + (long long)D * W * W;
        float s = 0.f;
        for (int k = p; k < W; k += 4) s = fmaf(h[TL::at(k, r)], Op<T>::f(wa[k]), s);
        red[p * CH + r] = s;
        consumer_sync();
        if (p == 0 && row0 + r < rows)
          raw_u[(row0 + r) * 4 + 3] = ((red[r] + red[CH + r]) + red[2 * CH + r]) + red[3 * CH + r] + b_alpha;
      }
      {  // view layer on cat([feature, view embedding]) -> h
        float acc[8][WH / 32];
        zero(acc);
        mm_ring<WH>(acc, g, W, ring);
        mm_ring<WH>(acc, vemb_s, A::CV, ring);
        store_ring<T, WH, A::ACT>(acc, b_views, h, sc.hv, LDH, pr, nvalid, false);
      }
      consumer_sync();
      {  // rgb head: three dots of length W/2 per row
        const T* wr = wts + ring_weight_floats(W, D, A::CIN, A::CV);
        float s[3] = {0.f, 0.f, 0.f};
        for (int k = p; k < WH; k += 4) {
          const float hv = h[TL::at(k, r)];
#pragma unroll
          for (int c = 0; c < 3; ++c) s[c] = fmaf(hv, Op<T>::f(wr[k * 3 + c]), s[c]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) red[(p * CH + r) * 3 + c] = s[c];
        consumer_sync();
        if (p == 0 && row0 + r < rows) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            raw_u[(row0 + r) * 4 + c] = ((red[r * 3 + c] + red[(CH + r) * 3 + c]) + red[(2 * CH + r) * 3 + c]) +
                                        red[(3 * CH + r) * 3 + c] + b_rgb[c];
        }
      }
    }
    tc::mbar_arrive(&raw_full[b]);  // this thread's raw writes, released to the compositor
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
  if (W == 256 ? tc_forward<T, 256, A, PTS, PTS>() : tc_forward<T, 128, A, PTS, PTS>())  // EXT implies PTS
    b += align256(image_bytes<A>(W, D));
  else if (sizeof(T) == 2)  // the ring's fp32 weight image
    b += align256(sizeof(float) * ring_weight_floats(W, D, A::CIN, A::CV));
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
  if constexpr (tc_forward<T, W, A, PTS, EXT>()) {
    // On the tensor cores: the weight image after the scratch, the
    // composite's log-transmittances in dhv32's room (P of its P * W/2
    // floats), which the sweep writes only after this launch.
    const long long img_bytes = image_bytes<A>(W, D);
    void* img = cv_.take<unsigned char>(img_bytes);
    const tc::TrainTape tp{sc.emb, sc.vemb, sc.h,  sc.hstride, sc.feat, sc.hv,      sc.dfa, sc.gq,
                           sc.graw, dhv32,  LDW,   LDH,        target,  loss_scale, sqerr};
    SWNERF_RUN((tc::render_launch<W, A, false, true>(origins, dirs, times, vemb, cv, z, dist, noise, wts, bias, D, skip,
                                                     L, white, N, S, rgb, acc, depth, w_out, img, img_bytes, st, &tp)));
  } else {
    const int rays_per_block = std::max(1, CH / S);
    // The wide family at W=256 leaves S <= 225 (render_loss_max_samples).
    const size_t smem = ring_render_smem<W, A>(S);
    if (smem > SMEM_OPTIN) return static_cast<int>(cudaErrorInvalidValue);
    const float* img = static_cast<const float*>(wts_v);  // fp32: the operands themselves
    if constexpr (sizeof(T) == 2) {  // the ring copies fp32: widen the operands once, after the scratch
      const long long n = ring_weight_floats(W, D, CIN, A::CV);
      float* wimg = cv_.take<float>(n);
      widen_kernel<<<ceil_div(n, 256), 256, 0, st>>>(wts, n, wimg);
      SWNERF_CHECK(cudaGetLastError());
      img = wimg;
    }
    auto kern = render_loss_fwd_kernel<T, W, A, PTS, EXT>;
    SWNERF_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    const int units = (N + rays_per_block - 1) / rays_per_block;
    kern<<<tc::grid_for(units), NTR, smem, st>>>(origins, dirs, times, vemb, cv, z, dist, noise, target, gct, wts, img,
                                               bias, D, skip, L, white, loss_scale, N, S, rays_per_block, rgb, acc,
                                               depth, sqerr, w_out, sc);
    SWNERF_CHECK(cudaGetLastError());
  }

  // 2-4. the heads, d feat next to d sigma, the trunk (with B5's and B9's
  //      input cotangent): gemm_common.cuh::field_reverse; in bf16 its
  //      large products on the tensor cores (TC)
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value &&
                      (std::is_same<A, Vanilla>::value || std::is_same<A, VanillaWide>::value ||
                       std::is_same<A, TNerf>::value);
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
// render_loss_ext_launch (wide) take: the train-mode block's shared memory
// (the ring block's, the same in fp32 and bf16), in bf16 at the narrow pads
// the lesser of it (B9 narrow) and the tensor-core body's (B1, B4 at W=128).
int render_loss_max_samples(int tnerf, int bf16, int wide, int W) {
  const int simt = ring_max_samples(tnerf, wide, W);
  const bool tc = bf16 && !wide && (!tnerf || W == 128);
  return tc && simt > 0 ? std::min(simt, tc::max_samples(tnerf, 0, W)) : simt;
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

// The input cotangent's product alone, for the card's tests: demb [P][cin]
// fp32 = (add ? demb + : ) dz w_emb^T, dz [P][W] and w_emb (the packed
// [CIN][W] embedding rows, CIN 64 or 128) bf16, on the tensor cores (tc !=
// 0: gemm_common.cuh::tc_demb, the product B5, B7 and B9 run) or on the
// SIMT gemm_act that it replaced.
int render_loss_demb_probe(int tc, int W, int CIN, int cin, long long P, const void* dz, const void* w_emb,
                           float* demb, int add, void* stream) {
  using T = __nv_bfloat16;
  if (P <= 0 || cin < 1 || cin > CIN) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* z = static_cast<const T*>(dz);
  const T* w = static_cast<const T*>(w_emb);
  if (tc) return tc_demb<T>(z, W, w, CIN, cin, P, demb, add != 0, st);
  GemmArgs g = gemm_args(z, W, 1, w, 1, W, (int)P, cin, W);
  g.C = demb;
  g.ldc = cin;
  return add ? gemm_act<T, false, 2>(g, st) : gemm_act<T, false, 1>(g, st);
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
