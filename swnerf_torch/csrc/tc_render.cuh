// The bf16 render body of a field on the tensor cores (tc_chunk.cuh): B3
// from rays and in pts mode, at the narrow and the wide (MultiRes) pads, and
// B4, the T-NeRF (render_pass.cu: its [embed(x) | embed(t)] input, 84 of
// 96 columns at multires 10, ELU in the trunk's and the view layer's
// epilogues as tc_chunk.cuh::elu_tc, the colour ReLU in the composite);
// its field product (field_rows) also runs the forward-only launch of B7,
// B7' and B8 and B7''s train-mode forward at W=128 (trunk.cu). B4's two
// embedding products (layer 0, the skip) run six k16 steps over two
// 64-column atoms, the second atom's last 32 columns skipped; 12 of the 96 columns are zeros past cin, an eighth of
// those two products' work. render_loss_tc_kernel is the same body in
// train mode, for B1 and B4 at W=128 (render_loss.cu): each tile also goes
// to a global tape for the reverse sweep, and the composite warps form the
// squared error and each ray's raw cotangent. B9's recomputed forward, and
// the training path's B3 launch that must equal it (render_pass_pts_launch's
// ordered), stay on the SIMT body: its fp32 FMAs in order keep B9's
// gradients at the twin's bar, which this body's products, rounded toward
// zero at every k16 step, leave; so do B5's and the T-NeRF's at W=256
// (render_loss.cu says why).
//
// A block takes whole rays, R per work unit (render_rays: up to 1,024 rows,
// a whole number of 128-row chunks where one fits). Per chunk each consumer
// warpgroup encodes its 64 rows (sinf/cosf of the exact x * 2^f, no fast
// math: the arguments reach 2^19 at MultiRes level 0), runs the trunk in
// place, the alpha head (m64n8), the feature layer, the view layer on
// [feature | view embedding] (two products into one accumulator) and the
// rgb head (m64n8); the raw lanes (rgb logits, sigma) of the unit's rows
// stay in shared memory. One thread per ray then composites in sample
// order (mlp_common.cuh::composite): the producer warpgroup's other three
// warps, on one of two raw-lane buffers, while the consumers already run
// the next unit (serial per ray, the composite took ~40% of the launch when
// the consumers did it between units).

#pragma once

#include <algorithm>

#include "tc_chunk.cuh"

namespace {
namespace tc {

template <int W, typename A>
__host__ __device__ constexpr size_t render_tiles() {
  return 2 * (size_t)(W / 64 + atoms(A::CIN) + atoms(A::CV)) * ATOM_BYTES;
}

// Floats kept per sample of a unit: its raw lanes (rgb logits, sigma), in
// two buffers, so that the composite of one unit overlaps the products of
// the next.
constexpr int LANES = 8;

// Three ring slabs where they fit beside the tiles and a 1,024-sample ray's
// lanes, else two (the wide family at W=256).
template <int W, typename A>
__host__ __device__ constexpr int render_stages() {
  return 1024 + 3 * (size_t)STAGE_BYTES + render_tiles<W, A>() + BAR_BYTES + 1024 * LANES * 4 <=
                 SMEM_OPTIN
             ? 3
             : 2;
}

template <int W, typename A>
__host__ __device__ constexpr size_t render_fixed_smem() {
  return 1024 + (size_t)render_stages<W, A>() * STAGE_BYTES + render_tiles<W, A>() + BAR_BYTES;
}

// Rays per work unit at S samples. The composite runs beside the next
// unit's products, one thread per ray, sample by sample (~1 us a sample on
// the card): units hold up to 1,024 rows, a whole number of chunks where one
// fits (S=64: 16 rays; S=192: 4), so that the products take longer than the
// composite.
inline int render_rays(int S) {
  const int most = S <= 1024 ? 1024 / S : 1;
  for (int r = most; r > 1; --r)
    if (r * S % ROWS == 0) return r;
  return most;
}

// Rays per unit of the train-mode launch (render_loss_tc_kernel) at N rays
// of S samples: of 1 .. render_rays(S), the count that puts the fewest
// 128-row chunks on the busiest SM, the larger on a tie. A train step's
// launch holds about a thousand rays, and render_rays' units would leave
// SMs idle (S=64: 64 units of 16 rays for 132 SMs). A row meets the same
// products in any unit, so the outputs do not change.
inline int train_rays(int S, long long N) {
  const long long sms = grid_for(1LL << 30);
  int best = 1;
  long long fewest = -1;
  for (int r = 1; r <= render_rays(S); ++r) {
    const long long units = (N + r - 1) / r;
    const long long chunks = (units + sms - 1) / sms * (((long long)r * S + ROWS - 1) / ROWS);
    if (fewest < 0 || chunks <= fewest) {
      fewest = chunks;
      best = r;
    }
  }
  return best;
}

template <int W, typename A>
size_t render_smem(int S) {
  return render_fixed_smem<W, A>() + (size_t)render_rays(S) * S * LANES * sizeof(float);
}

// The image of a vanilla field's packed weights (ops/kernels/render_pass.py::
// weight_layout, the embeddings' rows padded to cin_pad / cv_pad) in the
// order the consumers take them: the trunk, the alpha head [W][1] (before
// the feature layer, which overwrites its input), the feature layer, the
// view layer's feature and view-embedding rows, the rgb head [W/2][3]; the
// heads padded to 8 columns. The embedding products take A::CIN / A::CV
// rows of their cin_pad / cv_pad (B3: all of them; B7 and B8 pack 128-row
// pads and take the live atoms only: trunk.cu::trunk_tc_plan).
template <int W, typename A>
Plan render_plan(int D, int skip, int cin_pad = A::CIN, int cv_pad = A::CV) {
  Plan p{};
  const long long feat = add_trunk(p, D, skip, cin_pad, W, A::CIN);
  const long long alpha = feat + (long long)W * W;
  const long long vf = alpha + W;
  const long long ve = vf + (long long)W * (W / 2);
  const long long rgb = ve + (long long)cv_pad * (W / 2);
  add_seg(p, alpha, W, 1, W, 8);
  add_seg(p, feat, W, W, W, W);
  add_seg(p, vf, W, W / 2, W, W / 2);
  add_seg(p, ve, cv_pad, W / 2, A::CV, W / 2);
  add_seg(p, rgb, W / 2, 3, W / 2, 8);
  return p;
}

// Row r's Fourier encode of x into a tile, two threads a row (part 0 and
// 1), in encode_chunk's arithmetic (sinf/cosf of the exact x * 2^f): x at
// columns 0-2, then per frequency f < L sin at 3 + 6f and cos at 6 + 6f;
// columns c_end .. k_end zero. With time (B4), the ray's frame time t at
// column dpos = 3 + 6L, then sin / cos of t * 2^f at dpos + 1 + 2f /
// dpos + 2 + 2f (encode_chunk's A::TIME columns).
template <bool TIME = false>
__device__ __forceinline__ void encode_row(unsigned char* t, int r, int part, const float (&x)[3], int L, int c_end,
                                           int k_end, float tt = 0.f) {
  const int dpos = 3 + 6 * L;
  if (part == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) put(t, r, a, x[a]);
    if (TIME) put(t, r, dpos, tt);
  } else {
    for (int c = c_end; c < k_end; ++c) put(t, r, c, 0.f);
  }
  for (int f = part; f < L; f += 2) {
    const float scale = (float)(1 << f);  // exact: x * 2^f rounds nothing
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float u = x[a] * scale;
      put(t, r, 3 + 6 * f + a, sinf(u));
      put(t, r, 6 + 6 * f + a, cosf(u));
    }
    if (TIME) {
      const float u = tt * scale;
      put(t, r, dpos + 1 + 2 * f, sinf(u));
      put(t, r, dpos + 2 + 2 * f, cosf(u));
    }
  }
}

// encode_chunk for one consumer warpgroup's 64 rows (unit rows lrow0 ..,
// two threads a row) into its swizzled tiles, in encode_chunk's order and
// arithmetic: the embedding (with A::TIME the ray's times[ray] columns;
// columns cin .. atoms(CIN) * 64 zero) and the ray's view embedding
// (cv .. atoms(CV) * 64 zero).
template <typename A, bool PTS>
__device__ __forceinline__ void encode_rows(unsigned char* emb, unsigned char* vt, int tid, int lrow0, int rows,
                                            long long ray0, int S, int L, int cv, const float* __restrict__ origins,
                                            const float* __restrict__ dirs, const float* __restrict__ times,
                                            const float* __restrict__ z, const float* __restrict__ vemb) {
  const int r = tid & 63;
  const int part = tid >> 6;  // two threads share a row
  const int g = lrow0 + r;
  const bool valid = g < rows;
  const long long ray = ray0 + (valid ? g / S : 0);
  const int cin = A::cin(L);
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
  encode_row<A::TIME>(emb, r, part, x, L, cin, atoms(A::CIN) * 64, t);
  for (int k = part; k < atoms(A::CV) * 64; k += 2) put(vt, r, k, (valid && k < cv) ? vemb[ray * cv + k] : 0.f);
}

// Composites rays t, t + nthreads, .. of a unit (raw [nr][S][4]), one
// thread per ray, samples in order (mlp_common.cuh::composite).
template <typename A>
__device__ __forceinline__ void composite_unit(const float* raw, int t, int nthreads, long long ray0, int nr, int S,
                                               const float* __restrict__ z, const float* __restrict__ dist,
                                               const float* __restrict__ noise, int white,
                                               float* __restrict__ rgb_out, float* __restrict__ acc_out,
                                               float* __restrict__ depth_out, float* __restrict__ w_out) {
  for (int i = t; i < nr; i += nthreads) {
    const long long ray = ray0 + i;
    const float* rr = raw + (size_t)i * S * 4;
    const float* zr = z + ray * S;
    const float* dr = dist + ray * S;
    const float* nz = noise ? noise + ray * S : nullptr;
    float c_0, c_1, c_2, a, dep;
    composite<A>(rr, S, zr, dr, nz, white, w_out + ray * S, nullptr, c_0, c_1, c_2, a, dep);
    rgb_out[ray * 3 + 0] = c_0;
    rgb_out[ray * 3 + 1] = c_1;
    rgb_out[ray * 3 + 2] = c_2;
    acc_out[ray] = a;
    depth_out[ray] = dep;
  }
}

// What B1's and B4's train-mode launch (render_loss_tc_kernel) stores for
// the reverse sweep (render_loss.cu::Scratch, gemm_common.cuh::FieldTape),
// row-major over the launch's samples: the embedding [P][A::CIN] with a 1 at
// column A::cin(L) (columns past it 0), the view embedding [P][A::CV], each
// trunk layer's output at h + i * hstride [P][ldw] with a 1 at column W,
// feat [P][ldw], hv [P][ldh]; the composite's raw cotangent (graw fp32, gq
// rounded, [P][4]), q(d sigma) at column W of dfa [P][ldw], the
// log-transmittances lt [P] (fp32, read back by the same thread), and the
// squared error sqerr [N] against target [N][3], scaled by loss_scale.
// B7''s train-mode launch (trunk.cu) uses the activations' fields and u,
// its colour logits before the clip [P][4] (fp32; null elsewhere).
struct TrainTape {
  bf16* emb;
  bf16* vemb;
  bf16* h;
  size_t hstride;
  bf16* feat;
  bf16* hv;
  bf16* dfa;
  bf16* gq;
  float* graw;
  float* lt;
  int ldw, ldh;
  const float* target;
  float loss_scale;
  float* sqerr;
  float* u;
};

// Rows r < nvalid of a consumer's swizzled tile, columns 0 .. n-1 (a
// multiple of 8), to the row-major g[row0 + r][ld], 16 bytes a copy (a warp
// writes 512 contiguous bytes). Column one of each row goes out as 1: in
// place of the tile's 0 for one < n, after the row's n columns for one ==
// n; none for one < 0.
__device__ __forceinline__ void spill_tile(const unsigned char* tile, int tid, int n, bf16* __restrict__ g, int ld,
                                           long long row0, int nvalid, int one) {
  const int chunks = n / 8;
  for (int i = tid; i < 64 * chunks; i += WGT) {
    const int r = i / chunks, c = i - r * chunks;
    if (r >= nvalid) break;
    uint4 v = *reinterpret_cast<const uint4*>(tile + tile_off(r, c * 8));
    if (one >= c * 8 && one < c * 8 + 8) reinterpret_cast<bf16*>(&v)[one - c * 8] = __float2bfloat16_rn(1.f);
    *reinterpret_cast<uint4*>(g + (row0 + r) * ld + c * 8) = v;
  }
  if (one == n)
    for (int r = tid; r < nvalid; r += WGT) g[(row0 + r) * ld + n] = __float2bfloat16_rn(1.f);
}

// composite_unit in train mode, over the unit's raw lanes raw [nr][S][4]:
// per ray the same composite (its log-transmittances to tp.lt), then the
// squared error and the reverse (mlp_common.cuh::ray_reverse, B1's SIMT
// body's), which leaves each sample's raw cotangent in its lanes; then, once
// every composite thread is done (named barrier 4), the unit's lanes go out
// sample by sample, coalesced: graw, gq and q(d sigma) at column W of dfa.
template <int W, typename A>
__device__ __forceinline__ void composite_loss_unit(float* raw, int t, int nthreads, long long ray0, int nr, int S,
                                                    const float* __restrict__ z, const float* __restrict__ dist,
                                                    const float* __restrict__ noise, int white,
                                                    float* __restrict__ rgb_out, float* __restrict__ acc_out,
                                                    float* __restrict__ depth_out, float* __restrict__ w_out,
                                                    const TrainTape& tp) {
  for (int i = t; i < nr; i += nthreads) {
    const long long ray = ray0 + i;
    const long long p = ray * S;
    float* rr = raw + (size_t)i * S * 4;
    const float* nz = noise ? noise + p : nullptr;
    float c_0, c_1, c_2, a, dep;
    composite<A>(rr, S, z + p, dist + p, nz, white, w_out + p, tp.lt + p, c_0, c_1, c_2, a, dep);
    rgb_out[ray * 3 + 0] = c_0;
    rgb_out[ray * 3 + 1] = c_1;
    rgb_out[ray * 3 + 2] = c_2;
    acc_out[ray] = a;
    depth_out[ray] = dep;
    ray_reverse<A, false>(rr, tp.lt + p, S, z + p, dist + p, nz, white, c_0, c_1, c_2, ray, tp.target, nullptr,
                          tp.loss_scale, tp.sqerr, [rr](int s, const float (&d)[3], float dsig) {
                            *reinterpret_cast<float4*>(rr + s * 4) = make_float4(d[0], d[1], d[2], dsig);
                          });
  }
  asm volatile("bar.sync 4, %0;\n" ::"r"(nthreads) : "memory");
  const long long p0 = ray0 * S;
  for (int k = t; k < nr * S; k += nthreads) {
    const float4 g = *reinterpret_cast<const float4*>(raw + (size_t)k * 4);
    *reinterpret_cast<float4*>(tp.graw + (p0 + k) * 4) = g;
    uint2 q;
    reinterpret_cast<__nv_bfloat162*>(&q)[0] = __floats2bfloat162_rn(g.x, g.y);
    reinterpret_cast<__nv_bfloat162*>(&q)[1] = __floats2bfloat162_rn(g.z, g.w);
    *reinterpret_cast<uint2*>(tp.gq + (p0 + k) * 4) = q;
    tp.dfa[(p0 + k) * tp.ldw + W] = __float2bfloat16_rn(g.w);
  }
}

template <bool CLIP>
__device__ __forceinline__ float clip_rgb(float u) {
  if constexpr (CLIP) return fmaxf(u, 0.f);
  return u;
}

// One consumer warpgroup's 64 rows through a vanilla field on the tensor
// cores, from its encoded tiles (emb at emb_a: A::CIN columns; the view
// embedding at vt_a: A::CV), shared by B3 (consume) and B7 / B8's
// forward-only launch (trunk.cu::trunk_tc_kernel): the trunk in place in
// act (the skip as a second product into the same accumulators), the alpha
// head (m64n8), the feature layer, the view layer on [feature | view
// embedding] and the rgb head (m64n8). Row r's raw lanes (rgb logits,
// sigma; fp32) go to raw[r * 4 ..] for r < nvalid, in shared or global
// memory. With prof (one thread of the block), the heads' clock cycles.
// TRAIN (B1's, B4's and B7''s train mode): each trunk layer's output (with
// its column of ones), feat and hv of rows r < nvalid also go to the tape at
// global row grow0 + r, copied from the tile while the next product, which
// reads the same tile, runs (the epilogue that overwrites it waits for the
// warpgroup in mma_done). CLIP (B7', whose raw is the field's output: rgb
// = max(u, 0)): raw lanes 0-2 leave clipped at 0, and in train mode u goes
// to tp->u; B3's and B4's composites, and B7 / B8, take the logits as they
// are.
template <int W, typename A, bool TRAIN = false, bool CLIP = false>
__device__ __forceinline__ void field_rows(unsigned char* act, uint32_t emb_a, uint32_t vt_a,
                                           const float* __restrict__ bias, int D, int skip, int tid, int w, Ring& ring,
                                           float* raw, int nvalid, long long* prof, const TrainTape* tp = nullptr,
                                           long long grow0 = 0) {
  constexpr int WH = W / 2;
  const uint32_t act_a = smem_u32(act);
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // the accumulator rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);                 // and columns c0, c0 + 1
  float acc[W / 2];  // dead, its registers free, outside a layer's products (wgmma_zero)
  auto keep = [&](int n, bf16* g, int ld, int one) {  // TRAIN: the tile's rows to the tape
    if constexpr (TRAIN) spill_tile(act, tid, n, g, ld, grow0, nvalid, one);
  };
  const float* bp = bias;
  for (int i = 0; i < D; ++i) {
    if (i == 0 || i == skip + 1) {
      mma<W, true>(acc, emb_a, A::CIN, ring);  // cat([emb, h]) @ W == emb @ W_emb + h @ W_h
      if (i > 0) mma<W, false>(acc, act_a, W, ring);
    } else {
      mma<W, true>(acc, act_a, W, ring);
    }
    if constexpr (TRAIN)
      if (i > 0) keep(W, tp->h + (i - 1) * tp->hstride, tp->ldw, W);
    mma_done<W>(acc, ring, w);
    epilogue<W, A::ACT>(acc, bp, act, tid, nullptr, 0, 0, 0, false);
    publish(w);
    bp += W;
  }
  long long th = prof ? clock64() : 0;
  {  // the alpha head -> raw lane 3
    mma<8, true>(acc, act_a, W, ring);
    if constexpr (TRAIN) keep(W, tp->h + (D - 1) * tp->hstride, tp->ldw, W);
    mma_done<8>(acc, ring, w);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (c0 == 0 && r0 + 8 * h < nvalid) raw[(r0 + 8 * h) * 4 + 3] = acc[2 * h] + bias[(D + 1) * W + WH + 3];
  }
  if (prof) add_clock(prof, 1, th);
  {  // the feature layer (no activation), in place
    mma<W, true>(acc, act_a, W, ring);
    mma_done<W>(acc, ring, w);
    epilogue<W, Act::None>(acc, bias + D * W, act, tid, nullptr, 0, 0, 0, false);
    publish(w);
  }
  {  // the view layer on cat([feature, view embedding]), in place
    mma<WH, true>(acc, act_a, W, ring);
    mma<WH, false>(acc, vt_a, A::CV, ring);
    if constexpr (TRAIN) keep(W, tp->feat, tp->ldw, -1);
    mma_done<WH>(acc, ring, w);
    epilogue<WH, A::ACT>(acc, bias + (D + 1) * W, act, tid, nullptr, 0, 0, 0, false);
    publish(w);
  }
  th = prof ? clock64() : 0;
  {  // the rgb head -> raw lanes 0-2
    const float* b_rgb = bias + (D + 1) * W + WH;
    mma<8, true>(acc, act_a, WH, ring);
    if constexpr (TRAIN) keep(WH, tp->hv, tp->ldh, -1);
    mma_done<8>(acc, ring, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* rr = raw + (r0 + 8 * h) * 4;
      if (r0 + 8 * h >= nvalid) continue;
      if constexpr (TRAIN && CLIP) {  // B7': the logits before the clip, whose sign masks the backward's colour
        float* u = tp->u + (grow0 + r0 + 8 * h) * 4;
        if (c0 == 0) {
          u[0] = acc[2 * h] + b_rgb[0];
          u[1] = acc[2 * h + 1] + b_rgb[1];
        } else if (c0 == 2) {
          u[2] = acc[2 * h] + b_rgb[2];
        }
      }
      if (c0 == 0) {
        rr[0] = clip_rgb<CLIP>(acc[2 * h] + b_rgb[0]);
        rr[1] = clip_rgb<CLIP>(acc[2 * h + 1] + b_rgb[1]);
      } else if (c0 == 2) {
        rr[2] = clip_rgb<CLIP>(acc[2 * h] + b_rgb[2]);
      }
    }
  }
  if (prof) add_clock(prof, 1, th);
}

// The consumers' side of render_kernel (warpgroups 1 and 2): each unit's
// raw lanes go to the composite warps through raw_full / raw_free (two
// buffers). TRAIN: each chunk's embedding and view embedding also go to the
// tape, and field_rows stores the layers' outputs.
template <int W, typename A, bool PTS, bool TRAIN>
__device__ __forceinline__ void consume(const float* __restrict__ origins, const float* __restrict__ dirs,
                                        const float* __restrict__ times, const float* __restrict__ vemb, int cv,
                                        const float* __restrict__ z,
                                        const float* __restrict__ bias, int D, int skip, int L, int N, int S,
                                        int R, long long* __restrict__ prof, unsigned char* sm, uint64_t* bars,
                                        uint64_t* raw_full, uint64_t* raw_free, float* raw_s, const TrainTape* tp) {
  constexpr int KE = atoms(A::CIN), KV = atoms(A::CV);
  constexpr int NST = render_stages<W, A>();
  unsigned char* act_s = sm + NST * STAGE_BYTES;              // [2][W / 64 atoms]
  unsigned char* emb_s = act_s + 2 * (W / 64) * ATOM_BYTES;   // [2][KE atoms]
  unsigned char* vemb_s = emb_s + 2 * KE * ATOM_BYTES;        // [2][KV atoms]
  const int units = (N + R - 1) / R;
  const int wg = threadIdx.x / WGT;
  set_regs<TRAIN ? TRAIN_CONSUMER_REGS : CONSUMER_REGS>();
  const int w = wg - 1;
  const int tid = threadIdx.x - wg * WGT;
  const int ct = threadIdx.x - WGT;  // 0..255 over both consumers
  unsigned char* act = act_s + w * (W / 64) * ATOM_BYTES;
  unsigned char* emb = emb_s + w * KE * ATOM_BYTES;
  unsigned char* vt = vemb_s + w * KV * ATOM_BYTES;
  const uint32_t emb_a = smem_u32(emb), vt_a = smem_u32(vt);
  Ring ring{smem_u32(sm), bars, bars + NST, NST, 0, 0, -1};
  const bool timer = prof != nullptr && ct == 0;  // the cycle counts live in prof, not in registers
  if (timer) start_clock(prof);

  int it = 0;  // this block's units so far
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
    const long long ray0 = (long long)u * R;
    const int nr = min(R, N - u * R);
    const int rows = nr * S;
    const int buf = it & 1;
    float* raw_u = raw_s + (size_t)buf * R * S * 4;
    if (it >= 2) mbar_wait(&raw_free[buf], ((it >> 1) - 1) & 1);  // its composite of unit it - 2 is done
    for (int ch = 0; ch < rows; ch += ROWS) {
      const int lrow0 = ch + w * 64;
      const int nvalid = max(0, min(64, rows - lrow0));
      float* raw = raw_u + (size_t)lrow0 * 4;
      encode_rows<A, PTS>(emb, vt, tid, lrow0, rows, ray0, S, L, cv, origins, dirs, times, z, vemb);
      publish(w);
      if constexpr (TRAIN) {
        const long long grow0 = ray0 * S + lrow0;
        spill_tile(emb, tid, A::CIN, tp->emb, A::CIN, grow0, nvalid, A::cin(L));
        spill_tile(vt, tid, A::CV, tp->vemb, A::CV, grow0, nvalid, -1);
        field_rows<W, A, true>(act, emb_a, vt_a, bias, D, skip, tid, w, ring, raw, nvalid, timer ? prof : nullptr,
                               tp, grow0);
      } else {
        field_rows<W, A>(act, emb_a, vt_a, bias, D, skip, tid, w, ring, raw, nvalid, timer ? prof : nullptr);
      }
    }
    mbar_arrive(&raw_full[buf]);  // this thread's raw lanes of the unit are written
  }
  if (timer) add_clock(prof, 2, 0);
}

// The block of render_kernel and render_loss_tc_kernel: the producer
// warpgroup (thread 0 streams the weight slabs, warps 1-3 composite each
// unit; TRAIN: with the loss and its reverse) and the two consumers.
template <int W, typename A, bool PTS, bool TRAIN>
__device__ __forceinline__ void render_block(const float* __restrict__ origins, const float* __restrict__ dirs,
                                             const float* __restrict__ times, const float* __restrict__ vemb, int cv,
                                             const float* __restrict__ z, const float* __restrict__ dist,
                                             const float* __restrict__ noise, const Plan& plan,
                                             const unsigned char* __restrict__ img, const float* __restrict__ bias,
                                             int D, int skip, int L, int white, int N, int S, int R,
                                             float* __restrict__ rgb_out, float* __restrict__ acc_out,
                                             float* __restrict__ depth_out, float* __restrict__ w_out,
                                             long long* __restrict__ prof, const TrainTape* tp) {
  constexpr int NST = render_stages<W, A>();
  // The ring, each consumer's activation, embedding and view-embedding tiles
  // (consume), the barriers (the ring's, then raw_full[2] and raw_free[2]),
  // the raw lanes (two buffers of a unit's).
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned_smem: 1024
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + NST * STAGE_BYTES + render_tiles<W, A>());
  uint64_t* raw_full = bars + 2 * NST;
  uint64_t* raw_free = raw_full + 2;
  float* raw_s = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(bars) + BAR_BYTES);
  if (threadIdx.x == 0)
    for (int b = 0; b < 2; ++b) {
      mbar_init(&raw_full[b], 2 * WGT);      // every consumer thread
      mbar_init(&raw_free[b], WGT - 32);     // every composite thread
    }
  init_ring(bars, NST);
  const int units = (N + R - 1) / R;
  const int wg = threadIdx.x / WGT;

  if (wg == 0) {  // the producer (thread 0) and the composite (warps 1-3)
    set_regs<TRAIN ? TRAIN_PRODUCER_REGS : PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int st = 0, ph = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int rows = min(R, N - u * R) * S;
        for (int ch = 0; ch < rows; ch += ROWS) produce(plan, img, smem_u32(sm), bars, bars + NST, NST, st, ph);
      }
    } else if (threadIdx.x >= 32) {
      const int t = threadIdx.x - 32;
      const bool timer = prof != nullptr && t == 0;
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
        const int buf = it & 1;
        mbar_wait(&raw_full[buf], (it >> 1) & 1);
        const long long t0 = timer ? clock64() : 0;
        float* raw_u = raw_s + (size_t)buf * R * S * 4;
        if constexpr (TRAIN)
          composite_loss_unit<W, A>(raw_u, t, WGT - 32, (long long)u * R, min(R, N - u * R), S, z, dist, noise,
                                    white, rgb_out, acc_out, depth_out, w_out, *tp);
        else
          composite_unit<A>(raw_u, t, WGT - 32, (long long)u * R, min(R, N - u * R), S, z, dist, noise, white,
                            rgb_out, acc_out, depth_out, w_out);
        if (timer) add_clock(prof, 0, t0);
        mbar_arrive(&raw_free[buf]);
      }
    }
  } else {
    consume<W, A, PTS, TRAIN>(origins, dirs, times, vemb, cv, z, bias, D, skip, L, N, S, R, prof, sm, bars, raw_full,
                              raw_free, raw_s, tp);
  }
}

// B3 (from rays, pts, pts wide) and B4's forward-only launch.
template <int W, typename A, bool PTS>
__global__ void __launch_bounds__(NTHREADS, 1)
render_kernel(const float* __restrict__ origins, const float* __restrict__ dirs, const float* __restrict__ times,
              const float* __restrict__ vemb, int cv, const float* __restrict__ z, const float* __restrict__ dist, const float* __restrict__ noise,
              const __grid_constant__ Plan plan, const unsigned char* __restrict__ img, const float* __restrict__ bias,
              int D, int skip, int L, int white, int N, int S, int R, float* __restrict__ rgb_out,
              float* __restrict__ acc_out, float* __restrict__ depth_out, float* __restrict__ w_out,
              long long* __restrict__ prof) {
  render_block<W, A, PTS, false>(origins, dirs, times, vemb, cv, z, dist, noise, plan, img, bias, D, skip, L, white, N,
                                 S, R, rgb_out, acc_out, depth_out, w_out, prof, nullptr);
}

// B1's and B4's bf16 train-mode forward (render_loss.cu): B3's / B4's
// forward body from rays, storing the tape for the reverse sweep, with the
// squared error and the composite's reverse in the composite warps.
template <int W, typename A>
__global__ void __launch_bounds__(NTHREADS, 1)
render_loss_tc_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                      const float* __restrict__ times, const float* __restrict__ vemb, int cv,
                      const float* __restrict__ z, const float* __restrict__ dist, const float* __restrict__ noise,
                      const __grid_constant__ Plan plan, const unsigned char* __restrict__ img,
                      const float* __restrict__ bias, int D, int skip, int L, int white, int N, int S, int R,
                      float* __restrict__ rgb_out, float* __restrict__ acc_out, float* __restrict__ depth_out,
                      float* __restrict__ w_out, const __grid_constant__ TrainTape tp) {
  // No cycle counts (render_loss has no profile hook): fewer registers held
  // across the composite warps' reverse.
  render_block<W, A, false, true>(origins, dirs, times, vemb, cv, z, dist, noise, plan, img, bias, D, skip, L, white,
                                  N, S, R, rgb_out, acc_out, depth_out, w_out, nullptr, &tp);
}

// Packs the image into img (img_bytes long) and launches the body on a
// persistent grid; with tp (TRAIN), render_loss_tc_kernel.
template <int W, typename A, bool PTS, bool TRAIN = false>
int render_launch(const float* origins, const float* dirs, const float* times, const float* vemb, int cv, const float* z,
                  const float* dist,
                  const float* noise, const void* wts, const float* bias, int D, int skip, int L, int white, int N,
                  int S, float* rgb, float* acc, float* depth, float* w_out, void* img, long long img_bytes,
                  cudaStream_t st, const TrainTape* tp = nullptr) {
  const int R = TRAIN ? train_rays(S, N) : render_rays(S);  // render_smem holds render_rays(S)'s lanes
  const size_t smem = render_smem<W, A>(S);
  const Plan plan = render_plan<W, A>(D, skip);
  if (smem > SMEM_OPTIN || img == nullptr || img_bytes < plan.bytes || (TRAIN && tp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = pack(wts, plan, img, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long units = ((long long)N + R - 1) / R;
  const unsigned char* im = static_cast<const unsigned char*>(img);
  if constexpr (TRAIN) {
    auto kern = render_loss_tc_kernel<W, A>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid_for(units), NTHREADS, smem, st>>>(origins, dirs, times, vemb, cv, z, dist, noise, plan, im, bias, D,
                                                  skip, L, white, N, S, R, rgb, acc, depth, w_out, *tp);
  } else {
    auto kern = render_kernel<W, A, PTS>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid_for(units), NTHREADS, smem, st>>>(origins, dirs, times, vemb, cv, z, dist, noise, plan, im, bias, D,
                                                  skip, L, white, N, S, R, rgb, acc, depth, w_out, g_prof);
  }
  return static_cast<int>(cudaGetLastError());
}

// The most samples per ray (at most 1024) whose block of this body fits
// SMEM_OPTIN at width W (128 or 256) and the narrow, the wide or the T-NeRF
// pads: 1024 for every family (one ray per unit where two do not fit).
inline int max_samples(int tnerf, int wide, int W) {
  int S = 1024;
  for (; S > 0; --S) {
    const size_t smem =
        tnerf  ? (W == 256 ? render_smem<256, TNerf>(S) : render_smem<128, TNerf>(S))
        : wide ? (W == 256 ? render_smem<256, VanillaWide>(S) : render_smem<128, VanillaWide>(S))
               : (W == 256 ? render_smem<256, Vanilla>(S) : render_smem<128, Vanilla>(S));
    if (smem <= SMEM_OPTIN) break;
  }
  return S;
}

}  // namespace tc
}  // namespace
