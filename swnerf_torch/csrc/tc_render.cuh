// The bf16 render body of a vanilla field on the tensor cores
// (tc_chunk.cuh): B3 from rays and in pts mode, at the narrow and the wide
// (MultiRes) pads (render_pass.cu); its field product (field_rows) also
// runs B7's and B8's forward-only launch (trunk.cu). B9's recomputed
// forward, and the training path's B3 launch that must equal it
// (render_pass_pts_launch's ordered), stay on the SIMT body: its fp32 FMAs
// in order keep B9's gradients at the twin's bar, which this body's
// products, rounded toward zero at every k16 step, leave.
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
// columns c_end .. k_end zero.
__device__ __forceinline__ void encode_row(unsigned char* t, int r, int part, const float (&x)[3], int L, int c_end,
                                           int k_end) {
  if (part == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) put(t, r, a, x[a]);
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
  }
}

// encode_chunk for one consumer warpgroup's 64 rows (unit rows lrow0 ..,
// two threads a row) into its swizzled tiles, in encode_chunk's order and
// arithmetic: the embedding (columns cin .. atoms(CIN) * 64 zero) and the
// ray's view embedding (cv .. atoms(CV) * 64 zero).
template <typename A, bool PTS>
__device__ __forceinline__ void encode_rows(unsigned char* emb, unsigned char* vt, int tid, int lrow0, int rows,
                                            long long ray0, int S, int L, int cv, const float* __restrict__ origins,
                                            const float* __restrict__ dirs, const float* __restrict__ z,
                                            const float* __restrict__ vemb) {
  static_assert(!A::TIME, "the tensor-core body serves the vanilla families");
  const int r = tid & 63;
  const int part = tid >> 6;  // two threads share a row
  const int g = lrow0 + r;
  const bool valid = g < rows;
  const long long ray = ray0 + (valid ? g / S : 0);
  const int cin = A::cin(L);
  float x[3] = {0.f, 0.f, 0.f};
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
  }
  encode_row(emb, r, part, x, L, cin, atoms(A::CIN) * 64);
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

// One consumer warpgroup's 64 rows through a vanilla field on the tensor
// cores, from its encoded tiles (emb at emb_a: A::CIN columns; the view
// embedding at vt_a: A::CV), shared by B3 (consume) and B7 / B8's
// forward-only launch (trunk.cu::trunk_tc_kernel): the trunk in place in
// act (the skip as a second product into the same accumulators), the alpha
// head (m64n8), the feature layer, the view layer on [feature | view
// embedding] and the rgb head (m64n8). Row r's raw lanes (rgb logits,
// sigma; fp32) go to raw[r * 4 ..] for r < nvalid, in shared or global
// memory. With prof (one thread of the block), the heads' clock cycles.
template <int W, typename A>
__device__ __forceinline__ void field_rows(unsigned char* act, uint32_t emb_a, uint32_t vt_a,
                                           const float* __restrict__ bias, int D, int skip, int tid, int w, Ring& ring,
                                           float* raw, int nvalid, long long* prof) {
  constexpr int WH = W / 2;
  const uint32_t act_a = smem_u32(act);
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // the accumulator rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);                 // and columns c0, c0 + 1
  float acc[W / 2];  // dead, its registers free, outside a layer's products (wgmma_zero)
  const float* bp = bias;
  for (int i = 0; i < D; ++i) {
    if (i == 0 || i == skip + 1) {
      mma<W, true>(acc, emb_a, A::CIN, ring);  // cat([emb, h]) @ W == emb @ W_emb + h @ W_h
      if (i > 0) mma<W, false>(acc, act_a, W, ring);
    } else {
      mma<W, true>(acc, act_a, W, ring);
    }
    mma_done<W>(acc, ring, w);
    epilogue<W, A::ACT>(acc, bp, act, tid, nullptr, 0, 0, 0, false);
    publish(w);
    bp += W;
  }
  long long th = prof ? clock64() : 0;
  {  // the alpha head -> raw lane 3
    mma<8, true>(acc, act_a, W, ring);
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
    mma_done<WH>(acc, ring, w);
    epilogue<WH, A::ACT>(acc, bias + (D + 1) * W, act, tid, nullptr, 0, 0, 0, false);
    publish(w);
  }
  th = prof ? clock64() : 0;
  {  // the rgb head -> raw lanes 0-2
    const float* b_rgb = bias + (D + 1) * W + WH;
    mma<8, true>(acc, act_a, WH, ring);
    mma_done<8>(acc, ring, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* rr = raw + (r0 + 8 * h) * 4;
      if (r0 + 8 * h >= nvalid) continue;
      if (c0 == 0) {
        rr[0] = acc[2 * h] + b_rgb[0];
        rr[1] = acc[2 * h + 1] + b_rgb[1];
      } else if (c0 == 2) {
        rr[2] = acc[2 * h] + b_rgb[2];
      }
    }
  }
  if (prof) add_clock(prof, 1, th);
}

// The consumers' side of render_kernel (warpgroups 1 and 2): each unit's
// raw lanes go to the composite warps through raw_full / raw_free (two
// buffers).
template <int W, typename A, bool PTS>
__device__ __forceinline__ void consume(const float* __restrict__ origins, const float* __restrict__ dirs,
                                        const float* __restrict__ vemb, int cv, const float* __restrict__ z,
                                        const float* __restrict__ bias, int D, int skip, int L, int N, int S,
                                        int R, long long* __restrict__ prof, unsigned char* sm, uint64_t* bars,
                                        uint64_t* raw_full, uint64_t* raw_free, float* raw_s) {
  constexpr int KE = atoms(A::CIN), KV = atoms(A::CV);
  constexpr int NST = render_stages<W, A>();
  unsigned char* act_s = sm + NST * STAGE_BYTES;              // [2][W / 64 atoms]
  unsigned char* emb_s = act_s + 2 * (W / 64) * ATOM_BYTES;   // [2][KE atoms]
  unsigned char* vemb_s = emb_s + 2 * KE * ATOM_BYTES;        // [2][KV atoms]
  const int units = (N + R - 1) / R;
  const int wg = threadIdx.x / WGT;
  set_regs<CONSUMER_REGS>();
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
      encode_rows<A, PTS>(emb, vt, tid, lrow0, rows, ray0, S, L, cv, origins, dirs, z, vemb);
      publish(w);
      field_rows<W, A>(act, emb_a, vt_a, bias, D, skip, tid, w, ring, raw, nvalid, timer ? prof : nullptr);
    }
    mbar_arrive(&raw_full[buf]);  // this thread's raw lanes of the unit are written
  }
  if (timer) add_clock(prof, 2, 0);
}

template <int W, typename A, bool PTS>
__global__ void __launch_bounds__(NTHREADS, 1)
render_kernel(const float* __restrict__ origins, const float* __restrict__ dirs, const float* __restrict__ vemb, int cv,
              const float* __restrict__ z, const float* __restrict__ dist, const float* __restrict__ noise,
              const __grid_constant__ Plan plan, const unsigned char* __restrict__ img, const float* __restrict__ bias,
              int D, int skip, int L, int white, int N, int S, int R, float* __restrict__ rgb_out,
              float* __restrict__ acc_out, float* __restrict__ depth_out, float* __restrict__ w_out,
              long long* __restrict__ prof) {
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
    set_regs<PRODUCER_REGS>();
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
        composite_unit<A>(raw_s + (size_t)buf * R * S * 4, t, WGT - 32, (long long)u * R, min(R, N - u * R), S, z,
                          dist, noise, white, rgb_out, acc_out, depth_out, w_out);
        if (timer) add_clock(prof, 0, t0);
        mbar_arrive(&raw_free[buf]);
      }
    }
  } else {
    consume<W, A, PTS>(origins, dirs, vemb, cv, z, bias, D, skip, L, N, S, R, prof, sm, bars, raw_full, raw_free,
                       raw_s);
  }
}

// Packs the image into img (img_bytes long) and launches the body on a
// persistent grid.
template <int W, typename A, bool PTS>
int render_launch(const float* origins, const float* dirs, const float* vemb, int cv, const float* z, const float* dist,
                  const float* noise, const void* wts, const float* bias, int D, int skip, int L, int white, int N,
                  int S, float* rgb, float* acc, float* depth, float* w_out, void* img, long long img_bytes,
                  cudaStream_t st) {
  const int R = render_rays(S);
  const size_t smem = render_smem<W, A>(S);
  const Plan plan = render_plan<W, A>(D, skip);
  if (smem > SMEM_OPTIN || img == nullptr || img_bytes < plan.bytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = pack(wts, plan, img, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kern = render_kernel<W, A, PTS>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long units = ((long long)N + R - 1) / R;
  kern<<<grid_for(units), NTHREADS, smem, st>>>(origins, dirs, vemb, cv, z, dist, noise, plan,
                                                static_cast<const unsigned char*>(img), bias, D, skip, L, white, N, S,
                                                R, rgb, acc, depth, w_out, g_prof);
  return static_cast<int>(cudaGetLastError());
}

// The most samples per ray (at most 1024) whose block of this body fits
// SMEM_OPTIN at width W (128 or 256) and the narrow or the wide pads: 1024
// for every family (one ray per unit where two do not fit).
inline int max_samples(int wide, int W) {
  int S = 1024;
  for (; S > 0; --S) {
    const size_t smem = wide ? (W == 256 ? render_smem<256, VanillaWide>(S) : render_smem<128, VanillaWide>(S))
                             : (W == 256 ? render_smem<256, Vanilla>(S) : render_smem<128, Vanilla>(S));
    if (smem <= SMEM_OPTIN) break;
  }
  return S;
}

}  // namespace tc
}  // namespace
