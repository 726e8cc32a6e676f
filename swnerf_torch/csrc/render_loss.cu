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
//  2. head_bwd_kernel: d hv through the rgb head and the view layer's
//     activation.
//  3. gemm_kernel, per layer from the top: dH = dZ W^T with the activation's
//     derivative
//     and the rounding to the operand type in its epilogue (row-parallel over
//     samples), and dW = X^T dZ as partial sums over a fixed split of the
//     samples. reduce_kernel adds the partials in split order and scatters
//     them into the packed gradient buffers; colsum_kernel does the same for
//     the fp32 bias sums of the heads. No atomics: two launches on the same
//     inputs give bit-equal gradients.
//
// Operands are fp32 (parity mode) or bf16, rounded where the plain twin and
// _trunk_reverse round them (embedding, activations, dz, g_rgb, dhv, dfa);
// products accumulate in fp32, and the gradients are fp32. The per-sample
// colour stays fp32 (the TPU kernel rounds it in bf16 mode). SIMT only:
// mma/wgmma and TMA are later work. No --use_fast_math (ops/kernels/build.py):
// sinf/cosf stay accurate at the 2^9-frequency arguments, and the
// transmittance floor max(1 - alpha + 1e-10, 1e-10), which is also the
// divisor of d alpha, is not folded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "mlp_common.cuh"

namespace {

constexpr int PADC = 8;    // extra columns of a spilled activation row
constexpr int GT = 64;     // GEMM output tile (rows and columns)
constexpr int GK = 16;     // GEMM reduction tile
constexpr int GEMM_BLOCKS = 1056;  // dW split target: 8 blocks per SM

template <typename T>
struct Scratch {
  T* emb;    // [P][A::CIN], column A::cin(L) = 1
  T* vemb;   // [P][CV]
  T* h;      // D x [P][W + PADC], column W = 1, layer i at h + i * hstride
  size_t hstride;
  T* feat;   // [P][W + PADC]
  T* hv;     // [P][W/2 + PADC]
  T* dfa;    // [P][W + PADC]: d feat (columns < W), d sigma (column W)
  T* gq;     // [P][4]: the raw cotangent in the operand type
  float* graw;  // [P][4]
};

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

template <typename T, int W, typename A>
__global__ void __launch_bounds__(NT)
render_loss_fwd_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                       const float* __restrict__ times, const float* __restrict__ vemb, int cv,
                       const float* __restrict__ z,
                       const float* __restrict__ dist, const float* __restrict__ noise,
                       const float* __restrict__ target, const T* __restrict__ wts,
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
  float* lt_s = raw_s + rays_per_block * S * 4;        // [rays_per_block * S]
  float* red = lt_s + rays_per_block * S;              // [4][CH][3]
  T* actA = reinterpret_cast<T*>(red + NRED);          // [W][LDA]
  T* actB = actA + W * LDA;                            // [W][LDA]
  T* emb = actB + W * LDA;                             // [A::CIN][LDA]
  T* vemb_s = emb + A::CIN * LDA;                      // [CV][LDA]
  T* Ws = vemb_s + CV * LDA;                           // [KT][W]

  const float* b_views = bias + (D + 1) * W;
  const float* b_rgb = b_views + WH;
  const float b_alpha = b_rgb[3];
  const int r = threadIdx.x & (CH - 1);
  const int p = threadIdx.x / CH;

  for (int row0 = 0; row0 < rows; row0 += CH) {
    const int nvalid = min(CH, rows - row0);
    const long long pr = p0 + row0;
    encode_chunk<T, A>(emb, vemb_s, row0, rows, ray0, S, L, cv, origins, dirs, times, z, vemb);
    __syncthreads();
    spill<T>(emb, cin, sc.emb, A::CIN, pr, nvalid, true);
    spill<T>(vemb_s, cv, sc.vemb, CV, pr, nvalid, false);
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
      mm_acc<T, WH>(acc, vemb_s, CV, wp, Ws);
      wp += CV * WH;
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
    const float e0 = c0 - target[ray * 3 + 0];
    const float e1 = c1 - target[ray * 3 + 1];
    const float e2 = c2 - target[ray * 3 + 2];
    sqerr_out[ray] = (e0 * e0 + e1 * e1) + e2 * e2;
    // d loss / d rgb_map = loss_scale * 2 * err; white: d / d acc = -sum_c.
    const float gs = loss_scale * 2.f;
    const float g0 = gs * e0, g1 = gs * e1, g2 = gs * e2;
    const float gacc = white ? -((g0 + g1) + g2) : 0.f;
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
      const float dldw = ((g0 * rgb[0] + g1 * rgb[1]) + g2 * rgb[2]) + gacc;
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

// ELU's derivative from its stored output h (h = expm1(z) for z <= 0), in
// fp32 from h in the operand type, as _act_grad takes it.
__device__ __forceinline__ float elu_grad(float h) { return h > 0.f ? 1.f : h + 1.f; }

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

// ELU: the epilogue's act' is ELU's (else ReLU's [mask > 0]); a template
// parameter, so the vanilla instantiations stay the code B1 was measured with.
template <typename T, bool PARTIAL, bool ELU = false>
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

template <typename T, typename A>
size_t scratch_bytes(int W, int D, long long P) {
  const int WH = W / 2;
  size_t b = 0;
  b += align256(sizeof(T) * P * A::CIN);
  b += align256(sizeof(T) * P * CV);
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
  return b;
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

// dH-style product: row-parallel, masked and rounded in the epilogue.
template <typename T, bool ELU = false>
int gemm_act(GemmArgs g, cudaStream_t st) {
  g.kchunk = ceil_div(g.K, GK) * GK;
  gemm_kernel<T, false, ELU><<<dim3(ceil_div(g.M, GT), ceil_div(g.N, GT), 1), 256, 0, st>>>(g);
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

template <typename T, int W, typename A>
int launch(const float* origins, const float* dirs, const float* times, const float* vemb, int cv, const float* z,
           const float* dist, const float* noise, const float* target, const void* wts_v, const float* bias, int D,
           int skip, int L, int white, float loss_scale, int N, int S, float* rgb, float* acc, float* depth,
           float* sqerr, float* w_out, float* gw, float* gb, void* scratch, cudaStream_t st) {
  constexpr int CIN = A::CIN;
  constexpr bool ELU = A::ACT == Act::Elu;
  constexpr int LDA = Op<T>::LDA;
  constexpr int WH = W / 2;
  constexpr int LDW = W + PADC;
  constexpr int LDH = WH + PADC;
  const T* wts = static_cast<const T*>(wts_v);
  const long long P = (long long)N * S;
  const int cin = A::cin(L);

  Carver cv_{static_cast<unsigned char*>(scratch)};
  Scratch<T> sc;
  sc.emb = cv_.take<T>(P * CIN);
  sc.vemb = cv_.take<T>(P * CV);
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
  auto hl = [&](int i) { return sc.h + (size_t)i * sc.hstride; };

  // 1. forward, loss and the composite backward
  const int rays_per_block = std::max(1, CH / S);
  const size_t smem = sizeof(float) * ((size_t)rays_per_block * S * 5 + NRED) +
                      sizeof(T) * ((size_t)(2 * W + CIN + CV) * LDA + KT * W);
  auto kern = render_loss_fwd_kernel<T, W, A>;
  SWNERF_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  const long long blocks = ((long long)N + rays_per_block - 1) / rays_per_block;
  kern<<<(unsigned)blocks, NT, smem, st>>>(origins, dirs, times, vemb, cv, z, dist, noise, target, wts, bias, D,
                                            skip, L, white, loss_scale, N, S, rays_per_block, rgb, acc, depth,
                                            sqerr, w_out, sc);
  SWNERF_CHECK(cudaGetLastError());

  // Offsets of the packed matrices (ops/kernels/render_pass.py::weight_layout)
  // and biases (bias_layout).
  size_t off_w[16], off_wemb = 0;
  size_t o = 0;
  off_w[0] = o;
  o += (size_t)CIN * W;
  for (int i = 1; i < D; ++i) {
    if (i == skip + 1) {
      off_wemb = o;
      o += (size_t)CIN * W;
    }
    off_w[i] = o;
    o += (size_t)W * W;
  }
  const size_t off_feat = o, off_alpha = o + (size_t)W * W;
  const size_t off_vf = off_alpha + W, off_vv = off_vf + (size_t)W * WH, off_rgb = off_vv + (size_t)CV * WH;
  float* gb_feat = gb + (size_t)D * W;
  float* gb_views = gb_feat + W;
  float* gb_rgb = gb_views + WH;
  float* gb_alpha = gb_rgb + 3;
  const Region none{nullptr, 0, nullptr};

  // 2. rgb head and view layer
  head_bwd_kernel<T, WH, A::ACT><<<ceil_div(P * WH, 256), 256, 0, st>>>(sc.gq, sc.hv, LDH, wts + off_rgb, P, dhv32,
                                                                        dhv_c);
  SWNERF_CHECK(cudaGetLastError());
  SWNERF_RUN(gemm_reduce<T>(gemm_args(sc.hv, 1, LDH, sc.gq, 4, 1, WH, 4, (int)P), part, WH, 3,
                            Region{gw + off_rgb, 3, nullptr}, none, st));
  SWNERF_RUN(colsum(sc.graw, 4, 3, P, part, gb_rgb, st));
  SWNERF_RUN(colsum(dhv32, WH, WH, P, part, gb_views, st));
  SWNERF_RUN(gemm_reduce<T>(gemm_args(sc.feat, 1, LDW, dhv_c, WH, 1, W, WH, (int)P), part, W, WH,
                            Region{gw + off_vf, WH, nullptr}, none, st));
  SWNERF_RUN(gemm_reduce<T>(gemm_args(sc.vemb, 1, CV, dhv_c, WH, 1, cv, WH, (int)P), part, cv, WH,
                            Region{gw + off_vv, WH, nullptr}, none, st));

  // 3. d feat = q(dhv @ W_vf^T) next to the d sigma column, then the
  //    feature + alpha product's dW (its ones row gives both biases)
  {
    GemmArgs g = gemm_args(dhv_c, WH, 1, wts + off_vf, 1, WH, (int)P, W, WH);
    g.C = sc.dfa;
    g.ldc = LDW;
    SWNERF_RUN(gemm_act<T>(g, st));
  }
  SWNERF_RUN(gemm_reduce<T>(gemm_args(hl(D - 1), 1, LDW, sc.dfa, LDW, 1, W + 1, W + 1, (int)P), part, W, W,
                            Region{gw + off_feat, W, gb_feat}, Region{gw + off_alpha, 1, gb_alpha}, st));
  {  // dz_{D-1} = q((dfeat @ W_feat^T + dsigma * w_alpha^T) * act'(h_{D-1}))
    GemmArgs g = gemm_args(sc.dfa, LDW, 1, wts + off_feat, 1, W, (int)P, W, W);
    g.u = sc.dfa + W;
    g.su = LDW;
    g.v = wts + off_alpha;
    g.mask = hl(D - 1);
    g.ldm = LDW;
    g.C = dz[(D - 1) & 1];
    g.ldc = W;
    SWNERF_RUN((gemm_act<T, ELU>(g, st)));
  }

  // 4. the trunk, from the top
  for (int i = D - 1; i >= 0; --i) {
    const T* dzi = dz[i & 1];
    if (i == 0 || i == skip + 1) {  // embedding rows, with the bias row
      const size_t off = i == 0 ? off_w[0] : off_wemb;
      SWNERF_RUN(gemm_reduce<T>(gemm_args(sc.emb, 1, CIN, dzi, W, 1, cin + 1, W, (int)P), part, cin, W,
                                Region{gw + off, W, gb + (size_t)i * W}, none, st));
    }
    if (i > 0) {
      const bool bias_here = i != skip + 1;
      SWNERF_RUN(gemm_reduce<T>(gemm_args(hl(i - 1), 1, LDW, dzi, W, 1, bias_here ? W + 1 : W, W, (int)P), part,
                                W, W, Region{gw + off_w[i], W, bias_here ? gb + (size_t)i * W : nullptr}, none,
                                st));
      GemmArgs g = gemm_args(dzi, W, 1, wts + off_w[i], 1, W, (int)P, W, W);
      g.mask = hl(i - 1);
      g.ldm = LDW;
        g.C = dz[(i - 1) & 1];
      g.ldc = W;
      SWNERF_RUN((gemm_act<T, ELU>(g, st)));
    }
  }
  return 0;
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
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
  if (D < 2 || D > 16 || skip < 0 || skip + 1 >= D || !cin_ok || cv > CV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWNERF_LAUNCH(T, WW, AA)                                                                               \
  launch<T, WW, AA>(origins, dirs, times, vemb, cv, z, dist, noise, target, wts, bias, D, skip, L, white,     \
                    loss_scale, N, S, rgb, acc, depth, sqerr, w_out, gw, gb, scratch, st)
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

}  // extern "C"
