// Inverse-CDF importance sampling (kernel B2) and the same with the sorted
// union with the coarse depths (kernel B10) for Hopper: one body,
// sample_pdf_kernel<kMerge>, whose B2 instantiation drops B10's staging of
// the depths and uniforms, its sort vote, its merge and its output rows at
// compile time.
//
// B2 (sample_pdf_f32) replaces swnerf_tpu/ops/pallas/sample_pdf.py::_kernel
// (sample_pdf_pallas). Per ray: w + 1e-5 -> pdf -> cdf (sequential, in
// index order) -> right-side searchsorted (count of cdf <= u) -> below/above
// clamp -> denom < 1e-5 guard -> lerp. Values match the plain twin
// (swnerf_torch/ops/kernels/sample_pdf.py::sample_pdf_plain) bit for bit:
// same summation order, IEEE division, and __fmul_rn/__fadd_rn in the lerp
// so that nvcc does not contract it into an FMA.
//
// B10 (sample_pdf_merge_f32) replaces sample_pdf.py::_merge_kernel
// (sample_pdf_merge_pallas, the SWNERF_PDF_MERGE=1 path of the vanilla and
// D-NeRF kernel steps and eval passes): B2's samples, bit-equal to B2's,
// then written as the sorted union with the ray's coarse depths z [N, Mz],
// the importance resample's torch.sort(torch.cat([z, samples])) in one
// launch. The TPU kernel ranks by select sweeps and needs sorted u; this one
// takes any order.
//
// Bound on the card: bytes. Each ray reads M + (M-1) + S floats and writes
// S (B10: Mz more reads, Mz + S more writes), against ~S log2(M) compares.
// A body with one warp a ray, whose lane 0 scans the ray (and sorts its
// lists) while 31 lanes idle and whose lanes count the cdf by M compares a
// sample, is paced by issue slots, not HBM; here no lane waits on another's
// serial work:
//  - The scan (cdf_scan): a warp takes up to 32 rays and each lane scans
//    one, in B2's order; the warp stages the rows of weights in shared
//    memory on an odd row stride, so the lanes' reads fall in distinct banks.
//  - The search (count_le): each sample counts the cdf values <= u by a
//    binary search of fixed depth (the same steps on every lane) instead of
//    M compares. The cdf starts at 0 and adds w / sum >= 0 (w = weight +
//    1e-5, weights >= 0), so it is non-decreasing and the count is the
//    linear count for any u (NaN included: both give 0). A +inf weight
//    makes the sum +inf and its own step NaN, a NaN weight every step: the
//    cdf is then non-decreasing up to a NaN suffix, "x[p-1] <= u" is still
//    true on a prefix of p, and the two counts still agree.
//  - After the scan the warp takes its rays two at a time, sixteen lanes
//    to a ray; each lane takes eight samples at a time through the search
//    and the lerp (inverse_cdf), so their chains of shared-memory loads
//    overlap, and the loads of a step come before its branches. cp.async
//    brings the next two rays' bins (B10: and depths and uniforms) into a
//    second set of buffers while these are sampled. B2 reads its uniforms
//    and writes its samples straight from and to global memory in those
//    batches (sixteen lanes on a ray: one or two full 64-byte segments an
//    access), so S is not bounded by shared memory.
//  - B10's sort, only when needed: a warp vote over adjacent pairs skips it
//    when the samples (or the depths) are already sorted, the usual case
//    (sorted u, stratified z); else a bitonic sort in shared memory, padded
//    to a power of two with +inf. Every depth is > 0, so there is no -0 or
//    NaN, and any correct sort gives the same bits.
//  - B10's placement: the union's order puts z_i at i + |{j : s_j < z_i}|
//    and s_j at j + |{i : z_i <= s_j}| (ties go to the coarse depth, as
//    _merge_kernel ranks them). Each lane takes a run of the output row,
//    finds how many depths come before it by one bisection (co_rank, merge
//    path's co-rank) and merges its run in order; the row goes out through
//    shared memory, coalesced. (Searching for every element's rank took
//    0.08 of 0.19 ms a 32,768-ray chunk on the H100.)
//  - A warp takes 32 rays where that leaves 2,048 warps or more (a
//    160,000-ray frame), else 16, 8, 4 or 2 (a 32,768-ray chunk: 16; a
//    training step's 500-1,024 rays: 2), since a warp walks its rays in
//    turn. B2 holds a cdf row for each of its rays and takes fewer rays a
//    warp where a block's shared memory would pass 48 KB (M >= 170; at M =
//    1024, 2 rays a warp); B10 keeps 32 cdf rows a warp.

#include <cuda_runtime.h>

namespace {

// |{k < n : x[k] <= v}| over non-decreasing x, for B values at once: a
// binary search by halving steps from the largest power of two <= n, the
// same depth on every lane.
template <int B>
__device__ __forceinline__ void count_le(const float* x, int n, const float (&v)[B], int (&pos)[B]) {
#pragma unroll
  for (int b = 0; b < B; ++b) pos[b] = 0;
  for (int step = n > 0 ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1) {
#pragma unroll
    for (int b = 0; b < B; ++b) {  // loads first, selects after: no branch between them
      const int p = pos[b] + step;
      const float xv = x[min(p, n) - 1];
      pos[b] = (p <= n) & (xv <= v[b]) ? p : pos[b];
    }
  }
}

// One ray's cdf in place, by one lane: c[1 .. M-1] hold its M-1 weights;
// c[0 .. M-1] becomes the cdf in B2's order (w = weight + 1e-5; the sum
// left to right; each w / sum added to a running sum from 0).
__device__ __forceinline__ void cdf_scan(float* c, int M) {
  float sum = c[1] + 1e-5f;
  for (int j = 2; j < M; ++j) sum = sum + (c[j] + 1e-5f);
  float run = 0.f, w = c[1] + 1e-5f;
  c[0] = 0.f;
  for (int j = 1; j < M; ++j) {
    const float next = c[min(j + 1, M - 1)];  // loaded before this step's store
    run = run + w / sum;
    c[j] = run;
    w = next + 1e-5f;
  }
}

// B2's inverse-CDF step for B values us with counts inds of cdf values <=
// us (its clamp, its denominator guard, its unfused lerp); every load comes
// before the divisions, whose slow-path branches would split them.
template <int B>
__device__ __forceinline__ void inverse_cdf(const float* cdf, const float* bn, int M, const float (&us)[B],
                                            const int (&inds)[B], float (&out)[B]) {
  float cb[B], ca[B], bb[B], ba[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int below = max(0, inds[b] - 1), above = min(M - 1, inds[b]);
    cb[b] = cdf[below];
    ca[b] = cdf[above];
    bb[b] = bn[below];
    ba[b] = bn[above];
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    float denom = ca[b] - cb[b];
    denom = (denom < 1e-5f) ? 1.f : denom;
    const float t = (us[b] - cb[b]) / denom;
    out[b] = __fadd_rn(bb[b], __fmul_rn(t, ba[b] - bb[b]));
  }
}

// Sorts x[0 .. n-1] ascending: the lanes t0, t0 + stride, ... of a group
// (every group of the warp runs the same stages, with the same n and P);
// x holds room for P, the power of two >= n, and the pad is +inf.
__device__ void bitonic_sort(float* x, int n, int P, int t0, int stride) {
  for (int i = n + t0; i < P; i += stride) x[i] = __int_as_float(0x7f800000);
  __syncwarp();
  for (int k = 2; k <= P; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = t0; t < P / 2; t += stride) {
        const int a = 2 * t - (t & (j - 1));
        const float xa = x[a], xb = x[a + j];
        if ((xa > xb) == ((a & k) == 0)) {
          x[a] = xb;
          x[a + j] = xa;
        }
      }
      __syncwarp();
    }
}

// How many of the sorted depths z [Mz] come first among the first d
// elements of their union with the sorted samples s [S] (ties to the
// depth): the k with rank(z_k) = k + |{j : s_j < z_k}| < d, that is with
// s[d - k - 1] >= z_k, a prefix of k, found by bisection (merge path's
// co-rank).
__device__ __forceinline__ int co_rank(const float* z, int Mz, const float* s, int S, int d) {
  int lo = max(0, d - S), hi = min(Mz, d);
  while (lo < hi) {
    const int k = (lo + hi) >> 1;
    if (s[d - k - 1] >= z[k]) lo = k + 1;
    else hi = k;
  }
  return lo;
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

constexpr int kWarps = 2;              // warps per block
constexpr int kGroup = 16;             // lanes to a ray after the scan
constexpr int kAtOnce = 32 / kGroup;   // rays a warp samples (and merges) at once
constexpr int kBatch = 8;              // samples a lane takes through the search at once
constexpr long long kSmemDefault = 49152;  // bytes a block takes without opting in

__host__ __device__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The stride of B10's output rows in shared memory: = 4 (mod 32), so the
// groups' stores fall in different banks.
__host__ __device__ int out_stride(int K) { return K + (36 - K % 32) % 32; }

// Floats of one warp's shared memory: `rows` cdf rows (odd stride) and two
// sets of kAtOnce bins buffers; B10 adds to each buffer the depths and the
// uniforms / samples with the sorts' pads, and kAtOnce output rows.
template <bool kMerge>
__host__ __device__ long long warp_floats(int M, int Mz, int S, int rows) {
  if (!kMerge) return (long long)rows * (M | 1) + 2LL * kAtOnce * M;
  return (long long)rows * (M | 1) + 2LL * kAtOnce * (M + pow2_at_least(Mz) + pow2_at_least(S)) +
         (long long)kAtOnce * out_stride(Mz + S);
}

// B2 (kMerge false): out [N, S] the samples; z, z_stride and Mz unused.
// B10: out [N, Mz + S] the sorted union with z.
template <bool kMerge>
__global__ void __launch_bounds__(kWarps * 32)
sample_pdf_kernel(const float* __restrict__ bins, long long bins_stride,
                  const float* __restrict__ weights, long long w_stride,
                  const float* __restrict__ u, long long u_stride,
                  const float* __restrict__ z, long long z_stride,
                  float* __restrict__ out, int N, int M, int Mz, int S, int rays_per_warp) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / kGroup, gl = lane % kGroup;  // the ray group, the lane in it
  const long long ray0 = ((long long)blockIdx.x * kWarps + warp) * rays_per_warp;
  if (ray0 >= N) return;
  const int nr = (int)min((long long)rays_per_warp, N - ray0);
  const int rows = kMerge ? 32 : rays_per_warp;  // cdf rows a warp
  const int ldc = M | 1;
  const int Mzp = kMerge ? pow2_at_least(Mz) : 0, Sp = kMerge ? pow2_at_least(S) : 0;
  const int buf = M + Mzp + Sp;
  float* cdf = smem + warp * warp_floats<kMerge>(M, Mz, S, rows);
  float* stage = cdf + rows * ldc;          // [2][kAtOnce][buf]
  float* obs = stage + 2 * kAtOnce * buf;   // B10: [kAtOnce][Ko], consecutive rays' output rows

  // the bins (B10: and the depths and uniforms) of ray it * kAtOnce + g into its buffer
  auto fetch = [&](int it) {
    const int r = it * kAtOnce + g;
    if (r >= nr) return;
    float* bn = stage + ((it & 1) * kAtOnce + g) * buf;
    const long long ray = ray0 + r;
    for (int j = gl; j < M; j += kGroup) cp4(bn + j, bins + ray * bins_stride + j);
    if constexpr (kMerge) {
      for (int i = gl; i < Mz; i += kGroup) cp4(bn + M + i, z + ray * z_stride + i);
      for (int s = gl; s < S; s += kGroup) cp4(bn + M + Mzp + s, u + ray * u_stride + s);
    }
  };
  for (int r = 0; r < nr; ++r)
    for (int j = lane; j < M - 1; j += 32) cp4(cdf + r * ldc + 1 + j, weights + (ray0 + r) * w_stride + j);
  fetch(0);
  cp_commit();
  cp_wait<0>();
  __syncwarp();
  if (lane < nr) cdf_scan(cdf + lane * ldc, M);
  __syncwarp();

  const int iters = (nr + kAtOnce - 1) / kAtOnce;
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) fetch(it + 1);
    cp_commit();
    cp_wait<1>();  // this step's buffers have landed
    __syncwarp();
    const int r = it * kAtOnce + g;
    const bool live = r < nr;  // a group past the warp's last ray computes nothing and stores nothing
    const float* c = cdf + r * ldc;
    float* bn = stage + ((it & 1) * kAtOnce + g) * buf;
    float* zs = bn + M;
    float* smp = zs + Mzp;  // B10: the uniforms, overwritten by the samples
    const float* u_row = u + (ray0 + r) * u_stride;  // B2: straight from global memory
    float* o_row = out + (ray0 + r) * (long long)S;
    if (live) {
      for (int s0 = gl; s0 < S; s0 += kGroup * kBatch) {
        float us[kBatch];
        int inds[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int s = min(s0 + kGroup * b, S - 1);
          if constexpr (kMerge) us[b] = smp[s];
          else us[b] = u_row[s];
        }
        count_le(c, M, us, inds);
        float x[kBatch];
        inverse_cdf(c, bn, M, us, inds, x);
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (s0 + kGroup * b < S) {
            if constexpr (kMerge) smp[s0 + kGroup * b] = x[b];
            else o_row[s0 + kGroup * b] = x[b];
          }
      }
    }
    if constexpr (kMerge) {
      const int K = Mz + S, Ko = out_stride(K);
      float* ob = obs + g * Ko;
      bool ok_s = true, ok_z = true;
      __syncwarp();
      if (live) {
        for (int s = gl; s + 1 < S; s += kGroup) ok_s &= smp[s] <= smp[s + 1];
        for (int i = gl; i + 1 < Mz; i += kGroup) ok_z &= zs[i] <= zs[i + 1];
      }
      if (!__all_sync(0xffffffffu, ok_s)) bitonic_sort(smp, S, Sp, gl, kGroup);
      if (!__all_sync(0xffffffffu, ok_z)) bitonic_sort(zs, Mz, Mzp, gl, kGroup);
      if (live) {  // each lane merges its run of the output from its co-rank on
        const int run = (K + kGroup - 1) / kGroup;
        const int d0 = min(K, gl * run), d1 = min(K, d0 + run);
        int i = co_rank(zs, Mz, smp, S, d0), j = d0 - i;
        const float inf = __int_as_float(0x7f800000);
        for (int d = d0; d < d1; ++d) {  // both heads loaded every step, then a select: no branch
          const float zi = zs[min(i, Mz - 1)], sj = smp[min(j, S - 1)];
          const bool take_z = (i < Mz ? zi : inf) <= (j < S ? sj : inf);
          ob[d] = take_z ? zi : sj;
          i += take_z;
          j += !take_z;
        }
      }
      __syncwarp();
      const int nrows = min(kAtOnce, nr - it * kAtOnce);
      float* o = out + (ray0 + it * kAtOnce) * (long long)K;
      for (int q = 0; q < nrows; ++q)
        for (int k = lane; k < K; k += 32) o[q * K + k] = obs[q * Ko + k];
    }
    __syncwarp();  // the buffers (B10: and the output rows) are free for the next rays
  }
}

// 32 rays a warp (one a lane in the scan) where that leaves 2,048 warps or
// more, else fewer: a small batch wants warps more than full scans.
int rays_per_warp(int N) {
  int rpw = 32;
  while (rpw > kAtOnce && (long long)N < 2048LL * rpw) rpw >>= 1;
  return rpw;
}

template <bool kMerge>
cudaError_t launch(long long smem, int rpw, const float* bins, long long bins_stride, const float* weights,
                   long long w_stride, const float* u, long long u_stride, const float* z, long long z_stride,
                   float* out, int N, int M, int Mz, int S, void* stream) {
  if (smem > kSmemDefault) {
    const cudaError_t e =
        cudaFuncSetAttribute(sample_pdf_kernel<kMerge>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long per_block = (long long)rpw * kWarps;
  const int blocks = (int)((N + per_block - 1) / per_block);
  sample_pdf_kernel<kMerge><<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      bins, bins_stride, weights, w_stride, u, u_stride, z, z_stride, out, N, M, Mz, S, rpw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B2: bins [N, M], weights [N, M-1], u [N, S] (unit stride along the last
// dim; row strides in elements, 0 broadcasts one row), out [N, S]
// contiguous; 2 <= M <= 1024.
int sample_pdf_f32(const float* bins, long long bins_stride, const float* weights,
                   long long w_stride, const float* u, long long u_stride, float* out,
                   int N, int M, int S, void* stream) {
  if (N == 0 || S == 0) return 0;
  if (M < 2 || M > 1024 || N < 0 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  int rpw = rays_per_warp(N);
  const auto smem = [&] { return 4LL * kWarps * warp_floats<false>(M, 0, 0, rpw); };
  while (rpw > kAtOnce && smem() > kSmemDefault) rpw >>= 1;
  return static_cast<int>(
      launch<false>(smem(), rpw, bins, bins_stride, weights, w_stride, u, u_stride, nullptr, 0, out, N, M, 0, S, stream));
}

// Bytes of B10's shared memory per block, or -1 past the card's 227 KB.
long long sample_pdf_merge_smem_bytes(int M, int Mz, int S) {
  const long long b = 4LL * kWarps * warp_floats<true>(M, Mz, S, 32);
  return b <= 232448 ? b : -1;
}

// B10: bins, weights, u as sample_pdf_f32's; z [N, Mz] (unit stride along
// the last dim, row stride z_stride); out [N, Mz + S] contiguous: the sorted
// union of z's row and the row's samples.
int sample_pdf_merge_f32(const float* bins, long long bins_stride, const float* weights, long long w_stride,
                         const float* u, long long u_stride, const float* z, long long z_stride, float* out, int N,
                         int M, int Mz, int S, void* stream) {
  if (N == 0) return 0;
  const long long smem = sample_pdf_merge_smem_bytes(M, Mz, S);
  if (M < 2 || Mz < 1 || S < 1 || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<true>(smem, rays_per_warp(N), bins, bins_stride, weights, w_stride, u, u_stride,
                                       z, z_stride, out, N, M, Mz, S, stream));
}

}  // extern "C"
