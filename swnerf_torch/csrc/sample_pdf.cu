// Inverse-CDF importance sampling (kernel B2) for Hopper.
//
// Replaces swnerf_tpu/ops/pallas/sample_pdf.py::_kernel (sample_pdf_pallas).
// Per ray: w + 1e-5 -> pdf -> cdf (sequential, in index order) -> right-side
// searchsorted (count of cdf <= u) -> below/above clamp -> denom < 1e-5
// guard -> lerp. Values match the plain twin
// (swnerf_torch/ops/kernels/sample_pdf.py::sample_pdf_plain) bit for bit:
// same summation order, IEEE division, and __fmul_rn/__fadd_rn in the lerp
// so that nvcc does not contract it into an FMA.
//
// Bound on the card: bytes. Each ray reads M + (M-1) + S floats and writes
// S, against ~S*M compares. Design: one warp per ray; the warp stages the
// ray's bins and cdf in shared memory, lane 0 runs the 62-step scan, and
// every lane then serves S/32 samples with coalesced reads of u and writes
// of the output.
//
// B10 (sample_pdf_merge_f32) replaces sample_pdf.py::_merge_kernel
// (sample_pdf_merge_pallas, the SWNERF_PDF_MERGE=1 path of the vanilla and
// D-NeRF kernel steps and eval passes): B2's samples, bit-equal to B2's,
// then written as the sorted union with the ray's coarse depths z [N, Mz],
// the importance resample's torch.sort(torch.cat([z, samples])) in one
// launch. The TPU kernel ranks by select sweeps and needs sorted u; this one
// takes any order. Bound: bytes, as B2, plus Mz reads and Mz + S writes per
// ray. A body with one warp a ray, whose lane 0 scans the ray and sorts its
// lists while 31 lanes idle, is paced by issue slots, not HBM; here no lane
// waits on another's serial work:
//  - The scan (cdf_scan): a warp takes 32 rays and each lane scans one, in
//    B2's order; the warp stages the 32 rows of weights in shared memory on
//    an odd row stride, so the lanes' reads fall in distinct banks.
//  - The search (count_le): each sample counts the cdf values <= u by a
//    binary search of fixed depth (the same steps on every lane) instead of
//    M compares. The cdf starts at 0 and adds w / sum >= 0 (w = weight +
//    1e-5, weights >= 0), so it is non-decreasing and the count is the
//    linear count for any u (NaN included: both give 0).
//  - The sort, only when needed: a warp vote over adjacent pairs skips it
//    when the samples (or the depths) are already sorted, the usual case
//    (sorted u, stratified z); else a bitonic sort in shared memory, padded
//    to a power of two with +inf. Every depth is > 0, so there is no -0 or
//    NaN, and any correct sort gives the same bits.
//  - The placement: the union's order puts z_i at i + |{j : s_j < z_i}|
//    and s_j at j + |{i : z_i <= s_j}| (ties go to the coarse depth, as
//    _merge_kernel ranks them). Each lane takes a run of the output row,
//    finds how many depths come before it by one bisection (co_rank, merge
//    path's co-rank) and merges its run in order; the row goes out through
//    shared memory, coalesced. (Searching for every element's rank took
//    0.08 of 0.19 ms a 32,768-ray chunk on the H100.)
//  - After the scan the warp takes its rays two at a time, sixteen lanes
//    to a ray; each lane takes eight samples at a time through the search,
//    so their chains of shared-memory loads overlap, and the loads of a
//    step come before its branches. cp.async brings the next two rays'
//    bins, depths and uniforms into a second set of buffers while these
//    are sampled and merged. A warp takes 32 rays where that leaves 2,048
//    warps or more (a 160,000-ray frame), else 16, 8, 4 or 2 (a 32,768-ray
//    chunk: 16; a training step's 500-1,024 rays: 2), since a warp walks
//    its rays in turn.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays per block

__global__ void __launch_bounds__(kWarps * 32)
sample_pdf_kernel(const float* __restrict__ bins, long long bins_stride,
                  const float* __restrict__ weights, long long w_stride,
                  const float* __restrict__ u, long long u_stride,
                  float* __restrict__ out, int N, int M, int S) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kWarps + warp;
  float* cdf = smem + warp * 2 * M;
  float* bn = cdf + M;
  if (ray >= N) return;

  const float* b_row = bins + ray * bins_stride;
  const float* w_row = weights + ray * w_stride;
  const float* u_row = u + ray * u_stride;
  for (int j = lane; j < M; j += 32) {
    bn[j] = b_row[j];
    // cdf[j + 1] holds w[j] + 1e-5 until the scan below turns it into the cdf.
    if (j < M - 1) cdf[j + 1] = w_row[j] + 1e-5f;
  }
  __syncwarp();
  if (lane == 0) {
    float sum = cdf[1];
    for (int j = 2; j < M; ++j) sum = sum + cdf[j];
    float run = 0.f;
    cdf[0] = 0.f;
    for (int j = 1; j < M; ++j) {
      const float pdf = cdf[j] / sum;
      run = run + pdf;
      cdf[j] = run;
    }
  }
  __syncwarp();

  float* o_row = out + ray * (long long)S;
  for (int s = lane; s < S; s += 32) {
    const float us = u_row[s];
    int inds = 0;
    for (int k = 0; k < M; ++k) inds += (cdf[k] <= us) ? 1 : 0;
    const int below = max(0, inds - 1);
    const int above = min(M - 1, inds);
    const float cdf_b = cdf[below], cdf_a = cdf[above];
    const float bins_b = bn[below], bins_a = bn[above];
    float denom = cdf_a - cdf_b;
    denom = (denom < 1e-5f) ? 1.f : denom;
    const float t = (us - cdf_b) / denom;
    o_row[s] = __fadd_rn(bins_b, __fmul_rn(t, bins_a - bins_b));
  }
}

// |{k < n : x[k] <= v}| over non-decreasing x, for B values at once: a
// binary search by halving steps from the largest power of two <= n, the
// same depth on every lane. (It can replace sample_pdf_kernel's linear
// count.)
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
// left to right; each w / sum added to a running sum from 0). (It can
// replace sample_pdf_kernel's lane-0 scan.)
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

constexpr int kMergeWarps = 2;         // warps per block
constexpr int kGroup = 16;             // lanes to a ray after the scan
constexpr int kAtOnce = 32 / kGroup;   // rays a warp samples and merges at once
constexpr int kBatch = 8;              // samples a lane takes through the search at once

__host__ __device__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The stride of the output rows in shared memory: = 4 (mod 32), so the
// groups' stores fall in different banks.
__host__ __device__ int out_stride(int K) { return K + (36 - K % 32) % 32; }

// Floats of one warp's shared memory: up to 32 cdf rows (odd stride), two
// sets of kAtOnce buffers of (bins, depths, uniforms / samples) with the
// sorts' pads, and kAtOnce output rows.
__host__ __device__ long long merge_warp_floats(int M, int Mz, int S) {
  return 32LL * (M | 1) + 2LL * kAtOnce * (M + pow2_at_least(Mz) + pow2_at_least(S)) +
         (long long)kAtOnce * out_stride(Mz + S);
}

__global__ void __launch_bounds__(kMergeWarps * 32)
sample_pdf_merge_kernel(const float* __restrict__ bins, long long bins_stride,
                        const float* __restrict__ weights, long long w_stride,
                        const float* __restrict__ u, long long u_stride,
                        const float* __restrict__ z, long long z_stride,
                        float* __restrict__ out, int N, int M, int Mz, int S, int rays_per_warp) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / kGroup, gl = lane % kGroup;  // the ray group, the lane in it
  const long long ray0 = ((long long)blockIdx.x * kMergeWarps + warp) * rays_per_warp;
  if (ray0 >= N) return;
  const int nr = (int)min((long long)rays_per_warp, N - ray0);
  const int ldc = M | 1, Mzp = pow2_at_least(Mz), Sp = pow2_at_least(S), K = Mz + S, Ko = out_stride(K);
  const int buf = M + Mzp + Sp;
  float* cdf = smem + warp * merge_warp_floats(M, Mz, S);
  float* stage = cdf + 32 * ldc;            // [2][kAtOnce][buf]
  float* obs = stage + 2 * kAtOnce * buf;   // [kAtOnce][Ko]: consecutive rays' output rows

  // the bins, depths and uniforms of ray it * kAtOnce + g into its buffer
  auto fetch = [&](int it) {
    const int r = it * kAtOnce + g;
    if (r >= nr) return;
    float* bn = stage + ((it & 1) * kAtOnce + g) * buf;
    const long long ray = ray0 + r;
    for (int j = gl; j < M; j += kGroup) cp4(bn + j, bins + ray * bins_stride + j);
    for (int i = gl; i < Mz; i += kGroup) cp4(bn + M + i, z + ray * z_stride + i);
    for (int s = gl; s < S; s += kGroup) cp4(bn + M + Mzp + s, u + ray * u_stride + s);
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
    float* smp = zs + Mzp;  // the uniforms, overwritten by the samples
    float* ob = obs + g * Ko;
    bool ok_s = true, ok_z = true;
    if (live) {
      for (int s0 = gl; s0 < S; s0 += kGroup * kBatch) {
        float us[kBatch];
        int inds[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) us[b] = smp[min(s0 + kGroup * b, S - 1)];
        count_le(c, M, us, inds);
        float x[kBatch];
        inverse_cdf(c, bn, M, us, inds, x);
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (s0 + kGroup * b < S) smp[s0 + kGroup * b] = x[b];
      }
    }
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
    const int rows = min(kAtOnce, nr - it * kAtOnce);
    float* o = out + (ray0 + it * kAtOnce) * (long long)K;
    for (int q = 0; q < rows; ++q)
      for (int k = lane; k < K; k += 32) o[q * K + k] = obs[q * Ko + k];
    __syncwarp();  // the buffers and the output rows are free for the next rays
  }
}

}  // namespace

extern "C" {

const char* swnerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bins [N, M], weights [N, M-1], u [N, S] (unit stride along the last dim;
// row strides in elements, 0 broadcasts one row), out [N, S] contiguous.
int sample_pdf_f32(const float* bins, long long bins_stride, const float* weights,
                   long long w_stride, const float* u, long long u_stride, float* out,
                   int N, int M, int S, void* stream) {
  if (N == 0) return 0;
  const int blocks = (N + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * 2 * M;
  sample_pdf_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      bins, bins_stride, weights, w_stride, u, u_stride, out, N, M, S);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of B10's shared memory per block, or -1 past the card's 227 KB.
long long sample_pdf_merge_smem_bytes(int M, int Mz, int S) {
  const long long b = 4LL * kMergeWarps * merge_warp_floats(M, Mz, S);
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
  const cudaError_t e =
      cudaFuncSetAttribute(sample_pdf_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // 32 rays a warp (one a lane in the scan) where that leaves 2,048 warps
  // or more, else fewer: a small batch wants warps more than full scans
  int rpw = 32;
  while (rpw > kAtOnce && (long long)N < 2048LL * rpw) rpw >>= 1;
  const long long per_block = (long long)rpw * kMergeWarps;
  const int blocks = (int)((N + per_block - 1) / per_block);
  sample_pdf_merge_kernel<<<blocks, kMergeWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      bins, bins_stride, weights, w_stride, u, u_stride, z, z_stride, out, N, M, Mz, S, rpw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
