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
// D-NeRF kernel steps and eval passes): B2's samples, computed by the same
// code so that they are bit-equal to B2's, then written as the sorted union
// with the ray's coarse depths z [N, Mz], the importance resample's
// torch.sort(torch.cat([z, samples])) in one launch. The TPU kernel ranks
// by select sweeps and needs sorted u; here the warp keeps the samples and
// the coarse depths in shared memory, one lane insertion-sorts each (one
// pass of compares when they arrive sorted, as they do for sorted u up to
// B2's rounding at the bin edges), and every lane then places its elements
// by rank with a binary search in the other list: coarse depth z_i lands at
// i + |{j : s_j < z_i}|, sample s_j at j + |{i : z_i <= s_j}| (ties go to
// the coarse depth, as _merge_kernel ranks them). The output is the sorted
// multiset, whatever order the samples or the depths came in. Bound:
// bytes, as B2, plus Mz reads and Mz + S writes per ray.

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

// B2's inverse-CDF sample of us from the ray's cdf and bins in shared
// memory, with B2's arithmetic (the lerp unfused, as the twin computes it).
__device__ __forceinline__ float inverse_cdf(const float* cdf, const float* bn, int M, float us) {
  int inds = 0;
  for (int k = 0; k < M; ++k) inds += (cdf[k] <= us) ? 1 : 0;
  const int below = max(0, inds - 1);
  const int above = min(M - 1, inds);
  const float cdf_b = cdf[below], cdf_a = cdf[above];
  const float bins_b = bn[below], bins_a = bn[above];
  float denom = cdf_a - cdf_b;
  denom = (denom < 1e-5f) ? 1.f : denom;
  const float t = (us - cdf_b) / denom;
  return __fadd_rn(bins_b, __fmul_rn(t, bins_a - bins_b));
}

__device__ __forceinline__ void insertion_sort(float* x, int n) {
  for (int i = 1; i < n; ++i) {
    const float v = x[i];
    int j = i - 1;
    while (j >= 0 && x[j] > v) {
      x[j + 1] = x[j];
      --j;
    }
    x[j + 1] = v;
  }
}

// |{k < n : x_k < v}| (strict) or |{k < n : x_k <= v}| over sorted x.
template <bool STRICT>
__device__ __forceinline__ int count_below(const float* x, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (STRICT ? x[mid] < v : x[mid] <= v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kWarps * 32)
sample_pdf_merge_kernel(const float* __restrict__ bins, long long bins_stride,
                        const float* __restrict__ weights, long long w_stride,
                        const float* __restrict__ u, long long u_stride,
                        const float* __restrict__ z, long long z_stride,
                        float* __restrict__ out, int N, int M, int Mz, int S) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kWarps + warp;
  float* cdf = smem + warp * (2 * M + Mz + S);
  float* bn = cdf + M;
  float* zs = bn + M;
  float* smp = zs + Mz;
  if (ray >= N) return;

  const float* b_row = bins + ray * bins_stride;
  const float* w_row = weights + ray * w_stride;
  const float* u_row = u + ray * u_stride;
  const float* z_row = z + ray * z_stride;
  for (int j = lane; j < M; j += 32) {
    bn[j] = b_row[j];
    if (j < M - 1) cdf[j + 1] = w_row[j] + 1e-5f;
  }
  for (int i = lane; i < Mz; i += 32) zs[i] = z_row[i];
  __syncwarp();
  if (lane == 0) {  // B2's scan, in the same order
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
  for (int s = lane; s < S; s += 32) smp[s] = inverse_cdf(cdf, bn, M, u_row[s]);
  __syncwarp();
  if (lane == 0) insertion_sort(smp, S);
  else if (lane == 1) insertion_sort(zs, Mz);
  __syncwarp();
  float* o_row = out + ray * (long long)(Mz + S);
  for (int i = lane; i < Mz; i += 32) o_row[i + count_below<true>(smp, S, zs[i])] = zs[i];
  for (int j = lane; j < S; j += 32) o_row[j + count_below<false>(zs, Mz, smp[j])] = smp[j];
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

// B10: bins, weights, u as sample_pdf_f32's; z [N, Mz] (unit stride along
// the last dim, row stride z_stride); out [N, Mz + S] contiguous: the sorted
// union of z's row and the row's samples.
int sample_pdf_merge_f32(const float* bins, long long bins_stride, const float* weights, long long w_stride,
                         const float* u, long long u_stride, const float* z, long long z_stride, float* out, int N,
                         int M, int Mz, int S, void* stream) {
  if (N == 0) return 0;
  const int blocks = (N + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * (2 * M + Mz + S);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  sample_pdf_merge_kernel<<<blocks, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      bins, bins_stride, weights, w_stride, u, u_stride, z, z_stride, out, N, M, Mz, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
