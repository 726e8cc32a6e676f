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

}  // extern "C"
