// The reverse sweep's two large products on Hopper's tensor cores, for the
// bf16 backward of B1 (render_loss.cu, vanilla train mode), of B4 (the
// same, T-NeRF: ELU), of B6 (time_net.cu, without input cotangents) and of
// B7 (trunk.cu, with the input cotangent demb): dW = X^T dZ and dH = dZ
// W^T, the shapes of gemm_common.cuh::gemm_reduce and gemm_act, which
// trunk_reverse and field_reverse call here instead under their TC switch.
// Every other instantiation (the fp32 parity mode, B5, B7', B8, B9, B11)
// keeps gemm_common.cuh's SIMT product, and so do the narrow products of
// the swept kernels (the rgb head, B6's 3-wide output head,
// head_bwd_kernel), B7's dvemb and the column sums of fp32 cotangents.
//
// Replaces, on the card, the products of swnerf_tpu/ops/pallas/
// render_fused.py::_trunk_reverse (:184-268, inside _render_loss_kernel),
// raymarch.py::_bwd_kernel_plain (:480) and raymarch.py::_bwd_kernel
// (:446, _trunk_backward :393-418).
//
// Bound: operations. At D=8, W=256 one sample's dW and dH products are
// about 1.1M multiply-adds, 0.46 ms of B1's fine pass (196,608 samples) at
// 989 TFLOP/s. The operands do not stay on chip: each layer's spilled
// activation and its dz ([P][W] bf16, ~100 MB at that P) are read from HBM,
// and dz is read by both of the layer's products (a later PR may fuse
// them). So the design keeps HBM streaming and leaves the tensor cores'
// rate to spare:
//
//  - Both kernels are two warpgroups (256 threads) of which every thread
//    issues 16-byte cp.async copies into a 4-stage ring of 64-deep stages,
//    in the 128-byte swizzled layout wgmma reads; a stage is waited for,
//    fenced to the async proxy and published with one block barrier, and the
//    next stage's copies are issued before this one's products. One block
//    per SM (~200 KB of shared memory), three stages in flight.
//  - dH = dZ W^T (sweep_dh_kernel): a persistent grid over 128-row tiles,
//    64 rows per warpgroup, K-major operands (tc_chunk.cuh's layout): dZ's
//    rows are k-contiguous, and B(k = out, n = in) = W[n][k] is k-contiguous
//    in the packed [in][out] buffer, so each block copies the whole matrix
//    (128 KB at W=256) into shared memory once, straight from the packed
//    weights: no second weight image. The epilogue, from the accumulators:
//    + u[m] v[n] (the top layer's d sigma w_alpha term), times the
//    activation's derivative from the stored activation (ReLU's mask, or
//    ELU's h + 1 for h <= 0: B4), rounded to bf16 where gemm_kernel rounds.
//    B7's input cotangent demb = dz W_emb^T takes the same product with an
//    fp32 epilogue and no mask: stored over the live columns for the skip
//    layer's rows, then added to for layer 0's (gemm_act's F32 = 1, 2).
//  - dW = X^T dZ (sweep_dw_kernel): both operands have the reduction (the
//    rows) as their slow dimension, so both are MN-major (wgmma's transpose
//    flags): per row, 64 values in 128 bytes; 8 rows an atom (SBO 1024),
//    64-wide blocks along N an atom stack apart (LBO). A block owns 128 of
//    X's columns (64 per warpgroup, m64nN accumulators) over a fixed split
//    of the rows, a few thousand at the main paths' P, and writes an fp32
//    partial; reduce_kernel adds the partials in split order. No atomics:
//    two launches give bit-equal gradients.
//  - The awkward edges stay off the tensor cores: the bias row (the spilled
//    column of ones, M = in + 1) is the fp32 sum of dZ's columns, and the
//    top layer's d sigma column (N = W + 1) the fp32 dot of X's columns with
//    it, both taken by the block's threads from the stage in shared memory
//    while its products run, in row order (the SIMT product's order: one
//    FMA chain per element over the split). An extra m64 or n8 product
//    would cost a quarter more of the tensor cores' work, or a layout of
//    its own, for one row and one column.
//  - The chain of k16 steps rounds its fp32 sum toward zero at each step
//    (tc_rounding.py); a dW split's chain is a few hundred steps, a bias
//    near 1e-5 relative. The forwards stay where they were: the ReLU masks
//    come from the stored activations, which this product never rewrites.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_chunk.cuh"

namespace {
namespace tc {

constexpr int SWEEP_THREADS = 256;  // two warpgroups; every thread copies
constexpr int SWEEP_STAGES = 4;     // the cp.async ring
constexpr int SWEEP_KT = 64;        // reduction depth of one stage

// 16 bytes global -> shared, zero-filled (nothing read) when !valid.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// The oldest stage in flight has landed, every thread's copies, and is
// visible to the tensor cores (async proxy); every thread has also finished
// with the stage before it, whose slot the next copies refill.
__device__ __forceinline__ void stage_ready() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(SWEEP_STAGES - 2) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Byte offset of 16-byte chunk c of row r in a run of 128-byte swizzled
// rows starting 1024-aligned (tile_off's pattern).
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// A wgmma descriptor of an MN-major operand with the 128-byte swizzle: per
// k row 64 M (or N) values in 128 bytes, groups of 8 rows 1024 bytes apart
// (SBO), 64-wide blocks along M / N lbo bytes apart (LBO).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64 x N] += A[64 x 16] B[16 x N] with both operands MN-major (the
// transpose flags); the accumulators as tc::wgmma<N>'s.
template <int N>
__device__ __forceinline__ void wgmma_t(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_t<256>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_t<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_t<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// ---- dW = X^T dZ over a fixed split of the rows ----

struct DwArgs {
  const bf16* x;     // X [K][ldx]: A(m, k) = X[k][m]; columns >= mx read as 0
  long long ldx;
  int mx;
  const bf16* z;     // dZ [K][ldz]: B(k, n) = dZ[k][n]; with extra, column N too
  long long ldz;
  int M;             // output rows m < M
  long long K;
  long long kchunk;  // rows per split, a multiple of SWEEP_KT
  int bias;          // partial row M: sum_k dZ[k][n]
  int extra;         // partial column N: sum_k X[k][m] dZ[k][N] (and, with bias, sum_k dZ[k][N])
  float* part;       // [splits][M + bias][N + extra]
};

// One stage: X's 128 columns (an atom per warpgroup), dZ's N columns (an
// atom per 64), the 16-byte chunk holding dZ's column N.
template <int N>
__host__ __device__ constexpr int dw_slot() {
  return 2 * ATOM_BYTES + N * 128 + 1024;
}
template <int N>
__host__ __device__ constexpr size_t dw_smem() {
  return 1024 + (size_t)SWEEP_STAGES * dw_slot<N>();
}

template <int N>
__global__ void __launch_bounds__(SWEEP_THREADS, 1) sweep_dw_kernel(const DwArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int m0 = blockIdx.x * 128 + wg * 64;
  const bool active = m0 < g.M;  // uniform per warpgroup
  const long long kb = (long long)blockIdx.y * g.kchunk;
  const long long ke = min(g.K, kb + g.kchunk);
  const int stages = (int)((ke - kb + SWEEP_KT - 1) / SWEEP_KT);
  const bool do_bias = g.bias && blockIdx.x == 0 && tid < N;
  const bool do_extra = g.extra && tid < 128 && blockIdx.x * 128 + tid < g.M;
  const bool do_corner = g.bias && g.extra && blockIdx.x == 0 && tid == 128;  // a thread with no extra column

  // Neighbouring threads copy neighbouring 16 bytes of a row; rows past
  // the split are zero in both operands.
  auto load = [&](int t) {
    const uint32_t s = base + (t % SWEEP_STAGES) * dw_slot<N>();
    const long long r0 = kb + (long long)t * SWEEP_KT;
    for (int e = tid; e < SWEEP_KT * 16; e += SWEEP_THREADS) {
      const int k = e >> 4, w = (e >> 3) & 1, c = e & 7;
      const long long r = r0 + k;
      const int col = blockIdx.x * 128 + w * 64 + c * 8;
      const bool ok = r < ke && col < g.mx;
      cp16(s + w * ATOM_BYTES + swz(k, c), ok ? g.x + r * g.ldx + col : g.x, ok);
    }
    for (int e = tid; e < SWEEP_KT * (N / 8); e += SWEEP_THREADS) {
      const int k = e / (N / 8), nb = (e % (N / 8)) >> 3, c = e & 7;
      const long long r = r0 + k;
      const bool ok = r < ke;
      cp16(s + (2 + nb) * ATOM_BYTES + swz(k, c), ok ? g.z + r * g.ldz + nb * 64 + c * 8 : g.z, ok);
    }
    if (g.extra && tid < SWEEP_KT) {
      const long long r = r0 + tid;
      const bool ok = r < ke;
      cp16(s + 2 * ATOM_BYTES + N * 128 + tid * 16, ok ? g.z + r * g.ldz + N : g.z, ok);
    }
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  float colsum = 0.f, xdot = 0.f, corner = 0.f;
  for (int t = 0; t < SWEEP_STAGES - 1; ++t) {
    if (t < stages) load(t);
    cp_commit();
  }
  for (int t = 0; t < stages; ++t) {
    stage_ready();
    if (t + SWEEP_STAGES - 1 < stages) load(t + SWEEP_STAGES - 1);
    cp_commit();
    const unsigned char* sp = sm + (t % SWEEP_STAGES) * dw_slot<N>();
    const uint32_t sa = base + (t % SWEEP_STAGES) * dw_slot<N>();
    if (active) {
      fence_acc<N / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)  // 16 rows a step: two 8-row groups
        wgmma_t<N>(acc, desc_mn(sa + wg * ATOM_BYTES + s * 2048, ATOM_BYTES),
                   desc_mn(sa + 2 * ATOM_BYTES + s * 2048, ATOM_BYTES));
      wgmma_commit();
    }
    if (do_bias) {  // column tid of dZ, in row order
      const unsigned char* b = sp + (2 + (tid >> 6)) * ATOM_BYTES + (tid & 7) * 2;
      const int c = (tid & 63) >> 3;
      for (int k = 0; k < SWEEP_KT; ++k) colsum += __bfloat162float(*reinterpret_cast<const bf16*>(b + swz(k, c)));
    }
    if (do_extra) {  // X's column m = 128 blockIdx.x + tid against dZ's column N, in row order
      const unsigned char* a = sp + (tid >> 6) * ATOM_BYTES + (tid & 7) * 2;
      const unsigned char* dn = sp + 2 * ATOM_BYTES + N * 128;
      const int c = (tid & 63) >> 3;
      for (int k = 0; k < SWEEP_KT; ++k)
        xdot = fmaf(__bfloat162float(*reinterpret_cast<const bf16*>(a + swz(k, c))),
                    __bfloat162float(*reinterpret_cast<const bf16*>(dn + k * 16)), xdot);
    }
    if (do_corner) {  // dZ's column N, in row order
      const unsigned char* dn = sp + 2 * ATOM_BYTES + N * 128;
      for (int k = 0; k < SWEEP_KT; ++k) corner += __bfloat162float(*reinterpret_cast<const bf16*>(dn + k * 16));
    }
    if (active) {
      wgmma_wait<0>();
      fence_acc<N / 2>(acc);
    }
  }

  const int Nr = N + g.extra;
  float* part = g.part + (size_t)blockIdx.y * (g.M + g.bias) * Nr;
  if (active) {
    const int lane = tid & 31;
    const int r0 = m0 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = j * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + 8 * h;
        if (m < g.M) {
          part[(size_t)m * Nr + n] = acc[4 * j + 2 * h];
          part[(size_t)m * Nr + n + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  }
  if (do_bias) part[(size_t)g.M * Nr + tid] = colsum;
  if (do_extra) part[(size_t)(blockIdx.x * 128 + tid) * Nr + N] = xdot;
  if (do_corner) part[(size_t)g.M * Nr + N] = corner;
}

template <int N>
inline cudaError_t dw_launch(const DwArgs& g, int splits, cudaStream_t st) {
  constexpr size_t smem = dw_smem<N>();
  const cudaError_t e = cudaFuncSetAttribute(sweep_dw_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  sweep_dw_kernel<N><<<dim3((g.M + 127) / 128, splits), SWEEP_THREADS, smem, st>>>(g);
  return cudaGetLastError();
}

// ---- dH = dZ W^T, row-parallel, with the activation's derivative ----

struct DhArgs {
  const bf16* a;     // dZ [P][lda]: A(m, k), k < K
  long long lda;
  const bf16* w;     // the packed [N in][K out] matrix: B(k, n) = w[n K + k]
  long long P;
  const bf16* mask;  // nullable: times the activation's derivative at mask[m ldm + n]
  long long ldm;
  const bf16* u;     // nullable: + u[m su] v[n], before the mask
  long long su;
  const bf16* v;
  bf16* c;           // q(result) into c[m ldc + n]
  long long ldc;
  float* c32;        // Epi::Store32 / Add32: the fp32 result into (onto) c32[m ldc + n], n < ncol
  int ncol;
};

// The dH epilogue: times ReLU's derivative [mask > 0] (B1, B6, B7) or
// ELU's from the stored output (B4), rounded to bf16 into c; or the fp32
// sum stored into c32, or added to it, with no mask (B7's demb).
enum class Epi { Relu, Elu, Store32, Add32 };

// The matrix (K / 64 atoms of N rows), then the ring of 128-row A stages.
template <int N, int K>
__host__ __device__ constexpr size_t dh_smem() {
  return 1024 + (size_t)(K / 64) * N * 128 + (size_t)SWEEP_STAGES * 2 * ATOM_BYTES;
}

template <int N, int K, Epi E = Epi::Relu>
__global__ void __launch_bounds__(SWEEP_THREADS, 1) sweep_dh_kernel(const DhArgs g) {
  constexpr int KA = K / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(sm);
  const uint32_t ring = base + KA * N * 128;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const long long tiles = (g.P + 127) / 128;
  const long long units = ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * KA;  // (tile, atom) pairs

  // The matrix, once: atom a holds k = 64a .. 64a+63 of every n as one
  // 128-byte row per n (B k-major), with the first stage's copies.
  for (int e = tid; e < KA * N * 8; e += SWEEP_THREADS) {
    const int a = e / (N * 8), n = (e >> 3) % N, c = e & 7;
    cp16(base + a * N * 128 + swz(n, c), g.w + (size_t)n * K + a * 64 + c * 8, true);
  }
  auto load = [&](long long u) {
    const uint32_t s = ring + (int)(u % SWEEP_STAGES) * 2 * ATOM_BYTES;
    const long long row0 = (blockIdx.x + (u / KA) * gridDim.x) * 128;
    const int ka = (int)(u % KA);
    for (int e = tid; e < 128 * 8; e += SWEEP_THREADS) {
      const int r = e >> 3, c = e & 7;
      const long long row = row0 + r;
      const bool ok = row < g.P;
      cp16(s + (r >> 6) * ATOM_BYTES + swz(r & 63, c), ok ? g.a + row * g.lda + ka * 64 + c * 8 : g.a, ok);
    }
  };
  for (int t = 0; t < SWEEP_STAGES - 1; ++t) {
    if (t < units) load(t);
    cp_commit();
  }

  float acc[N / 2];
  for (long long u = 0; u < units; ++u) {
    stage_ready();
    if (u + SWEEP_STAGES - 1 < units) load(u + SWEEP_STAGES - 1);
    cp_commit();
    const int ka = (int)(u % KA);
    const uint32_t sa = ring + (int)(u % SWEEP_STAGES) * 2 * ATOM_BYTES + wg * ATOM_BYTES;
    const uint32_t sb = base + ka * N * 128;
    if (ka > 0) fence_acc<N / 2>(acc);
    wgmma_fence();
    if (ka == 0)
      wgmma_zero<N>(acc, desc(sa), desc(sb));
    else
      wgmma<N>(acc, desc(sa), desc(sb));
#pragma unroll
    for (int s = 1; s < 4; ++s) wgmma<N>(acc, desc(sa + s * 32), desc(sb + s * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<N / 2>(acc);
    if (ka < KA - 1) continue;

    // the tile's epilogue, rows < P: each row's mask is loaded before any
    // of its stores (which the compiler cannot move loads across), so the
    // loads are in flight together. An absent mask or v reads row m of c
    // instead, unused: no load of the epilogue can leave valid memory.
    const int lane = tid & 31;
    const long long r0 = (blockIdx.x + (u / KA) * gridDim.x) * 128 + wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
    if constexpr (E == Epi::Store32 || E == Epi::Add32) {  // fp32, the live columns; ldc may be odd
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = r0 + 8 * h;
        if (m >= g.P) continue;
        float* crow = g.c32 + m * g.ldc;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = j * 8 + 2 * (lane & 3) + e;
            if (n < g.ncol) crow[n] = E == Epi::Add32 ? crow[n] + acc[4 * j + 2 * h + e] : acc[4 * j + 2 * h + e];
          }
      }
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = r0 + 8 * h;
      if (m >= g.P) continue;
      const bf16* mrow = g.mask ? g.mask + m * g.ldm : g.c + m * g.ldc;
      const bf16* vrow = g.u ? g.v : g.c + m * g.ldc;
      __nv_bfloat162 mk[N / 8];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) mk[j] = *reinterpret_cast<const __nv_bfloat162*>(mrow + j * 8 + 2 * (lane & 3));
      const float um = g.u ? __bfloat162float(g.u[m * g.su]) : 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int n = j * 8 + 2 * (lane & 3);
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (g.u) {
          const float2 vn = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vrow + n));
          v0 = fmaf(um, vn.x, v0);
          v1 = fmaf(um, vn.y, v1);
        }
        if (g.mask) {
          const float2 f = __bfloat1622float2(mk[j]);
          if constexpr (E == Epi::Elu) {
            v0 *= elu_grad(f.x);
            v1 *= elu_grad(f.y);
          } else {
            if (!(f.x > 0.f)) v0 = 0.f;
            if (!(f.y > 0.f)) v1 = 0.f;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(g.c + m * g.ldc + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int N, int K, Epi E = Epi::Relu>
inline cudaError_t dh_launch(const DhArgs& g, cudaStream_t st) {
  constexpr size_t smem = dh_smem<N, K>();
  const cudaError_t e =
      cudaFuncSetAttribute(sweep_dh_kernel<N, K, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  sweep_dh_kernel<N, K, E><<<grid_for((g.P + 127) / 128), SWEEP_THREADS, smem, st>>>(g);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace
