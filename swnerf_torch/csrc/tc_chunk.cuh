// The tensor-core chunk product for Hopper, shared by the bf16
// instantiations of B6's forward (time_net.cu), of B3 (render_pass.cu:
// from rays, pts, pts wide), of B4's forward-only launch (the T-NeRF
// traits, same file) and of B7's and B8's forward-only launch (trunk.cu):
// bf16 wgmma with fp32 accumulators, an asynchronous ring of weight slabs,
// and 128 sample rows per pass over the weights. The fp32 instantiations
// (the parity mode), B7', the train-mode forwards of B1, B4, B5, B9, B7 and
// B8 and the training path's B3 launch (ordered) keep mlp_common.cuh's
// SIMT chunk product (mm_acc).
//
// Why: the SIMT product keeps the tensor cores idle and re-reads a ~1 MB
// weight set from L2 for every 64 rows (about 16-19 KB per row); a
// tensor-core product at that blocking would be held by L2. So:
//
//  - A block is three warpgroups: a producer (warpgroup 0, 56 registers a
//    thread after setmaxnreg; one thread issues the copies, and in B3 its
//    other three warps composite) and two consumers (224 registers: an
//    m64n256 fp32 accumulator is 128 a thread). Each consumer owns 64 rows,
//    so every weight slab that lands serves 128 rows, half the L2 bytes per
//    row of the SIMT kernels (about 8-9.5 KB per row).
//  - The weights are laid out once per launch (pack_kernel) as an image in
//    exactly the shared-memory layout wgmma reads as B: per product, per 64
//    input rows (an "atom"), N rows of 128 bytes (B k-major: W^T), with the
//    128-byte swizzle. One thread of the producer copies it slab by slab
//    (cp.async.bulk, at most 32 KB a slab) into a ring of 2-3 slabs, each with
//    a full and an empty mbarrier: the next layer's slabs land while this
//    layer's products run. The grid is persistent (one block per SM), so the
//    ring never drains between row chunks.
//  - A layer's activations stay in shared memory as the A operand, in the
//    same swizzled k-major layout (one 64 x 64 atom per 64 columns;
//    tile_off),
//    one buffer per consumer: the accumulators hold a whole layer's output,
//    so once the consumer's last wgmma on its input has retired, the epilogue
//    writes bias + activation, rounded to bf16 exactly where the twins round,
//    back into the same buffer. Barriers between layers are per warpgroup
//    (named barriers), never block-wide. A second input (the skip layer's
//    embedding, the view layer's view embedding) is a second product into the
//    same accumulators.
//  - The narrow heads are m64n8 products on zero-padded weight columns
//    (1-3% of the blocks' cycles on the card: no other head could save more).
//  - The chain of k16 steps rounds its fp32 sum toward zero at each step
//    (tc_rounding.py), so a bf16 layer's outputs are not those of fp32 FMAs
//    in order: B9's forward, whose gradients the twin's bar holds, the
//    training path's B3 launch that it equals, and B7's and B8's train-mode
//    forwards, whose spilled activations their backward reads, keep the
//    SIMT body.
//
// Deterministic: no atomics; each output element's sum runs in the tensor
// core's fixed order, whatever the row's chunk or block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WGT = 128;               // threads of a warpgroup
constexpr int NTHREADS = 3 * WGT;      // the producer warpgroup, then two consumers
constexpr int ROWS = 128;              // rows per pass over the weights: 64 per consumer
constexpr int ATOM_BYTES = 64 * 128;   // an A atom: 64 rows x 64 bf16 columns
constexpr int STAGE_BYTES = 32768;     // one slab of the weight ring
constexpr int MAX_SEGS = 24;           // products of one plan (D <= 16, a skip, five head products)
constexpr int BAR_BYTES = 128;         // mbarriers: the ring's (3 full + 3 empty), tc_render.cuh's four
// setmaxnreg moves registers within the block's launch allocation (384 x
// 168 = 64,512): the producer warpgroup gives 112 a thread, the consumers
// take 56 (128 x 56 + 256 x 224 = 64,512; more and the consumers wait
// forever). 56 keeps tc_render.cuh's composite warps from spilling.
constexpr int PRODUCER_REGS = 56;      // the producer, and tc_render.cuh's composite warps
constexpr int CONSUMER_REGS = 224;

__host__ __device__ constexpr int atoms(int k) { return (k + 63) / 64; }
// Atoms of a B operand with N columns that one slab holds (each N x 128 bytes).
__host__ __device__ constexpr int slab_atoms(int n) { return STAGE_BYTES / (n * 128); }

// One B operand of a plan: the packed matrix [k_src][n_src] at element src
// of the weight buffer (ops/kernels/*.py::weight_layout), as k (a multiple
// of 16) x n (a multiple of 8) in the image at byte dst; rows and columns
// past the source are zero.
struct Seg {
  long long src;
  int k_src, n_src;
  int k, n;
  long long dst;
};

// The image's products in the order the consumers take them.
struct Plan {
  Seg s[MAX_SEGS];
  int count;
  long long bytes;
};

inline void add_seg(Plan& p, long long src, int k_src, int n_src, int k, int n) {
  Seg& s = p.s[p.count++];
  s.src = src;
  s.k_src = k_src;
  s.n_src = n_src;
  s.k = k;
  s.n = n;
  s.dst = p.bytes;
  p.bytes += (long long)atoms(k) * n * 128;
}

// A D-layer ReLU trunk with one skip, input CIN rows, width W, packed as
// gemm_common.cuh::trunk_offsets lays it out, the embedding products taking
// the first K of their CIN rows; returns the element offset past it.
inline long long add_trunk(Plan& p, int D, int skip, int CIN, int W, int K) {
  long long o = 0;
  add_seg(p, o, CIN, W, K, W);
  o += (long long)CIN * W;
  for (int i = 1; i < D; ++i) {
    if (i == skip + 1) {
      add_seg(p, o, CIN, W, K, W);
      o += (long long)CIN * W;
    }
    add_seg(p, o, W, W, W, W);
    o += (long long)W * W;
  }
  return o;
}

// The image: one thread per 16 bytes. Atom a of a segment holds its k rows
// a*64 .. a*64+63 as n rows of 128 bytes (B k-major), the 16-byte chunk c of
// row j at chunk c ^ (j & 7): the 128-byte swizzle wgmma reads, which keys
// on shared-memory address bits, so every atom starts 1024-aligned.
__global__ void pack_kernel(const bf16* __restrict__ w, const __grid_constant__ Plan plan, uint4* __restrict__ img) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long byte = i * 16;
  if (byte >= plan.bytes) return;
  int si = 0;
  while (si + 1 < plan.count && plan.s[si + 1].dst <= byte) ++si;
  const Seg& s = plan.s[si];
  const long long off = byte - s.dst;
  const int abytes = s.n * 128;
  const int atom = (int)(off / abytes);
  const int rem = (int)(off - (long long)atom * abytes);
  const int j = rem >> 7;
  const int c = ((rem >> 4) & 7) ^ (j & 7);
  uint4 out;
  bf16* v = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = atom * 64 + c * 8 + e;
    v[e] = (k < s.k_src && j < s.n_src) ? w[s.src + (long long)k * s.n_src + j] : __float2bfloat16_rn(0.f);
  }
  img[i] = out;
}

inline cudaError_t pack(const void* w, const Plan& plan, void* img, cudaStream_t st) {
  const long long n16 = plan.bytes / 16;
  pack_kernel<<<(unsigned)((n16 + 255) / 256), 256, 0, st>>>(static_cast<const bf16*>(w), plan,
                                                                static_cast<uint4*>(img));
  return cudaGetLastError();
}

// Where the next launches of a library's tensor-core kernels record, per
// block, clock cycles (3 x blocks int64; null: not recorded): in the
// composite (its first composite thread, overlapped with the products), in
// the narrow heads and in all (warpgroup 1's first thread).
// Set through render_pass_profile / time_net_profile; chip_smoke.py reads
// B3's composite share and the heads' share from it.
long long* g_prof = nullptr;

// One thread per block keeps the counts in the (zeroed) buffer itself, so
// they hold no registers across the products: slot 2 starts at -clock64().
__device__ __forceinline__ void start_clock(long long* prof) { prof[3 * blockIdx.x + 2] = -clock64(); }
__device__ __forceinline__ void add_clock(long long* prof, int slot, long long since) {
  prof[3 * blockIdx.x + slot] += clock64() - since;
}

// One block per SM, at most as many as there are work units.
inline int grid_for(long long units) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)(units < sms ? units : sms);
}

// ---- PTX wrappers (sm_90a) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma operand descriptor: k-major, 128-byte swizzle, 8-row groups 1024
// bytes apart (SBO), the leading offset unused (1).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Waits for the phase of the given parity to complete. A wait of more than
// ~2^35 cycles (about 20 s) can only be a broken ring: it traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) t0 = clock64();
    else if ((spin & 1023) == 0 && clock64() - t0 > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Named barrier over the consumers: id 1 + w for warpgroup w alone, 3 for both.
__device__ __forceinline__ void wg_sync(int w) { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory"); }
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }

// Generic-proxy writes to a tile (the epilogue, the encode) before wgmma,
// which reads through the async proxy, may read them; then the warpgroup's
// barrier.
__device__ __forceinline__ void publish(int w) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(w);
}

template <int R>
__device__ __forceinline__ void set_regs() {
  if constexpr (R > 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the points
// where the asynchronous products may write them.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] B[16 x N]: N/2 fp32 accumulators a thread, row
// 16 w + l/4 (+ 8 for i % 4 >= 2) and column 8 (i / 4) + 2 (l % 4) + i % 2
// for register i of lane l in warp w of the warpgroup.
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<256>(float* d, uint64_t da, uint64_t db) {
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
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}


// The same with d = A B: the first k-step of a layer. Its accumulators are
// outputs only, so the compiler holds no registers for them before it.
template <int N>
__device__ __forceinline__ void wgmma_zero(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_zero<256>(float* d, uint64_t da, uint64_t db) {
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
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]),
        "=f"(d[64]), "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]), "=f"(d[70]), "=f"(d[71]),
        "=f"(d[72]), "=f"(d[73]), "=f"(d[74]), "=f"(d[75]), "=f"(d[76]), "=f"(d[77]), "=f"(d[78]), "=f"(d[79]),
        "=f"(d[80]), "=f"(d[81]), "=f"(d[82]), "=f"(d[83]), "=f"(d[84]), "=f"(d[85]), "=f"(d[86]), "=f"(d[87]),
        "=f"(d[88]), "=f"(d[89]), "=f"(d[90]), "=f"(d[91]), "=f"(d[92]), "=f"(d[93]), "=f"(d[94]), "=f"(d[95]),
        "=f"(d[96]), "=f"(d[97]), "=f"(d[98]), "=f"(d[99]), "=f"(d[100]), "=f"(d[101]), "=f"(d[102]), "=f"(d[103]),
        "=f"(d[104]), "=f"(d[105]), "=f"(d[106]), "=f"(d[107]), "=f"(d[108]), "=f"(d[109]), "=f"(d[110]), "=f"(d[111]),
        "=f"(d[112]), "=f"(d[113]), "=f"(d[114]), "=f"(d[115]), "=f"(d[116]), "=f"(d[117]), "=f"(d[118]), "=f"(d[119]),
        "=f"(d[120]), "=f"(d[121]), "=f"(d[122]), "=f"(d[123]), "=f"(d[124]), "=f"(d[125]), "=f"(d[126]), "=f"(d[127])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_zero<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_zero<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_zero<8>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "l"(da), "l"(db), "r"(0));
}

// ---- the consumers' side of the ring ----

struct Ring {
  uint32_t base;    // shared address of slab 0
  uint64_t* full;   // [stages]: the slab landed
  uint64_t* empty;  // [stages]: every consumer warp is done with it
  int stages;
  int st, ph;       // the next slab and the parity of its fill
  int held;         // the slab the last committed products read (-1: none)
};

__device__ __forceinline__ void release(Ring& r) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[r.held]);
  r.held = -1;
}

// One slab of a segment: atoms a0 .. a0+nb-1 of A against the slab's B.
// ZERO: the layer's first k-step, which overwrites acc.
template <int N, bool ZERO>
__device__ __forceinline__ void mma_slab(float* acc, uint32_t a, int k, int a0, int nb, Ring& r) {
  mbar_wait(&r.full[r.st], r.ph);
  if constexpr (!ZERO) fence_acc<N / 2>(acc);
  wgmma_fence();
  const uint32_t b = r.base + r.st * STAGE_BYTES;
  int s0 = 0;
  if constexpr (ZERO) {
    wgmma_zero<N>(acc, desc(a + a0 * ATOM_BYTES), desc(b));
    s0 = 1;
  }
  for (int j = 0; j < nb; ++j) {
    const int ks = min(4, (k - (a0 + j) * 64) / 16);
    for (int s = j == 0 ? s0 : 0; s < ks; ++s)
      wgmma<N>(acc, desc(a + (a0 + j) * ATOM_BYTES + s * 32), desc(b + j * N * 128 + s * 32));
  }
  wgmma_commit();
  if (r.held >= 0) {  // the previous slab's products have retired: hand it back
    wgmma_wait<1>();
    fence_acc<N / 2>(acc);
    release(r);
  }
  r.held = r.st;
  if (++r.st == r.stages) {
    r.st = 0;
    r.ph ^= 1;
  }
}

// acc (+)= A[64 x k] B[k x N] for one segment of the plan: A is the
// warpgroup's tile at a (k-major swizzled atoms), B comes through the ring.
// FIRST: the layer's first segment, which overwrites acc.
template <int N, bool FIRST>
__device__ __forceinline__ void mma(float* acc, uint32_t a, int k, Ring& r) {
  constexpr int APN = slab_atoms(N);
  const int na = atoms(k);
  mma_slab<N, FIRST>(acc, a, k, 0, min(APN, na), r);
  for (int a0 = APN; a0 < na; a0 += APN) mma_slab<N, false>(acc, a, k, a0, min(APN, na - a0), r);
}

// The end of a layer's products: all retired, the last slab handed back,
// and (a warpgroup barrier) no warp still reading the input tile, which the
// epilogue may overwrite.
template <int N>
__device__ __forceinline__ void mma_done(float* acc, Ring& r, int w) {
  wgmma_wait<0>();
  fence_acc<N / 2>(acc);
  release(r);
  wg_sync(w);
}

// ---- the producer ----

// Streams every segment of the plan, slab by slab, once per row chunk.
__device__ __forceinline__ void produce(const Plan& plan, const unsigned char* img, uint32_t ring, uint64_t* full,
                                        uint64_t* empty, int stages, int& st, int& ph) {
  for (int i = 0; i < plan.count; ++i) {
    const int n = plan.s[i].n, na = atoms(plan.s[i].k), apn = slab_atoms(n);
    const unsigned char* src = img + plan.s[i].dst;
    for (int a0 = 0; a0 < na; a0 += apn) {
      const uint32_t bytes = (uint32_t)(min(apn, na - a0) * n * 128);
      mbar_wait(&empty[st], ph ^ 1);
      mbar_expect_tx(&full[st], bytes);
      bulk_load(ring + st * STAGE_BYTES, src + (size_t)a0 * n * 128, bytes, &full[st]);
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    }
  }
}

// The block's shared memory, 1024-aligned: the ring, then the tiles.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Barriers at bars: full[0..stages), empty[0..stages).
__device__ __forceinline__ void init_ring(uint64_t* bars, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars[s], 1);
      mbar_init(&bars[stages + s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---- tiles: 64 rows x (atoms x 64) bf16 columns, swizzled k-major ----

__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 6) * ATOM_BYTES + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// Writes q(v) at (r, c) and returns it.
__device__ __forceinline__ bf16 put(unsigned char* tile, int r, int c, float v) {
  const bf16 q = __float2bfloat16_rn(v);
  *reinterpret_cast<bf16*>(tile + tile_off(r, c)) = q;
  return q;
}

// ELU in the tensor-core epilogue (B4's forward), branch-free: expm1 from
// ex2.approx (__expf(z) - 1) for z < -1/2, where the result's magnitude
// keeps the subtraction to ~3e-7 relative, and the degree-7 Taylor
// polynomial of expm1 by Horner's rule on [-1/2, 0] (remainder below 1e-7
// absolute), both computed and one selected. Within ~3e-7 relative of
// expm1f, so the bf16 it rounds to is expm1f's but for the ~1e-5 of values
// that sit that close to a rounding boundary. expm1f (or this form with
// branches) made the epilogue, which unrolls one per output of every layer
// in the consumers' critical path between two layers' products, most of
// B4's time on the H100 (PERF.md §6). tc_model.elu_tc is its twin.
__device__ __forceinline__ float elu_tc(float z) {
  const float e = __expf(z) - 1.f;
  float p = fmaf(z, 1.f / 5040.f, 1.f / 720.f);
  p = fmaf(z, p, 1.f / 120.f);
  p = fmaf(z, p, 1.f / 24.f);
  p = fmaf(z, p, 1.f / 6.f);
  p = fmaf(z, p, 0.5f);
  p = fmaf(z, p, 1.f);
  const float n = z < -0.5f ? e : z * p;
  return z > 0.f ? z : n;
}

template <Act A>
__device__ __forceinline__ float epi_act(float z) {
  return A == Act::Elu ? elu_tc(z) : act<A>(z);
}

// The epilogue of an N-wide layer: tile[r][c] = q(act(acc + bias[c])), in
// place, for the warpgroup's 64 rows (tid: the thread in the warpgroup);
// ELU as elu_tc.
// With g, the rounded values of rows < nvalid also go to the row-major
// g[row0 + r][c] (ld columns), and with ones a 1 to column N.
template <int N, Act ACT>
__device__ __forceinline__ void epilogue(const float* acc, const float* __restrict__ bias, unsigned char* tile, int tid,
                                         bf16* __restrict__ g, int ld, long long row0, int nvalid, bool ones) {
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = j * 8 + 2 * (lane & 3);
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const __nv_bfloat162 v = __floats2bfloat162_rn(epi_act<ACT>(acc[4 * j + 2 * h] + b.x),
                                                     epi_act<ACT>(acc[4 * j + 2 * h + 1] + b.y));
      *reinterpret_cast<__nv_bfloat162*>(tile + tile_off(r, c)) = v;
      if (g != nullptr && r < nvalid) {
        *reinterpret_cast<__nv_bfloat162*>(g + (row0 + r) * ld + c) = v;
        if (ones && j == 0 && (lane & 3) == 0) g[(row0 + r) * ld + N] = __float2bfloat16_rn(1.f);
      }
    }
  }
}

}  // namespace tc
}  // namespace
