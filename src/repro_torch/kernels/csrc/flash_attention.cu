// Kernel 7 for bf16 inputs on Hopper (sm_90a), plain C interface: causal
// GQA flash-attention forward (the prefill) on the tensor cores, with TMA
// copies and a producer warp feeding two consumer warpgroups.
//
// Replaces the TPU kernel flash_attention_pallas
// (repro/kernels/flash_attention.py, pallas_call at :119), which the port's
// prefill runs once per layer.  Layouts are the reference's: q and out
// (B, S, H, D), k and v (B, S, Hkv, D), bf16; query head h*G + g belongs to
// kv head h.  f32 inputs take the CUDA-core kernel of attention.cu.
//
// Bound on an H100: operations.  The causal products are 4*B*H*D*S(S+1)/2
// flops: 48.33 GFLOP at the serving shape (B, S, H, Hkv, D) = (1, 3072, 20,
// 20, 128), 0.049 ms at the 989 TFLOP/s of the bf16 tensor cores, against
// 47 MB of q, k, v and out (0.014 ms at 3.35 TB/s).  Design:
//   - Rows.  A block owns 128 query rows of one (b, kv head): TQ = 128 / G
//     positions times the G heads of the group, so the group shares every
//     K/V tile, as the TPU kernel flattens TQ*G rows.  Row r is position
//     q0 + r / G, head h*G + r % G.  Each of two consumer warpgroups owns
//     64 rows; one warp of a third warpgroup is the producer (its other
//     three warps leave at once).  Blocks with the most keys start first.
//   - Copies.  The producer's TMA loads put Q (once) and a ring of 64-key
//     K/V tiles into shared memory in 64-column boxes with the 128-byte
//     swizzle that wgmma reads; a full and an empty mbarrier per stage
//     hand tiles over.  TMA's zero fill covers the ragged last tile of S
//     and the columns past D, so nothing is padded in device memory for
//     any D that is a multiple of 8.  Tiles past a block's last row are
//     never loaded: the causal skip is the loop bound.
//   - S = Q K^T on wgmma m64n64k16 (bf16 operands from shared memory, f32
//     accumulation; bf16 products are exact in f32), then times the f32
//     1/sqrt(D).  Only tiles that cross a warpgroup's diagonal mask
//     elements, with the TPU kernel's finite -1e30.
//   - The online softmax runs in registers: a row's values sit on the 4
//     threads of a quad, so its max and sum take two shuffles each.  expf,
//     the running max and sum and the max(l, 1e-30) clamp are the TPU
//     kernel's.
//   - O += P V on wgmma m64n(64*DC)k16 with P in registers and V
//     (MN-major) in shared memory.  The probabilities keep f32 accuracy:
//     p = hi + lo with hi = bf16(p) and lo = bf16(p - hi), each multiplied
//     by V in its own wgmma, so P V costs twice the minimum and the whole
//     kernel 1.5x.
//   - Overlap within a warpgroup: tile j's Q K^T and tile j-1's P V are
//     issued together; the softmax of tile j runs once Q K^T is in, while
//     P V still runs on the tensor cores.
//   - Registers: the block starts at 168 a thread (384 threads); setmaxnreg
//     gives the producer's warpgroup 40 and each consumer thread 232,
//     64,512 in all as at the start.  A consumer holds a 64 x 64*DC f32
//     accumulator, the 64 x 64 logit tile and the hi/lo fragments.  ptxas
//     still fits the consumers' code into the 168 it starts with, so DC =
//     3 and 4 (D > 128) spill and serialize their wgmma; no config has
//     such a head.
//   - Epilogue: divide by l, round once to bf16, store rows r < rows and
//     columns < D.
// Every block reads K and V up to its diagonal from L2: 393 MB at the
// serving shape, ~75 us of the time alone on an H100 (PERF.md); sharing
// tiles between blocks (a cluster's TMA multicast) is later work.
//
// The build passes -fmad=false: every multiply and add here is separately
// rounded, as the twin rounds them.  A wait on an mbarrier that has not
// completed after kWatchdogCycles traps, so a fault shows as a launch
// error instead of a hung card.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or cudaErrorInvalidValue for what it does
// not take), so the wrapper can raise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kRows = 64 * kConsumers;         // query rows per block
constexpr int kTK = 64;                        // keys per K/V tile
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's group
constexpr int kMaxGroup = 64;                  // query heads per kv head
constexpr uint32_t kQChunk = kRows * 128;      // bytes of a 64-column box
constexpr uint32_t kKVChunk = kTK * 128;
constexpr float kNegInf = -1.0e30f;
constexpr float kMinDenom = 1e-30f;
constexpr long long kWatchdogCycles = 1ll << 34;  // ~10 s

template <int DC>
__host__ __device__ constexpr int stages() { return DC == 4 ? 2 : 3; }

template <int DC>
constexpr size_t smem_bytes() {
  return 1024 + DC * kQChunk + stages<DC>() * 2 * DC * kKVChunk +
         (1 + 2 * stages<DC>()) * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > kWatchdogCycles) __trap();
  }
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled tile whose 8-row groups are 1024 bytes
// apart (the layout TMA writes for a box 64 bf16 wide): K-major for Q and
// K; MN-major for V, whose 64-column boxes lie `lbo` bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr,
                                               uint32_t lbo = 16) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup's wgmma run
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of registers that an
// asynchronous wgmma reads or writes across the wait that ends it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 64, f32) = A (64 x 16, K-major in shared memory) * B (16 x 64,
// K-major in shared memory) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64*DC, f32) += A (64 x 16, bf16 fragments in registers) * B
// (16 x 64*DC, MN-major in shared memory)
template <int DC>
__device__ __forceinline__ void wgmma_pv(float (&d)[32 * DC],
                                         const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<1>(float (&d)[32], const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<2>(float (&d)[64], const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<3>(float (&d)[96], const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<4>(float (&d)[128], const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax of one thread's two rows (r0 and r0 + 8 of its
// warpgroup), in registers.  s[i] of a 64-key tile is row r0 + 8 * ((i >> 1)
// & 1), key k0 + 8 * (i >> 2) + 2 * quad + (i & 1); a row's 64 values sit
// on the 4 threads of a quad.
struct Softmax {
  int first, pos0, pos1, quad;  // the group's first position; the rows'
  float scale;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  __device__ Softmax(int first, int pos0, int pos1, int quad, float scale)
      : first(first), pos0(pos0), pos1(pos1), quad(quad), scale(scale) {}

  // turns tile j's logits into its probabilities in place (scaled, the
  // diagonal masked), moves the running max and sum, and gives the
  // factors c0, c1 that rescale the rows' output so far.  Masked logits
  // are -1e30, so their expf is exactly 0.
  __device__ __forceinline__ void tile(float (&s)[32], int j, float& c0,
                                       float& c1) {
    const int k0 = j * kTK;
    const bool diag = k0 + kTK - 1 > first;  // crosses some row's diagonal
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale;
      if (diag && k0 + 8 * (i >> 2) + 2 * quad + (i & 1) >
                      ((i & 2) ? pos1 : pos0))
        x = kNegInf;
      s[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float mn = (i & 2) ? mn1 : mn0;
      s[i] = expf(s[i] - mn);
      s[i + 1] = expf(s[i + 1] - mn);
      if (i & 2)
        sum1 += s[i] + s[i + 1];
      else
        sum0 += s[i] + s[i + 1];
    }
    c0 = expf(m0 - mn0);
    c1 = expf(m1 - mn1);
    l0 = l0 * c0 + quad_sum(sum0);
    l1 = l1 * c1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
  }
};

// Probabilities as the bf16 A fragments of P V: p = hi + lo with hi =
// bf16(p) and lo = bf16(p - hi).  Keys 16 kk.. of the tile are fragments
// 4 kk..4 kk + 3, pairs of neighbouring columns in one register.
__device__ __forceinline__ void split(const float (&p)[32], uint32_t (&hi)[16],
                                      uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(p[i], p[i + 1]);
    const float2 hf = __bfloat1622float2(h2);
    hi[i / 2] = pack_bf16(h2);
    lo[i / 2] = pack_bf16(__floats2bfloat162_rn(p[i] - hf.x, p[i + 1] - hf.y));
  }
}

// ---------------------------------------------------------------------------
// The kernel.  DC = 64-column boxes per row (D_pad = 64 * DC).  Grid (Hkv,
// B, query tiles); blockIdx.z = 0 is the last query tile.
// ---------------------------------------------------------------------------

template <int DC>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel_bf16(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
    int S, int H, int G, int TQ, int D, float scale) {
  constexpr int kStages = stages<DC>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* s_q = smem_raw + ((1024 - (raw & 1023)) & 1023);  // DC boxes
  uint8_t* s_kv = s_q + DC * kQChunk;  // per stage: DC boxes of K, DC of V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      s_kv + kStages * 2 * DC * kKVChunk);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TQ;
  const int tq = min(TQ, S - q0);
  const int rows = tq * G;
  const int n_tiles = (q0 + tq - 1) / kTK + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // ---- producer: one thread of the last warpgroup ------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumers * 4 && lane == 0) {
      mbar_expect_tx(q_full, DC * 128u * G * TQ);
      for (int c = 0; c < DC; ++c)
        tma_load_5d(s_q + c * kQChunk, &map_q, q_full, 64 * c, 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int stage = j % kStages;
        mbar_wait(&empty[stage], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[stage], 2u * DC * kKVChunk);
        uint8_t* kt = s_kv + stage * 2 * DC * kKVChunk;
        uint8_t* vt = kt + DC * kKVChunk;
        for (int c = 0; c < DC; ++c) {
          tma_load_4d(kt + c * kKVChunk, &map_k, &full[stage], 64 * c, h,
                      j * kTK, b);
          tma_load_4d(vt + c * kKVChunk, &map_v, &full[stage], 64 * c, h,
                      j * kTK, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4;
    const int r0 = 64 * wg + 16 * (warp % 4) + lane / 4;  // and r0 + 8
    const int r1 = r0 + 8;
    const int wg_rows = min(max(rows - 64 * wg, 0), 64);
    const int my_tiles =
        wg_rows > 0 ? (q0 + (64 * wg + wg_rows - 1) / G) / kTK + 1 : 0;
    Softmax sm(q0 + 64 * wg / G, q0 + r0 / G, q0 + r1 / G, lane % 4, scale);
    const uint32_t q_addr = smem_u32(s_q) + wg * 64 * 128;
    auto k_addr = [&](int j) {
      return smem_u32(s_kv + (j % kStages) * 2 * DC * kKVChunk);
    };
    // S = Q K^T of tile j, issued and committed as one group
    auto issue_qk = [&](float (&s)[32], int j) {
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, sw128_desc(q_addr + c * kQChunk + 32 * kk),
                   sw128_desc(k_addr(j) + c * kKVChunk + 32 * kk),
                   c + kk > 0);
      wgmma_commit();
      fence_regs(s);
    };
    // O += P_hi V + P_lo V of tile j, issued and committed as one group
    float o[32 * DC];
#pragma unroll
    for (int i = 0; i < 32 * DC; ++i) o[i] = 0.f;
    auto issue_pv = [&](const uint32_t (&hi)[16], const uint32_t (&lo)[16],
                        int j) {
      const uint32_t v_addr = k_addr(j) + DC * kKVChunk;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<DC>(o, hi + 4 * kk, sw128_desc(v_addr + 2048 * kk, kKVChunk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<DC>(o, lo + 4 * kk, sw128_desc(v_addr + 2048 * kk, kKVChunk));
      wgmma_commit();
      fence_regs(o);
    };
    auto rescale = [&](float c0, float c1) {
#pragma unroll
      for (int i = 0; i < 32 * DC; ++i) o[i] *= (i & 2) ? c1 : c0;
    };
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
    };

    mbar_wait(q_full, 0);
    if (my_tiles > 0) {
      // tile 0; then each tile's Q K^T and the tile before's P V run on the
      // tensor cores while the rows are rescaled and, once Q K^T is in,
      // while the softmax runs
      float c0, c1;
      uint32_t hi[16], lo[16];
      {
        float s[32];
        mbar_wait(&full[0], 0);
        issue_qk(s, 0);
        wgmma_wait<0>();
        fence_regs(s);
        sm.tile(s, 0, c0, c1);
        split(s, hi, lo);
      }
      for (int j = 1; j < my_tiles; ++j) {
        float s[32];
        mbar_wait(&full[j % kStages], (j / kStages) & 1);
        issue_qk(s, j);
        rescale(c0, c1);
        issue_pv(hi, lo, j - 1);
        wgmma_wait<1>();
        fence_regs(s);
        sm.tile(s, j, c0, c1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(hi);
        fence_regs(lo);
        release(j - 1);
        split(s, hi, lo);
      }
      rescale(c0, c1);
      issue_pv(hi, lo, my_tiles - 1);
      wgmma_wait<0>();
      fence_regs(o);
      release(my_tiles - 1);
    }
    for (int j = my_tiles; j < n_tiles; ++j) {  // tiles past this group's
      mbar_wait(&full[j % kStages], (j / kStages) & 1);  // rows
      release(j);
    }

    // epilogue: rows r < rows, columns < D (D is a multiple of 8).  o[i] is
    // row r0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 * quad + (i & 1).
    const float den0 = fmaxf(sm.l0, kMinDenom), den1 = fmaxf(sm.l1, kMinDenom);
#pragma unroll
    for (int i = 0; i < 32 * DC; i += 2) {
      const int r = (i & 2) ? r1 : r0;
      const int col = 8 * (i >> 2) + 2 * (lane % 4);
      if (r >= rows || col >= D) continue;
      const float den = (i & 2) ? den1 : den0;
      __nv_bfloat16* orow =
          out + ((static_cast<size_t>(b) * S + q0 + r / G) * H +
                 static_cast<size_t>(h) * G + r % G) *
                    D;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the build
// needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, strides in elements),
// read in boxes of `box`, 128-byte swizzled, zero-filled out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t bytes[4];
  for (int i = 0; i < rank - 1; ++i) bytes[i] = strides[i] * 2;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, bytes, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

float inv_sqrt(int d) {  // f32 of the double 1/sqrt(D), as the reference
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
}

template <int DC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, int D, int head_dim, cudaStream_t stream) {
  const int G = H / Hkv, TQ = kRows / G;
  const cuuint64_t qd[5] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(G),
                            static_cast<cuuint64_t>(Hkv),
                            static_cast<cuuint64_t>(S),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t qs[4] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(G) * D,
                            static_cast<cuuint64_t>(H) * D,
                            static_cast<cuuint64_t>(S) * H * D};
  const cuuint32_t qb[5] = {64, static_cast<cuuint32_t>(G), 1,
                            static_cast<cuuint32_t>(TQ), 1};
  const cuuint64_t kd[4] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(Hkv),
                            static_cast<cuuint64_t>(S),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t ks[3] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(Hkv) * D,
                            static_cast<cuuint64_t>(S) * Hkv * D};
  const cuuint32_t kb[4] = {64, 1, kTK, 1};
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, 5, qd, qs, qb) || !make_map(&mk, k, 4, kd, ks, kb) ||
      !make_map(&mv, v, 4, kd, ks, kb))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel_bf16<DC>;
  const size_t smem = smem_bytes<DC>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const int tiles = (S + TQ - 1) / TQ;
  kernel<<<dim3(Hkv, B, tiles), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), S, H, G, TQ, D,
      inv_sqrt(head_dim));
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out bf16 and contiguous, 16-byte aligned (the wrapper,
// repro_torch/kernels/flash_attention.py, checks them).  D is the stored
// head width, a multiple of 8 up to 256; head_dim <= D is the model's,
// which sets the 1/sqrt scale (the wrapper pads other widths with zeros).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int Hkv, int D, int head_dim,
                                    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || D < 8 || D > 256 ||
      D % 8 != 0 || head_dim < 1 || head_dim > D || B < 1 || S < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 63) / 64) {
    case 1: return launch<1>(q, k, v, out, B, S, H, Hkv, D, head_dim, s);
    case 2: return launch<2>(q, k, v, out, B, S, H, Hkv, D, head_dim, s);
    case 3: return launch<3>(q, k, v, out, B, S, H, Hkv, D, head_dim, s);
    default: return launch<4>(q, k, v, out, B, S, H, Hkv, D, head_dim, s);
  }
}
