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

#include "hopper.cuh"

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

template <int DC>
__host__ __device__ constexpr int stages() { return DC == 4 ? 2 : 3; }

template <int DC>
constexpr size_t smem_bytes() {
  return 1024 + DC * kQChunk + stages<DC>() * 2 * DC * kKVChunk +
         (1 + 2 * stages<DC>()) * sizeof(uint64_t);
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
