// Kernel 8 for bf16 inputs on Hopper (sm_90a), plain C interface: the Mamba2
// SSD (state-space duality) chunked scan of the SSM prefill, as three
// chunk-parallel passes on the tensor cores (wgmma) fed by TMA.
//
// Replaces the TPU kernel ssd_scan_pallas (repro/kernels/ssd_scan.py,
// pallas_call at :104), which the port's ssm_block runs once per layer.
// Layouts are the reference's: x (B, L, H, P) bf16, dt (B, L, H) f32, a (H,)
// f32 and negative, bm and cm (B, L, N) bf16 and shared by all heads
// (n_groups = 1), an optional initial state (B, H, P, N) f32 (zeros when
// null); out y (B, L, H, P) f32 and the final state (B, H, P, N) f32.  f32
// inputs take the CUDA-core kernel of ssd_scan.cu.
//
// The TPU kernel walks the chunks of one (b, h) in order and carries the
// (P, N) state in VMEM.  Here the same function is split as the reference's
// jnp formulation splits it (models/ssm.py::ssd_chunked), with cum the
// inclusive prefix sum of dt * a inside a chunk of Q steps:
//   pass 1, chunk states, grid (chunk, head, batch):
//     S^c = x^T (B ⊙ w),  w_j = e^(cum_Q - cum_j) dt_j          (P x N)
//     on wgmma with M = P, N = the state width, depth Q; it also writes cum
//     and dt of the chunk, contiguous per (b, h), for the other passes;
//   pass 2, state passing, f32 elementwise, chunks in order:
//     s_in^c = s;  s <- s e^(cum_Q) + S^c
//     from the initial state (or zeros); it writes s_in^c as the bf16 pair
//     hi/lo that pass 3 reads (the bytes of f32) and the final state;
//   pass 3, chunk outputs, grid (chunk x row tile of 64, head, batch):
//     y_i = e^(cum_i) (C s_in^T)_i + sum_{j <= i} (C B^T)_ij e^(cum_i -
//     cum_j) dt_j x_j
//     on wgmma: C s_in^T and C B^T with C, B and s_in K-major in shared
//     memory (bf16 products are exact in f32), the masked and scaled logit
//     tile in registers times x (MN-major), as kernel 7's Q K^T and P V.
//     The row scale e^(cum_i) applies after the product, so C stays exact.
//     Key tiles past a row tile's diagonal are never loaded: the causal
//     skip is the loop bound.
//
// The chunk.  The function does not depend on it, so the kernel takes its
// own: kChunk = 256 steps.  A smaller chunk halves pass 3's quadratic work
// but doubles the intermediate states (B * H * L / Q * P * N f32, written
// by pass 1 and read by pass 2, and again as s_in): at the serving shape
// (B, L, H, P, N) = (1, 3072, 64, 64, 128) they are 25 MB each at Q = 256,
// which stays in the 50 MB L2 between the passes; at Q = 128 they would be
// 50 MB each, and the whole scan measured slower (tools/ssd_scan_ablation.py
// times both).
//
// f32 accuracy.  Three operands are f32 and not bf16: x ⊙ w in pass 1, the
// masked scores and s_in in pass 3.  Each enters the tensor cores as hi +
// lo, hi = bf16(v) and lo = bf16(v - hi), in its own wgmma (hopper.cuh's
// split), so each term keeps ~16 bits and the sums are f32.  Every exponent
// is <= 0 (dt >= 0, a < 0): e^cum, e^(cum_Q - cum_j) and e^(cum_i - cum_j)
// with j <= i; the kernel never forms e^(-cum), so an underflow to 0 is the
// true value.  Steps past L read as zeros (TMA's zero fill) with dt = 0,
// which leaves the state as it is: any L is taken unpadded.
//
// Widths: P and N multiples of 8 (TMA's rows are whole 16-byte vectors), P
// <= 64 (one warpgroup's 64 rows in pass 1, one 64-column box of x in pass
// 3), N <= 256 (NC = 1..4 boxes of 64 columns); TMA zero-fills the rest of
// the boxes.  The wrapper (repro_torch/kernels/ssd_scan.py) pads other
// widths with zeros and refuses wider ones.
//
// Bound on an H100: bytes.  x, bm, cm in bf16, dt, a, y and the final state
// in f32: 79.95 MB at the serving shape, 0.02387 ms at 3.35 TB/s; the 4 * P
// * N flops per (step, head) of the increment and the read-out are 6.44
// GFLOP, 0.0065 ms at 989 TFLOP/s.  The passes add the intermediate states
// (L2 traffic), the hi/lo split doubles the products of pass 1 and pass 3's
// x and s_in products, and pass 3 recomputes C B^T for every head (bm and
// cm are shared by all heads; reading it back once a chunk measured
// slower) and spends the quadratic Q-wide logits.
//
// The build passes -fmad=false: every multiply and add outside the tensor
// cores is separately rounded, as the twin rounds them.  A wait on an
// mbarrier that has not completed after kWatchdogCycles traps, so a fault
// shows as a launch error instead of a hung card.
//
// The entry point launches its three passes on the caller's stream,
// allocates nothing (the wrapper passes the intermediate states as `work`,
// ssd_scan_bf16_work_bytes of them) and returns cudaGetLastError() (or
// cudaErrorInvalidValue for what it does not take), so the wrapper can
// raise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 256;                   // Q: steps per chunk
constexpr int kTile = 64;                     // steps per sub-tile / key tile
constexpr int kSlots1 = 2;                    // pass 1's ring of sub-tiles
constexpr int kThreads1 = 128;
constexpr int kThreads2 = 256;
constexpr int kThreads3 = 128;
constexpr uint32_t kBox = kTile * 128;        // a 64 x 64 bf16 box, bytes
constexpr int kMaxP = 64;
constexpr int kMaxN = 256;
static_assert(kChunk % kTile == 0 && kChunk % 32 == 0, "chunk tiling");

// Shared memory holds no 1024-byte slack: a block's dynamic shared memory
// starts 1024-aligned on sm_90 when it has no static shared memory, as the
// 128-byte swizzle needs; each kernel checks it and traps otherwise.
template <int NC>
constexpr size_t smem1_bytes() {
  return kSlots1 * (1 + NC) * kBox + 2 * kChunk * sizeof(float) +
         kSlots1 * sizeof(uint64_t);
}

template <int NC>
constexpr size_t smem3_bytes() {
  return (4 * NC + 1) * kBox + 2 * kChunk * sizeof(float) +
         3 * sizeof(uint64_t);
}

// element (row, col) of a 64-column bf16 box that TMA wrote with the
// 128-byte swizzle: 16-byte chunk col / 8 of the row's 128 bytes, XOR row % 8
__device__ __forceinline__ float box_at(const uint8_t* box, int row, int col) {
  const int off = row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(box + off));
}

// ---------------------------------------------------------------------------
// pass 1: chunk states.  Grid (chunk, head, batch), one warpgroup; thread 0
// puts the chunk's x and B into shared memory with TMA, 64 steps at a time
// through a ring of kSlots1 sub-tiles (small enough for three blocks an
// SM), while warp 0 takes cum.  S^c (P x N, f32) += (x ⊙ w)^T_hi B + (x ⊙
// w)^T_lo B per 16 steps, with the A fragments built in registers from the
// swizzled x box.
// ---------------------------------------------------------------------------

template <int NC>
__global__ void __launch_bounds__(kThreads1, NC <= 2 ? 3 : 1)
    ssd_chunk_states_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_b, const float* __restrict__ dt,
    const float* __restrict__ a, float* __restrict__ states,
    float* __restrict__ cum_out, float* __restrict__ dt_out, int L, int H,
    int P, int N) {
  extern __shared__ uint8_t smem_raw[];
  if (smem_u32(smem_raw) & 1023) __trap();
  uint8_t* s_t = smem_raw;  // per slot: a box of x, NC of B
  float* s_cum = reinterpret_cast<float*>(s_t + kSlots1 * (1 + NC) * kBox);
  float* s_w = s_cum + kChunk;                   // dt, then w
  uint64_t* full = reinterpret_cast<uint64_t*>(s_w + kChunk);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int t0 = c * kChunk;
  const int len = min(kChunk, L - t0);
  const int tiles = (len + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // sub-tile s (steps 64 s..) into its slot: x, then B
  auto load = [&](int s) {
    uint64_t* bar = &full[s % kSlots1];
    uint8_t* dst = s_t + (s % kSlots1) * (1 + NC) * kBox;
    mbar_expect_tx(bar, (1 + NC) * kBox);
    tma_load_4d(dst, &map_x, bar, 0, h, t0 + s * kTile, b);
    for (int k = 0; k < NC; ++k)
      tma_load_3d(dst + (1 + k) * kBox, &map_b, bar, 64 * k, t0 + s * kTile,
                  b);
  };
  if (tid == 0) {
    for (int s = 0; s < kSlots1; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < min(kSlots1, tiles); ++s) load(s);
  }
  if (warp == 0) {
    // cum: each lane sums its kChunk / 32 steps in order, then the lanes'
    // totals are scanned across the warp
    constexpr int kPer = kChunk / 32;
    const float ah = a[h];
    float run = 0.f, part[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = kPer * lane + k;
      const float d =
          i < len ? dt[(static_cast<size_t>(b) * L + t0 + i) * H + h] : 0.f;
      run += d * ah;
      part[k] = run;
      s_w[i] = d;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.f;
    const size_t base = (static_cast<size_t>(b) * H + h) * nc * kChunk + t0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = kPer * lane + k;
      const float cv = before + part[k];
      s_cum[i] = cv;
      cum_out[base + i] = cv;
      dt_out[base + i] = s_w[i];
    }
  }
  __syncthreads();
  const float cum_last = s_cum[kChunk - 1];
  for (int i = tid; i < kChunk; i += kThreads1)
    s_w[i] = expf(cum_last - s_cum[i]) * s_w[i];
  __syncthreads();

  const int g = lane / 4, t = lane % 4;
  const int p0 = 16 * warp + g;  // the thread's rows p0 and p0 + 8
  float acc[32 * NC];
#pragma unroll
  for (int i = 0; i < 32 * NC; ++i) acc[i] = 0.f;
  for (int s = 0; s < tiles; ++s) {
    mbar_wait(&full[s % kSlots1], (s / kSlots1) & 1);
    const uint8_t* xt = s_t + (s % kSlots1) * (1 + NC) * kBox;
    const float* w = s_w + s * kTile;
    // v[i] is row p0 + 8 * ((i >> 1) & 1), step 8 * (i >> 2) + 2 t + (i & 1)
    // of (x ⊙ w)^T: the layout split() turns into the A fragments of the
    // sub-tile's 64 steps
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = 8 * (i >> 2) + 2 * t + (i & 1);
      v[i] = box_at(xt, j, p0 + 8 * ((i >> 1) & 1)) * w[j];
    }
    uint32_t hi[16], lo[16];
    split(v, hi, lo);
    wgmma_fence();
    const uint32_t b_addr = smem_u32(xt + kBox);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<NC>(acc, hi + 4 * kk, sw128_desc(b_addr + 2048 * kk, kBox));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<NC>(acc, lo + 4 * kk, sw128_desc(b_addr + 2048 * kk, kBox));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<0>();
    fence_regs(acc);
    if (s + kSlots1 < tiles) {
      __syncthreads();  // every warp is done with the slot
      if (tid == 0) load(s + kSlots1);
    }
  }

  // acc[i] is row p0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2 t + (i & 1)
  float* st = states + ((static_cast<size_t>(b) * H + h) * nc + c) * P * N;
#pragma unroll
  for (int i = 0; i < 32 * NC; i += 2) {
    const int p = p0 + 8 * ((i >> 1) & 1);
    const int n = 8 * (i >> 2) + 2 * t;
    if (p < P && n < N)
      *reinterpret_cast<float2*>(st + p * N + n) = make_float2(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// pass 2: state passing.  Grid (P N / 4 / kThreads2, head, batch); a thread
// walks 4 neighbouring state elements through the chunks in order.
// ---------------------------------------------------------------------------

// the hi/lo split of two neighbouring values, as split() makes it
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h2);
  hi = pack_bf16(h2);
  lo = pack_bf16(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__global__ void __launch_bounds__(kThreads2) ssd_state_passing_kernel(
    const float* __restrict__ states, const float* __restrict__ cum,
    const float* __restrict__ init_state, __nv_bfloat16* __restrict__ s_in,
    float* __restrict__ final_state, int H, int PN, int nc) {
  const int i = 4 * (blockIdx.x * kThreads2 + threadIdx.x);
  if (i >= PN) return;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  float4 s = init_state != nullptr
                 ? *reinterpret_cast<const float4*>(init_state + bh * PN + i)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    __nv_bfloat16* dst = s_in + (bh * nc + c) * 2 * PN + i;  // hi, then lo
    uint2 hi, lo;
    split2(s.x, s.y, hi.x, lo.x);
    split2(s.z, s.w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(dst) = hi;
    *reinterpret_cast<uint2*>(dst + PN) = lo;
    const float decay = expf(cum[(bh * nc + c) * kChunk + kChunk - 1]);
    const float4 inc =
        *reinterpret_cast<const float4*>(states + (bh * nc + c) * PN + i);
    s.x = s.x * decay + inc.x;
    s.y = s.y * decay + inc.y;
    s.z = s.z * decay + inc.z;
    s.w = s.w * decay + inc.w;
  }
  *reinterpret_cast<float4*>(final_state + bh * PN + i) = s;
}

// ---------------------------------------------------------------------------
// pass 3: chunk outputs.  Grid (chunk x row tile, head, batch); a block is
// one warpgroup and owns 64 rows of one chunk, three blocks an SM (75 KB
// of shared memory each at N <= 128: a key tile in flight at a time, the
// SM's other blocks hide its loads).  Thread 0 puts C's rows, s_in (hi,
// lo) and key tile 0 in flight before the block reads cum, then loads key
// tile j + 1's B as soon as C B^T of tile j is in and its x once tile j's
// product with x is done.  Row tiles with the most key tiles start first.
// ---------------------------------------------------------------------------

template <int NC>
__global__ void __launch_bounds__(kThreads3, 3) ssd_chunk_outputs_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_b,
    const __grid_constant__ CUtensorMap map_c,
    const __grid_constant__ CUtensorMap map_s, const float* __restrict__ cum,
    const float* __restrict__ dts, float* __restrict__ y, int L, int H,
    int P) {
  extern __shared__ uint8_t smem_raw[];
  if (smem_u32(smem_raw) & 1023) __trap();
  uint8_t* s_c = smem_raw;             // NC boxes of the 64 rows
  uint8_t* s_s = s_c + NC * kBox;      // NC boxes hi, NC lo
  uint8_t* s_b = s_s + 2 * NC * kBox;  // the key tile's B, NC boxes
  uint8_t* s_x = s_b + NC * kBox;      // and its x
  float* s_cum = reinterpret_cast<float*>(s_x + kBox);
  float* s_u = s_cum + kChunk;
  uint64_t* head_full = reinterpret_cast<uint64_t*>(s_u + kChunk);
  uint64_t* b_full = head_full + 1;
  uint64_t* x_full = b_full + 1;

  constexpr int kTilesPerChunk = kChunk / kTile;
  const int c = blockIdx.x / kTilesPerChunk;
  const int rt = kTilesPerChunk - 1 - blockIdx.x % kTilesPerChunk;
  const int i0 = rt * kTile;  // the block's first row in the chunk
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (L + kChunk - 1) / kChunk;
  const int t0 = c * kChunk;
  const int len = min(kChunk, L - t0);
  if (i0 >= len) return;  // rows past L
  const int rows = min(kTile, len - i0);
  const int n_tiles = rt + 1;  // key tiles 0..rt; tile rt holds the diagonal
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t bhc = (static_cast<size_t>(b) * H + h) * nc + c;

  auto load_b = [&](int j) {
    mbar_expect_tx(b_full, NC * kBox);
    for (int k = 0; k < NC; ++k)
      tma_load_3d(s_b + k * kBox, &map_b, b_full, 64 * k, t0 + j * kTile, b);
  };
  auto load_x = [&](int j) {
    mbar_expect_tx(x_full, kBox);
    tma_load_4d(s_x, &map_x, x_full, 0, h, t0 + j * kTile, b);
  };
  if (tid == 0) {
    for (int s = 0; s < 3; ++s) mbar_init(&head_full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(head_full, 3 * NC * kBox);
    for (int k = 0; k < NC; ++k) {
      tma_load_3d(s_c + k * kBox, &map_c, head_full, 64 * k, t0 + i0, b);
      tma_load_3d(s_s + k * kBox, &map_s, head_full, 64 * k, 0,
                  static_cast<int>(2 * bhc));
      tma_load_3d(s_s + (NC + k) * kBox, &map_s, head_full, 64 * k, 0,
                  static_cast<int>(2 * bhc + 1));
    }
    load_b(0);
    load_x(0);
  }
  // cum, and u_j: for the key tiles below the diagonal tile the column
  // factor e^(cum_e - cum_j) dt_j, e the last step of j's tile; for the
  // diagonal tile dt_j
  for (int i = tid; i < kChunk; i += kThreads3) {
    const float* cb = cum + bhc * kChunk;
    const float d = dts[bhc * kChunk + i];
    s_cum[i] = cb[i];
    s_u[i] = i / kTile == rt ? d : expf(cb[(i | (kTile - 1))] - cb[i]) * d;
  }
  __syncthreads();

  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // the thread's rows
  const int row0 = i0 + r0, row1 = i0 + r1;   // the same, in the chunk
  const uint32_t c_addr = smem_u32(s_c), s_addr = smem_u32(s_s);
  const uint32_t b_addr = smem_u32(s_b), x_addr = smem_u32(s_x);

  // the state's part: C s_in^T with s_in = hi + lo, then the rows'
  // e^(cum_i)
  float acc[32];
  mbar_wait(head_full, 0);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, sw128_desc(c_addr + k * kBox + 32 * kk),
               sw128_desc(s_addr + k * kBox + 32 * kk), k + kk > 0);
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, sw128_desc(c_addr + k * kBox + 32 * kk),
               sw128_desc(s_addr + (NC + k) * kBox + 32 * kk), 1);
  wgmma_commit();
  fence_regs(acc);
  wgmma_wait<0>();
  fence_regs(acc);
  const float e0 = expf(s_cum[row0]), e1 = expf(s_cum[row1]);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? e1 : e0;

  // the chunk's part, one key tile at a time
  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(b_full, j & 1);
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, sw128_desc(c_addr + k * kBox + 32 * kk),
                 sw128_desc(b_addr + k * kBox + 32 * kk), k + kk > 0);
    wgmma_commit();
    fence_regs(s);
    wgmma_wait<0>();
    fence_regs(s);
    if (tid == 0 && j + 1 < n_tiles) load_b(j + 1);  // B is free
    // s[i] is row (i & 2 ? row1 : row0), key 64 j + 8 (i >> 2) + 2 t + (i
    // & 1): (C B^T) e^(cum_i - cum_j) dt_j for j <= i, else 0.  Below the
    // diagonal tile every key precedes every row, and e^(cum_i - cum_j) =
    // e^(cum_i - cum_e) e^(cum_e - cum_j) with e the tile's last key: both
    // exponents <= 0, one exp a row and the column factor u_j
    if (j == rt) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? row1 : row0;
        const int col = j * kTile + 8 * (i >> 2) + 2 * t + (i & 1);
        s[i] = col <= row ? s[i] * expf(s_cum[row] - s_cum[col]) * s_u[col]
                          : 0.f;
      }
    } else {
      const float ce = s_cum[j * kTile + kTile - 1];
      const float v0 = expf(s_cum[row0] - ce), v1 = expf(s_cum[row1] - ce);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = j * kTile + 8 * (i >> 2) + 2 * t + (i & 1);
        s[i] = s[i] * ((i & 2) ? v1 : v0) * s_u[col];
      }
    }
    uint32_t hi[16], lo[16];
    split(s, hi, lo);
    mbar_wait(x_full, j & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<1>(acc, hi + 4 * kk, sw128_desc(x_addr + 2048 * kk, kBox));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<1>(acc, lo + 4 * kk, sw128_desc(x_addr + 2048 * kk, kBox));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    if (tid == 0 && j + 1 < n_tiles) load_x(j + 1);  // x is free
  }

  // epilogue: rows < rows, columns < P.  acc[i] is row (i & 2 ? r1 : r0),
  // column 8 (i >> 2) + 2 t + (i & 1).
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i & 2) ? r1 : r0;
    const int p = 8 * (i >> 2) + 2 * t;
    if (r >= rows || p >= P) continue;
    float* yr = y + ((static_cast<size_t>(b) * L + t0 + i0 + r) * H + h) * P;
    *reinterpret_cast<float2*>(yr + p) = make_float2(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

size_t work_bytes(int B, int L, int H, int P, int N) {
  const size_t bhc = static_cast<size_t>(B) * H * ((L + kChunk - 1) / kChunk);
  // states f32, s_in bf16 hi and lo, cum and dt f32
  return bhc * (2 * sizeof(float) * P * N + 2 * sizeof(float) * kChunk);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // the next launch starts clean
  return err;
}

template <int NC>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* init_state, float* y,
           float* final_state, void* work, int B, int L, int H, int P, int N,
           cudaStream_t stream) {
  const int nc = (L + kChunk - 1) / kChunk;
  const size_t bhc = static_cast<size_t>(B) * H * nc;
  float* states = static_cast<float*>(work);
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(states + bhc * P * N);
  float* cum = reinterpret_cast<float*>(s_in + bhc * 2 * P * N);
  float* dts = cum + bhc * kChunk;

  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u64 xd[4] = {u64(P), u64(H), u64(L), u64(B)};
  const u64 xs[3] = {u64(P), u64(H) * P, u64(L) * H * P};
  const u32 xb[4] = {64, 1, kTile, 1};
  const u64 bd[3] = {u64(N), u64(L), u64(B)};
  const u64 bs[2] = {u64(N), u64(L) * N};
  const u32 bb[3] = {64, kTile, 1};
  const u64 sd[3] = {u64(N), u64(P), 2 * bhc};
  const u64 ss[2] = {u64(N), u64(P) * N};
  const u32 sb[3] = {64, 64, 1};
  CUtensorMap mx, mb, mc, ms;
  if (!make_map(&mx, x, 4, xd, xs, xb) || !make_map(&mb, bm, 3, bd, bs, bb) ||
      !make_map(&mc, cm, 3, bd, bs, bb) ||
      !make_map(&ms, s_in, 3, sd, ss, sb))
    return cudaErrorInvalidValue;

  auto pass1 = ssd_chunk_states_kernel<NC>;
  auto pass3 = ssd_chunk_outputs_kernel<NC>;
  cudaError_t err = allow_smem(pass1, smem1_bytes<NC>());
  if (err == cudaSuccess) err = allow_smem(pass3, smem3_bytes<NC>());
  if (err != cudaSuccess) return err;

  pass1<<<dim3(nc, H, B), kThreads1, smem1_bytes<NC>(), stream>>>(
      mx, mb, dt, a, states, cum, dts, L, H, P, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int pn = P * N;
  ssd_state_passing_kernel<<<dim3((pn / 4 + kThreads2 - 1) / kThreads2, H, B),
                             kThreads2, 0, stream>>>(
      states, cum, init_state, s_in, final_state, H, pn, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pass3<<<dim3(nc * (kChunk / kTile), H, B), kThreads3, smem3_bytes<NC>(),
          stream>>>(mx, mb, mc, ms, cum, dts, y, L, H, P);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the intermediate states that ssd_scan_bf16 takes as `work` (16-
// byte aligned) for these shapes.
extern "C" long long ssd_scan_bf16_work_bytes(int B, int L, int H, int P,
                                              int N) {
  return static_cast<long long>(work_bytes(B, L, H, P, N));
}

// x, bm, cm bf16 and dt, a, init_state (or null), y, final_state f32, all
// contiguous (the wrapper, repro_torch/kernels/ssd_scan.py, checks them and
// pads P and N); P and N multiples of 8, P <= 64, N <= 256.
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a,
                             const void* bm, const void* cm,
                             const void* init_state, void* y,
                             void* final_state, void* work, int B, int L,
                             int H, int P, int N, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 8 || P > kMaxP || P % 8 != 0 || N < 8 ||
      N > kMaxN || N % 8 != 0 || work == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(a);
  const float* f_init = static_cast<const float*>(init_state);
  float* f_y = static_cast<float*>(y);
  float* f_final = static_cast<float*>(final_state);
  switch ((N + 63) / 64) {
    case 1: return launch<1>(x, f_dt, f_a, bm, cm, f_init, f_y, f_final, work,
                             B, L, H, P, N, s);
    case 2: return launch<2>(x, f_dt, f_a, bm, cm, f_init, f_y, f_final, work,
                             B, L, H, P, N, s);
    case 3: return launch<3>(x, f_dt, f_a, bm, cm, f_init, f_y, f_final, work,
                             B, L, H, P, N, s);
    default: return launch<4>(x, f_dt, f_a, bm, cm, f_init, f_y, f_final,
                              work, B, L, H, P, N, s);
  }
}
