// Kernel 6 for Hopper (sm_90a), plain C interface: one-token GQA decode
// attention over a length-masked KV cache, split over the cache's positions
// (split-S), with a ring of K/V tiles kept full by TMA and one launch per
// call.
//
// Replaces the TPU kernel decode_attention_pallas
// (repro/kernels/decode_attention.py, pallas_call at :90), which the port's
// decode step runs once per layer.  Layouts are the reference's: q (B, H, D),
// k and v (B, S, Hkv, D), length (B,) int32, out (B, H, D); query head
// h*G + g belongs to kv head h.  f32 and bf16; any head_dim D from 1 to 256.
//
// Bound on an H100: bytes.  Each (row, kv head) must read its K and V rows
// up to length[b] once, at ~1 flop per byte: at the serving engine's shape
// (B, H, Hkv, D, S) = (16, 20, 20, 128, 4096), bf16, with 22,685 valid
// positions, 232 MB, 0.069 ms at 3.35 TB/s.  Design, point by point against
// what held the previous kernel (one block per (kv head, row), one tile in
// flight, f32 staging) back:
//   1. Split-S.  The grid is (split, kv head, row).  The wrapper sets the
//      split (a multiple of the 64-position tile, at most kMaxSplits splits
//      of S) from S, B*Hkv and the SM count only, never from `length`; a
//      block whose split starts at or past min(max(length[b], 0), S) exits
//      at once, so the work units are about equal and the longest row no
//      longer sets the time.
//   2. Loads overlap the math.  Thread 0 keeps up to kStages (2) tiles of
//      64 positions of K and V in flight by TMA (a 4-d map over (D, Hkv, S,
//      B), box (D, 1, 64, 1)), each stage with a full and an empty
//      mbarrier; the tiles stay in the input's own type in shared memory
//      (bf16 is widened in registers), so at bf16 and D = 128 a stage is 32
//      KB, a block 69 KB, and three blocks fit an SM (as many as its 76
//      registers a thread allow).  Where D is not a
//      multiple of 8 (TMA's 16-byte strides, the workers' 8-column
//      groups), the same kernel's kTma = false instance stages each tile
//      with plain loads into the same layout, rows padded with zeros to a
//      multiple of 8 columns.
//   3. Every thread works at G = 1.  The query rows of a group times KP =
//      8 / G key parts (one part from G = 8 on) make the (row, part) pairs;
//      a warp owns pairs and takes a tile's keys p, p + KP, ... of its part
//      eight at a time: each of its four workers of 8 lanes reads two keys'
//      rows in 16-byte vectors (16 columns a lane at D = 128) and reduces
//      each logit in three butterfly steps, so every lane of the worker
//      ends with the same bits; the warp moves its running max and sum (the
//      same on every lane) once per eight keys, rescaling only when the max
//      grows (a factor of exactly 1 changes nothing), and each lane adds P
//      V for its worker's keys to its f32 accumulator in registers.  No
//      barrier sits between the logits, the softmax and P V.  At the end
//      of a split the four workers' sums are added in a fixed order and
//      the parts of a row folded in part order.
// Combine: with one live split a block writes the output itself; otherwise
// each split writes its (m, l, acc) in f32 to the wrapper's scratch, and the
// last block of the (row, kv head) to finish -- found by an integer ticket,
// atomicAdd after __threadfence -- folds the splits in split order, writes
// the output and resets its ticket.  No float atomics: the result is
// bitwise the same from run to run.  Rows past a row's length are never
// read into the arithmetic (the tail of a tile is loaded, not used).
//
// The mask value and the divisor clamp are the TPU kernel's: -1e30 and
// max(l, 1e-30); a row of length 0 gives zeros.  All arithmetic is f32; the
// output is rounded once to the element type.  The build passes -fmad=false;
// the dot products ask for fused multiply-adds explicitly (fmaf).  A wait on
// an mbarrier that has not completed after kWatchdogCycles traps.
//
// The entry point launches on the caller's stream, allocates nothing (the
// wrapper, repro_torch/kernels/decode_attention.py, passes the scratch and
// the tickets) and returns cudaGetLastError(), or cudaErrorInvalidValue for
// what it does not take, so the wrapper can raise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstring>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                    // lanes of a worker
constexpr int kWorkers = 32 / kLanes;        // workers of a warp
constexpr int kRound = 8;                    // keys a warp takes at once
constexpr int kTile = 64;                    // positions per K/V tile
constexpr int kStages = 2;                   // K/V tiles in flight
constexpr int kRingBytes = 128 * 1024;       // cap on the ring of one block
constexpr int kMaxSplits = 32;               // splits of S (one lane each)
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNegInf = -1.0e30f;
constexpr float kMinDenom = 1e-30f;

// the ring's depth for a padded width: kStages, fewer where a stage is so
// large that kStages of them pass kRingBytes
template <typename T, int DP>
__host__ __device__ constexpr int stages() {
  constexpr int stage = 2 * kTile * DP * static_cast<int>(sizeof(T));
  return kRingBytes / stage >= kStages ? kStages
         : kRingBytes / stage >= 1     ? kRingBytes / stage
                                       : 1;
}

// key parts per query row: the 8 warps share the keys of a lone row
__host__ __device__ inline int key_parts(int G) {
  return G >= kWarps ? 1 : kWarps / G;
}

template <typename T, int DP>
size_t smem_bytes(int G) {
  const size_t pairs = static_cast<size_t>(G) * key_parts(G);
  const size_t ring = static_cast<size_t>(stages<T, DP>()) * 2 * kTile * DP *
                      sizeof(T);
  const size_t scales = sizeof(float) * G * kMaxSplits;  // the combine's
  return 128 + (ring > scales ? ring : scales) +
         sizeof(float) * (static_cast<size_t>(G) * DP + pairs * DP +
                          3 * pairs + 2 * static_cast<size_t>(G)) +
         8 + 2 * sizeof(uint64_t) * stages<T, DP>() + 16;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// elements of a 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / static_cast<int>(sizeof(T));
}

// one 16-byte vector from shared memory, widened to f32
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// eight floats from shared memory (q or an accumulator row)
__device__ __forceinline__ void load_f32(const float* p, float* x, int n) {
  for (int i = 0; i < n; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + i);
    x[i] = u.x;
    x[i + 1] = u.y;
    x[i + 2] = u.z;
    x[i + 3] = u.w;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kAll, x, off));
  return x;
}

// Rows [0, n) of a tile from rows of `stride` elements, each D long, into
// rows of LD elements with zeros in columns D..LD-1 (the kTma = false
// instance).
template <typename T>
__device__ __forceinline__ void stage_plain(T* dst, const T* src,
                                            size_t stride, int n, int D,
                                            int LD) {
  for (int i = threadIdx.x; i < n * LD; i += kThreads) {
    const int r = i / LD, c = i % LD;
    dst[i] = c < D ? src[r * stride + c] : from_float<T>(0.f);
  }
}

// A worker's columns of a row: NV vectors of vec<T>() elements; in each
// 64-column chunk the worker's 8 lanes read 8 consecutive 16-byte vectors
// (128 bytes: every bank once), one or two of them a lane.
template <typename T>
__device__ __forceinline__ int column(int v, int wl) {
  constexpr int W = vec<T>(), VPC = 64 / (kLanes * W);
  return 64 * (v / VPC) + kLanes * W * (v % VPC) + W * wl;
}

// The running state of one (query row, key part) pair on one warp: its max
// and sum (the same on every lane) and, on each lane, its columns of the
// f32 accumulator over its worker's keys.
template <typename T, int NV>
struct Pair {
  float m, l;
  float acc[NV][vec<T>()];
};

// One tile's keys p, p + KP, ... (< n) of a pair, in rounds of kRound:
// worker w (lanes 8w .. 8w + 7) takes a round's keys w, w + 4, ...; the
// warp's softmax state moves once a round.
template <typename T, int NV>
__device__ __forceinline__ void pair_tile(
    Pair<T, NV>& st, const float (&qf)[NV][vec<T>()], const T* kt,
    const T* vt, int LD, int p, int KP, int n, int wl, int wsub) {
  constexpr int W = vec<T>();
  constexpr int KW = kRound / kWorkers;  // keys a worker takes a round
  const int cnt = n > p ? (n - p + KP - 1) / KP : 0;
  for (int u0 = 0; u0 < cnt; u0 += kRound) {
    bool live[KW];  // each the same on the worker's lanes
    int row[KW];
    float dot[KW];
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const int u = u0 + kWorkers * j + wsub;
      live[j] = u < cnt;
      row[j] = (p + KP * u) * LD;
      float d0 = 0.f, d1 = 0.f;  // even and odd columns
      if (live[j]) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c = column<T>(v, wl);
          if (c < LD) {
            float x[W];
            load_vec(kt + row[j] + c, x);
#pragma unroll
            for (int e = 0; e < W; e += 2) {
              d0 = fmaf(qf[v][e], x[e], d0);
              d1 = fmaf(qf[v][e + 1], x[e + 1], d1);
            }
          }
        }
      }
      dot[j] = d0 + d1;
    }
    // butterflies over each worker's 8 lanes (every lane takes part): each
    // step adds the same two values on both lanes of a pair, so every lane
    // of a worker ends with the same bits
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < KW; ++j)
        dot[j] += __shfl_xor_sync(kAll, dot[j], off);
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      dot[j] = live[j] ? dot[j] : kNegInf;
      mx = fmaxf(mx, dot[j]);
    }
    // over the workers: their lanes hold equal values
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 16));
    if (mx > st.m) {  // the same on every lane; else the factor is 1
      const float corr = expf(st.m - mx);
      st.l *= corr;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < W; ++e) st.acc[v][e] *= corr;
      st.m = mx;
    }
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      dot[j] = live[j] ? expf(dot[j] - st.m) : 0.f;  // now probabilities
      ps += dot[j];
    }
    ps += __shfl_xor_sync(kAll, ps, 8);
    st.l += ps + __shfl_xor_sync(kAll, ps, 16);
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      if (live[j]) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c = column<T>(v, wl);
          if (c < LD) {
            float x[W];
            load_vec(vt + row[j] + c, x);
#pragma unroll
            for (int e = 0; e < W; ++e)
              st.acc[v][e] = fmaf(dot[j], x[e], st.acc[v][e]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel.  DP is the padded width (16 .. 256) that sizes the shared
// arrays; LD, the stored row width of a tile, is D rounded up to 8.  Grid
// (splits, Hkv, B).
// ---------------------------------------------------------------------------

template <typename T, int DP, bool kTma>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ length, T* __restrict__ out,
    float* __restrict__ partial, int* __restrict__ ticket, int S, int Hkv,
    int G, int D, int LD, int split, float scale) {
  constexpr int NS = stages<T, DP>();
  constexpr int W = vec<T>();
  constexpr int NV = (DP < 64 ? 64 : DP) / (kLanes * W);  // vectors a lane
  constexpr int kTileBytes = kTile * DP * static_cast<int>(sizeof(T));
  constexpr int kRegion = NS * 2 * kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);  // NS x (K, V)
  const int KP = key_parts(G);
  const int pairs = G * KP;
  const int region = kRegion > G * kMaxSplits * 4 ? kRegion
                                                  : G * kMaxSplits * 4;
  float* s_q = reinterpret_cast<float*>(ring + region);  // G x DP, scaled
  float* s_acc = s_q + G * DP;        // pairs x DP
  float* s_m = s_acc + pairs * DP;    // pairs: running max
  float* s_l = s_m + pairs;           // pairs: running sum
  float* s_sc = s_l + pairs;          // pairs: the fold's scales
  float* s_row = s_sc + pairs;        // G x (max, sum) of this split
  uint64_t* full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(s_row + 2 * G) + 7) & ~uintptr_t{7});
  uint64_t* empty = full + NS;
  int* s_last = reinterpret_cast<int*>(empty + NS);

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(length[b], 0), S);
  const int start = sp * split;
  const int GD = G * D;
  T* ob = out + (static_cast<size_t>(b) * Hkv + h) * GD;
  if (start >= len) {
    if (len == 0 && sp == 0)
      for (int i = tid; i < GD; i += kThreads) ob[i] = from_float<T>(0.f);
    return;
  }
  const int n_live = (len + split - 1) / split;
  const int end = min(start + split, len);
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const size_t stride = static_cast<size_t>(Hkv) * D;  // between positions
  const size_t base = static_cast<size_t>(b) * S * stride +
                      static_cast<size_t>(h) * D;

  if (kTma && tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);  // lane 0 of every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int t = 0; t < min(NS, n_tiles); ++t) {
      uint8_t* dst = ring + t * 2 * kTileBytes;
      mbar_expect_tx(&full[t], 2 * kTile * D * sizeof(T));
      tma_load_4d(dst, &map_k, &full[t], 0, h, start + t * kTile, b);
      tma_load_4d(dst + kTileBytes, &map_v, &full[t], 0, h,
                  start + t * kTile, b);
    }
  }
  const T* qb = q + (static_cast<size_t>(b) * Hkv + h) * GD;
  for (int i = tid; i < G * DP; i += kThreads) {
    const int g = i / DP, c = i % DP;
    s_q[i] = c < D ? to_float(qb[g * D + c]) * scale : 0.f;
  }
  for (int i = tid; i < pairs * DP; i += kThreads) s_acc[i] = 0.f;
  for (int i = tid; i < pairs; i += kThreads) {
    s_m[i] = kNegInf;
    s_l[i] = 0.f;
  }
  __syncthreads();

  // ---- a warp owns pairs warp, warp + 8, ...; with one pair each (G <= 8)
  // its state and q stay in registers across the tiles.  Lane wl of worker
  // wsub reads the columns column<T>(v, wl) of its worker's key ----------
  const int wsub = lane / kLanes, wl = lane % kLanes;
  const bool one_pair = pairs <= kWarps;
  Pair<T, NV> st;
  float qf[NV][W];
  auto load_pair = [&](int pi) {  // worker 0 carries the stored sum
    const int g = pi / KP;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = column<T>(v, wl);
      if (c < LD) {
        load_f32(s_q + g * DP + c, qf[v], W);
        load_f32(s_acc + pi * DP + c, st.acc[v], W);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) qf[v][e] = st.acc[v][e] = 0.f;
      }
      if (wsub != 0)
#pragma unroll
        for (int e = 0; e < W; ++e) st.acc[v][e] = 0.f;
    }
    st.m = s_m[pi];
    st.l = s_l[pi];
  };
  auto store_pair = [&](int pi) {  // the workers' sums, in a fixed order
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = column<T>(v, wl);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float a = st.acc[v][e] + __shfl_xor_sync(kAll, st.acc[v][e], 8);
        a += __shfl_xor_sync(kAll, a, 16);
        if (wsub == 0 && c < LD) s_acc[pi * DP + c + e] = a;
      }
    }
    if (lane == 0) {
      s_m[pi] = st.m;
      s_l[pi] = st.l;
    }
    __syncwarp();
  };
  if (one_pair && warp < pairs) load_pair(warp);

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % NS;
    const uint32_t parity = (t / NS) & 1;
    const int n = min(kTile, end - start - t * kTile);  // valid keys
    const T* kt = reinterpret_cast<const T*>(ring + slot * 2 * kTileBytes);
    const T* vt = reinterpret_cast<const T*>(ring + slot * 2 * kTileBytes +
                                             kTileBytes);
    if (kTma) {
      mbar_wait(&full[slot], parity);
    } else {
      __syncthreads();  // every warp is done with the slot's last tile
      const size_t at = base + static_cast<size_t>(start + t * kTile) * stride;
      stage_plain(const_cast<T*>(kt), k + at, stride, n, D, LD);
      stage_plain(const_cast<T*>(vt), v + at, stride, n, D, LD);
      __syncthreads();
    }

    if (one_pair) {
      if (warp < pairs)
        pair_tile(st, qf, kt, vt, LD, warp % KP, KP, n, wl, wsub);
    } else {
      for (int pi = warp; pi < pairs; pi += kWarps) {
        load_pair(pi);
        pair_tile(st, qf, kt, vt, LD, pi % KP, KP, n, wl, wsub);
        store_pair(pi);
      }
    }

    if (kTma) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (tid == 0 && t + NS < n_tiles) {  // refill the slot
        mbar_wait(&empty[slot], parity);
        uint8_t* dst = ring + slot * 2 * kTileBytes;
        const int pos = start + (t + NS) * kTile;
        mbar_expect_tx(&full[slot], 2 * kTile * D * sizeof(T));
        tma_load_4d(dst, &map_k, &full[slot], 0, h, pos, b);
        tma_load_4d(dst + kTileBytes, &map_v, &full[slot], 0, h, pos, b);
      }
      __syncwarp();
    }
  }
  if (one_pair && warp < pairs) store_pair(warp);
  __syncthreads();

  // ---- fold a row's key parts, in part order: this split's (m, l, acc) ---
  const int H = Hkv * G;
  const int n_split = gridDim.x;
  for (int g = warp; g < G; g += kWarps) {
    const int p0 = g * KP;
    const float mp = lane < KP ? s_m[p0 + lane] : kNegInf;
    const float m = warp_max(mp);
    const float sc = lane < KP ? expf(mp - m) : 0.f;
    float l = 0.f;
    for (int p = 0; p < KP; ++p)
      l = fmaf(__shfl_sync(kAll, sc, p), s_l[p0 + p], l);
    if (lane < KP) s_sc[p0 + lane] = sc;
    if (lane == 0) {
      s_row[2 * g] = m;
      s_row[2 * g + 1] = l;
    }
  }
  __syncthreads();
  // partials of row g: (m, l, acc[D]) at ((b * H + h * G + g) * n_split +
  // sp) * (D + 2)
  float* pw = n_live == 1 ? nullptr
                          : partial + (static_cast<size_t>(b) * H + h * G) *
                                          n_split * (D + 2);
  for (int i = tid; i < GD; i += kThreads) {
    const int g = i / D, c = i % D;
    const int p0 = g * KP;
    float a = 0.f;
    for (int p = 0; p < KP; ++p)
      a = fmaf(s_sc[p0 + p], s_acc[(p0 + p) * DP + c], a);
    if (n_live == 1)
      ob[i] = from_float<T>(a / fmaxf(s_row[2 * g + 1], kMinDenom));
    else
      pw[(static_cast<size_t>(g) * n_split + sp) * (D + 2) + 2 + c] = a;
  }
  if (n_live == 1) return;
  for (int g = tid; g < G; g += kThreads) {
    pw[(static_cast<size_t>(g) * n_split + sp) * (D + 2)] = s_row[2 * g];
    pw[(static_cast<size_t>(g) * n_split + sp) * (D + 2) + 1] =
        s_row[2 * g + 1];
  }

  // ---- the last split of the (row, kv head) to finish combines: the
  // barrier orders the block's partials before thread 0's fence, which
  // publishes them before its ticket ----------------------------------------
  __syncthreads();
  if (tid == 0) {
    int* tk = ticket + static_cast<size_t>(b) * Hkv + h;
    __threadfence();
    const int last = atomicAdd(tk, 1) == n_live - 1;
    if (last) *tk = 0;  // ready for the next call
    *s_last = last;
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  float* s_scale = reinterpret_cast<float*>(ring);  // G x kMaxSplits
  for (int g = warp; g < G; g += kWarps) {
    const float* mine = pw + (static_cast<size_t>(g) * n_split + lane) *
                                 (D + 2);
    const float ms = lane < n_live ? __ldcg(mine) : kNegInf;
    const float ls = lane < n_live ? __ldcg(mine + 1) : 0.f;
    const float m = warp_max(ms);
    const float sc = lane < n_live ? expf(ms - m) : 0.f;
    float l = 0.f;
    for (int s = 0; s < n_live; ++s)
      l = fmaf(__shfl_sync(kAll, sc, s), __shfl_sync(kAll, ls, s), l);
    s_scale[g * kMaxSplits + lane] = sc;
    if (lane == 0) s_row[2 * g + 1] = l;
  }
  __syncthreads();
  for (int i = tid; i < GD; i += kThreads) {
    const int g = i / D, c = i % D;
    const float* pr = pw + static_cast<size_t>(g) * n_split * (D + 2) + 2 + c;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s)
      a = fmaf(s_scale[g * kMaxSplits + s], __ldcg(pr + s * (D + 2)), a);
    ob[i] = from_float<T>(a / fmaxf(s_row[2 * g + 1], kMinDenom));
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
constexpr CUtensorMapDataType map_type();
template <>
constexpr CUtensorMapDataType map_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <>
constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A map of the (B, S, Hkv, D) cache read in boxes of (D, 1, kTile, 1): one
// kv head's rows of kTile positions, unswizzled, zeros past S.
template <typename T>
bool cache_map(CUtensorMap* map, const void* ptr, int B, int S, int Hkv,
               int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t bytes[3] = {D * es, static_cast<cuuint64_t>(Hkv) * D * es,
                               static_cast<cuuint64_t>(S) * Hkv * D * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, kTile, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, map_type<T>(), 4, const_cast<void*>(ptr), dims, bytes,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v, *length;
  void *out, *partial, *ticket;
  int B, Hkv, S, G, D, split;
  cudaStream_t stream;
};

template <typename T, int DP, bool kTma>
int launch(const Args& a) {
  CUtensorMap mk, mv;
  if (kTma) {
    if (!cache_map<T>(&mk, a.k, a.B, a.S, a.Hkv, a.D) ||
        !cache_map<T>(&mv, a.v, a.B, a.S, a.Hkv, a.D))
      return cudaErrorInvalidValue;
  } else {
    memset(&mk, 0, sizeof(mk));
    memset(&mv, 0, sizeof(mv));
  }
  auto kernel = decode_attention_kernel<T, DP, kTma>;
  const size_t smem = smem_bytes<T, DP>(a.G);
  // more than the card's shared memory per block is refused here with the
  // runtime's error, which is then cleared so the next launch's
  // cudaGetLastError() does not report it again
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const int LD = (a.D + 7) / 8 * 8;
  const int n_split = (a.S + a.split - 1) / a.split;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(a.D)));
  kernel<<<dim3(n_split, a.Hkv, a.B), kThreads, smem, a.stream>>>(
      mk, mv, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.length),
      static_cast<T*>(a.out), static_cast<float*>(a.partial),
      static_cast<int*>(a.ticket), a.S, a.Hkv, a.G, a.D, LD, a.split, scale);
  return cudaGetLastError();
}

template <typename T, int DP>
int by_stride(const Args& a) {
  // TMA writes rows of D elements, which the workers read in groups of 8
  // columns; D a multiple of 8 also makes every stride of the map a
  // multiple of 16 bytes, as TMA needs
  return a.D % 8 == 0 ? launch<T, DP, true>(a) : launch<T, DP, false>(a);
}

template <typename T>
int by_width(const Args& a) {
  if (a.D <= 16) return by_stride<T, 16>(a);
  if (a.D <= 32) return by_stride<T, 32>(a);
  if (a.D <= 64) return by_stride<T, 64>(a);
  if (a.D <= 128) return by_stride<T, 128>(a);
  return by_stride<T, 256>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, out contiguous and 16-byte
// aligned (the wrapper checks them).  `split` is the positions per split, a
// multiple of 32 with at most 32 splits of S; `partial` holds B * H * splits
// * (D + 2) floats (unused with one split), `ticket` B * Hkv zeros, which
// every call leaves at zero.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* length, void* out, void* partial,
                                void* ticket, int B, int H, int Hkv, int S,
                                int D, int split, int dtype, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || D < 1 || D > 256 ||
      split < kTile || split % kTile != 0 ||
      (S + split - 1) / split > kMaxSplits ||
      ((S + split - 1) / split > 1 && (partial == nullptr || ticket == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, length, out, partial, ticket, B, Hkv, S, H / Hkv, D,
               split, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_width<float>(a);
  if (dtype == 1) return by_width<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
