// Attention kernels for Hopper (sm_90a), plain C interface: kernel 6
// (one-token decode attention over a KV cache) and kernel 7 (causal
// flash-attention forward, the prefill).
//
// Built by repro_torch/kernels/_build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -fmad=false -shared) and bound with
// ctypes.  The build turns off contracted multiply-adds for the
// refinement kernels; the dot products here ask for fused multiply-adds
// explicitly (fmaf), which that flag leaves alone.
//
// Kernel 6 is templated on the element type (float or __nv_bfloat16),
// kernel 7 here takes float (bf16 inputs go to flash_attention.cu's
// tensor-core kernel); both are instantiated on a padded head width DP in
// {16, 32, 64, 128, 256} and take the real head_dim D <= DP at run time,
// as the reference pads D.  Rows are read in 16-byte vectors where D
// fills whole vectors, element by element otherwise, and widened to float
// in shared memory with zeros in columns D..DP-1, which add nothing to a
// dot product; columns past D are never stored.  All arithmetic is f32;
// the output is rounded once to the element type.  The mask value and the
// divisor clamp are the TPU kernels': -1e30 and max(l, 1e-30).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a type or
// head dimension it has no instance for), so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1.0e30f;
constexpr float kMinDenom = 1e-30f;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows [0, n) of a TILE-row tile into shared memory as float: row r
// of the source starts at row_ptr(r) (d contiguous elements) and lands at
// dst + r * ld, columns d..DP-1 as zeros.  Where d is a whole number of
// 16-byte vectors (rows then start 16-byte aligned), every load of the
// tile is issued before the first store, so a thread keeps kIters 16-byte
// loads in flight per array; other widths are read element by element.
// Rows n..TILE-1 are left as they are.
template <typename T, int DP, int TILE, typename RowPtr>
__device__ __forceinline__ void stage_rows(RowPtr row_ptr, int n, int d,
                                           float* dst, int ld) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per 16 bytes
  if (d % kVec != 0) {
    for (int i = threadIdx.x; i < n * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * ld + c] = c < d ? to_float(row_ptr(r)[c]) : 0.f;
    }
    return;
  }
  constexpr int kPerRow = DP / kVec;
  constexpr int kTotal = TILE * kPerRow;
  constexpr int kIters = (kTotal + kThreads - 1) / kThreads;
  uint4 buf[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    buf[it] = make_uint4(0, 0, 0, 0);
    if (i < kTotal && r < n && c < d)
      buf[it] = *reinterpret_cast<const uint4*>(row_ptr(r) + c);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kPerRow;
    if (i < kTotal && r < n) {
      const T* elems = reinterpret_cast<const T*>(&buf[it]);
      float* out = dst + r * ld + (i % kPerRow) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = to_float(elems[e]);
    }
  }
}

// K and V rows [s0, s0 + n) of one (batch, kv head): consecutive
// positions are `stride` elements apart.
template <typename T, int DP, int TILE>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         size_t stride, int n, int d,
                                         float* s_k, int ldk, float* s_v) {
  stage_rows<T, DP, TILE>([=](int r) { return k + r * stride; }, n, d, s_k,
                          ldk);
  stage_rows<T, DP, TILE>([=](int r) { return v + r * stride; }, n, d, s_v,
                          DP);
}

// ---------------------------------------------------------------------------
// Kernel 6: one-token GQA decode attention over a KV cache.
//
// Replaces the TPU kernel decode_attention_pallas
// (repro/kernels/decode_attention.py), which the port's decode step runs
// once per layer.  Layouts are the reference's: q (B, H, D), k and v
// (B, S, Hkv, D), length (B,) int32, out (B, H, D); query head h*G + g
// belongs to kv head h.
//
// Bound on an H100: bytes.  Each (b, kv head) must read its K and V rows
// up to length[b] once; at the serving engine's shape (B=16, Hkv=20,
// D=128, bf16, lengths up to 4096) that is ~300 MB, ~90 us at 3.35 TB/s,
// against ~2 flops per byte.  Design: one block per (kv head, b), 256
// threads, a loop over S in tiles of 64 positions that stops at
// length[b] (clamped to S, as XLA clamps the reference's cache write), so
// nothing past the valid prefix is read -- the TPU kernel streams all of
// S and masks.  Each tile's K and V are staged once in shared memory as
// float, the G query rows of the kv head (pre-scaled by 1/sqrt(D)) stay
// in shared memory, and the online softmax runs in f32: one thread per
// (query row, key) logit, one warp per query row for the running max and
// sum, one thread per (query row, d) output accumulator.  A row with no
// valid key (length 0) gives zeros.  Split-S (flash-decoding) with a
// combine pass is later work; B*Hkv = 320 blocks fill the 132 SMs here.
// ---------------------------------------------------------------------------

constexpr int kDecodeTile = 64;

template <int DP>
size_t decode_smem_bytes(int G) {
  const int TS = kDecodeTile;
  return sizeof(float) * (static_cast<size_t>(TS) * (DP + 1) + TS * DP +
                          2 * G * DP + G * TS + 3 * G);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ length,
                            T* __restrict__ out, int S, int Hkv, int G, int D,
                            float scale) {
  constexpr int TS = kDecodeTile;
  constexpr int LDK = DP + 1;  // odd row stride: a warp's key rows hit 32 banks
  extern __shared__ float smem[];
  float* s_k = smem;               // TS x LDK
  float* s_v = s_k + TS * LDK;     // TS x DP
  float* s_q = s_v + TS * DP;      // G x DP, scaled
  float* s_acc = s_q + G * DP;     // G x DP
  float* s_p = s_acc + G * DP;     // G x TS: logits, then probabilities
  float* s_m = s_p + G * TS;       // G running max
  float* s_l = s_m + G;            // G running sum
  float* s_corr = s_l + G;         // G rescale of this tile

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(length[b], 0), S);
  const int GD = G * D, GDP = G * DP;
  const T* qb = q + (static_cast<size_t>(b) * Hkv + h) * GD;
  for (int i = tid; i < GDP; i += kThreads) {
    const int g = i / DP, c = i % DP;
    s_q[i] = c < D ? to_float(qb[g * D + c]) * scale : 0.f;
    s_acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    s_m[g] = kNegInf;
    s_l[g] = 0.f;
  }
  const size_t stride = static_cast<size_t>(Hkv) * D;
  const size_t base = static_cast<size_t>(b) * S * stride +
                      static_cast<size_t>(h) * D;

  for (int j0 = 0; j0 < len; j0 += TS) {
    const int n = min(TS, len - j0);
    stage_kv<T, DP, TS>(k + base + j0 * stride, v + base + j0 * stride,
                        stride, n, D, s_k, LDK, s_v);
    __syncthreads();
    for (int i = tid; i < G * TS; i += kThreads) {
      const int g = i / TS, j = i % TS;
      float logit = kNegInf;
      if (j < n) {
        const float* qr = s_q + g * DP;
        const float* kr = s_k + j * LDK;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DP; ++d) dot = fmaf(qr[d], kr[d], dot);
        logit = dot;
      }
      s_p[i] = logit;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float* pr = s_p + g * TS;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TS; j += 32) {
        const float p = j < n ? expf(pr[j] - m_new) : 0.f;
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        s_corr[g] = c;
        s_l[g] = s_l[g] * c + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < GDP; i += kThreads) {
      const int g = i / DP, d = i % DP;
      const float* pr = s_p + g * TS;
      float a = s_acc[i] * s_corr[g];
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], s_v[j * DP + d], a);
      s_acc[i] = a;
    }
    __syncthreads();
  }
  __syncthreads();
  T* ob = out + (static_cast<size_t>(b) * Hkv + h) * GD;
  for (int i = tid; i < GD; i += kThreads) {
    const int g = i / D;
    ob[i] = from_float<T>(s_acc[g * DP + i % D] / fmaxf(s_l[g], kMinDenom));
  }
}

// ---------------------------------------------------------------------------
// Kernel 7 for f32 inputs: causal GQA flash-attention forward (prefill).
// bf16 inputs, the serving path, take the tensor-core kernel of
// flash_attention.cu; this one serves f32 compute.
//
// Replaces the TPU kernel flash_attention_pallas
// (repro/kernels/flash_attention.py), which the port's prefill runs once
// per layer.  Layouts are the reference's: q and out (B, S, H, D), k and v
// (B, S, Hkv, D).
//
// Bound on an H100: operations at long S.  The causal product is
// 4*B*H*D*S(S+1)/2 flops (48 GFLOP at S=3072, H=20, D=128: 0.72 ms at the
// 67 TFLOP/s of f32 outside the tensor cores) against ~94 MB of f32 q, k,
// v and out.  It runs on the CUDA cores in f32, TF32 off, so f32 compute
// keeps full f32 products.  Design: a block owns 64
// query rows of one (b, kv head) -- TQ = 64 / G positions times the G
// heads of the group, so the group shares every K/V tile, as the TPU
// kernel flattens TQ*G rows.  It loops over 64-key tiles up to its last
// row's position only (the causal skip, as a loop bound) and masks per
// element; tiles past the diagonal are never loaded.  K/V tiles are
// staged in shared memory as float; each thread holds a 4 x 4 block of
// logits and a 4 x D/16 block of the output accumulator in registers; one
// warp per row runs the online softmax.  Any S is taken: the last tile of
// queries or keys is ragged, nothing is padded.  Blocks start with the
// last query tile (the most keys), so the longest blocks go first.
// ---------------------------------------------------------------------------

constexpr int kFlashRows = 64;
constexpr int kFlashTile = 64;

template <int DP>
size_t flash_smem_bytes() {
  const int R = kFlashRows, TK = kFlashTile;
  return sizeof(float) * (static_cast<size_t>(R) * (DP + 1) + TK * (DP + 1) +
                          TK * DP + R * (TK + 1) + 3 * R);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int Hkv, int G,
                           int TQ, int D, float scale) {
  constexpr int R = kFlashRows, TK = kFlashTile;
  constexpr int LD = DP + 1, LDP = TK + 1;
  constexpr int DC = DP / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* s_q = smem;              // R x LD, scaled
  float* s_k = s_q + R * LD;      // TK x LD
  float* s_v = s_k + TK * LD;     // TK x DP
  float* s_p = s_v + TK * DP;     // R x LDP: logits, then probabilities
  float* s_m = s_p + R * LDP;     // R running max
  float* s_l = s_m + R;           // R running sum
  float* s_corr = s_l + R;        // R rescale of this tile

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid / 16, tc = tid % 16;
  const int q0 = qt * TQ;
  const int tq = min(TQ, S - q0);
  const int rows = tq * G;
  const int GD = G * D;
  const size_t q_stride = static_cast<size_t>(Hkv) * GD;  // per position
  const float* qb = q + (static_cast<size_t>(b) * S + q0) * q_stride +
                    static_cast<size_t>(h) * GD;

  stage_rows<float, DP, R>(
      [=](int r) { return qb + (r / G) * q_stride + (r % G) * D; }, rows, D,
      s_q, LD);
  for (int i = tid; i < R; i += kThreads) {
    s_m[i] = kNegInf;
    s_l[i] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < R * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    s_q[r * LD + d] = r < rows ? s_q[r * LD + d] * scale : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const size_t kv_base = static_cast<size_t>(b) * S * kv_stride +
                         static_cast<size_t>(h) * D;
  const int q_last = q0 + tq - 1;
  for (int k0 = 0; k0 <= q_last; k0 += TK) {
    const int n = min(TK, S - k0);
    __syncthreads();  // the previous tile's readers are done
    stage_kv<float, DP, TK>(k + kv_base + k0 * kv_stride,
                            v + kv_base + k0 * kv_stride, kv_stride, n, D,
                            s_k, LD, s_v);
    __syncthreads();

    float lg[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) lg[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = s_q[(tr + 16 * a) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = s_k[(tc + 16 * c) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) lg[a][c] = fmaf(qa[a], kc[c], lg[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s_p[(tr + 16 * a) * LDP + tc + 16 * c] = lg[a][c];
    __syncthreads();

    for (int r = warp; r < R; r += kWarps) {
      const int qpos = q0 + r / G;
      const int live = r < rows ? min(n, qpos - k0 + 1) : 0;  // valid keys
      float* pr = s_p + r * LDP;
      float mx = kNegInf;
      for (int j = lane; j < live; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = j < live ? expf(pr[j] - m_new) : 0.f;
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        s_corr[r] = c;
        s_l[r] = s_l[r] * c + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float c = s_corr[tr + 16 * a];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) acc[a][cc] *= c;
    }
    for (int j = 0; j < n; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = s_p[(tr + 16 * a) * LDP + j];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = s_v[j * DP + tc + 16 * cc];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][cc] = fmaf(pa[a], vv, acc[a][cc]);
      }
    }
  }

  float* ob = out + (static_cast<size_t>(b) * S + q0) * q_stride +
              static_cast<size_t>(h) * GD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = tr + 16 * a;
    if (r >= rows) continue;
    const float denom = fmaxf(s_l[r], kMinDenom);
    float* orow = ob + (r / G) * q_stride + (r % G) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = tc + 16 * cc;
      if (d < D) orow[d] = acc[a][cc] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// More than the card's shared memory per block is refused here with the
// runtime's error, which is then cleared so the next launch's
// cudaGetLastError() does not report it again.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

float inv_sqrt(int d) {  // f32 of the double 1/sqrt(D), as the reference
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(d)));
}

template <typename T, int DP>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* length, void* out, int B, int Hkv, int S, int G,
                  int D, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<DP>(G);
  auto kernel = decode_attention_kernel<T, DP>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(length),
      static_cast<T*>(out), S, Hkv, G, D, inv_sqrt(D));
  return cudaGetLastError();
}

template <int DP>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int Hkv, int G, int D, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<DP>();
  auto kernel = flash_attention_kernel<DP>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int TQ = kFlashRows / G;
  const int tiles = (S + TQ - 1) / TQ;
  kernel<<<dim3(tiles, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Hkv, G, TQ,
      D, inv_sqrt(D));
  return cudaGetLastError();
}

// The padded width an instance is built for: 16, 32, 64, 128 or 256
// (0 for a head_dim outside [1, 256]).
int padded_width(int D) {
  if (D < 1 || D > 256) return 0;
  int dp = 16;
  while (dp < D) dp *= 2;
  return dp;
}

template <typename T>
int decode_by_dim(int D, const void* q, const void* k, const void* v,
                  const void* length, void* out, int B, int Hkv, int S, int G,
                  cudaStream_t s) {
  switch (padded_width(D)) {
    case 16:
      return launch_decode<T, 16>(q, k, v, length, out, B, Hkv, S, G, D, s);
    case 32:
      return launch_decode<T, 32>(q, k, v, length, out, B, Hkv, S, G, D, s);
    case 64:
      return launch_decode<T, 64>(q, k, v, length, out, B, Hkv, S, G, D, s);
    case 128:
      return launch_decode<T, 128>(q, k, v, length, out, B, Hkv, S, G, D, s);
    case 256:
      return launch_decode<T, 256>(q, k, v, length, out, B, Hkv, S, G, D, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int flash_by_dim(int D, const void* q, const void* k, const void* v,
                 void* out, int B, int S, int Hkv, int G, cudaStream_t s) {
  switch (padded_width(D)) {
    case 16: return launch_flash<16>(q, k, v, out, B, S, Hkv, G, D, s);
    case 32: return launch_flash<32>(q, k, v, out, B, S, Hkv, G, D, s);
    case 64: return launch_flash<64>(q, k, v, out, B, S, Hkv, G, D, s);
    case 128: return launch_flash<128>(q, k, v, out, B, S, Hkv, G, D, s);
    case 256: return launch_flash<256>(q, k, v, out, B, S, Hkv, G, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes and contiguity are the
// wrapper's to check (repro_torch/kernels/decode_attention.py).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* length, void* out, int B, int H,
                                int Hkv, int S, int D, int dtype,
                                void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return decode_by_dim<float>(D, q, k, v, length, out, B, Hkv, S, G, s);
  if (dtype == 1)
    return decode_by_dim<__nv_bfloat16>(D, q, k, v, length, out, B, Hkv, S,
                                        G, s);
  return cudaErrorInvalidValue;
}

// f32 only (bf16 takes flash_attention.cu).  The wrapper
// (repro_torch/kernels/flash_attention.py) checks shapes and contiguity;
// G > kFlashRows is refused here.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int Hkv, int D,
                               void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kFlashRows)
    return cudaErrorInvalidValue;
  return flash_by_dim(D, q, k, v, out, B, S, Hkv, H / Hkv,
                      static_cast<cudaStream_t>(stream));
}
