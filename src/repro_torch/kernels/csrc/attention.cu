// Kernel 7 for f32 inputs on Hopper (sm_90a), plain C interface: causal
// flash-attention forward (the prefill) on the CUDA cores.  bf16 inputs go
// to flash_attention.cu's tensor-core kernel; kernel 6 (decode attention)
// lives in decode_attention.cu.
//
// Built by repro_torch/kernels/_build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -fmad=false -shared) and bound with
// ctypes.  The build turns off contracted multiply-adds for the
// refinement kernels; the dot products here ask for fused multiply-adds
// explicitly (fmaf), which that flag leaves alone.
//
// The kernel is instantiated on a padded head width DP in {16, 32, 64,
// 128, 256} and takes the real head_dim D <= DP at run time, as the
// reference pads D.  Rows are read in 16-byte vectors where D fills whole
// vectors, element by element otherwise, and staged in shared memory with
// zeros in columns D..DP-1, which add nothing to a dot product; columns
// past D are never stored.  The mask value and the divisor clamp are the
// TPU kernel's: -1e30 and max(l, 1e-30).
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a head
// dimension it has no instance for), so the wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1.0e30f;
constexpr float kMinDenom = 1e-30f;

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

// Stage rows [0, n) of a TILE-row tile into shared memory: row r of the
// source starts at row_ptr(r) (d contiguous floats) and lands at dst + r *
// ld, columns d..DP-1 as zeros.  Where d is a whole number of 16-byte
// vectors (rows then start 16-byte aligned), every load of the tile is
// issued before the first store, so a thread keeps kIters 16-byte loads in
// flight per array; other widths are read element by element.  Rows
// n..TILE-1 are left as they are.
template <int DP, int TILE, typename RowPtr>
__device__ __forceinline__ void stage_rows(RowPtr row_ptr, int n, int d,
                                           float* dst, int ld) {
  constexpr int kVec = 4;  // floats per 16 bytes
  if (d % kVec != 0) {
    for (int i = threadIdx.x; i < n * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * ld + c] = c < d ? row_ptr(r)[c] : 0.f;
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
    if (i < kTotal && r < n) {  // ld may be odd: store float by float
      const float* elems = reinterpret_cast<const float*>(&buf[it]);
      float* out = dst + r * ld + (i % kPerRow) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = elems[e];
    }
  }
}

// K and V rows [s0, s0 + n) of one (batch, kv head): consecutive
// positions are `stride` elements apart.
template <int DP, int TILE>
__device__ __forceinline__ void stage_kv(const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         size_t stride, int n, int d,
                                         float* s_k, int ldk, float* s_v) {
  stage_rows<DP, TILE>([=](int r) { return k + r * stride; }, n, d, s_k,
                       ldk);
  stage_rows<DP, TILE>([=](int r) { return v + r * stride; }, n, d, s_v,
                       DP);
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

  stage_rows<DP, R>(
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
    stage_kv<DP, TK>(k + kv_base + k0 * kv_stride,
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
