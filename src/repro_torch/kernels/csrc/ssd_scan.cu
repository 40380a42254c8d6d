// Kernel 8 for f32 inputs on Hopper (sm_90a), plain C interface: the Mamba2
// SSD (state-space duality) chunked scan of the SSM prefill, on the CUDA
// cores.  bf16 inputs, the serving path, take the tensor-core kernel of
// ssd_scan_bf16.cu.
//
// Replaces the TPU kernel ssd_scan_pallas (repro/kernels/ssd_scan.py),
// which the port's ssm_block runs once per layer.  Layouts are the
// reference's: x (B, L, H, P) f32, dt (B, L, H) f32, a (H,) f32 and
// negative, bm and cm (B, L, N) f32 and shared by all heads
// (n_groups = 1), an optional initial state (B, H, P, N) f32 (zeros when
// null); out y (B, L, H, P) f32 and the final state (B, H, P, N) f32.
//
// Built by repro_torch/kernels/_build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -fmad=false -shared) and bound with
// ctypes.  The products ask for fused multiply-adds explicitly (fmaf).
//
// The function, per chunk of Q steps (arXiv:2405.21060 §6), with cum the
// inclusive prefix sum of dt * a inside the chunk:
//   y     = ((C B^T) ⊙ L ⊙ dt_j) x + (C ⊙ e^cum) state^T,
//           L[i, j] = e^(cum_i - cum_j) for j <= i, else 0
//   state <- state e^(cum_Q) + x^T (B ⊙ e^(cum_Q - cum) ⊙ dt)
// does not depend on Q, so this kernel takes its own sub-chunk, kChunk =
// 64 steps, whatever chunk the model asks for (mamba2-1.3b asks for 256:
// one chunk of f32 B and C alone would be 256 KB, more than a block's 227
// KB of shared memory).  Every exponent is <= 0 (dt >= 0, a < 0), so every
// exp is <= 1: e^cum may underflow to 0, which is its value; the kernel
// never divides by it and never forms e^(-cum).  Steps past L are zero
// (dt = 0), which leaves the state as it is: any L is taken unpadded.
//
// Bound on an H100: operations.  Every formulation adds each step's rank-1
// increment into the (P, N) state and reads the state back through C: 4 *
// P * N flops per (step, head), 6.44 GFLOP at the serving shape (B=1,
// L=3072, H=64, P=64, N=128; ~96 us at 67 TFLOP/s f32) against ~107 MB of
// f32 inputs and outputs (~32 us at 3.35 TB/s).  This kernel runs on the
// CUDA cores in f32.
// Design: one block per (b, h, tile of kRows = 32 state rows): a row p of
// y needs only row p of the state and of x, so the tiles are independent
// and B=1, H=64, P=64 gives 128 blocks for the 132 SMs, at the price of
// each tile recomputing C B^T.  The block walks the sub-chunks in order and
// keeps its 32 x N state rows in shared memory across them, so the state
// never leaves the chip until the end.  Per sub-chunk: B, C and x are
// staged as float in shared memory (rows past L as zeros), one thread
// takes the prefix sum of dt * a in order, then 4 x 4 register tiles
// build the masked score tile, 2 x 4 tiles the output rows (intra-chunk
// product plus the state's contribution, read before the update), and
// 4 x 4 tiles the state update.  Row strides of N + 1 floats keep a warp's
// reads of different rows on different banks.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it
// does not take, and the runtime's error, cleared, for an N whose tiles do
// not fit a block's shared memory), so the wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // sub-chunk: steps per pass
constexpr int kRows = 32;   // state rows (p) per block

size_t smem_bytes(int N) {
  const size_t ldn = static_cast<size_t>(N) + 1;
  return sizeof(float) * (2 * kChunk * ldn + kChunk * kRows +
                          kChunk * (kChunk + 1) + kRows * ldn + 4 * kChunk);
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bm,
                    const float* __restrict__ cm,
                    const float* __restrict__ init_state,
                    float* __restrict__ y, float* __restrict__ final_state,
                    int L, int H, int P, int N) {
  constexpr int Q = kChunk, R = kRows, LDQ = Q + 1;
  const int ldn = N + 1;
  extern __shared__ float smem[];
  float* s_b = smem;             // Q x ldn: B, then B ⊙ w
  float* s_c = s_b + Q * ldn;    // Q x ldn
  float* s_x = s_c + Q * ldn;    // Q x R
  float* s_s = s_x + Q * R;      // Q x LDQ: masked scores
  float* s_st = s_s + Q * LDQ;   // R x ldn: this block's state rows
  float* s_dt = s_st + R * ldn;  // Q
  float* s_cum = s_dt + Q;       // Q: inclusive prefix sum of dt * a
  float* s_ecum = s_cum + Q;     // Q: e^cum
  float* s_w = s_ecum + Q;       // Q: e^(cum_Q - cum) * dt

  const int p0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(R, P - p0);
  const float ah = a[h];
  const size_t st_base = (static_cast<size_t>(b) * H + h) * P * N +
                         static_cast<size_t>(p0) * N;
  for (int i = tid; i < R * N; i += kThreads) {
    const int r = i / N, n = i % N;
    s_st[r * ldn + n] = init_state != nullptr && r < rows
                            ? init_state[st_base + static_cast<size_t>(i)]
                            : 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int len = min(Q, L - t0);
    __syncthreads();  // the previous sub-chunk's readers are done
    const size_t row0 = static_cast<size_t>(b) * L + t0;  // (b, t0)
    for (int i = tid; i < Q; i += kThreads)
      s_dt[i] = i < len ? dt[(row0 + i) * H + h] : 0.f;
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N, n = i % N;
      float vb = 0.f, vc = 0.f;
      if (r < len) {
        vb = bm[row0 * N + i];
        vc = cm[row0 * N + i];
      }
      s_b[r * ldn + n] = vb;
      s_c[r * ldn + n] = vc;
    }
    for (int i = tid; i < Q * R; i += kThreads) {
      const int r = i / R, p = i % R;
      s_x[i] = r < len && p < rows
                   ? x[((row0 + r) * H + h) * P + p0 + p]
                   : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int i = 0; i < Q; ++i) {
        c += s_dt[i] * ah;
        s_cum[i] = c;
      }
    }
    __syncthreads();
    const float cum_last = s_cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      s_ecum[i] = expf(s_cum[i]);
      s_w[i] = expf(cum_last - s_cum[i]) * s_dt[i];
    }

    // scores: (C B^T)[i, j] * e^(cum_i - cum_j) * dt_j for j <= i, else 0
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = s_c[(ti + 16 * u) * ldn + n];
#pragma unroll
        for (int v = 0; v < 4; ++v) bv[v] = s_b[(tj + 16 * v) * ldn + n];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(cv[u], bv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ti + 16 * u, j = tj + 16 * v;
          s_s[i * LDQ + j] =
              j <= i ? acc[u][v] * expf(s_cum[i] - s_cum[j]) * s_dt[j] : 0.f;
        }
    }
    __syncthreads();

    // y rows: scores @ x + e^cum_i * (C @ state^T), the state as it was
    // before this sub-chunk; meanwhile B's rows are scaled by w
    {
      const int ti = tid / 8, tp = tid % 8;
      float acc[2][4], off[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = off[u][v] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        float sv[2], xv[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) sv[u] = s_s[(ti + 32 * u) * LDQ + j];
#pragma unroll
        for (int v = 0; v < 4; ++v) xv[v] = s_x[j * R + tp + 8 * v];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(sv[u], xv[v], acc[u][v]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[2], sv[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) cv[u] = s_c[(ti + 32 * u) * ldn + n];
#pragma unroll
        for (int v = 0; v < 4; ++v) sv[v] = s_st[(tp + 8 * v) * ldn + n];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) off[u][v] = fmaf(cv[u], sv[v], off[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = ti + 32 * u;
        if (i >= len) continue;
        float* yr = y + ((row0 + i) * H + h) * P + p0;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = tp + 8 * v;
          if (p < rows) yr[p] = acc[u][v] + s_ecum[i] * off[u][v];
        }
      }
      for (int i = tid; i < Q * N; i += kThreads) {
        const int r = i / N, n = i % N;
        s_b[r * ldn + n] *= s_w[r];
      }
    }
    __syncthreads();

    // state <- state * e^(cum_Q) + x^T (B ⊙ w)
    {
      const int tp = tid / 32, tn = tid % 32;
      const float total = expf(cum_last);
      for (int n0 = 0; n0 < N; n0 += 128) {
        bool live[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) live[v] = n0 + tn + 32 * v < N;
        float acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 4
        for (int j = 0; j < Q; ++j) {
          float xv[4], bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) xv[u] = s_x[j * R + tp + 8 * u];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            bv[v] = live[v] ? s_b[j * ldn + n0 + tn + 32 * v] : 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xv[u], bv[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (!live[v]) continue;
            float* s = s_st + (tp + 8 * u) * ldn + n0 + tn + 32 * v;
            *s = *s * total + acc[u][v];
          }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * N; i += kThreads)
    final_state[st_base + i] = s_st[(i / N) * ldn + i % N];
}

int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* init_state, void* y,
           void* final_state, int B, int L, int H, int P, int N,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  auto kernel = ssd_scan_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // the next launch starts clean
      return err;
    }
  }
  const dim3 grid((P + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(init_state),
      static_cast<float*>(y), static_cast<float*>(final_state), L, H, P, N);
  return cudaGetLastError();
}

}  // namespace

// x, dt, a, bm, cm, init_state (or null), y, final_state f32.  Shapes and
// contiguity are the wrapper's to check (repro_torch/kernels/ssd_scan.py);
// B, H, P, N >= 1 and L >= 1.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* bm, const void* cm,
                        const void* init_state, void* y, void* final_state,
                        int B, int L, int H, int P, int N, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0)
    return cudaErrorInvalidValue;
  return launch(x, dt, a, bm, cm, init_state, y, final_state, B, L, H, P, N,
                static_cast<cudaStream_t>(stream));
}
