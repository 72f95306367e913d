// Mamba2 SSD intra-chunk step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_intra_chunk
// (_ssd_chunk_kernel).  For every (batch b, head h, chunk c) of Q tokens,
// with xd (b, s, h, p) the dt-scaled inputs, dA (b, s, h) = dt * A and the
// single-group projections B, C (b, s, n):
//   dA_cs   = cumsum(dA_c)                                        (Q,)
//   Y_diag  = ((C_c B_c^T) o L) xd_c,
//             L_ij = exp(dA_cs_i - dA_cs_j) for j <= i, else 0    (Q, P)
//   state_c = xd_c^T (B_c o exp(dA_cs_Q - dA_cs))                 (P, N)
// All three outputs are float32: Y_diag (b, s, h, p), states
// (b, nc, h, p, n), dA_cumsum (b, s, h).
//
// Bound.  Per block the products C B^T (Q^2 N), S xd (Q^2 P) and the state
// (Q P N) are some 4 M multiply-adds at mamba2's shape (Q = 128, N = 128,
// P = 64) against about 100 KB of inputs and outputs: far above the card's
// float32 ridge, so the kernel is bound by operations.  Every product is a
// scalar float32 FMA, no tensor cores: TF32 would break the reference's
// float32 gate of 2e-3.
//
// Design, one block of 256 threads (16 x 16) per (head, chunk, batch):
//   * the chunk's B and C are staged in shared memory as float32 rows
//     padded to N + 1 floats (bf16 widened on load; any row stride, so the
//     slices of xBC are read in place), xd as (Q, P) float32 rows;
//   * warp 0 forms dA_cs with a shuffle scan (Q / 32 values a lane) and
//     writes it out; every j gets its decay exp(dA_cs_Q - dA_cs_j);
//   * state: thread (ty, tx) owns p = ty + 16a, n = tx + 16e; the sum over
//     the chunk runs in registers;
//   * scores: the same thread owns rows i = ty + 16a and keys j = tx + 16e
//     of C B^T, summed over n in registers; the decay factor exp(dA_cs_i -
//     dA_cs_j) is computed (expf, not a fast-math exponential) only where
//     j <= i, and the rest is 0, so the masked triangle never meets an
//     exponential (dA < 0 keeps every kept factor <= 1);
//   * once B and C are consumed, the scores overwrite them in shared memory
//     ((Q, Q + 1) floats), and Y_diag = S xd is summed in registers,
//     thread (ty, tx) owning rows i = ty + 16a and columns p = tx + 16e.
// Padded rows put the 16 threads that read 16 different rows of B, C or S
// on 16 different banks.  Shared memory is max(2 Q (N + 1), Q (Q + 1)) +
// Q P + 2 Q floats: 165,888 bytes at mamba2's shape, so above 48 KB the
// launch opts in (up to 227 KB).  Offsets are 64-bit throughout.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/ssd_scan.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxState = 128;   // N
constexpr int kNE = kMaxState / 16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ constexpr int64_t region_floats(int Q, int N) {
  return (int64_t)2 * Q * (N + 1) > (int64_t)Q * (Q + 1)
             ? (int64_t)2 * Q * (N + 1)
             : (int64_t)Q * (Q + 1);
}

template <typename T, int Q, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_chunk_kernel(const float* __restrict__ xd,
                       const float* __restrict__ dA,
                       const T* __restrict__ B, const T* __restrict__ C,
                       float* __restrict__ y, float* __restrict__ states,
                       float* __restrict__ dacs, int S, int H, int N,
                       int64_t b_sb, int64_t b_ss, int64_t c_sb,
                       int64_t c_ss) {
  constexpr int R = Q / 16;      // score / output rows per thread
  constexpr int RP = P / 16;     // output columns (state rows) per thread
  constexpr int QP = Q + 1;      // padded row of the score tile
  const int NP = N + 1;          // padded row of the B and C tiles

  extern __shared__ float smem[];
  float* Bs = smem;                                  // (Q, N + 1)
  float* Cs = smem + (int64_t)Q * NP;                // (Q, N + 1)
  float* Ss = smem;                                  // (Q, Q + 1), later
  float* xs = smem + region_floats(Q, N);            // (Q, P)
  float* cs = xs + Q * P;                            // (Q,)
  float* dec = cs + Q;                               // (Q,)

  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t t0 = (int64_t)c * Q;                 // first token of chunk
  const int64_t row0 = b * S + t0;                   // its (b, s) row

  // ---- stage xd, B, C -----------------------------------------------------
  for (int idx = tid; idx < Q * P; idx += kThreads) {
    const int j = idx / P;
    const int p = idx - j * P;
    xs[idx] = xd[((row0 + j) * H + h) * P + p];
  }
  for (int idx = tid; idx < Q * N; idx += kThreads) {
    const int j = idx / N;
    const int n = idx - j * N;
    Bs[j * NP + n] = widen(B[b * b_sb + (t0 + j) * b_ss + n]);
    Cs[j * NP + n] = widen(C[b * c_sb + (t0 + j) * c_ss + n]);
  }

  // ---- dA_cs: warp 0, Q / 32 consecutive values a lane ---------------------
  if (tid < 32) {
    constexpr int PER = Q / 32;
    float v[PER];
    float run = 0.0f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      run += dA[(row0 + tid * PER + k) * H + h];
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.0f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const float val = excl + v[k];
      cs[tid * PER + k] = val;
      dacs[(row0 + tid * PER + k) * H + h] = val;
    }
  }
  __syncthreads();
  for (int j = tid; j < Q; j += kThreads) dec[j] = expf(cs[Q - 1] - cs[j]);
  __syncthreads();

  // ---- state = xd^T (B o decay) --------------------------------------------
  {
    float acc[RP][kNE];
#pragma unroll
    for (int a = 0; a < RP; ++a)
#pragma unroll
      for (int e = 0; e < kNE; ++e) acc[a][e] = 0.0f;
    for (int j = 0; j < Q; ++j) {
      const float dj = dec[j];
      float xv[RP];
      float bv[kNE];
#pragma unroll
      for (int a = 0; a < RP; ++a) xv[a] = xs[j * P + ty + 16 * a] * dj;
#pragma unroll
      for (int e = 0; e < kNE; ++e) {
        const int n = tx + 16 * e;
        bv[e] = n < N ? Bs[j * NP + n] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < RP; ++a)
#pragma unroll
        for (int e = 0; e < kNE; ++e) acc[a][e] = fmaf(xv[a], bv[e], acc[a][e]);
    }
    const int64_t st0 = ((b * gridDim.y + c) * H + h) * (int64_t)P;
#pragma unroll
    for (int a = 0; a < RP; ++a)
#pragma unroll
      for (int e = 0; e < kNE; ++e) {
        const int n = tx + 16 * e;
        if (n < N) states[(st0 + ty + 16 * a) * N + n] = acc[a][e];
      }
  }

  // ---- scores S = (C B^T) o L ----------------------------------------------
  float sc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int e = 0; e < R; ++e) sc[a][e] = 0.0f;
  for (int n = 0; n < N; ++n) {
    float cv[R];
    float bv[R];
#pragma unroll
    for (int a = 0; a < R; ++a) cv[a] = Cs[(ty + 16 * a) * NP + n];
#pragma unroll
    for (int e = 0; e < R; ++e) bv[e] = Bs[(tx + 16 * e) * NP + n];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int e = 0; e < R; ++e) sc[a][e] = fmaf(cv[a], bv[e], sc[a][e]);
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = ty + 16 * a;
    const float ci = cs[i];
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int j = tx + 16 * e;
      sc[a][e] = j <= i ? sc[a][e] * expf(ci - cs[j]) : 0.0f;
    }
  }
  __syncthreads();               // every read of B and C is done
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int e = 0; e < R; ++e) Ss[(ty + 16 * a) * QP + tx + 16 * e] = sc[a][e];
  __syncthreads();

  // ---- Y_diag = S xd -------------------------------------------------------
  float acc[R][RP];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int e = 0; e < RP; ++e) acc[a][e] = 0.0f;
  for (int j = 0; j < Q; ++j) {
    float sv[R];
    float xv[RP];
#pragma unroll
    for (int a = 0; a < R; ++a) sv[a] = Ss[(ty + 16 * a) * QP + j];
#pragma unroll
    for (int e = 0; e < RP; ++e) xv[e] = xs[j * P + tx + 16 * e];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int e = 0; e < RP; ++e) acc[a][e] = fmaf(sv[a], xv[e], acc[a][e]);
  }
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int e = 0; e < RP; ++e)
      y[((row0 + ty + 16 * a) * H + h) * P + tx + 16 * e] = acc[a][e];
}

template <typename T, int Q, int P>
cudaError_t launch(const float* xd, const float* dA, const void* B,
                   const void* C, float* y, float* states, float* dacs,
                   int batch, int S, int H, int N, int64_t b_sb,
                   int64_t b_ss, int64_t c_sb, int64_t c_ss,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)(region_floats(Q, N) + (int64_t)Q * P + 2 * Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel<T, Q, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, S / Q, batch);
  ssd_intra_chunk_kernel<T, Q, P><<<grid, kThreads, smem, stream>>>(
      xd, dA, static_cast<const T*>(B), static_cast<const T*>(C), y, states,
      dacs, S, H, N, b_sb, b_ss, c_sb, c_ss);
  return cudaGetLastError();
}

template <typename T, int Q>
cudaError_t by_head_dim(int P, const float* xd, const float* dA,
                        const void* B, const void* C, float* y,
                        float* states, float* dacs, int batch, int S, int H,
                        int N, int64_t b_sb, int64_t b_ss, int64_t c_sb,
                        int64_t c_ss, cudaStream_t stream) {
  switch (P) {
    case 16:
      return launch<T, Q, 16>(xd, dA, B, C, y, states, dacs, batch, S, H, N,
                              b_sb, b_ss, c_sb, c_ss, stream);
    case 32:
      return launch<T, Q, 32>(xd, dA, B, C, y, states, dacs, batch, S, H, N,
                              b_sb, b_ss, c_sb, c_ss, stream);
    case 64:
      return launch<T, Q, 64>(xd, dA, B, C, y, states, dacs, batch, S, H, N,
                              b_sb, b_ss, c_sb, c_ss, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_chunk(int Q, int P, const float* xd, const float* dA,
                     const void* B, const void* C, float* y, float* states,
                     float* dacs, int batch, int S, int H, int N,
                     int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
                     cudaStream_t stream) {
  switch (Q) {
    case 32:
      return by_head_dim<T, 32>(P, xd, dA, B, C, y, states, dacs, batch, S,
                                H, N, b_sb, b_ss, c_sb, c_ss, stream);
    case 64:
      return by_head_dim<T, 64>(P, xd, dA, B, C, y, states, dacs, batch, S,
                                H, N, b_sb, b_ss, c_sb, c_ss, stream);
    case 128:
      return by_head_dim<T, 128>(P, xd, dA, B, C, y, states, dacs, batch, S,
                                 H, N, b_sb, b_ss, c_sb, c_ss, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 on success).  xd (batch, S, H, P), dA (batch,
// S, H), y (batch, S, H, P), states (batch, S / Q, H, P, N) and dacs
// (batch, S, H) are contiguous float32 device pointers; B and C are
// (batch, S, N) of `dtype` (0 float32, 1 bfloat16) with unit stride in N
// and element strides b_sb / b_ss (c_sb / c_ss) over batch and sequence.
// Q in {32, 64, 128}, P in {16, 32, 64}, 1 <= N <= 128, S % Q == 0.
extern "C" int ssd_intra_chunk_launch(const float* xd, const float* dA,
                                      const void* B, const void* C, float* y,
                                      float* states, float* dacs, int dtype,
                                      int batch, int S, int H, int P, int N,
                                      int Q, int64_t b_sb, int64_t b_ss,
                                      int64_t c_sb, int64_t c_ss,
                                      void* stream) {
  if (N < 1 || N > kMaxState || Q <= 0 || S % Q != 0 || S / Q > 65535 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)by_chunk<float>(Q, P, xd, dA, B, C, y, states, dacs, batch,
                                S, H, N, b_sb, b_ss, c_sb, c_ss, s);
  if (dtype == 1)
    return (int)by_chunk<__nv_bfloat16>(Q, P, xd, dA, B, C, y, states, dacs,
                                        batch, S, H, N, b_sb, b_ss, c_sb,
                                        c_ss, s);
  return (int)cudaErrorInvalidValue;
}
