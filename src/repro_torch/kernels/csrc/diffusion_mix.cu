// Fused eq.-20 mask-and-mix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/diffusion_mix.py::diffusion_mix
// (_mix_kernel with _masked_matrix): out = A_eff^T W, where A_eff is the
// realized combination matrix of eq. (20), rebuilt from the (K, K) base
// matrix A and the (K,) activation mask inside every block.
//
// Bound: device-memory bytes.  The kernel reads the (K, M) float32 stack
// once and writes the (K, M) result once (8 K M bytes) against 2 K^2 M
// float32 operations, about K/4 operations per byte: far below the card's
// float32 ridge for the K <= 64 of the design range.  So the design keeps
// every byte of W and out to a single pass:
//   * A_eff (K*K floats) lives in shared memory, built once per block; the
//     whole warp reads the same A_eff entry, a broadcast;
//   * each thread owns a column j of W, reads W[0..K-1, j] (neighbouring
//     threads on neighbouring addresses, so every warp load is coalesced)
//     and accumulates out[k, j] = sum_l A_eff[l, k] W[l, j] in float32
//     registers, CHUNK output agents per pass (a K beyond CHUNK re-reads the
//     column, which the thread has just pulled into L1);
//   * columns are walked by a grid-stride loop with 64-bit offsets, since
//     K * M exceeds 2^31 at full model width.
// Plain FMA in float32, no tensor cores: TF32 would break the 1e-5 parity
// with the reference.  Any M is taken; there is no padding contract.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/diffusion_mix.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

template <int CHUNK>
__global__ void __launch_bounds__(kThreads)
diffusion_mix_kernel(const float* __restrict__ A,
                     const float* __restrict__ active,
                     const float* __restrict__ W,
                     float* __restrict__ out,
                     int K, int64_t M) {
  extern __shared__ float smem[];
  float* a_eff = smem;          // (K, K), row l = sender, column k = receiver
  float* m = smem + K * K;      // (K,) activation mask

  for (int i = threadIdx.x; i < K; i += blockDim.x) m[i] = active[i];
  __syncthreads();
  // off-diagonal weights survive iff both endpoints are active
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) {
    const int l = i / K;
    const int k = i - l * K;
    a_eff[i] = (l == k) ? 0.0f : A[i] * (m[l] * m[k]);
  }
  __syncthreads();
  // self weight: m (1 - masked column off-sum) + (1 - m)
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float col = 0.0f;
    for (int l = 0; l < K; ++l) col += a_eff[l * K + k];
    a_eff[k * K + k] = m[k] * (1.0f - col) + (1.0f - m[k]);
  }
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < M;
       j += stride) {
    for (int k0 = 0; k0 < K; k0 += CHUNK) {
      float acc[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) acc[c] = 0.0f;
#pragma unroll 4
      for (int l = 0; l < K; ++l) {
        const float w = __ldg(W + (int64_t)l * M + j);
        const float* row = a_eff + l * K + k0;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          if (k0 + c < K) acc[c] = fmaf(row[c], w, acc[c]);
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
        if (k0 + c < K) out[(int64_t)(k0 + c) * M + j] = acc[c];
    }
  }
}

template <int CHUNK>
cudaError_t launch(const float* A, const float* active, const float* W,
                   float* out, int K, int64_t M, cudaStream_t stream) {
  const size_t smem = (size_t)(K * K + K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      diffusion_mix_kernel<CHUNK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t need = (M + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  const int blocks = (int)(need < cap ? need : cap);
  diffusion_mix_kernel<CHUNK><<<blocks, kThreads, smem, stream>>>(
      A, active, W, out, K, M);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success).  A, active, W and out are float32
// device pointers: A (K, K), active (K,), W and out (K, M), row-major.
extern "C" int diffusion_mix_launch(const float* A, const float* active,
                                    const float* W, float* out, int K,
                                    int64_t M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 4) return (int)launch<4>(A, active, W, out, K, M, s);
  if (K <= 8) return (int)launch<8>(A, active, W, out, K, M, s);
  return (int)launch<16>(A, active, W, out, K, M, s);
}
