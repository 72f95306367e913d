// Fused dequantize + eq.-20 mask + mix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/diffusion_mix.py::diffusion_mix_int8 (_mix_int8_kernel with
// _masked_matrix): out = A_eff^T C, or (A_eff - I)^T C with
// subtract_identity, where C[l, j] = Wq[l, j] * scales[l, j / tile_m] is the
// int8 stack dequantized with one float32 scale per (agent, tile of tile_m
// columns), and A_eff is the realized combination matrix of eq. (20),
// rebuilt from the (K, K) base matrix A and the (K,) activation mask inside
// every block.
//
// Bound: device-memory bytes.  The kernel reads the (K, M) int8 stack and
// its K * M / tile_m scales once and writes the (K, M) float32 result once,
// about 5 K M bytes, against 2 K^2 M float32 operations: K / 2.5 operations
// per byte, below the card's float32 ridge up to K of about 50.  So, as in
// diffusion_mix.cu, every byte goes through a single pass:
//   * A_eff (K*K floats) lives in shared memory, built once per block, so
//     K <= 240; the whole warp reads the same entry, a broadcast;
//   * each thread owns a column j: it reads the K int8 values of the column
//     (neighbouring threads on neighbouring bytes) and each agent's scale of
//     the column's tile (a warp's 32 columns share one tile, since tile_m is
//     a multiple of 128: another broadcast), dequantizes in registers and
//     accumulates out[k, j] = sum_l A_eff[l, k] C[l, j] in float32,
//     CHUNK output agents per pass (a K beyond CHUNK re-reads the column
//     from L1);
//   * columns are walked by a grid-stride loop with 64-bit offsets, since
//     K * M exceeds 2^31 at full model width.
// Plain float32 FMA, no tensor cores: the reference's gate is atol 1e-4 /
// rtol 1e-5 in float32.  Loads are one byte a thread; vector loads are
// left for a later version.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/diffusion_mix_int8.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

template <int CHUNK>
__global__ void __launch_bounds__(kThreads)
diffusion_mix_int8_kernel(const float* __restrict__ A,
                          const float* __restrict__ active,
                          const signed char* __restrict__ Wq,
                          const float* __restrict__ scales,
                          float* __restrict__ out,
                          int K, int64_t M, int64_t tile_m,
                          int64_t num_tiles, int subtract_identity) {
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
  // self weight: m (1 - masked column off-sum) + (1 - m), then minus the
  // identity when the caller wants the combination delta
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float col = 0.0f;
    for (int l = 0; l < K; ++l) col += a_eff[l * K + k];
    float diag = m[k] * (1.0f - col) + (1.0f - m[k]);
    if (subtract_identity) diag -= 1.0f;
    a_eff[k * K + k] = diag;
  }
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < M;
       j += stride) {
    const int64_t t = j / tile_m;
    for (int k0 = 0; k0 < K; k0 += CHUNK) {
      float acc[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) acc[c] = 0.0f;
#pragma unroll 4
      for (int l = 0; l < K; ++l) {
        const float w = (float)__ldg(Wq + (int64_t)l * M + j)
                        * __ldg(scales + (int64_t)l * num_tiles + t);
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
cudaError_t launch(const float* A, const float* active, const signed char* Wq,
                   const float* scales, float* out, int K, int64_t M,
                   int64_t tile_m, int subtract_identity,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(K * K + K) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      diffusion_mix_int8_kernel<CHUNK>,
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
  diffusion_mix_int8_kernel<CHUNK><<<blocks, kThreads, smem, stream>>>(
      A, active, Wq, scales, out, K, M, tile_m, M / tile_m,
      subtract_identity);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success).  A (K, K), active (K,), scales
// (K, M / tile_m) and out (K, M) are float32 device pointers, Wq (K, M)
// int8, all row-major; M is a multiple of tile_m.
extern "C" int diffusion_mix_int8_launch(const float* A, const float* active,
                                         const signed char* Wq,
                                         const float* scales, float* out,
                                         int K, int64_t M, int64_t tile_m,
                                         int subtract_identity,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 4)
    return (int)launch<4>(A, active, Wq, scales, out, K, M, tile_m,
                          subtract_identity, s);
  if (K <= 8)
    return (int)launch<8>(A, active, Wq, scales, out, K, M, tile_m,
                          subtract_identity, s);
  return (int)launch<16>(A, active, Wq, scales, out, K, M, tile_m,
                         subtract_identity, s);
}
