// Bounded-degree linear combination through a static neighbor table, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/diffusion_mix.py::gather_mix (_gather_mix_kernel):
//
//   out[k, j] = sum_s gw[k, s] * W[idx[k, s], j],   s = 0 .. D-1 in order,
//
// where idx is the (K, D) int32 neighbor table (slot 0 = self, padding
// slots repeat self) and gw the (K, D) float32 realized weights (padding
// exactly 0).  An inactive agent's weights are (1, 0, ..., 0), so its row
// comes back exactly whenever the gathered values are finite.
//
// Bound: device-memory bytes.  The function reads the (K, M) float32 stack
// once and writes the (K, M) result once, 8 K M bytes (10.37 ms at K = 12,
// M = 361,821,120 on an H100's 3.35 TB/s), against 2 D K M float32
// operations, D/4 per byte: far below the card's float32 ridge.
//
// What the design reads: every target gathers D rows, so a naive sweep
// target by target reads D K M 4 bytes from device memory, D times the
// bound.  The blocks are ordered so that this does not happen: block b
// takes target b % K of column chunk b / K, so the K targets of one chunk
// run side by side and the chunk's K rows (K x 1024 floats, 48 KB at
// K = 12) are pulled from device memory once and served to the other
// D - 1 readers from the 50 MB L2.  A block stages its target's table row
// (idx, gw) in shared memory; each thread owns kCols columns (neighbouring
// threads on neighbouring addresses, so every warp load is coalesced) and
// keeps their kCols accumulators in registers, so each slot issues kCols
// independent loads.  Offsets are 64-bit: idx[k, s] * M + j passes 2^31 at
// full model width.  Plain float32 FMAs, no tensor cores (TF32 would break
// the 1e-5 parity with the reference); any M and any D the shared memory
// holds.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/gather_mix.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;           // columns per thread
constexpr int kChunk = kThreads * kCols;
constexpr int kBlocksPerSM = 8;

__global__ void __launch_bounds__(kThreads)
gather_mix_kernel(const int* __restrict__ idx, const float* __restrict__ gw,
                  const float* __restrict__ W, float* __restrict__ out,
                  int K, int D, int64_t M, int64_t nchunks) {
  extern __shared__ unsigned char smem_raw[];
  int* s_idx = reinterpret_cast<int*>(smem_raw);       // (D,) rows to read
  float* s_w = reinterpret_cast<float*>(s_idx + D);    // (D,) their weights

  const int64_t total = (int64_t)K * nchunks;
  for (int64_t b = blockIdx.x; b < total; b += gridDim.x) {
    const int k = (int)(b % K);
    const int64_t base = (b / K) * kChunk + threadIdx.x;
    __syncthreads();                  // the previous row is no longer read
    for (int s = threadIdx.x; s < D; s += blockDim.x) {
      s_idx[s] = idx[(int64_t)k * D + s];
      s_w[s] = gw[(int64_t)k * D + s];
    }
    __syncthreads();

    float acc[kCols];
    {
      const float* row = W + (int64_t)s_idx[0] * M;
      const float w = s_w[0];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int64_t j = base + (int64_t)u * kThreads;
        acc[u] = j < M ? w * __ldg(row + j) : 0.0f;
      }
    }
    for (int s = 1; s < D; ++s) {
      const float* row = W + (int64_t)s_idx[s] * M;
      const float w = s_w[s];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int64_t j = base + (int64_t)u * kThreads;
        if (j < M) acc[u] = fmaf(w, __ldg(row + j), acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int64_t j = base + (int64_t)u * kThreads;
      if (j < M) out[(int64_t)k * M + j] = acc[u];
    }
  }
}

}  // namespace

// Returns a cudaError_t (0 on success).  idx (K, D) int32, gw (K, D)
// float32, W and out (K, M) float32: device pointers, row-major.
extern "C" int gather_mix_launch(const int* idx, const float* gw,
                                 const float* W, float* out, int K, int D,
                                 int64_t M, void* stream) {
  if (K <= 0 || D <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)D * (sizeof(int) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gather_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t nchunks = (M + kChunk - 1) / kChunk;
  const int64_t need = (int64_t)K * nchunks;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  const int blocks = (int)(need < cap ? need : cap);
  gather_mix_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      idx, gw, W, out, K, D, M, nchunks);
  return (int)cudaGetLastError();
}
