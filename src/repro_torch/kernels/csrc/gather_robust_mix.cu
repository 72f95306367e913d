// Fused neighborhood gather + order-statistic aggregation for Hopper
// (sm_90a): the per-neighborhood trimmed mean or median of the robust
// combination step.
//
// Replaces the Pallas TPU kernel
// repro/kernels/diffusion_mix.py::gather_robust_mix (_gather_robust_kernel
// with _bitonic_sort).  For every target k and column j:
//
//   v[s]   = member[k, s] > 0 ? W[idx[k, s], j] : +inf     s = 0 .. D-1
//   srt    = v sorted ascending (padded with +inf to P = 2^ceil(log2 D))
//   out    = sum_s where(wslot[k, s] > 0, srt[s], 0) * wslot[k, s]
//   out[k, j] = active[k] > 0 ? out : W[idx[k, 0], j]     (slot 0 = self)
//
// The contraction runs over the slots in order 0 .. D-1 with a separate
// multiply and add, as the reference writes it, and the where keeps
// 0 * inf = nan out.  An inactive target writes its own float32 row,
// bit-exactly.
//
// Bound: device-memory bytes.  The function reads the (K, M) float32 stack
// once and writes the (K, M) result once, 8 K M bytes: 10.37 ms at K = 12,
// M = 361,821,120 on an H100's 3.35 TB/s (6.91 ms at K = 8).  The sort
// network is about P log2(P)^2 / 4 compare-exchanges per (target, column),
// a few dozen float operations per 8 bytes at D <= 8: below the float32
// ridge, so bytes still bound it.
//
// What the design reads: every target gathers D rows, so a sweep target by
// target reads D K M 4 bytes from device memory, D times the bound.  Block
// b takes target b % K of column chunk b / K, so the K targets of one
// chunk run side by side and the chunk's K rows come from device memory
// once and from the 50 MB L2 for the other readers.  A block stages its
// target's table row (idx, member, wslot, active) in shared memory; each
// thread owns one column at a time and holds its P gathered values in
// registers: the network is unrolled through a template on
// P in {1, 2, 4, 8, 16, 32}, so every index is a compile-time constant and
// nothing spills to local memory.  D > 32 is refused (the wrapper raises
// ValueError).  Non-members are not loaded at all (they become +inf), and
// an inactive target reads only its own row.  Offsets are 64-bit:
// idx[k, s] * M + j passes 2^31 at K = 12 smollm.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/gather_robust_mix.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;             // columns per thread, one at a time
constexpr int kChunk = kThreads * kCols;
constexpr int kBlocksPerSM = 8;
constexpr int kMaxSlots = 32;

// Ascending bitonic sort of P values held in registers (P a power of 2):
// the compare-exchange network of the reference's _bitonic_sort.
template <int P>
__device__ __forceinline__ void bitonic_sort(float (&v)[P]) {
#pragma unroll
  for (int k = 2; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j >= 1; j >>= 1) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const float lo = fminf(v[i], v[l]);
          const float hi = fmaxf(v[i], v[l]);
          if ((i & k) == 0) {
            v[i] = lo;
            v[l] = hi;
          } else {
            v[i] = hi;
            v[l] = lo;
          }
        }
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
gather_robust_kernel(const int* __restrict__ idx,
                     const float* __restrict__ member,
                     const float* __restrict__ wslot,
                     const float* __restrict__ active,
                     const float* __restrict__ W, float* __restrict__ out,
                     int K, int D, int64_t M, int64_t nchunks) {
  __shared__ int s_idx[kMaxSlots];
  __shared__ float s_mem[kMaxSlots];
  __shared__ float s_ws[kMaxSlots];
  __shared__ float s_act;

  const int64_t total = (int64_t)K * nchunks;
  for (int64_t b = blockIdx.x; b < total; b += gridDim.x) {
    const int k = (int)(b % K);
    const int64_t base = (b / K) * kChunk + threadIdx.x;
    __syncthreads();                  // the previous row is no longer read
    if (threadIdx.x < D) {
      const int64_t t = (int64_t)k * D + threadIdx.x;
      s_idx[threadIdx.x] = idx[t];
      s_mem[threadIdx.x] = member[t];
      s_ws[threadIdx.x] = wslot[t];
    }
    if (threadIdx.x == 0) s_act = active[k];
    __syncthreads();

    const float* own_row = W + (int64_t)s_idx[0] * M;
    if (!(s_act > 0.0f)) {
      // inactive target: its own float32 row, bit-exactly
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int64_t j = base + (int64_t)u * kThreads;
        if (j < M) out[(int64_t)k * M + j] = __ldg(own_row + j);
      }
      continue;
    }
#pragma unroll 1
    for (int u = 0; u < kCols; ++u) {
      const int64_t j = base + (int64_t)u * kThreads;
      if (j >= M) break;
      float v[P];
#pragma unroll
      for (int s = 0; s < P; ++s) {
        v[s] = (s < D && s_mem[s] > 0.0f)
                   ? __ldg(W + (int64_t)s_idx[s] * M + j)
                   : CUDART_INF_F;
      }
      bitonic_sort<P>(v);
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < P; ++s) {
        if (s < D) {
          const float w = s_ws[s];
          acc = __fadd_rn(acc, __fmul_rn(w > 0.0f ? v[s] : 0.0f, w));
        }
      }
      out[(int64_t)k * M + j] = acc;
    }
  }
}

template <int P>
cudaError_t launch(const int* idx, const float* member, const float* wslot,
                   const float* active, const float* W, float* out, int K,
                   int D, int64_t M, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t nchunks = (M + kChunk - 1) / kChunk;
  const int64_t need = (int64_t)K * nchunks;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  const int blocks = (int)(need < cap ? need : cap);
  gather_robust_kernel<P><<<blocks, kThreads, 0, stream>>>(
      idx, member, wslot, active, W, out, K, D, M, nchunks);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success).  idx (K, D) int32; member, wslot
// (K, D) float32; active (K,) float32; W and out (K, M) float32: device
// pointers, row-major.  1 <= D <= 32.
extern "C" int gather_robust_mix_launch(const int* idx, const float* member,
                                        const float* wslot,
                                        const float* active, const float* W,
                                        float* out, int K, int D, int64_t M,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 0 || D <= 0 || D > kMaxSlots || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (D <= 1) return (int)launch<1>(idx, member, wslot, active, W, out, K, D, M, s);
  if (D <= 2) return (int)launch<2>(idx, member, wslot, active, W, out, K, D, M, s);
  if (D <= 4) return (int)launch<4>(idx, member, wslot, active, W, out, K, D, M, s);
  if (D <= 8) return (int)launch<8>(idx, member, wslot, active, W, out, K, D, M, s);
  if (D <= 16) return (int)launch<16>(idx, member, wslot, active, W, out, K, D, M, s);
  return (int)launch<32>(idx, member, wslot, active, W, out, K, D, M, s);
}
