// Staging of a target group's neighbour rows, shared by the two gather
// kernels (gather_mix.cu, gather_robust_mix.cu) on Hopper (sm_90a).
//
// The group route: a block owns a group of R consecutive targets and walks
// column chunks of kChunk columns.  Per chunk it copies the union U of the
// rows its group reads (the plan's `rows`, at most kMaxRows) from device
// memory into shared memory once, computes every output of the group from
// there into a shared output tile, and writes that tile out.  The copies
// run kStages chunks ahead of the compute (a ring of kStages buffers), so
// the next chunk's bytes are in flight while this one is computed.
//
// Alignment.  A chunk of row r starts at W + r M + c0.  Rows of an odd M
// are not 16-byte aligned, so a row is copied in 16-byte cp.async segments
// from its aligned-down address, and its phase p = (address / 4) mod 4 is
// recorded: column j of the chunk sits at element p + j of the staged row.
// c0 is a multiple of 4, so p is the same for every chunk of a row.  A
// segment that reaches outside the (K, M) buffer (only at its two ends) is
// copied element by element.  The output goes the same way backwards: the
// tile holds column j of target k at element q + j, q the phase of
// out + k M, so the tile's 16-byte words map onto aligned words of the
// output and are written with 16-byte stores, the partial words at the
// chunk's edges element by element.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gather_stage {

constexpr int kThreads = 256;
// staging buffers: the next chunk is copied while this one is computed.  A
// deeper ring that costs a block per SM was slower on an H100, and one that
// did not gained nothing: resident warps matter more than chunks in flight
constexpr int kStages = 2;
// rows a group stages per chunk (U), and slot entries (R x D) it keeps
constexpr int kMaxRows = 16;
constexpr int kMaxEntries = 512;
constexpr int kMaxGroup = 16;

// element phase of a float address within its 16-byte word
__device__ __forceinline__ int phase_of(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a block's work item lies: group g, columns [c0, c0 + width).
struct Item {
  int g;
  int64_t c0;
  int width;
};

template <int C>
__device__ __forceinline__ Item item_at(int64_t item, int64_t nchunks,
                                        int64_t M) {
  Item it;
  it.g = (int)(item / nchunks);
  it.c0 = (item % nchunks) * C;
  const int64_t left = M - it.c0;
  it.width = left < C ? (int)left : C;
  return it;
}

// Issue the copies of one chunk of the group's U rows into `dst` (U rows of
// C + 4 floats).  Every thread of the block calls it; the caller commits.
template <int C>
__device__ __forceinline__ void stage_chunk(float* dst,
                                            const int* __restrict__ rows_g,
                                            int U, const float* W,
                                            int64_t M, int64_t KM,
                                            const Item& it) {
  constexpr int kSeg = C / 4 + 1;       // 16-byte words of a staged row
  const float* end = W + KM;
  for (int e = threadIdx.x; e < U * kSeg; e += kThreads) {
    const int u = e / kSeg;
    const int i = e - u * kSeg;
    const int r = __ldg(rows_g + u);
    if (r < 0) continue;                // padding of a smaller union
    const float* src = W + (int64_t)r * M + it.c0;
    const int p = phase_of(src);
    if (4 * i >= p + it.width) continue;  // past the chunk's last column
    const float* s = src - p + 4 * i;
    float* d = dst + u * (C + 4) + 4 * i;
    if (s >= W && s + 4 <= end) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (s + k >= W && s + k < end) d[k] = __ldg(s + k);
    }
  }
}

// Write the group's output tile (row t holds target g R + t's column j at
// element phase + j) to out[g R + t, c0 + j], t < n.
template <int C>
__device__ __forceinline__ void store_chunk(float* out, const float* tile,
                                            int R, int n, int64_t M,
                                            const Item& it) {
  constexpr int kSeg = C / 4 + 1;
  for (int e = threadIdx.x; e < n * kSeg; e += kThreads) {
    const int t = e / kSeg;
    const int i = e - t * kSeg;
    float* dst = out + (int64_t)(it.g * R + t) * M + it.c0;
    const int q = phase_of(dst);
    const int j0 = 4 * i - q;            // the chunk column of element 0
    if (j0 >= it.width) continue;
    const float* src = tile + t * (C + 4) + 4 * i;
    float* d = dst - q + 4 * i;
    if (j0 >= 0 && j0 + 4 <= it.width) {
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(src);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j0 + k >= 0 && j0 + k < it.width) d[k] = src[k];
    }
  }
}

// Shared memory of the group route: a ring of kStages staging buffers, the
// output tile and `extra` bytes of per-group tables.
template <int C>
__host__ __device__ constexpr size_t smem_bytes(int U, int R, size_t extra) {
  return (size_t)(kStages * U + R) * (C + 4) * sizeof(float) + extra;
}

// Blocks for `items` work items of `kernel` at `smem` bytes: as many as
// fit the card at once, at most one per item.
template <class Kernel>
cudaError_t grid_for(Kernel kernel, size_t smem, int64_t items,
                     int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t cap = (int64_t)sms * per_sm;
  *blocks = (int)(items < cap ? items : cap);
  return cudaSuccess;
}

}  // namespace gather_stage
