// Bounded-degree linear combination through a static neighbour table, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/diffusion_mix.py::gather_mix (_gather_mix_kernel):
//
//   out[k, j] = sum_s gw[k, s] * W[idx[k, s], j],   s = 0 .. D-1 in order,
//
// where idx is the (K, D) int32 neighbour table (slot 0 = self, padding
// slots repeat self) and gw the (K, D) float32 realized weights (padding
// exactly 0).  The sum is the first product, then fmaf slot by slot.  An
// inactive agent's weights are (1, 0, ..., 0), so its row comes back
// exactly whenever the gathered values are finite.
//
// Bound: device-memory bytes.  The function reads the (K, M) float32 stack
// once and writes the (K, M) result once, 8 K M bytes (10.37 ms at K = 12,
// M = 361,821,120 on an H100's 3.35 TB/s), against 2 D K M float32
// operations, D/4 per byte: far below the card's float32 ridge.
//
// What the design does about it.  Every target reads D rows, so a kernel
// that serves one target per block reads each row D times, from L2 at best
// (D K M 4 bytes of L2 traffic: 4x the bytes that must move at serving's
// D = 8).  Here a block owns a group of R consecutive targets (the plan of
// kernels/gather_mix.py::stage_plan: R, the group's U distinct rows, and
// each slot's position among them) and walks column chunks.  It stages the
// U rows of a chunk once, with 16-byte cp.async copies one chunk ahead
// (gather_stage.cuh: rows of any phase, so the odd M of a K = 12
// column tile too), and computes all R x C outputs from shared memory: each
// thread owns C / 256 columns, reads a slot's (position, weight) once as a
// broadcast and its values conflict-free.  Device reads are U/R times the
// stack (1 for a ring of K <= 16 and for FedAvg up to K = 16).  Results go
// through a shared output tile to 16-byte stores.  Chunks of 1024, 768 or
// 512 columns, the widest at which two blocks of 256 threads fit an SM.
//
// A table whose groups cannot stage a union of at most 16 rows (FedAvg at
// larger K, where D = K) takes the second route of this kernel: block b
// serves target b % K of a 1024-column chunk, reading its D rows with
// 4-byte __ldg loads, and the K targets of a chunk running side by side
// let the 50 MB L2 serve the repeated reads.  The plan chooses the route
// (rows == nullptr: the one-target route); one launch either way.
//
// Offsets are 64-bit (idx[k, s] * M + j passes 2^31 at full width).  Plain
// float32 FMAs, no tensor cores (TF32 would break the 1e-5 parity with the
// reference); any M and any D up to the wrapper's MAX_SLOTS.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/gather_mix.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gather_stage.cuh"

namespace {

using namespace gather_stage;

// ---------------------------------------------------------------- group route

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
gather_group_kernel(const int* __restrict__ idx, const float* __restrict__ gw,
                    const float* __restrict__ W, float* __restrict__ out,
                    const int* __restrict__ rows,
                    const int* __restrict__ slot, int K, int D, int64_t M,
                    int R, int U, int64_t nchunks) {
  constexpr int S = C + 4;               // staged row stride, floats
  constexpr int V = C / kThreads;        // columns per thread
  extern __shared__ __align__(16) float smem[];
  float* tile = smem + kStages * U * S;                  // (R, S) outputs
  int2* ent = reinterpret_cast<int2*>(tile + R * S);     // (R, D) slots
  int* s_q = reinterpret_cast<int*>(ent + R * D);        // (R,) out phase

  const int64_t total = (int64_t)((K + R - 1) / R) * nchunks;
  const int64_t KM = (int64_t)K * M;
  const int64_t step = gridDim.x;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    const int64_t pre = blockIdx.x + p * step;
    if (pre < total) {
      const Item it = item_at<C>(pre, nchunks, M);
      stage_chunk<C>(smem + p * U * S, rows + it.g * U, U, W, M, KM, it);
    }
    cp_async_commit();
  }
  int cur = -1;
  int n = 0;
  for (int64_t item = blockIdx.x; item < total; item += step, ++n) {
    const int64_t ahead = item + (kStages - 1) * step;
    if (ahead < total) {
      const Item it = item_at<C>(ahead, nchunks, M);
      stage_chunk<C>(smem + ((n + kStages - 1) % kStages) * U * S,
                     rows + it.g * U, U, W, M, KM, it);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();              // this chunk staged; last tile written

    const Item it = item_at<C>(item, nchunks, M);
    const int first = it.g * R;
    const int nt = min(R, K - first);
    if (it.g != cur) {
      // slot (staged position + phase, weight) of each target of the group
      for (int e = threadIdx.x; e < nt * D; e += kThreads) {
        const int64_t ks = (int64_t)first * D + e;
        const int r = __ldg(idx + ks);
        ent[e] = make_int2(__ldg(slot + ks) * S + phase_of(W + (int64_t)r * M),
                           __float_as_int(__ldg(gw + ks)));
      }
      for (int t = threadIdx.x; t < nt; t += kThreads)
        s_q[t] = phase_of(out + (int64_t)(first + t) * M);
      __syncthreads();
      cur = it.g;
    }

    const float* buf = smem + (n % kStages) * U * S + threadIdx.x;
    for (int t = 0; t < nt; ++t) {
      const int2* e = ent + t * D;
      float acc[V];
      {
        const int2 m = e[0];
        const float w = __int_as_float(m.y);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = w * buf[m.x + v * kThreads];
      }
      for (int s = 1; s < D; ++s) {
        const int2 m = e[s];
        const float w = __int_as_float(m.y);
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = fmaf(w, buf[m.x + v * kThreads], acc[v]);
      }
      float* o = tile + t * S + s_q[t] + threadIdx.x;
#pragma unroll
      for (int v = 0; v < V; ++v) o[v * kThreads] = acc[v];
    }
    __syncthreads();              // the tile is complete
    store_chunk<C>(out, tile, R, nt, M, it);
  }
  cp_async_wait<0>();
}

template <int C>
cudaError_t group_shape(int K, int D, int64_t M, int R, int U, int* blocks,
                        size_t* smem) {
  const int64_t items = (int64_t)((K + R - 1) / R) * ((M + C - 1) / C);
  const size_t extra = (size_t)R * D * sizeof(int2) + (size_t)R * sizeof(int);
  *smem = smem_bytes<C>(U, R, extra);
  return grid_for(gather_group_kernel<C>, *smem, items, blocks);
}

template <int C>
cudaError_t launch_group(const int* idx, const float* gw, const float* W,
                         float* out, int K, int D, int64_t M,
                         const int* rows, const int* slot, int R, int U,
                         cudaStream_t stream) {
  int blocks = 0;
  size_t smem = 0;
  cudaError_t err = group_shape<C>(K, D, M, R, U, &blocks, &smem);
  if (err != cudaSuccess) return err;
  gather_group_kernel<C><<<blocks, kThreads, smem, stream>>>(
      idx, gw, W, out, rows, slot, K, D, M, R, U, (M + C - 1) / C);
  return cudaGetLastError();
}

// The chunk of the group route: the widest of 1024, 768 and 512 columns
// at which two blocks of 256 threads still fit an SM with their rings and
// output tiles (U >= R, so U bounds both).
int chunk_for(int U) { return U <= 8 ? 1024 : U <= 12 ? 768 : 512; }

template <class Fn>
cudaError_t at_chunk(int U, Fn fn) {
  switch (chunk_for(U)) {
    case 1024: return fn(std::integral_constant<int, 1024>());
    case 768: return fn(std::integral_constant<int, 768>());
    default: return fn(std::integral_constant<int, 512>());
  }
}

// ----------------------------------------------------------- one-target route

constexpr int kCols = 4;              // columns per thread
constexpr int kChunk = kThreads * kCols;
constexpr int kBlocksPerSM = 8;

__global__ void __launch_bounds__(kThreads)
gather_target_kernel(const int* __restrict__ idx, const float* __restrict__ gw,
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

cudaError_t launch_target(const int* idx, const float* gw, const float* W,
                          float* out, int K, int D, int64_t M,
                          cudaStream_t stream) {
  const size_t smem = (size_t)D * (sizeof(int) + sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gather_target_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t nchunks = (M + kChunk - 1) / kChunk;
  const int64_t need = (int64_t)K * nchunks;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  const int blocks = (int)(need < cap ? need : cap);
  gather_target_kernel<<<blocks, kThreads, smem, stream>>>(idx, gw, W, out,
                                                           K, D, M, nchunks);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success).  idx (K, D) int32, gw (K, D)
// float32, W and out (K, M) float32: device pointers, row-major.  rows
// (G, U) and slot (K, D) int32 are the plan of the group route, groups of
// R targets (G = ceil(K / R)); rows == nullptr takes the one-target route.
extern "C" int gather_mix_launch(const int* idx, const float* gw,
                                 const float* W, float* out, int K, int D,
                                 int64_t M, const int* rows, const int* slot,
                                 int R, int U, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 0 || D <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  if (rows == nullptr) return (int)launch_target(idx, gw, W, out, K, D, M, s);
  if (slot == nullptr || R < 1 || R > kMaxGroup || U < 1 || U > kMaxRows ||
      R * D > kMaxEntries)
    return (int)cudaErrorInvalidValue;
  return (int)at_chunk(U, [&](auto c) {
    return launch_group<decltype(c)::value>(idx, gw, W, out, K, D, M, rows,
                                            slot, R, U, s);
  });
}

// The group route's launch for these sizes: shape = {blocks, ring depth,
// shared-memory bytes, chunk columns}.  Returns a cudaError_t.
extern "C" int gather_mix_shape(int K, int D, int64_t M, int R, int U,
                                int* shape) {
  int blocks = 0;
  size_t smem = 0;
  const cudaError_t err = at_chunk(U, [&](auto c) {
    return group_shape<decltype(c)::value>(K, D, M, R, U, &blocks, &smem);
  });
  shape[0] = blocks;
  shape[1] = kStages;
  shape[2] = (int)smem;
  shape[3] = chunk_for(U);
  return (int)err;
}
