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
// Bound: device-memory bytes up to K of about 50.  The kernel reads the
// (K, M) int8 stack and its K * M / tile_m scales once and writes the
// (K, M) float32 result once, about 5 K M bytes, four fifths of them
// writes, against 2 K^2 M float32 operations (K / 2.5 operations a byte,
// below the card's float32 ridge of about 20 up to K of about 50).  Past
// that the float32 FMAs bound it.  Design:
//   * A_eff lives in shared memory, built once per block, rows padded to a
//     multiple of 4 floats so that one 16-byte broadcast read brings 4
//     receivers' weights; K <= 240 (231 KB);
//   * each thread owns kVec = 4 consecutive columns (tile_m is a multiple
//     of 128, so the 4 share a tile and one scale a row): one 4-byte load
//     brings a row's 4 int8 values, each A_eff entry read feeds 4 FMAs, and
//     a row of results leaves in one 16-byte store with the streaming
//     (evict-first) hint, since the output passes through L2 once.  A
//     warp's loads cover one 128-byte line a row and its stores 512
//     contiguous bytes;
//   * up to K = 16 (the rows route) every row's load of a column group is
//     issued before the first FMA, so K loads a thread are in flight, and
//     the receivers are accumulated 8 at a time over the loaded rows (no
//     spill); past 16 (the passes route) 16 or 32 receivers a pass over
//     all K senders, the group's rows re-read from L1 or L2;
//   * columns are walked by a grid-stride loop with 64-bit offsets (K * M
//     exceeds 2^31 at full model width); the tile index advances with the
//     stride instead of a 64-bit division a group.
// On an H100 (80 GB HBM3, 700 W) the path's tile (K = 8, 33,554,432
// columns) moves about 81 % of 3.35 TB/s (chip_smoke.py phase 13), as
// fast as a plain copy of the same bytes; 8- and 16-column threads, whose
// 16-byte stores no longer cover contiguous warp spans, and write-back
// stores were slower.
// Each output is the float32 FMA chain over l = 0 .. K-1 of
// A_eff[l, k] * (float(q) * scale), the product rounded first, as in the
// one-column-a-thread design this replaces: results are bit-equal to it.
// That design stays as the scalar route, for operands the vector routes
// cannot take: a Wq or out not aligned to 4 and 16 bytes (a view at a
// storage offset), or a tile_m not a multiple of kVec.  Plain float32 FMA,
// no tensor cores: the reference's gate is atol 1e-4 / rtol 1e-5 in
// float32.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/diffusion_mix_int8.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// columns a thread on the vector routes (one 4-byte load, one 16-byte
// store a row)
constexpr int kVec = 4;
// the rows route's largest K and its receivers a pass
constexpr int kRowsMax = 16;
constexpr int kRowsChunk = 8;
// receivers a pass on the passes route: kChunk (two blocks an SM) up to
// K = kWideFrom - 1, kChunkWide (one block, half the passes over the
// rows) from there; on an H100 the wide pass was slower at K = 64 and
// faster from K = 96 on
constexpr int kChunk = 16;
constexpr int kChunkWide = 32;
constexpr int kWideFrom = 65;

enum Route { kScalar = 0, kRows = 1, kPasses = 2 };

// A_eff of eq. (20) in shared memory, row l = sender, column k = receiver,
// row stride ld >= K (columns past K zero), m the activation mask.
__device__ void build_a_eff(const float* __restrict__ A,
                            const float* __restrict__ active, float* a_eff,
                            float* m, int K, int ld, int subtract_identity) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) m[i] = active[i];
  __syncthreads();
  // off-diagonal weights survive iff both endpoints are active
  for (int i = threadIdx.x; i < K * ld; i += blockDim.x) {
    const int l = i / ld;
    const int k = i - l * ld;
    a_eff[i] = (k >= K || l == k) ? 0.0f : A[l * K + k] * (m[l] * m[k]);
  }
  __syncthreads();
  // self weight: m (1 - masked column off-sum) + (1 - m), then minus the
  // identity when the caller wants the combination delta
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float col = 0.0f;
    for (int l = 0; l < K; ++l) col += a_eff[l * ld + k];
    float diag = m[k] * (1.0f - col) + (1.0f - m[k]);
    if (subtract_identity) diag -= 1.0f;
    a_eff[k * ld + k] = diag;
  }
  __syncthreads();
}

// The tile index t of column j, kept as the grid-stride loop advances j by
// step: j = t * tile_m + r with 0 <= r < tile_m.
struct TileWalk {
  int64_t t, r, dt, dr, tile_m;
  __device__ TileWalk(int64_t j, int64_t step, int64_t tile_m_)
      : tile_m(tile_m_) {
    t = j / tile_m;
    r = j - t * tile_m;
    dt = step / tile_m;
    dr = step - dt * tile_m;
  }
  __device__ void next() {
    t += dt;
    r += dr;
    if (r >= tile_m) {
      r -= tile_m;
      ++t;
    }
  }
};

// a row's kVec = 4 int8 values, one 4-byte load
__device__ __forceinline__ uint32_t load_row(const signed char* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// the 4 values of a loaded row, dequantized: float(q) * s, rounded once
__device__ __forceinline__ void dequant(uint32_t w, float s,
                                        float (&c)[kVec]) {
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    c[v] = (float)(signed char)(w >> (8 * v)) * s;
}

// a row's 4 results, one 16-byte evict-first store
__device__ __forceinline__ void store_row(float* p, const float (&v)[kVec]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// acc[k][v] += A_eff[l, k0 + k] * c[v] for the n receivers k < n (n a
// multiple of 4 or the last receivers), 4 receivers a broadcast read
template <int N>
__device__ __forceinline__ void fma_row(const float* row, int n,
                                        const float (&c)[kVec],
                                        float (&acc)[N][kVec]) {
#pragma unroll
  for (int k4 = 0; k4 < N / 4; ++k4)
    if (4 * k4 < n) {
      const float4 a = reinterpret_cast<const float4*>(row)[k4];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        acc[4 * k4 + 0][v] = fmaf(a.x, c[v], acc[4 * k4 + 0][v]);
        acc[4 * k4 + 1][v] = fmaf(a.y, c[v], acc[4 * k4 + 1][v]);
        acc[4 * k4 + 2][v] = fmaf(a.z, c[v], acc[4 * k4 + 2][v]);
        acc[4 * k4 + 3][v] = fmaf(a.w, c[v], acc[4 * k4 + 3][v]);
      }
    }
}

// The vector routes.  ROWS: K <= KMAX, every row of a column group loaded
// before the FMAs, then the receivers kRowsChunk at a time over them.
// Otherwise KMAX receivers a pass over all K senders.
template <int KMAX, bool ROWS>
__global__ void __launch_bounds__(kThreads)
mix_int8_vec(const float* __restrict__ A, const float* __restrict__ active,
             const signed char* __restrict__ Wq,
             const float* __restrict__ scales, float* __restrict__ out,
             int K, int64_t M, int64_t tile_m, int64_t num_tiles,
             int subtract_identity) {
  extern __shared__ float4 smem4[];
  const int ld = (K + 3) & ~3;
  float* a_eff = reinterpret_cast<float*>(smem4);   // (K, ld)
  float* m = a_eff + K * ld;                         // (K,)
  build_a_eff(A, active, a_eff, m, K, ld, subtract_identity);

  const int64_t groups = M / kVec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  TileWalk walk(g * kVec, stride * kVec, tile_m);
  for (; g < groups; g += stride, walk.next()) {
    const int64_t j = g * kVec;
    const signed char* wq = Wq + j;
    const float* sc = scales + walk.t;
    float* o = out + j;
    if constexpr (ROWS) {
      uint32_t w[KMAX];
      float s[KMAX];
#pragma unroll
      for (int l = 0; l < KMAX; ++l)
        if (l < K) {
          w[l] = load_row(wq + (int64_t)l * M);
          s[l] = __ldg(sc + (int64_t)l * num_tiles);
        }
      // receivers RC at a time over the loaded rows, re-dequantized for
      // each: the accumulators stay at RC * kVec registers
      constexpr int RC = KMAX < kRowsChunk ? KMAX : kRowsChunk;
#pragma unroll
      for (int k0 = 0; k0 < KMAX; k0 += RC)
        if (k0 < K) {
          float acc[RC][kVec];
#pragma unroll
          for (int k = 0; k < RC; ++k)
#pragma unroll
            for (int v = 0; v < kVec; ++v) acc[k][v] = 0.0f;
#pragma unroll
          for (int l = 0; l < KMAX; ++l)
            if (l < K) {
              float c[kVec];
              dequant(w[l], s[l], c);
              fma_row<RC>(a_eff + l * ld + k0, K - k0, c, acc);
            }
#pragma unroll
          for (int k = 0; k < RC; ++k)
            if (k0 + k < K) store_row(o + (int64_t)(k0 + k) * M, acc[k]);
        }
    } else {
      for (int k0 = 0; k0 < K; k0 += KMAX) {
        float acc[KMAX][kVec];
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[k][v] = 0.0f;
        // four senders' loads in flight a thread: fewer were slower at
        // K = 20 to 96 on an H100
#pragma unroll 4
        for (int l = 0; l < K; ++l) {
          float c[kVec];
          dequant(load_row(wq + (int64_t)l * M),
                  __ldg(sc + (int64_t)l * num_tiles), c);
          fma_row<KMAX>(a_eff + l * ld + k0, K - k0, c, acc);
        }
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k0 + k < K) store_row(o + (int64_t)(k0 + k) * M, acc[k]);
      }
    }
  }
}

// The scalar route: one column a thread, one-byte loads, CHUNK receivers a
// pass (a K beyond CHUNK re-reads the column from L1).
template <int CHUNK>
__global__ void __launch_bounds__(kThreads)
mix_int8_scalar(const float* __restrict__ A, const float* __restrict__ active,
                const signed char* __restrict__ Wq,
                const float* __restrict__ scales, float* __restrict__ out,
                int K, int64_t M, int64_t tile_m, int64_t num_tiles,
                int subtract_identity) {
  extern __shared__ float4 smem4[];
  float* a_eff = reinterpret_cast<float*>(smem4);   // (K, K)
  float* m = a_eff + K * K;                          // (K,)
  build_a_eff(A, active, a_eff, m, K, K, subtract_identity);

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

int route_of(int K, int64_t tile_m, const void* Wq, const void* out) {
  const bool vec = tile_m % kVec == 0
                   && reinterpret_cast<uintptr_t>(Wq) % kVec == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec) return kScalar;
  return K <= kRowsMax ? kRows : kPasses;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int64_t items,
                   cudaStream_t stream, const float* A, const float* active,
                   const signed char* Wq, const float* scales, float* out,
                   int K, int64_t M, int64_t tile_m, int subtract_identity) {
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
  const int64_t need = (items + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * per_sm;
  const int blocks = (int)(need < cap ? need : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(A, active, Wq, scales, out, K,
                                             M, tile_m, M / tile_m,
                                             subtract_identity);
  return cudaGetLastError();
}

}  // namespace

// The route diffusion_mix_int8_launch takes for these operands: 0 scalar
// (one column a thread), 1 rows (K <= 16), 2 passes (K > 16).
extern "C" int diffusion_mix_int8_route(int K, int64_t tile_m,
                                        const void* Wq, const void* out) {
  return route_of(K, tile_m, Wq, out);
}

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
  const int route = route_of(K, tile_m, Wq, out);
  if (route == kScalar) {
    const size_t smem = (size_t)(K * K + K) * sizeof(float);
    if (K <= 4)
      return (int)launch(mix_int8_scalar<4>, smem, M, s, A, active, Wq,
                         scales, out, K, M, tile_m, subtract_identity);
    if (K <= 8)
      return (int)launch(mix_int8_scalar<8>, smem, M, s, A, active, Wq,
                         scales, out, K, M, tile_m, subtract_identity);
    return (int)launch(mix_int8_scalar<16>, smem, M, s, A, active, Wq,
                       scales, out, K, M, tile_m, subtract_identity);
  }
  const size_t smem = (size_t)(K * ((K + 3) & ~3) + K) * sizeof(float);
  const int64_t groups = M / kVec;
  if (route == kPasses && K < kWideFrom)
    return (int)launch(mix_int8_vec<kChunk, false>, smem, groups, s, A,
                       active, Wq, scales, out, K, M, tile_m,
                       subtract_identity);
  if (route == kPasses)
    return (int)launch(mix_int8_vec<kChunkWide, false>, smem, groups, s, A,
                       active, Wq, scales, out, K, M, tile_m,
                       subtract_identity);
  if (K <= 4)
    return (int)launch(mix_int8_vec<4, true>, smem, groups, s, A, active,
                       Wq, scales, out, K, M, tile_m, subtract_identity);
  if (K <= 8)
    return (int)launch(mix_int8_vec<8, true>, smem, groups, s, A, active,
                       Wq, scales, out, K, M, tile_m, subtract_identity);
  return (int)launch(mix_int8_vec<kRowsMax, true>, smem, groups, s, A,
                     active, Wq, scales, out, K, M, tile_m,
                     subtract_identity);
}
