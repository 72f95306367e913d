// Flash-attention forward (GQA, causal, optional sliding window) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_flash_kernel): for
// q (B, Sq, H, D) and k, v (B, Skv, Kv, D), row-major and contiguous,
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, g] / sqrt(D)) v[b, j, g]
// with g = h / (H / Kv), absolute positions from 0 for both q and k, the
// causal mask j <= i and the window mask j > i - window.  Masked scores take
// the reference's finite NEG_INF = -1e30 and the final division uses
// max(l, 1e-30), so a row that sees only masked keys averages them exactly
// as the reference does.
//
// Bound.  At the training shape (S = 1024, D = 64) the block does 2 D
// float32 operations per score against a few bytes per key row, far above
// the card's float32 ridge: the kernel is bound by operations.  Scores, the
// running max and denominator and the output accumulator stay in float32
// with plain FMAs, no tensor cores: TF32 would break the reference's 2e-5
// float32 gate.
//
// Design, one block per (query tile of 64 rows, q head, batch):
//   * the Q tile is staged once in shared memory (bf16 widened to f32);
//   * the block walks K/V tiles of 64 keys, staging each in shared memory,
//     reading the kv head g in place (no repeated copies for GQA);
//   * S = Q K^T: 256 threads, each a 4 x 4 micro-tile of scores; rows of the
//     Q and K tiles are padded to D + 1 floats so the 16 threads reading 16
//     key rows hit 16 banks;
//   * online softmax: 4 threads per query row reduce the tile max and sum
//     with warp shuffles and rescale the running max m and denominator l;
//   * O = O * corr + P V: each thread owns a 4 x (D / 16) output micro-tile
//     in registers.
// Tiles wholly above the causal diagonal are skipped, which is exact: once a
// row has seen a valid key, exp(-1e30 - m) is 0.  Tiles wholly left of the
// window are skipped only when every row of the block has its own position
// among the keys, so every row sees a valid key later and the masked
// tile's contribution is erased by corr = exp(-1e30 - m) = 0, as it is in
// the reference.  Keys at or past Skv (the ragged edge) get -inf, so they
// move neither the max nor the sum: the kernel bounds its tiles by Sq and
// Skv and needs no padding.  Offsets are 64-bit.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_floats() {
  // Q and K tiles (padded rows), V tile, P tile (padded rows), m, l, corr
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int H, int Kv, int causal, int window,
                       float scale) {
  constexpr int DP = D + 1;      // padded row of the Q and K tiles
  constexpr int PP = kBK + 1;    // padded row of the P tile
  constexpr int NJ = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * DP;
  float* vs = ks + kBK * DP;
  float* ps = vs + kBK * D;
  float* m_s = ps + kBQ * PP;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / Kv);
  const int64_t q_stride = (int64_t)H * D;     // between positions
  const int64_t kv_stride = (int64_t)Kv * D;
  const T* qb = q + ((int64_t)b * Sq * H + h) * D;
  const T* kb = k + ((int64_t)b * Skv * Kv + g) * D;
  const T* vb = v + ((int64_t)b * Skv * Kv + g) * D;
  T* ob = out + ((int64_t)b * Sq * H + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int qp = q0 + r;
    qs[r * DP + d] = qp < Sq ? widen(qb[qp * q_stride + d]) : 0.0f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }

  // the key tiles this block reads
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q_last < Skv) {
    const int first = q0 - window + 1;   // first key row q0 may see
    if (first > 0) kt_begin = first / kBK;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();             // the previous tile's K, V and P are used
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int kp = k0 + r;
      const bool in = kp < Skv;
      ks[r * DP + d] = in ? widen(kb[kp * kv_stride + d]) : 0.0f;
      vs[r * D + d] = in ? widen(vb[kp * kv_stride + d]) : 0.0f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        bool keep = true;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        float val = keep ? s[i][j] * scale : kNegInf;
        if (kp >= Skv) val = -INFINITY;      // past the keys: weight 0
        ps[r * PP + c] = val;
      }
    }
    __syncthreads();

    // online softmax, four threads per row (neighbouring lanes of a warp)
    {
      const int r = tid >> 2, part = tid & 3;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj)
        mx = fmaxf(mx, ps[r * PP + part + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) {
        const int idx = r * PP + part + 4 * jj;
        const float p = expf(ps[idx] - m_new);
        ps[idx] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V, rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], w[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) w[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();               // l_s of the last tile is written

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      store(ob + qp * q_stride + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int Kv, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, H, Kv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Skv, int H, int Kv,
                       int D, int causal, int window, float scale,
                       cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, Kv, causal, window,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, Kv, causal, window,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, Kv, causal, window,
                            scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 on success).  q, out: (B, Sq, H, D); k, v:
// (B, Skv, Kv, D); all contiguous device buffers of one type: dtype 0 is
// float32, 1 is bfloat16.  D is 32, 64 or 128; H % Kv == 0; window <= 0
// means no window.  B, Sq and H must be positive.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int Sq, int Skv, int H, int Kv,
                                      int D, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, out, B, Sq, Skv, H, Kv, D, causal,
                                  window, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, Kv, D,
                                          causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
