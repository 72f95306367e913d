// Flash attention (GQA, causal, optional sliding window) for Hopper
// (sm_90a): the forward, and the backward of its bf16 route (its note is at
// flash_attention_bf16_backward_kernel, after the forward's launch).
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
// Two routes, chosen by dtype before the launch:
//
// float32 (fp32::flash_attention_kernel).  Bound by operations: every
// product is a float32 FMA outside the tensor cores, since TF32 would break
// the reference's 2e-5 float32 gate.  One block per (query tile of 64 rows,
// q head, batch); Q staged once and K/V tiles of 64 keys staged in shared
// memory as float32; S = Q K^T as 4 x 4 micro-tiles per thread; the online
// softmax four threads per row; O = O * corr + P V in registers.
//
// bfloat16 (hopper::flash_attention_bf16_kernel).  Bound by operations at
// the bf16 tensor-core rate: a bf16 x bf16 product is exact in a float32
// accumulator, and the reference's bf16 gate (2e-2) leaves room to round P
// to bf16 before P V (at most 2^-8 sum_j p_j |v_j| / l per output).  A work
// item is a (query tile of 128 rows, q head, batch); one persistent block
// per SM takes items longest first in a boustrophedon over the blocks, so
// the causal tiles' lengths even out over the SMs:
//   * warps 0-7 are two consumer warpgroups of 64 query rows each; warp 8
//     is the producer: one lane issues every TMA load;
//   * Q is loaded once per item (the next item's as soon as both
//     warpgroups have read this one's), K and V tiles of 64 keys stream
//     through a ring of two stages, each tile with its own mbarrier,
//     through 4-D tensor maps over (D, heads, S, B) with the swizzle of the
//     row's width (128 B for D = 64, 64 B for D = 32, two 64-column atoms
//     for D = 128);
//   * S = Q K^T is one wgmma chain (bf16 operands from shared memory,
//     float32 accumulator in registers);
//   * the online softmax runs on the accumulator fragments: a row's values
//     sit in a quad of lanes, reduced with two shuffles; masks are applied
//     only on the tiles that cross the diagonal, the window edge or Skv;
//   * P is rounded to bf16 in registers in wgmma's A-fragment layout and
//     O += P V is a second wgmma chain, A from registers and V from shared
//     memory through the transpose flag; O stays in float32 registers and
//     is rescaled by corr at each tile where a row's running max moved;
//   * the epilogue divides by max(l, 1e-30), rounds to bf16, stages the
//     warpgroup's rows in an output tile in shared memory and stores them
//     with 16-byte vector stores.
// The float32 plain model of this rounding is
// repro_torch/kernels/ref.py::attention_bf16p_ref.
//
// Head dim 112 (kimi-k2's): the float32 route is instantiated at D = 112
// (seven output columns a thread).  The bf16 route's layout is built on
// 64-column, 128-byte swizzle panels, which 112 does not fill, so it runs
// the D = 128 instantiation on the true 112-column buffers: the tensor maps
// hold the true head dim (a 224-byte row), TMA fills the second panel's
// columns 112..127 with zeros, which add nothing to Q K^T and make zero
// columns of P V, and the epilogue stores only the first 112 columns of
// each row.  The zero columns cost 8/7 of the products, no bytes.
//
// Both routes skip the same key tiles (of 64 keys; the bf16 route per
// warpgroup of 64 rows).  Tiles wholly above the causal diagonal are
// skipped, which is exact: once a row has seen a valid key, exp(-1e30 - m)
// is 0.  Tiles wholly left of the window are skipped only when every row of
// the block has its own position among the keys, so every row sees a valid
// key later and the masked tile's contribution is erased by corr =
// exp(-1e30 - m) = 0, as it is in the reference.  Keys at or past Skv (the
// ragged edge) get -inf, so they move neither the max nor the sum: the
// kernel bounds its tiles by Sq and Skv and needs no padding (TMA fills the
// rows past Sq and Skv with zeros; the bf16 route still sets those keys'
// scores to -inf).  Offsets are 64-bit.
//
// The bf16 route stores each row's log-sum-exp, ln sum_j exp(s_j scale) =
// (m + log2 l) ln 2, where the caller passes a buffer for it (the backward
// needs it; forward-only callers pass none and store nothing).
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/flash_attention.py).  The tensor maps are encoded on
// the host with cuTensorMapEncodeTiled, looked up through the runtime
// (cudaGetDriverEntryPointByVersion), so the library does not link libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit once per device: the
// attribute outlives the launch.  ``done`` is the caller's flags, one set per
// kernel instantiation.
cudaError_t allow_smem_once(const void* kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

namespace fp32 {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int Kv, int causal,
                   int window, float scale, cudaStream_t stream) {
  static bool smem_set[kMaxDevices];
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = allow_smem_once(
      (const void*)flash_attention_kernel<float, D>, (int)smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq,
      Skv, H, Kv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace fp32


namespace hopper {

constexpr int kBQ = 128;               // query rows per block
constexpr int kBK = 64;                // keys per tile
constexpr int kStages = 2;             // K/V ring
constexpr int kConsumers = 256;        // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;   // and one producer warp

// Shared-memory layout of one block for head dim D: the Q tile, the output
// tile, the K and V stages, then the mbarriers.  A tile is stored as panels
// of kPanel columns (one swizzle atom wide), each panel rows x kRowBytes.
template <int D>
struct Tile {
  static constexpr int kPanel = D < 64 ? D : 64;
  static constexpr int kRowBytes = kPanel * 2;               // 64 or 128
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // B128, B64
  static constexpr int kSbo = 8 * kRowBytes;     // between 8-row groups
  static constexpr int kQPanel = kBQ * kRowBytes;
  static constexpr int kKVPanel = kBK * kRowBytes;
  static constexpr int kQBytes = kBQ * D * 2;    // and the output tile's
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kBars = 2 * kQBytes + 2 * kStages * kKVBytes;
  // 2 + 3 kStages mbarriers, and slack to align the base to 1024 bytes
  static constexpr int kSmem = kBars + 8 * (2 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity ``parity`` to complete.  A wait that never
// completes is a fault of the kernel: trap (the launch then fails) rather
// than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

// One TMA box of a 4-D tensor map (D, heads, S, B) into shared memory;
// completion is counted in bytes on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of in-flight accumulators
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x in one MUFU instruction (denormal results flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 64, float32) += Q (64 x 16, K-major) K^T, B K-major; O (64 x N)
// += P (64 x 16, registers) V (16 x N, MN-major: the transpose flag).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(o, a, db, 1);
  if constexpr (D == 64) wgmma_rs_n64(o, a, db, 1);
  if constexpr (D == 128) wgmma_rs_n128(o, a, db, 1);
}

// The key tiles that query rows r0 .. r0 + rows - 1 read ([begin, end);
// empty when the rows lie past Sq), by the rules of the header comment.
__device__ __forceinline__ void key_tiles(int r0, int rows, int Sq, int Skv,
                                          int causal, int window, int& begin,
                                          int& end) {
  begin = end = 0;
  if (r0 >= Sq) return;
  const int q_last = min(r0 + rows, Sq) - 1;
  end = (Skv + kBK - 1) / kBK;
  if (causal) end = min(end, q_last / kBK + 1);
  if (window > 0 && q_last < Skv) {
    const int first = r0 - window + 1;   // first key row r0 may see
    if (first > 0) begin = first / kBK;
  }
}

// The key tiles of a block's query tile at q0: each warpgroup's (by
// key_tiles) and the block's, their union.
struct Ranges {
  int begin0, end0, begin1, end1, begin, end;
};

__device__ __forceinline__ Ranges block_tiles(int q0, int Sq, int Skv,
                                              int causal, int window) {
  Ranges r;
  key_tiles(q0, 64, Sq, Skv, causal, window, r.begin0, r.end0);
  key_tiles(q0 + 64, 64, Sq, Skv, causal, window, r.begin1, r.end1);
  r.begin = r.begin0;
  r.end = r.end0;
  if (r.end1 > r.begin1) {
    r.begin = min(r.begin, r.begin1);
    r.end = max(r.end, r.end1);
  }
  return r;
}

// A work item is one (query tile, q head, batch); items of rank 0 are the
// longest (the last query tile, under the causal mask).  One block per SM
// walks ranks c, 2G - 1 - c, 2G + c, 4G - 1 - c, ... of G blocks, so the
// blocks that start on the longest tiles end on the shortest and every SM
// gets about the same number of key tiles.
__device__ __forceinline__ int item_rank(int j, int c, int G) {
  return (j & 1) ? (j + 1) * G - 1 - c : j * G + c;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int Sq, int Skv,
                            int H, int Kv, int B, int causal, int window,
                            float scale_log2, int q_tiles, int dg) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  uint8_t* out_tile = smem_raw + (base - raw) + T::kQBytes;
  const uint32_t sq = base;
  const uint32_t sk = sq + 2 * T::kQBytes;             // stage s: + s kKVBytes
  const uint32_t sv = sk + kStages * T::kKVBytes;
  const uint32_t q_full = base + T::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;                 // + 8 s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int heads = H * B;
  const int items = q_tiles * heads;
  const int c = static_cast<int>(blockIdx.x), G = static_cast<int>(gridDim.x);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one lane keeps Q and the ring full, item after item
    if (tid == kConsumers) {
      int n = 0;                                       // K/V tiles issued
      for (int j = 0;; ++j) {
        const int r = item_rank(j, c, G);
        if (r >= items) break;
        const int q0 = (q_tiles - 1 - r / heads) * kBQ;
        const int h = (r % heads) % H, b = (r % heads) / H;
        const int g = h / (H / Kv);
        const Ranges rg = block_tiles(q0, Sq, Skv, causal, window);
        if (j > 0) mbar_wait(q_empty, (j - 1) & 1);    // Q of item j - 1 read
        mbar_expect_tx(q_full, T::kQBytes);
        for (int p = 0; p < D / T::kPanel; ++p)
          tma_load(sq + p * T::kQPanel, &tq, q_full, p * T::kPanel, h, q0, b);
        for (int kt = rg.begin; kt < rg.end; ++kt, ++n) {
          const int s = n % kStages;
          mbar_wait(empty + 8 * s, ((n / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full + 8 * s, T::kKVBytes);
          for (int p = 0; p < D / T::kPanel; ++p)
            tma_load(sk + s * T::kKVBytes + p * T::kKVPanel, &tk,
                     k_full + 8 * s, p * T::kPanel, g, kt * kBK, b);
          mbar_expect_tx(v_full + 8 * s, T::kKVBytes);
          for (int p = 0; p < D / T::kPanel; ++p)
            tma_load(sv + s * T::kKVBytes + p * T::kKVPanel, &tv,
                     v_full + 8 * s, p * T::kPanel, g, kt * kBK, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows r0 .. r0 + 63 of each item; this thread
  // holds rows row_a and row_a + 8 (accumulator fragments: register i is
  // row row_a + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane & 3) + (i & 1))
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const uint64_t dq = make_desc(sq + 64 * wg * T::kRowBytes, 16, T::kSbo,
                                T::kLayout);
  constexpr int kChunks = T::kPanel / 8;   // 16-byte chunks per panel row
  int n = 0;                                // K/V tiles consumed
  for (int j = 0;; ++j) {
    const int r = item_rank(j, c, G);
    if (r >= items) break;
    const int q0 = (q_tiles - 1 - r / heads) * kBQ;
    const int h = (r % heads) % H, b = (r % heads) / H;
    const Ranges rg = block_tiles(q0, Sq, Skv, causal, window);
    const int my_begin = wg ? rg.begin1 : rg.begin0;
    const int my_end = wg ? rg.end1 : rg.end0;
    const int r0 = q0 + 64 * wg;
    const int r_last = min(r0 + 63, Sq - 1);
    const int row_a = r0 + 16 * warp + lane / 4;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    // Q of item j is in (so q_empty's phase j - 1 is complete: an arrival
    // now counts for item j); rows that read none of it release it at once
    mbar_wait(q_full, j & 1);
    if (my_begin >= my_end) mbar_arrive(q_empty);
    for (int kt = rg.begin; kt < rg.end; ++kt, ++n) {
      const int s = n % kStages;
      const uint32_t phase = (n / kStages) & 1;
      const int k0 = kt * kBK;
      // wait for the tile even when these rows skip it: the stage is freed
      // by both warpgroups, so neither runs ahead of the producer
      mbar_wait(k_full + 8 * s, phase);
      if (kt < my_begin || kt >= my_end) {
        mbar_arrive(empty + 8 * s);
        continue;
      }

      // S = Q K^T
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
      fence_regs(sc);
      wgmma_fence();
      const uint64_t dk = make_desc(sk + s * T::kKVBytes, 16, T::kSbo,
                                    T::kLayout);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int panel = kk / (T::kPanel / 16);
        const int in_row = (kk % (T::kPanel / 16)) * 32;   // 16 columns
        wgmma_ss_n64(sc, dq + ((panel * T::kQPanel + in_row) >> 4),
                     dk + ((panel * T::kKVPanel + in_row) >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if (kt == my_end - 1) mbar_arrive(q_empty);   // the last read of Q

      // scores in the log2 domain, masked where the tile needs it
      const bool need_mask = (causal && k0 + kBK - 1 > r0) ||
                             (window > 0 && k0 <= r_last - window) ||
                             (k0 + kBK > Skv);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * scale_log2;
        if (need_mask) {
          const int qp = row_a + 8 * ((i >> 1) & 1);
          const int kp = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
            x = kNegInf;
          if (kp >= Skv) x = -INFINITY;    // past the keys: weight 0
        }
        sc[i] = x;
      }

      // online softmax on the fragments: a row is a quad of lanes
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m[rr], mx[rr]);
        corr[rr] = fast_exp2(m[rr] - m_new);
        m[rr] = m_new;
        l[rr] *= corr[rr];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = fast_exp2(sc[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p;              // this lane's part of the row sum
        sc[i] = p;
      }
      // P in bf16, as the A fragments of four k-steps of 16 keys
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          pa[kk][rr] = pack_bf16(sc[8 * kk + 2 * rr], sc[8 * kk + 2 * rr + 1]);
      // the running max seldom moves after the first tiles: rescale O only
      // where it did (corr is 1 exactly where it did not)
      if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }

      // O += P V
      mbar_wait(v_full + 8 * s, phase);
      fence_regs(o);
      wgmma_fence();
      const uint64_t dv = make_desc(sv + s * T::kKVBytes, T::kKVPanel,
                                    T::kSbo, T::kLayout);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<D>(o, pa[kk], dv + ((kk * 16 * T::kRowBytes) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(empty + 8 * s);
    }

    // epilogue: the row sums over the quad, then out = O / max(l, 1e-30),
    // staged in the warpgroup's rows of the output tile (16-byte chunks of
    // a row XOR-ed with the row, as the swizzle does, to spread the banks)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      l[rr] = fmaxf(l[rr], 1e-30f);
    }
    // each row's log-sum-exp of its scaled scores, for the backward: m is
    // in the log2 domain, so ln(sum_j exp(s_j scale)) = (m + log2 l) ln 2
    if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qp = row_a + 8 * rr;
        if (qp < Sq)
          lse[((int64_t)b * H + h) * Sq + qp] =
              (m[rr] + log2f(l[rr])) * 0.6931471805599453f;
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int rr = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      const int p = col / T::kPanel, cc = col % T::kPanel;
      const int chunk = (cc / 8) ^ (rr % kChunks);
      const float denom = l[(i >> 1) & 1];
      *reinterpret_cast<uint32_t*>(out_tile + p * T::kQPanel +
                                   (64 * wg + rr) * T::kRowBytes +
                                   chunk * 16 + (cc % 8) * 2) =
          pack_bf16(o[i] / denom, o[i + 1] / denom);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    for (int ch = tid % 128; ch < 64 * D / 8; ch += 128) {
      const int rr = ch / (D / 8), col = (ch % (D / 8)) * 8;
      const int qp = r0 + rr;
      if (qp >= Sq || col >= dg) continue;
      const int p = col / T::kPanel, cc = col % T::kPanel;
      const int chunk = (cc / 8) ^ (rr % kChunks);
      const uint4 val = *reinterpret_cast<const uint4*>(
          out_tile + p * T::kQPanel + (64 * wg + rr) * T::kRowBytes +
          chunk * 16);
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + qp) * H + h) * dg +
                                col) = val;
    }
    // the next item's staging waits for every copy of this one
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over the bf16 (B, S, heads, D) buffer as (D, heads, S, B),
// boxes of (cols, 1, rows, 1) elements; TMA fills rows past S and columns
// past D with zeros.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D,
            int heads, int S, int B, int cols, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols * 2 == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The device's SM count, asked once per device.
int sm_count() {
  static int count[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && count[dev] > 0) return count[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < kMaxDevices) count[dev] = n;
  return n;
}

// dg is the buffers' head dim: D, or 112 on the D = 128 instantiation
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int Kv,
                   int causal, int window, float scale, cudaStream_t stream,
                   int dg) {
  using T = Tile<D>;
  static bool smem_set[kMaxDevices];
  if (Skv == 0)          // no keys: the row sums stay 0 and out is 0
    return cudaMemsetAsync(out, 0, (size_t)B * Sq * H * dg * 2, stream);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode(enc, &tq, q, dg, H, Sq, B, T::kPanel, kBQ) ||
      !encode(enc, &tk, k, dg, Kv, Skv, B, T::kPanel, kBK) ||
      !encode(enc, &tv, v, dg, Kv, Skv, B, T::kPanel, kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem_once(
      (const void*)flash_attention_bf16_kernel<D>, T::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Sq + kBQ - 1) / kBQ;
  const long long items = (long long)q_tiles * H * B;
  if (items >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int blocks = items < sms ? (int)items : sms;   // persistent: 1 per SM
  flash_attention_bf16_kernel<D>
      <<<blocks, kThreads, T::kSmem, stream>>>(
          tq, tk, tv, (__nv_bfloat16*)out, lse, Sq, Skv, H, Kv, B, causal,
          window,
          scale * 1.4426950408889634f, q_tiles, dg);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The backward of the bf16 route: dQ, dK and dV from q, k, v, the output,
// its gradient dO and each row's log-sum-exp, which the forward stores when
// it is asked to.  It replaces no TPU kernel: the reference differentiates
// its attention with the framework (repro/kernels/ops.py, a custom VJP
// whose backward recomputes the plain streaming attention), and so did
// this port, in float32.  It was added because that plain backward, at
// the training shapes, took most of a training block (PERF.md).
//
// With z = s scale the scaled scores, P = exp(z - lse), delta = rowsum(dO
// o out) and dZ = P o (dO V^T - delta):
//   dV = P^T dO,  dK = scale dZ^T Q,  dQ = scale dZ K.
// Every product has bf16 operands and a float32 accumulator; P and dZ are
// rounded to bf16 before their products, as the forward rounds P before
// P V (the float32 plain model is repro_torch/kernels/ref.py::
// attention_bf16_backward_ref).  Bound by operations at the bf16
// tensor-core rate: five products over the kept (query, key) pairs, 5 x 2
// x Dh operations a pair, against a few bytes a pair.
//
// Design:
//   * flash_attention_bf16_backward_prep: one warp a (batch, head, row)
//     computes delta, |dO|_1 (the row's L1 norm) and lse in the log2
//     domain (+inf on the rows past Sq, so their P is 0); the first blocks
//     also take max |K| and max |V| (atomicMax on the bits, which order
//     non-negative floats), and every block zeroes its share of dQ's int32
//     accumulator;
//   * flash_attention_bf16_backward_kernel: one persistent block per SM; a
//     work item is one (key tile of 128 keys, kv head, batch), taken
//     longest first (under the causal mask the first key tiles see the
//     most query tiles) in the forward's boustrophedon over the blocks.
//     The block is two consumer warpgroups of 64 keys each and nothing
//     else: with any thread beyond them (a producer warp, as the forward
//     has, or warpgroup) ptxas caps a thread at 168 registers, and dK and
//     dV (D floats a thread) with S^T and dP^T (64) then spill and
//     serialise the wgmma chains; at 256 threads it may use 255.
//     Thread 0 is also the loader: K and V once an item, then for each of
//     the G = H / Kv query heads of the kv head and each query tile of 64
//     rows that sees the key tile, Q, dO (TMA) and that tile's lse, delta
//     and |dO|_1 (bulk copies) through a ring of two stages, one step
//     ahead of the step being consumed.  Per step each consumer
//     warpgroup runs S^T = K Q^T and dP^T = V dO^T (the forward's S = Q K^T
//     with the roles of the tiles swapped, so the keys are wgmma's M),
//     forms P^T and dZ^T on the fragments, then dV += P^T dO and dK += dZ^T
//     Q with P^T and dZ^T as register A operands.  dK and dV stay in
//     float32 registers over every step of the item, which takes GQA's sum
//     over the G heads without atomics;
//   * dQ = dZ K sums over the keys of every item that sees a query tile:
//     each step's dZ^T goes to shared memory (double-buffered, swizzled as
//     the 128-byte wgmma layout), both warpgroups meet at one barrier, and
//     each computes half of dQ's columns over all 128 keys (A = dZ^T and B
//     = K, both from shared memory, both through the transpose flags);
//     the half-tile is scaled into fixed point (below), staged in shared
//     memory and added to an int32 accumulator in device memory with one
//     bulk reduce-add (cp.reduce.async.bulk), laid out in the order the
//     threads write it;
//   * flash_attention_bf16_backward_dq: the accumulator back to float,
//     into dq in bf16.
// The items that add into one dQ tile run on different SMs in no fixed
// order, and float additions in another order round otherwise: summed in
// float32, dq would differ from run to run in its last bits.  Integer
// addition does not depend on the order, so dQ is summed in fixed point
// and dq, dk and dv are the same bits on every run (a training run on the
// card is then repeatable, and the stacked and sharded engines give the
// same step bit for bit).  Each query row has its own unit 2^-E, from a
// bound on the row's |dQ| that the prep pass's numbers give:
//   |dQ_ij| <= scale max|K| (|dO_i|_1 max|V| + |delta_i|) = bound_i,
// since |dP_ik| <= |dO_i|_1 max|V| and the row's P sums to 1; E puts
// bound_i below 2^29, which leaves 2^2 of room in int32 for the row's P
// summing to more than 1 through rounding (the log-sum-exp must be the
// forward's of the same q and k).  The unit is bound_i 2^-28 at most, so
// rounding a partial sum to it errs by bound_i 2^-29 at most: with the
// 32 partials of 4,096 keys, bound_i 2^-24, where float32's error is
// 2^-24 of the sum of the partials' magnitudes, which the bound exceeds by
// the cancellation among the keys.  A row whose bound is not finite gives
// NaN.  Alternatives timed on an H100 at mistral-7b's shape (1, 4096, 32,
// 8, 128): int64 fixed point (bound below 2^56) 1.86 ms a call, its
// 64-bit reduce-adds alone 0.66 ms; float32 added in a fixed order of the
// key tiles (a semaphore a dQ tile, each item waiting for the tile's
// earlier key tiles) 1.41 ms; int32 1.22 ms, against 1.11 ms for float32
// in no fixed order.  A second pass over the pairs by query tile would
// take seven products instead of five.
//
// The kernel skips the (query tile, key tile) pairs the forward skips:
// those wholly above the causal diagonal, and those wholly left of the
// window where every row of the query tile has its own position among the
// keys.  Masked scores give P = 0, which is what the forward's -1e30 gives
// a row that sees a valid key (a row that sees none, possible only past
// Skv + window without the causal mask, is outside the model).  Keys past
// Skv and rows past Sq are zero (TMA's fill) and masked (P = 0), so no
// length needs padding.  Head dim 112 runs the D = 128 layout on the true
// buffers, as the forward does.

constexpr int kBwdQ = 64;                  // query rows a step
constexpr int kBwdK = 128;                 // keys an item: 64 a warpgroup
constexpr int kBwdStages = 2;              // Q / dO / row stats ring
constexpr int kFixBits = 29;               // dQ's bound below 2^29
constexpr int kBwdConsumers = 256;         // two warpgroups
constexpr int kBwdThreads = kBwdConsumers;        // thread 0 also loads

// Shared memory of one backward block for head dim D: the K and V tiles of
// the item (128 rows), the ring's Q and dO tiles (64 rows), two dZ^T tiles
// (128 key rows of 64 queries, 128-byte rows), each warpgroup's dQ
// staging (int32), the ring's lse, delta and |dO|_1, then the mbarriers.
// Tiles are panels of kPanel columns, as in the forward's Tile.
template <int D>
struct BwdTile {
  static constexpr int kPanel = D < 64 ? D : 64;
  static constexpr int kRowBytes = kPanel * 2;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kSbo = 8 * kRowBytes;
  static constexpr int kKPanel = kBwdK * kRowBytes;
  static constexpr int kQPanel = kBwdQ * kRowBytes;
  static constexpr int kKBytes = kBwdK * D * 2;
  static constexpr int kQBytes = kBwdQ * D * 2;
  static constexpr int kDSBytes = kBwdK * kBwdQ * 2;
  static constexpr int kHalf = D / 2;            // dQ columns a warpgroup
  static constexpr int kDQBytes = kBwdQ * kHalf * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQ = kV + kKBytes;                   // + s kQBytes
  static constexpr int kDO = kQ + kBwdStages * kQBytes;     // + s kQBytes
  static constexpr int kDS = kDO + kBwdStages * kQBytes;    // + buf kDSBytes
  static constexpr int kDQ = kDS + 2 * kDSBytes;            // + wg kDQBytes
  static constexpr int kLse = kDQ + 2 * kDQBytes;           // + s 256
  static constexpr int kDelta = kLse + kBwdStages * kBwdQ * 4;
  static constexpr int kAbs = kDelta + kBwdStages * kBwdQ * 4;
  static constexpr int kBars = kAbs + kBwdStages * kBwdQ * 4;
  // full and empty a stage, kv_full, kv_empty; slack to align the base
  static constexpr int kSmem = kBars + 8 * (2 * kBwdStages + 2) + 1024;
};

// ``bytes`` contiguous bytes from device memory into shared memory,
// completion counted on ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// dst[i] += src[i] for ``bytes`` of int32 (two's complement, so the u32
// add), in device memory's L2, as one bulk group of this thread
__device__ __forceinline__ void bulk_reduce_add(int* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u32 "
      "[%0], [%1], %2;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk groups have read their shared memory (.read) or are
// complete
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// order this thread's shared-memory writes before the async proxy's reads
// (wgmma, bulk copies)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D (64 x N) += A (64 x 16) B (16 x N), both from shared memory, both
// MN-major (the transpose flags): dQ's half = dZ K
__device__ __forceinline__ void wgmma_tt_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tt_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tt(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_tt_n16(d, da, db, scale_d);
  if constexpr (N == 32) wgmma_tt_n32(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_tt_n64(d, da, db, scale_d);
}

// Whether query tile qt sees key tile kt, by the forward's skipping rules
// (header comment of the backward).
__device__ __forceinline__ bool bwd_visible(int qt, int kt, int Sq, int Skv,
                                            int causal, int window) {
  const int q0 = qt * kBwdQ, k0 = kt * kBwdK;
  if (q0 >= Sq) return false;
  const int q_last = min(q0 + kBwdQ, Sq) - 1;
  if (causal && k0 > q_last) return false;
  if (window > 0 && q_last < Skv && min(k0 + kBwdK, Skv) - 1 <= q0 - window)
    return false;
  return true;
}

// The first query tile that can see key tile kt: none before the diagonal
// under the causal mask.
__device__ __forceinline__ int bwd_first_tile(int kt, int causal) {
  return causal ? kt * (kBwdK / kBwdQ) : 0;
}

// Where element (row, col) of a warpgroup's half of a dQ tile (64 rows x
// half columns) sits in the accumulator: in the order the consumer threads
// write their fragments (register pair jj of lane l of warp w at ((w half/4
// + jj) 32 + l) 2), so that each store of a warp is 256 contiguous bytes.
template <int kHalf>
__device__ __forceinline__ int dq_slot(int row, int col) {
  const int warp = row / 16, rr = (row % 16) / 8;
  const int lane = 4 * (row % 8) + (col % 8) / 2;
  const int jj = 2 * (col / 8) + rr;
  return ((warp * (kHalf / 4) + jj) * 32 + lane) * 2 + (col & 1);
}

// The bound on a query row's |dQ| (header comment) from its |dO|_1 and
// delta and kvmax = {max |K|, max |V|}.  Each operation rounds as written
// (no contraction), so the main kernel and the conversion find the same.
__device__ __forceinline__ float dq_bound(float absdo, float delta,
                                          const float* kvmax, float scale) {
  return __fmul_rn(__fmul_rn(scale, kvmax[0]),
                   __fadd_rn(__fmul_rn(absdo, kvmax[1]), fabsf(delta)));
}

// E of the row's unit 2^-E: bound 2^E < 2^kFixBits (frexpf gives bound =
// f 2^e with f in [0.5, 1), and e = 0 for 0, inf and NaN), kept where 2^E
// and 2^-E are normal floats
__device__ __forceinline__ int fix_exponent(float bound) {
  int e;
  frexpf(bound, &e);
  return min(max(kFixBits - e, -126), 126);
}

// 2^e for e in [-126, 127], exactly
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

constexpr int kMaxBlocks = 256;   // prep blocks that take max |K|, max |V|

// The largest |x| of ``n8`` chunks of 8 bf16, over the first kMaxBlocks
// blocks, into *dst as a float's bits by atomicMax: a bf16's |x| is its
// low 15 bits, and non-negative floats (NaN above inf) sort as their bits.
__device__ __forceinline__ void abs_max(const __nv_bfloat16* __restrict__ x,
                                        int64_t n8, unsigned* dst,
                                        unsigned* scratch) {
  unsigned m = 0;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n8;
       e += (int64_t)kMaxBlocks * blockDim.x) {
    const uint4 u = reinterpret_cast<const uint4*>(x)[e];
    m = max(m, max(max(u.x & 0x7fffu, (u.x >> 16) & 0x7fffu),
                   max(u.y & 0x7fffu, (u.y >> 16) & 0x7fffu)));
    m = max(m, max(max(u.z & 0x7fffu, (u.z >> 16) & 0x7fffu),
                   max(u.w & 0x7fffu, (u.w >> 16) & 0x7fffu)));
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, k));
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned best = 0;
    for (int w = 0; w < (int)blockDim.x / 32; ++w)
      best = max(best, scratch[w]);
    atomicMax(dst, best << 16);
  }
  __syncthreads();
}

// stats: delta, lse2 and |dO|_1 (rows each), then kvmax (2), zeroed by the
// caller
__global__ void __launch_bounds__(256)
flash_attention_bf16_backward_prep(const __nv_bfloat16* __restrict__ out,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   float* __restrict__ stats,
                                   int* __restrict__ dqacc, int Sq,
                                   int H, int dg, int sq_pad, int64_t rows,
                                   int64_t kv8, int64_t acc4) {
  __shared__ unsigned scratch[8];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * 8 + warp;
  if (row < rows) {
    const int r = (int)(row % sq_pad);
    const int64_t bh = row / sq_pad;
    const int64_t b = bh / H;
    const int h = (int)(bh % H);
    float d = 0.0f, a = 0.0f, l = INFINITY;   // past Sq: P = exp2(-inf) = 0
    if (r < Sq) {
      const int64_t off = ((b * Sq + r) * H + h) * dg;
      for (int c = 2 * lane; c < dg; c += 64) {
        const float2 o = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(out + off + c));
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
        d = fmaf(o.x, g.x, fmaf(o.y, g.y, d));
        a += fabsf(g.x) + fabsf(g.y);
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        d += __shfl_xor_sync(0xffffffffu, d, m);
        a += __shfl_xor_sync(0xffffffffu, a, m);
      }
      l = lse[bh * Sq + r] * 1.4426950408889634f;
    }
    if (lane == 0) {
      stats[row] = d;
      stats[rows + row] = l;
      stats[2 * rows + row] = a;
    }
  }
  if (blockIdx.x < kMaxBlocks) {     // uniform over the block
    unsigned* kvmax = reinterpret_cast<unsigned*>(stats + 3 * rows);
    abs_max(k, kv8, kvmax, scratch);
    abs_max(v, kv8, kvmax + 1, scratch);
  }
  int4* acc = reinterpret_cast<int4*>(dqacc);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < acc4;
       e += stride)
    acc[e] = make_int4(0, 0, 0, 0);
}

// A step of a block's walk: item j (its key tile kt, kv head g, batch b),
// query head hh of the G that share g, query tile qt.
struct BwdCursor {
  int j, kt, g, b, hh, qt;
};

// Move ``cur`` to the first step at or after it that some query row sees
// (items in the block's order, then heads, then query tiles); false past
// the block's last item.
__device__ __forceinline__ bool bwd_seek(BwdCursor& cur, int c, int nb,
                                         int items, int heads, int Kv, int G,
                                         int q_tiles, int Sq, int Skv,
                                         int causal, int window) {
  for (;; ++cur.j, cur.hh = 0, cur.qt = 0) {
    const int r = item_rank(cur.j, c, nb);
    if (r >= items) return false;
    cur.kt = r / heads;
    cur.g = (r % heads) % Kv;
    cur.b = (r % heads) / Kv;
    const int first = bwd_first_tile(cur.kt, causal);
    for (; cur.hh < G; ++cur.hh, cur.qt = first)
      for (cur.qt = max(cur.qt, first); cur.qt < q_tiles; ++cur.qt)
        if (bwd_visible(cur.qt, cur.kt, Sq, Skv, causal, window)) return true;
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bf16_backward_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ stats,
    int* __restrict__ dqacc, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H, int Kv, int B,
    int causal, int window, float scale, float scale_log2, int q_tiles,
    int dg) {
  using T = BwdTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1024 B
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t full = base + T::kBars;         // + 8 s
  const uint32_t empty = full + 8 * kBwdStages;  // + 8 s
  const uint32_t kv_full = empty + 8 * kBwdStages;
  const uint32_t kv_empty = kv_full + 8;

  const int G = H / Kv;
  const int heads = Kv * B;
  const int items = ((Skv + kBwdK - 1) / kBwdK) * heads;
  // the prep pass's row stats (its layout) and max |K|, max |V|
  const int64_t rows = (int64_t)B * H * q_tiles * kBwdQ;
  const float* delta = stats;
  const float* lse2 = stats + rows;
  const float* absdo = stats + 2 * rows;
  const float kvmax[2] = {stats[3 * rows], stats[3 * rows + 1]};
  const int c = static_cast<int>(blockIdx.x), nb = static_cast<int>(gridDim.x);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kBwdConsumers);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kBwdConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 is also the loader: K and V at each item's start, and Q, dO,
  // lse, delta and |dO|_1 of the steps ahead through the ring, up to
  // kBwdStages steps before the one being consumed (its cursor walks the
  // same steps as every consumer's loops).
  BwdCursor ahead = {0, 0, 0, 0, 0, 0};
  bool more = tid == 0 && bwd_seek(ahead, c, nb, items, heads, Kv, G,
                                   q_tiles, Sq, Skv, causal, window);
  int issued = 0;                                  // steps loaded
  auto load_ahead = [&](int consumed) {
    for (; more && issued < consumed + kBwdStages; ++issued) {
      const int s = issued % kBwdStages;
      mbar_wait(empty + 8 * s, ((issued / kBwdStages) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, 2 * T::kQBytes + 3 * kBwdQ * 4);
      const int h = ahead.g * G + ahead.hh;
      for (int p = 0; p < D / T::kPanel; ++p) {
        tma_load(base + T::kQ + s * T::kQBytes + p * T::kQPanel, &tq,
                 full + 8 * s, p * T::kPanel, h, ahead.qt * kBwdQ, ahead.b);
        tma_load(base + T::kDO + s * T::kQBytes + p * T::kQPanel, &tdo,
                 full + 8 * s, p * T::kPanel, h, ahead.qt * kBwdQ, ahead.b);
      }
      const int64_t row =
          ((int64_t)ahead.b * H + h) * q_tiles * kBwdQ + ahead.qt * kBwdQ;
      bulk_load(base + T::kLse + s * kBwdQ * 4, lse2 + row, kBwdQ * 4,
                full + 8 * s);
      bulk_load(base + T::kDelta + s * kBwdQ * 4, delta + row, kBwdQ * 4,
                full + 8 * s);
      bulk_load(base + T::kAbs + s * kBwdQ * 4, absdo + row, kBwdQ * 4,
                full + 8 * s);
      ++ahead.qt;
      more = bwd_seek(ahead, c, nb, items, heads, Kv, G, q_tiles, Sq, Skv,
                      causal, window);
    }
  };

  // a consumer warpgroup: keys kw0 .. kw0 + 63 of each item; this thread
  // holds keys key_a and key_a + 8 (the accumulator fragments' rows, as
  // in the forward) and, of S^T and dP^T, query columns 8 (i >> 2) + 2
  // (lane & 3) + (i & 1)
  const int wg = tid / 128, lt = tid % 128;
  const int warp = lt / 32, lane = tid % 32;
  const float* lse_s = reinterpret_cast<const float*>(gbase + T::kLse);
  const float* delta_s = reinterpret_cast<const float*>(gbase + T::kDelta);
  const float* abs_s = reinterpret_cast<const float*>(gbase + T::kAbs);
  int* dq_stage = reinterpret_cast<int*>(gbase + T::kDQ + wg * T::kDQBytes);
  // K and V as the A operands of S^T and dP^T (K-major): this warpgroup's
  // 64 rows of the 128-row tiles
  const uint64_t ka = make_desc(base + T::kK + 64 * wg * T::kRowBytes, 16,
                                T::kSbo, T::kLayout);
  const uint64_t va = make_desc(base + T::kV + 64 * wg * T::kRowBytes, 16,
                                T::kSbo, T::kLayout);
  // K as dQ's B operand (MN-major): this warpgroup's half of the columns
  const int col0 = T::kHalf * wg;
  const uint64_t kb = make_desc(
      base + T::kK + (col0 / T::kPanel) * T::kKPanel +
          (col0 % T::kPanel) * 2,
      T::kKPanel, T::kSbo, T::kLayout);
  int n = 0;                                   // steps consumed
  for (int j = 0;; ++j) {
    const int r = item_rank(j, c, nb);
    if (r >= items) break;
    const int kt = r / heads, g = (r % heads) % Kv, b = (r % heads) / Kv;
    const int kw0 = kt * kBwdK + 64 * wg;
    const int key_a = kw0 + 16 * warp + lane / 4;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;
    if (tid == 0) {
      if (j > 0) mbar_wait(kv_empty, (j - 1) & 1);   // item j - 1 done
      mbar_expect_tx(kv_full, 2 * T::kKBytes);
      for (int p = 0; p < D / T::kPanel; ++p) {
        tma_load(base + T::kK + p * T::kKPanel, &tk, kv_full,
                 p * T::kPanel, g, kt * kBwdK, b);
        tma_load(base + T::kV + p * T::kKPanel, &tv, kv_full,
                 p * T::kPanel, g, kt * kBwdK, b);
      }
    }
    mbar_wait(kv_full, j & 1);
    for (int hh = 0; hh < G; ++hh) {
      const int h = g * G + hh;
      for (int qt = bwd_first_tile(kt, causal); qt < q_tiles; ++qt) {
        if (!bwd_visible(qt, kt, Sq, Skv, causal, window)) continue;
        const int s = n % kBwdStages;
        const int q0 = qt * kBwdQ;
        const uint32_t sq = base + T::kQ + s * T::kQBytes;
        const uint32_t sdo = base + T::kDO + s * T::kQBytes;
        if (tid == 0) load_ahead(n);
        mbar_wait(full + 8 * s, (n / kBwdStages) & 1);

        // S^T = K Q^T and dP^T = V dO^T (Q and dO as K-major B)
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        const uint64_t qb = make_desc(sq, 16, T::kSbo, T::kLayout);
        const uint64_t dob = make_desc(sdo, 16, T::kSbo, T::kLayout);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int panel = kk / (T::kPanel / 16);
          const int in_row = (kk % (T::kPanel / 16)) * 32;
          wgmma_ss_n64(st, ka + ((panel * T::kKPanel + in_row) >> 4),
                       qb + ((panel * T::kQPanel + in_row) >> 4), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int panel = kk / (T::kPanel / 16);
          const int in_row = (kk % (T::kPanel / 16)) * 32;
          wgmma_ss_n64(dpt, va + ((panel * T::kKPanel + in_row) >> 4),
                       dob + ((panel * T::kQPanel + in_row) >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        // P^T = exp2(z log2 e - lse log2 e), masked to 0; dZ^T = P^T o
        // (dP^T - delta), delta and lse by column (query)
        const float* ls = lse_s + s * kBwdQ;
        const float* ds = delta_s + s * kBwdQ;
        const bool need_mask = (causal && kw0 + 63 > q0) ||
                               (window > 0 && kw0 <= q0 + kBwdQ - 1 - window) ||
                               (kw0 + 64 > Skv);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          float p = fast_exp2(st[i] * scale_log2 - ls[col]);
          if (need_mask) {
            const int kp = key_a + 8 * ((i >> 1) & 1);
            const int qp = q0 + col;
            if ((causal && kp > qp) || (window > 0 && kp <= qp - window) ||
                kp >= Skv)
              p = 0.0f;
          }
          dpt[i] = p * (dpt[i] - ds[col]);
          st[i] = p;
        }
        // P^T and dZ^T in bf16, as the A fragments of four k-steps of 16
        // queries
        uint32_t pa[kBwdQ / 16][4], za[kBwdQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBwdQ / 16; ++kk)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            pa[kk][rr] = pack_bf16(st[8 * kk + 2 * rr],
                                   st[8 * kk + 2 * rr + 1]);
            za[kk][rr] = pack_bf16(dpt[8 * kk + 2 * rr],
                                   dpt[8 * kk + 2 * rr + 1]);
          }
        // dZ^T into this step's buffer: row = key of the item (128),
        // 128-byte rows of 64 queries, 16-byte chunks XOR-ed with the row
        // (the 128-byte swizzle); both warpgroups' rows in, then dQ
        uint8_t* zs = gbase + T::kDS + (n & 1) * T::kDSBytes;
#pragma unroll
        for (int kk = 0; kk < kBwdQ / 16; ++kk)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int row = 64 * wg + 16 * warp + lane / 4 + 8 * (rr & 1);
            const int col = 8 * (2 * kk + (rr >> 1)) + 2 * (lane & 3);
            *reinterpret_cast<uint32_t*>(
                zs + row * 128 + (((col >> 3) ^ (row & 7)) << 4) +
                (col & 7) * 2) = za[kk][rr];
          }
        fence_async_smem();
        named_sync(1, kBwdConsumers);

        // dV += P^T dO, dK += dZ^T Q (A from registers, B MN-major)
        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
        const uint64_t dot = make_desc(sdo, T::kQPanel, T::kSbo,
                                       T::kLayout);
        const uint64_t qtr = make_desc(sq, T::kQPanel, T::kSbo,
                                       T::kLayout);
#pragma unroll
        for (int kk = 0; kk < kBwdQ / 16; ++kk)
          wgmma_pv<D>(dva, pa[kk],
                      dot + ((kk * 16 * T::kRowBytes) >> 4));
#pragma unroll
        for (int kk = 0; kk < kBwdQ / 16; ++kk)
          wgmma_pv<D>(dka, za[kk],
                      qtr + ((kk * 16 * T::kRowBytes) >> 4));
        // this warpgroup's half of dQ = dZ K over the item's 128 keys
        float dqa[T::kHalf / 2];
#pragma unroll
        for (int i = 0; i < T::kHalf / 2; ++i) dqa[i] = 0.0f;
        fence_regs(dqa);
        wgmma_fence();
        const uint64_t za_desc = make_desc(
            base + T::kDS + (n & 1) * T::kDSBytes, 8192, 1024, 1);
#pragma unroll
        for (int kk = 0; kk < kBwdK / 16; ++kk)
          wgmma_tt<T::kHalf>(dqa, za_desc + ((kk * 16 * 128) >> 4),
                             kb + ((kk * 16 * T::kRowBytes) >> 4), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(dqa);
        // the units of this thread's two dQ rows, scale folded in
        float fix[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int qr = 16 * warp + lane / 4 + 8 * rr;
          fix[rr] = scale * pow2(fix_exponent(dq_bound(
                                abs_s[s * kBwdQ + qr], ds[qr], kvmax, scale)));
        }
        mbar_arrive(empty + 8 * s);                // Q, dO, row stats read

        // stage the half-tile (its last reduce-add has read the staging)
        // and add it to the accumulator
        if (lt == 0) bulk_wait_read();
        named_sync(2 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < T::kHalf / 4; ++jj)    // pair jj: row 8 (jj & 1)
          *reinterpret_cast<int2*>(
              dq_stage + ((warp * (T::kHalf / 4) + jj) * 32 + lane) * 2) =
              make_int2(__float2int_rn(dqa[2 * jj] * fix[jj & 1]),
                        __float2int_rn(dqa[2 * jj + 1] * fix[jj & 1]));
        fence_async_smem();
        named_sync(2 + wg, 128);
        if (lt == 0)
          bulk_reduce_add(
              dqacc + (((int64_t)b * H + h) * q_tiles + qt) *
                          (int64_t)(kBwdQ * D) + wg * (kBwdQ * T::kHalf),
              base + T::kDQ + wg * T::kDQBytes, T::kDQBytes);
        ++n;
      }
    }
    mbar_arrive(kv_empty);                       // K and V read

    // dk = scale dK and dv = dV in bf16, straight from the fragments
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int kp = key_a + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      if (kp >= Skv || col >= dg) continue;
      const int64_t off = (((int64_t)b * Skv + kp) * Kv + g) * dg + col;
      *reinterpret_cast<uint32_t*>(dk + off) =
          pack_bf16(dka[i] * scale, dka[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dva[i], dva[i + 1]);
    }
  }
  if (lt == 0) bulk_wait();      // the last reduce-add is done
}

template <int D>
__global__ void __launch_bounds__(256)
flash_attention_bf16_backward_dq(const int* __restrict__ dqacc,
                                 const float* __restrict__ stats,
                                 __nv_bfloat16* __restrict__ dq, int Sq,
                                 int H, int dg, int q_tiles, float scale,
                                 int64_t rows, int64_t pairs) {
  constexpr int kHalf = D / 2;
  const int sq_pad = q_tiles * kBwdQ;
  const float kvmax[2] = {stats[3 * rows], stats[3 * rows + 1]};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < pairs;
       e += stride) {
    const int64_t idx = 2 * e;           // dq is (B, Sq, H, dg)
    const int col = (int)(idx % dg);
    const int64_t t = idx / dg;
    const int h = (int)(t % H);
    const int64_t bq = t / H;
    const int qp = (int)(bq % Sq);
    const int64_t b = bq / Sq;
    const int64_t tile = ((b * H + h) * q_tiles + qp / kBwdQ) *
                             (int64_t)(kBwdQ * D) +
                         (col / kHalf) * (kBwdQ * kHalf);
    const int2 v = *reinterpret_cast<const int2*>(
        dqacc + tile + dq_slot<kHalf>(qp % kBwdQ, col % kHalf));
    const int64_t row = (b * H + h) * sq_pad + qp;
    const float bound = dq_bound(stats[2 * rows + row], stats[row], kvmax,
                                 scale);
    const float unit = isfinite(bound) ? pow2(-fix_exponent(bound)) : NAN;
    *reinterpret_cast<uint32_t*>(dq + idx) =
        pack_bf16(__int2float_rn(v.x) * unit, __int2float_rn(v.y) * unit);
  }
}

// dg is the buffers' head dim: D, or 112 on the D = 128 instantiation
template <int D>
cudaError_t launch_backward(const void* q, const void* k, const void* v,
                            const void* out, const void* dout,
                            const float* lse, void* dq, void* dk, void* dv,
                            int* dqacc, float* stats, int B, int Sq,
                            int Skv, int H, int Kv, int causal, int window,
                            float scale, cudaStream_t stream, int dg) {
  using T = BwdTile<D>;
  static bool smem_set[kMaxDevices];
  const int q_tiles = (Sq + kBwdQ - 1) / kBwdQ;
  const int64_t rows = (int64_t)B * H * q_tiles * kBwdQ;
  const long long items = (long long)((Skv + kBwdK - 1) / kBwdK) * Kv * B;
  if (items >= (1LL << 31) || items <= 0 || rows / 8 >= (1LL << 31))
    return cudaErrorInvalidConfiguration;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(enc, &tq, q, dg, H, Sq, B, T::kPanel, kBwdQ) ||
      !encode(enc, &tdo, dout, dg, H, Sq, B, T::kPanel, kBwdQ) ||
      !encode(enc, &tk, k, dg, Kv, Skv, B, T::kPanel, kBwdK) ||
      !encode(enc, &tv, v, dg, Kv, Skv, B, T::kPanel, kBwdK))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem_once(
      (const void*)flash_attention_bf16_backward_kernel<D>, T::kSmem,
      smem_set);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  err = cudaMemsetAsync(stats + 3 * rows, 0, 2 * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  flash_attention_bf16_backward_prep<<<(unsigned)((rows + 7) / 8), 256, 0,
                                       stream>>>(
      (const __nv_bfloat16*)out, (const __nv_bfloat16*)dout, lse,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, stats, dqacc, Sq, H,
      dg, q_tiles * kBwdQ, rows, (int64_t)B * Skv * Kv * dg / 8,
      rows * D / 4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = items < sms ? (int)items : sms;   // persistent
  flash_attention_bf16_backward_kernel<D>
      <<<blocks, kBwdThreads, T::kSmem, stream>>>(
          tq, tk, tv, tdo, stats, dqacc, (__nv_bfloat16*)dk,
          (__nv_bfloat16*)dv, Sq, Skv, H, Kv, B, causal, window, scale,
          scale * 1.4426950408889634f, q_tiles, dg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t pairs = (int64_t)B * Sq * H * dg / 2;
  const int64_t want = (pairs + 255) / 256;
  const int post = (int)(want < 16LL * sms ? want : 16LL * sms);
  flash_attention_bf16_backward_dq<D><<<post, 256, 0, stream>>>(
      dqacc, stats, (__nv_bfloat16*)dq, Sq, H, dg, q_tiles, scale, rows,
      pairs);
  return cudaGetLastError();
}

}  // namespace hopper

namespace {

// the route by dtype, then the head dim; lse (float32, (B, H, Sq)) only on
// the bf16 route
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int dtype, int B, int Sq, int Skv, int H,
                     int Kv, int D, int causal, int window, float scale,
                     cudaStream_t s) {
  if (dtype == 0 && lse == nullptr) {
    switch (D) {
      case 32:
        return fp32::launch<32>(q, k, v, out, B, Sq, Skv, H, Kv, causal,
                                window, scale, s);
      case 64:
        return fp32::launch<64>(q, k, v, out, B, Sq, Skv, H, Kv, causal,
                                window, scale, s);
      case 112:
        return fp32::launch<112>(q, k, v, out, B, Sq, Skv, H, Kv, causal,
                                 window, scale, s);
      case 128:
        return fp32::launch<128>(q, k, v, out, B, Sq, Skv, H, Kv, causal,
                                 window, scale, s);
    }
  } else if (dtype == 1) {
    if (lse != nullptr && Skv == 0) return cudaErrorInvalidValue;
    switch (D) {
      case 32:
        return hopper::launch<32>(q, k, v, out, lse, B, Sq, Skv, H, Kv,
                                  causal, window, scale, s, D);
      case 64:
        return hopper::launch<64>(q, k, v, out, lse, B, Sq, Skv, H, Kv,
                                  causal, window, scale, s, D);
      case 112:    // the D = 128 layout, columns 112..127 zero-filled
      case 128:
        return hopper::launch<128>(q, k, v, out, lse, B, Sq, Skv, H, Kv,
                                   causal, window, scale, s, D);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns a cudaError_t (0 on success).  q, out: (B, Sq, H, D); k, v:
// (B, Skv, Kv, D); all contiguous device buffers of one type: dtype 0 is
// float32 (the FMA route), 1 is bfloat16 (the tensor-core route, whose
// buffers must be 16-byte aligned for TMA).  D is 32, 64, 112 or 128;
// H % Kv == 0; window <= 0 means no window.  B, Sq and H must be positive.
// lse: null, or on the bf16 route with Skv > 0 a float32 (B, H, Sq) buffer
// that takes each row's log-sum-exp of its scaled scores.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int dtype, int B, int Sq, int Skv,
                                      int H, int Kv, int D, int causal,
                                      int window, float scale, void* stream) {
  return (int)dispatch(q, k, v, out, (float*)lse, dtype, B, Sq, Skv, H, Kv,
                       D, causal, window, scale, (cudaStream_t)stream);
}

// The bf16 route's backward.  Returns a cudaError_t (0 on success).  q,
// out, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Skv, Kv, D); all
// contiguous bfloat16 device buffers, 16-byte aligned; lse: float32 (B, H,
// Sq) from the forward.  Scratch, 16-byte aligned: dqacc, int32, of B H Sq'
// D' elements, and stats, float32, of 3 B H Sq' + 2, with Sq' = Sq rounded
// up to 64 and D' = 128 for D = 112, else D.  D is 32, 64, 112 or 128;
// H % Kv == 0; window <= 0 means no window; B, Sq, Skv and H must be
// positive.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dqacc, void* stats, int B, int Sq, int Skv, int H, int Kv, int D,
    int causal, int window, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return (int)hopper::launch_backward<32>(
          q, k, v, out, dout, (const float*)lse, dq, dk, dv,
          (int*)dqacc, (float*)stats, B, Sq, Skv, H, Kv, causal,
          window, scale, s, D);
    case 64:
      return (int)hopper::launch_backward<64>(
          q, k, v, out, dout, (const float*)lse, dq, dk, dv,
          (int*)dqacc, (float*)stats, B, Sq, Skv, H, Kv, causal,
          window, scale, s, D);
    case 112:      // the D = 128 layout, columns 112..127 zero-filled
    case 128:
      return (int)hopper::launch_backward<128>(
          q, k, v, out, dout, (const float*)lse, dq, dk, dv,
          (int*)dqacc, (float*)stats, B, Sq, Skv, H, Kv, causal,
          window, scale, s, D);
  }
  return (int)cudaErrorInvalidValue;
}
