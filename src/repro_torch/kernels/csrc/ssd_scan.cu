// Mamba2 SSD intra-chunk step for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_intra_chunk
// (_ssd_chunk_kernel).  For every (batch b, chunk c of Q tokens, head h),
// with xd (b, s, h, p) the dt-scaled inputs, dA (b, s, h) = dt * A and the
// single-group projections B, C (b, s, n):
//   dA_cs   = cumsum(dA_c)                                        (Q,)
//   G       = C_c B_c^T                                           (Q, Q)
//   Y_diag  = (G o L) xd_c,
//             L_ij = exp(dA_cs_i - dA_cs_j) for j <= i, else 0    (Q, P)
//   state_c = xd_c^T (B_c o exp(dA_cs_Q - dA_cs))                 (P, N)
// All three outputs are float32: Y_diag (b, s, h, p), states
// (b, nc, h, p, n), dA_cumsum (b, s, h).
//
// Bound.  At mamba2's shape (Q = 128, N = 128, P = 64, 80 heads) the
// function reads xd and writes Y_diag and the states, some 64 MB a call,
// against about 2e9 operations once G is counted once per (batch, chunk)
// (it does not depend on the head): 19 us of bytes at 3.35 TB/s against
// 4 us of operations at the TF32 tensor-core rate.  So it is bound by
// bytes, as long as the products run on the tensor cores; as float32 FMAs
// they alone would take 30 us.
//
// Precision.  The gate is float32's (2e-4 relative to the plain version),
// and one TF32 product keeps 11 bits.  So every product is split: a
// float32 x becomes hi = rna(x) and lo = rna(x - hi), rounded to TF32 as
// cvt.rna.tf32.f32 rounds (done in two integer operations, since the
// conversion takes a slow pipe), and a product is hi*hi + hi*lo + lo*hi
// (three wgmma), which misses only lo*lo (2^-22 relative).  B and C in
// bf16 are exact in TF32, so G takes one product there.  The exponentials
// are ex2.approx of x log2(e) (relative error near 2^-22).  The plain model
// of this arithmetic is repro_torch/kernels/ref.py::ssd_intra_chunk_split_ref.
//
// Design.  A block takes one (batch, chunk) and a run of its heads, with as
// many runs a chunk as fill the SMs once (mamba2: 8 chunks x 16 runs of 5
// heads, 128 blocks), so a block forms G once for all its heads:
//   * B_c and C_c are read (any row stride: the slices of xBC are read in
//     place; 16-byte loads and stores where the rows allow), widened to
//     float32 and stored as K-major panels of 32 columns in the 128-byte
//     swizzle, zero past N; G = C B^T is a wgmma chain with C from
//     registers and B from those panels, four k-steps at a time, each group
//     summed in its own accumulator and added into G (float32 B and C: B's
//     hi and lo panels are built in G's region first).  G then goes to
//     shared memory as its accumulator fragments, 16 bytes a lane and
//     k-step, only the k-steps left of each warpgroup's diagonal (48 KB);
//   * each head's xd slab ((Q, P) at row stride H P) and dA column come in
//     with cp.async into one stage, the next head's issued once this head's
//     xd is split, so they land during its products;
//   * warp 0 scans dA_cs (a shuffle scan, Q / 32 values a lane) and writes
//     the decay exp(dA_cs_Q - dA_cs_j); every thread splits xd into hi and
//     lo, four values of one p at a time, and stores both transposed, as
//     (P, Q) K-major panels in 16-byte stores, with j permuted inside each
//     group of 8 (j = 2t lands at k = t, j = 2t + 1 at k = t + 4).  That
//     permutation is what lets the A operand of Y_diag be built in G's
//     accumulator layout, since TF32 wgmma takes both operands K-major (its
//     transpose flag exists only for 16-bit types);
//   * Y_diag = S xd with S = G o L formed in registers from G's fragments
//     and dA_cs; each warp masks only the k-steps that cross its rows'
//     diagonal, the masked pairs get 0 by a select and never meet an
//     exponential, and each warpgroup issues only the k-steps left of its
//     diagonal;
//   * the state is formed transposed, state^T = (B_c o dec)^T xd, with
//     (B_c o dec)^T built in registers from the B panels (the same j
//     permutation), so it reads the same xd operand as Y_diag; warpgroup w
//     takes states n = 64 w .. 64 w + 63;
//   * both chains go in groups of 4 k-steps, and a group's A fragments are
//     built in a second register set while the previous group runs on the
//     tensor cores.  Every register a wgmma reads is written before the
//     wgmma.fence, and no wgmma sits behind a condition of its own: ptxas
//     otherwise inserts warpgroup.arrive (C7519) and serializes every wgmma
//     of the kernel (C7520).
// What holds it back: the tensor cores.  With the builds hidden behind
// them, 168 m64n64k8 TF32 wgmma a head (three a product) take about twice
// the time the TF32 peak allows, with A from registers and N = 64.
// Shared memory at Q = N = 128, P = 64: xd's hi and lo (64 KB, also C
// while G is formed), B's panels (64 KB), the xd stage (35 KB, row stride
// P + 4 floats so the transposing reads meet no bank conflict), G (48 KB),
// and the dA stage, dA_cs and decay: 218,624 bytes.  Offsets are 64-bit.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/ssd_scan.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;      // two warpgroups
constexpr int kMaxState = 128;     // N
constexpr int kGroup = 4;          // k-steps a commit group
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared-memory layout (byte offsets from a 1024-byte-aligned base).
template <int Q, int P>
struct Layout {
  static constexpr int kXBytes = P * Q * 4;          // one of xd's hi, lo
  static constexpr int kPanel = Q * 128;             // Q rows x 32 floats
  static constexpr int kR0 = 2 * kXBytes > 4 * kPanel ? 2 * kXBytes
                                                      : 4 * kPanel;
  static constexpr int kRS = P + 4;                  // xd stage row, floats
  static constexpr int kStageRaw = (Q * kRS * 4 + 1023) & ~1023;
  // G's k-steps that warpgroup w reads: those left of its rows' diagonal
  static constexpr int kKs0 = (Q < 64 ? Q : 64) / 8;
  static constexpr int kKs1 = Q > 64 ? Q / 8 : 0;
  static constexpr int kGBytes = (kKs0 + kKs1) * 4 * 32 * 16;   // >= 2 panels
  static constexpr int kB = 0 + kR0;                 // B panels
  static constexpr int kRaw = kB + 4 * kPanel;       // the xd stage
  static constexpr int kG = kRaw + kStageRaw;        // G, fragment by fragment
  static constexpr int kDA = kG + kGBytes;           // the dA stage
  static constexpr int kCs = kDA + Q * 4;
  static constexpr int kDec = kCs + Q * 4;
  static constexpr int kBytes = kDec + Q * 4 + 1024;
  static_assert(kGBytes >= 2 * kPanel, "G's region holds two B panels");
};

// Byte offset of (row, col) in a K-major panel of 32 floats a row in the
// 128-byte swizzle (16-byte chunks XOR-ed with the row's index mod 8).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// e^x as 2^(x log2 e) in one MUFU instruction (results below 2^-126
// flush to 0)
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (nearest, ties away from
// zero; finite x), in two integer operations where the conversion takes a
// slow pipe
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & ~0x1FFFu;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
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

// generic-proxy writes to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode (1: 128 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t lbo = 16, sbo = 1024, layout = 1;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (((lbo >> 4) & 0x3FFF) << 16) | (((sbo >> 4) & 0x3FFF) << 32) |
         (layout << 62);
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
// pin A fragments and descriptors before wgmma.fence: a register that a
// wgmma reads and that is written after the fence makes ptxas wait for
// every wgmma in flight before the next one (it reports C7519)
template <int G>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[G][4]) {
#pragma unroll
  for (int u = 0; u < G; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[u][e])::"memory");
}
template <int G>
__device__ __forceinline__ void fence_regs(uint64_t (&d)[G]) {
#pragma unroll
  for (int u = 0; u < G; ++u) asm volatile("" : "+l"(d[u])::"memory");
}

// D (64 x N, float32) += A (64 x 8, TF32, registers) B (8 x N, TF32,
// K-major in shared memory).  A fragment: a0 (row g, k t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4), g = lane / 4, t = lane % 4, rows 16 a
// warp.  Accumulator register i: row g + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 t + (i & 1).
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// hi * hi + hi * lo + lo * hi of one k-step
template <int N>
__device__ __forceinline__ void wgmma_split(float (&d)[N],
                                            const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4],
                                            uint64_t dhi, uint64_t dlo) {
  wgmma_tf32(d, ah, dhi);
  wgmma_tf32(d, ah, dlo);
  wgmma_tf32(d, al, dhi);
}

// acc = A xd over ``groups`` groups of kGroup k-steps (j = 8 kGroup grp ..):
// each group's A fragments, split into hi and lo, come from ``build(grp,
// hi, lo)``; xd's hi and lo are (P, Q) K-major panels at ``xhi`` and
// ``xhi + xlo``.  Group grp + 1 is built while group grp runs on the
// tensor cores, in the other of two register sets.
template <int N, typename Build>
__device__ __forceinline__ void chain(float (&acc)[N], int groups,
                                      Build&& build, uint32_t xhi,
                                      uint32_t xlo) {
  constexpr int P = 2 * N;
  uint32_t ah[kGroup][4], al[kGroup][4], bh[kGroup][4], bl[kGroup][4];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  // issue group grp from (h, l), then build group grp + 1 into (nh, nl)
  auto step = [&](int grp, uint32_t (&h)[kGroup][4],
                  uint32_t (&l)[kGroup][4], uint32_t (&nh)[kGroup][4],
                  uint32_t (&nl)[kGroup][4]) {
    const uint64_t x0 = make_desc(xhi);
    uint64_t dh[kGroup], dl[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int ks = grp * kGroup + u;
      const uint32_t off = (ks >> 2) * (P * 128) + (ks & 3) * 32;
      dh[u] = x0 + (off >> 4);
      dl[u] = x0 + ((off + xlo) >> 4);
    }
    fence_regs(dh);
    fence_regs(dl);
    fence_regs(h);
    fence_regs(l);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kGroup; ++u) wgmma_split(acc, h[u], l[u], dh[u], dl[u]);
    wgmma_commit();
    if (grp + 1 < groups) build(grp + 1, nh, nl);
    wgmma_wait_all();
    fence_regs(acc);
  };
  if (groups > 0) build(0, ah, al);
#pragma unroll 1
  for (int grp = 0; grp < groups; grp += 2) {
    step(grp, ah, al, bh, bl);
    if (grp + 1 < groups) step(grp + 1, bh, bl, ah, al);
  }
}

template <typename T, int Q, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_intra_chunk_kernel(const float* __restrict__ xd,
                       const float* __restrict__ dA,
                       const T* __restrict__ B, const T* __restrict__ C,
                       float* __restrict__ y, float* __restrict__ states,
                       float* __restrict__ dacs, int nc, int H, int N,
                       int hpb, int runs, int64_t b_sb, int64_t b_ss,
                       int64_t c_sb, int64_t c_ss) {
  using L = Layout<Q, P>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wv = warp % 4;                  // warp in the warpgroup
  // this block's chunk (bc = batch * nc + chunk) and its heads [h0, h1)
  const int64_t bc = blockIdx.x / runs;
  const int h0 = static_cast<int>(blockIdx.x % runs) * hpb;
  const int h1 = h0 + hpb < H ? h0 + hpb : H;
  const int64_t row0 = (bc / nc) * nc * Q + (bc % nc) * Q;   // b S + t0

  // head ``h``'s xd slab and dA column into the stage (one commit group,
  // empty past the block's heads)
  auto prefetch = [&](int h) {
    if (h < h1) {
      const float* src = xd + (row0 * H + h) * P;
      const uint32_t dst = base + L::kRaw;
      constexpr int kPieces = Q * P / 4;     // 16-byte pieces
      for (int idx = tid; idx < kPieces; idx += kThreads) {
        const int j = idx / (P / 4), q = idx % (P / 4);
        cp_async16(dst + (j * L::kRS + 4 * q) * 4,
                   src + (int64_t)j * H * P + 4 * q);
      }
      if (tid < Q)
        cp_async4(base + L::kDA + tid * 4,
                  dA + (row0 + tid) * H + h);
    }
    cp_async_commit();
  };

  prefetch(h0);

  // ---- the chunk's B and C into panels, then G = C B^T ----------------------
  // G stays in registers, each warpgroup its 64 rows, for every head
  float gacc[Q / 2];
  {
    const int64_t bi = bc / nc;
    const int64_t t0 = (bc % nc) * (int64_t)Q;
    const T* bsrc = B + bi * b_sb + t0 * b_ss;
    const T* csrc = C + bi * c_sb + t0 * c_ss;
    auto put = [&](int j, int n, float v, uint32_t region) {
      *reinterpret_cast<float*>(sm + region + (n >> 5) * L::kPanel +
                                swz(j, n & 31)) = v;
    };
    const bool vec = N % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(bsrc) |
                       reinterpret_cast<uintptr_t>(csrc)) & 15) == 0 &&
                     ((b_ss * sizeof(T)) & 15) == 0 &&
                     ((c_ss * sizeof(T)) & 15) == 0;
    if (vec) {
      // 16-byte pieces, 16 / sizeof(T) columns each; a batch issues all its
      // loads before it stores
      constexpr int kV = 16 / sizeof(T);
      constexpr int kRowPieces = kMaxState / kV;
      constexpr int kBatch = 8;                // pieces a thread, a batch
#pragma unroll 1
      for (int i0 = 0; i0 < Q * kRowPieces; i0 += kThreads * kBatch) {
        uint4 vb[kBatch], vc[kBatch];
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
          const int idx = i0 + m * kThreads + tid;
          const int j = idx / kRowPieces, n = (idx % kRowPieces) * kV;
          const bool in = j < Q && n < N;
          vb[m] = in ? *reinterpret_cast<const uint4*>(bsrc + j * b_ss + n)
                     : make_uint4(0, 0, 0, 0);
          vc[m] = in ? *reinterpret_cast<const uint4*>(csrc + j * c_ss + n)
                     : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
          const int idx = i0 + m * kThreads + tid;
          const int j = idx / kRowPieces, n = (idx % kRowPieces) * kV;
          if (j >= Q) continue;
          const T* pb = reinterpret_cast<const T*>(&vb[m]);
          const T* pc = reinterpret_cast<const T*>(&vc[m]);
          // kV columns from n: kV / 4 16-byte chunks of one panel row
#pragma unroll
          for (int c = 0; c < kV / 4; ++c) {
            uint32_t wb[4], wc[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              wb[e] = __float_as_uint(widen(pb[4 * c + e]));
              wc[e] = __float_as_uint(widen(pc[4 * c + e]));
            }
            const uint32_t off = ((n + 4 * c) >> 5) * L::kPanel +
                                 swz(j, (n + 4 * c) & 31);
            sts4(base + L::kB + off, wb);
            sts4(base + off, wc);
          }
        }
      }
    } else {
      // element by element: warp w takes rows w, w + 8, ..., 8 rows at a
      // time; lane + 32 q is the column, so each load of a row is coalesced
#pragma unroll 1
      for (int r0 = 0; r0 < Q; r0 += 64) {
        float vb[8][4], vc[8][4];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int j = r0 + warp + 8 * m;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = lane + 32 * q;
            const bool in = j < Q && n < N;
            vb[m][q] = in ? widen(bsrc[j * b_ss + n]) : 0.0f;
            vc[m][q] = in ? widen(csrc[j * c_ss + n]) : 0.0f;
          }
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int j = r0 + warp + 8 * m;
          if (j >= Q) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            put(j, lane + 32 * q, vb[m][q], L::kB);
            put(j, lane + 32 * q, vc[m][q], 0);
          }
        }
      }
    }
    fence_async_smem();
    __syncthreads();

#pragma unroll
    for (int i = 0; i < Q / 2; ++i) gacc[i] = 0.0f;
    const bool g_rows = 64 * wg < Q;
    // the 32-column panels that hold B and C (zero past N): every k-step
    // of a panel is issued, so no wgmma sits behind a condition of its own
    const int panels = (N + 31) / 32;
    const int r_a = 64 * wg + 16 * wv + g;     // this thread's rows
    // C's A fragment of k-step kk: rows r_a, r_a + 8; n = 8 kk + t, + 4
    auto c_frag = [&](int kk, float (&c)[4]) {
      const int n0 = 8 * kk + t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r_a + 8 * (e & 1);
        const int n = n0 + 4 * (e >> 1);
        c[e] = i < Q ? lds(base + (n >> 5) * L::kPanel + swz(i, n & 31))
                     : 0.0f;
      }
    };
    if constexpr (!kF32) {
      // bf16 B and C are exact in TF32: one product, B's panels as they are
      if (g_rows) {
#pragma unroll 1
        for (int k0 = 0; k0 < 4 * panels; k0 += kGroup) {
          float gt[Q / 2];
#pragma unroll
          for (int i = 0; i < Q / 2; ++i) gt[i] = 0.0f;
          uint32_t a[kGroup][4];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            float c[4];
            c_frag(k0 + u, c);
#pragma unroll
            for (int e = 0; e < 4; ++e) a[u][e] = __float_as_uint(c[e]);
          }
          uint64_t d[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int kk = k0 + u;
            d[u] = make_desc(base + L::kB) +
                   (((kk >> 2) * L::kPanel + (kk & 3) * 32) >> 4);
          }
          fence_regs(d);
          fence_regs(a);
          fence_regs(gt);
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < kGroup; ++u) wgmma_tf32(gt, a[u], d[u]);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(gt);
#pragma unroll
          for (int i = 0; i < Q / 2; ++i) gacc[i] += gt[i];
        }
      }
    } else {
      // float32: panel by panel, B's hi and lo built in G's region
      const uint32_t thi = L::kG;
      const uint32_t tlo = thi + L::kPanel;
#pragma unroll 1
      for (int nt = 0; nt < panels; ++nt) {
        for (int idx = tid; idx < Q * 32; idx += kThreads) {
          const uint32_t off = swz(idx / 32, idx % 32);
          uint32_t hi, lo;
          split(*reinterpret_cast<const float*>(sm + L::kB +
                                                nt * L::kPanel + off),
                hi, lo);
          *reinterpret_cast<uint32_t*>(sm + thi + off) = hi;
          *reinterpret_cast<uint32_t*>(sm + tlo + off) = lo;
        }
        fence_async_smem();
        __syncthreads();
        if (g_rows) {
          float gt[Q / 2];
#pragma unroll
          for (int i = 0; i < Q / 2; ++i) gt[i] = 0.0f;
          uint32_t ah[4][4], al[4][4];
          uint64_t dh[4], dl[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float c[4];
            c_frag(4 * nt + u, c);
#pragma unroll
            for (int e = 0; e < 4; ++e) split(c[e], ah[u][e], al[u][e]);
            dh[u] = make_desc(base + thi + u * 32);
            dl[u] = make_desc(base + tlo + u * 32);
          }
          fence_regs(dh);
          fence_regs(dl);
          fence_regs(ah);
          fence_regs(al);
          fence_regs(gt);
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < 4; ++u)
            wgmma_split(gt, ah[u], al[u], dh[u], dl[u]);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(gt);
#pragma unroll
          for (int i = 0; i < Q / 2; ++i) gacc[i] += gt[i];
        }
        __syncthreads();                  // the panel is read
      }
    }
    __syncthreads();                        // C and the tiles are read
    // G into its region, one 16-byte fragment (k-step ks: registers 4 ks ..
    // 4 ks + 3) a lane, for the k-steps left of the warpgroup's diagonal
    if (g_rows) {
      const int nks = wg ? L::kKs1 : L::kKs0;
      const uint32_t gw = base + L::kG + (wg ? L::kKs0 * 2048 : 0) +
                          (wv * nks * 32 + lane) * 16;
#pragma unroll
      for (int ks = 0; ks < Q / 8; ++ks)
        if (ks < nks) {
          const uint32_t v[4] = {
              __float_as_uint(gacc[4 * ks]), __float_as_uint(gacc[4 * ks + 1]),
              __float_as_uint(gacc[4 * ks + 2]),
              __float_as_uint(gacc[4 * ks + 3])};
          sts4(gw + ks * 32 * 16, v);
        }
    }
  }

  for (int h = h0; h < h1; ++h) {
    cp_async_wait<0>();                     // this head's stage is in
    __syncthreads();

    // ---- dA_cs and the decay: warp 0, Q / 32 consecutive values a lane ----
    if (warp == 0) {
      constexpr int PER = Q / 32;
      const float* das = reinterpret_cast<const float*>(sm + L::kDA);
      float v[PER];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        run += das[lane * PER + e];
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
      const float last = __shfl_sync(0xffffffffu, excl + v[PER - 1], 31);
      float* csw = reinterpret_cast<float*>(sm + L::kCs);
      float* decw = reinterpret_cast<float*>(sm + L::kDec);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int j = lane * PER + e;
        const float val = excl + v[e];
        csw[j] = val;
        decw[j] = exp_fast(last - val);
        dacs[(row0 + j) * H + h] = val;
      }
    }

    // ---- xd into hi and lo, transposed to (P, Q) K-major, j permuted ------
    // a unit is one p and the four j of one parity in a group of 8, which
    // the permutation puts in one 16-byte chunk of the panel row: four
    // reads (lanes on 32 consecutive p, so no bank conflict) and one
    // 16-byte store each for hi and lo
    {
      const uint32_t xs = base + L::kRaw;
      constexpr int kUnits = P * (Q / 8) * 2;
#pragma unroll 4
      for (int u = tid; u < kUnits; u += kThreads) {
        const int p = u % P;
        const int jg = (u / P) / 2, par = (u / P) % 2;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(lds(xs + ((8 * jg + 2 * e + par) * L::kRS + p) * 4), hi[e],
                lo[e]);
        const uint32_t off = (jg >> 2) * (P * 128) +
                             swz(p, 8 * (jg & 3) + 4 * par);
        sts4(base + off, hi);
        sts4(base + L::kXBytes + off, lo);
      }
    }
    fence_async_smem();
    __syncthreads();
    prefetch(h + 1);                        // lands during the products

    // ---- Y_diag = (G o L) xd: rows 64 wg .. 64 wg + 63 ----------------------
    if (64 * wg < Q) {
      const int w0 = 64 * wg + 16 * wv;          // this warp's first row
      const int i0 = w0 + g, i1 = i0 + 8;
      const uint32_t csa = base + L::kCs;
      const float ci0 = i0 < Q ? lds(csa + 4 * i0) : 0.0f;
      const float ci1 = i1 < Q ? lds(csa + 4 * i1) : 0.0f;
      const int nks = wg ? L::kKs1 : L::kKs0;    // left of the diagonal
      const uint32_t gr = base + L::kG + (wg ? L::kKs0 * 2048 : 0) +
                          (wv * nks * 32 + lane) * 16;
      // S's fragments of group grp: a0 (i0, j0), a1 (i1, j0), a2 (i0, j1),
      // a3 (i1, j1); the warp's rows see all of a k-step's columns, none,
      // or (on the diagonal) some
      auto build = [&](int grp, uint32_t (&ah)[kGroup][4],
                       uint32_t (&al)[kGroup][4]) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int ks = grp * kGroup + u;
          const int j0 = 8 * ks + 2 * t, j1 = j0 + 1;
          float sv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (w0 < Q && 8 * ks <= w0 + 15) {
            const float4 gv = lds4(gr + ks * 32 * 16);
            const float cj0 = lds(csa + 4 * j0), cj1 = lds(csa + 4 * j1);
            if (8 * ks + 7 <= w0) {
              sv[0] = gv.x * exp_fast(ci0 - cj0);
              sv[1] = gv.z * exp_fast(ci1 - cj0);
              sv[2] = gv.y * exp_fast(ci0 - cj1);
              sv[3] = gv.w * exp_fast(ci1 - cj1);
            } else {
              sv[0] = (j0 <= i0 && i0 < Q) ? gv.x * exp_fast(ci0 - cj0) : 0.0f;
              sv[1] = (j0 <= i1 && i1 < Q) ? gv.z * exp_fast(ci1 - cj0) : 0.0f;
              sv[2] = (j1 <= i0 && i0 < Q) ? gv.y * exp_fast(ci0 - cj1) : 0.0f;
              sv[3] = (j1 <= i1 && i1 < Q) ? gv.w * exp_fast(ci1 - cj1) : 0.0f;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) split(sv[e], ah[u][e], al[u][e]);
        }
      };
      float acc[P / 2];
      chain(acc, nks / kGroup, build, base, L::kXBytes);
#pragma unroll
      for (int i = 0; i < P / 2; i += 2) {
        const int row = 64 * wg + 16 * wv + g + 8 * ((i >> 1) & 1);
        const int p = 8 * (i >> 2) + 2 * t;
        if (row < Q)
          *reinterpret_cast<float2*>(y + ((row0 + row) * H + h) * P + p) =
              make_float2(acc[i], acc[i + 1]);
      }
    }

    // ---- state^T = (B o dec)^T xd: states n = 64 wg .. 64 wg + 63 -----------
    if (64 * wg < N) {
      const int n0 = 64 * wg + 16 * wv + g, n1 = n0 + 8;
      const uint32_t bp = base + L::kB + (n0 >> 5) * L::kPanel;
      // (B o dec)^T's fragments of group grp: a0 (n0, j0), a1 (n1, j0), a2
      // (n0, j1), a3 (n1, j1); n0 and n1 lie in one panel
      auto build = [&](int grp, uint32_t (&ah)[kGroup][4],
                       uint32_t (&al)[kGroup][4]) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int ks = grp * kGroup + u;
          const int j0 = 8 * ks + 2 * t, j1 = j0 + 1;
          const float d0 = lds(base + L::kDec + 4 * j0);
          const float d1 = lds(base + L::kDec + 4 * j1);
          auto bv = [&](int n, int j) { return lds(bp + swz(j, n & 31)); };
          const float av[4] = {bv(n0, j0) * d0, bv(n1, j0) * d0,
                               bv(n0, j1) * d1, bv(n1, j1) * d1};
#pragma unroll
          for (int e = 0; e < 4; ++e) split(av[e], ah[u][e], al[u][e]);
        }
      };
      float acc[P / 2];
      chain(acc, Q / 8 / kGroup, build, base, L::kXBytes);
      const int64_t st0 = (bc * H + h) * (int64_t)P * N;
#pragma unroll
      for (int i = 0; i < P / 2; ++i) {
        const int n = 64 * wg + 16 * wv + g + 8 * ((i >> 1) & 1);
        const int p = 8 * (i >> 2) + 2 * t + (i & 1);
        if (n < N) states[st0 + (int64_t)p * N + n] = acc[i];
      }
    }
  }
  cp_async_wait<0>();
}

// Raise a kernel's dynamic shared-memory limit once per device: the
// attribute outlives the launch.
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

struct Args {
  const float* xd;
  const float* dA;
  const void* B;
  const void* C;
  float* y;
  float* states;
  float* dacs;
  int batch, S, H, N;
  int64_t b_sb, b_ss, c_sb, c_ss;
  cudaStream_t stream;
};

template <typename T, int Q, int P>
cudaError_t launch(const Args& a) {
  using L = Layout<Q, P>;
  static bool smem_set[kMaxDevices];
  static_assert(L::kBytes <= 232448, "shared memory past Hopper's 227 KB");
  cudaError_t err = allow_smem_once(
      (const void*)ssd_intra_chunk_kernel<T, Q, P>, L::kBytes, smem_set);
  if (err != cudaSuccess) return err;
  // a block per (chunk, run of heads): as many runs as fill the SMs once
  const int nc = a.S / Q;
  const long long chunks = (long long)a.batch * nc;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  long long per = (chunks * a.H + sms - 1) / sms;         // heads a block
  if (per > a.H) per = a.H;
  const int runs = (int)((a.H + per - 1) / per);         // runs a chunk
  const int hpb = (a.H + runs - 1) / runs;               // evened out
  if (chunks * runs >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  ssd_intra_chunk_kernel<T, Q, P>
      <<<(unsigned)(chunks * runs), kThreads, L::kBytes, a.stream>>>(
          a.xd, a.dA, static_cast<const T*>(a.B), static_cast<const T*>(a.C),
          a.y, a.states, a.dacs, nc, a.H, a.N, hpb, runs, a.b_sb, a.b_ss,
          a.c_sb, a.c_ss);
  return cudaGetLastError();
}

template <typename T, int Q>
cudaError_t by_head_dim(int P, const Args& a) {
  switch (P) {
    case 16:
      return launch<T, Q, 16>(a);
    case 32:
      return launch<T, Q, 32>(a);
    case 64:
      return launch<T, Q, 64>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_chunk(int Q, int P, const Args& a) {
  switch (Q) {
    case 32:
      return by_head_dim<T, 32>(P, a);
    case 64:
      return by_head_dim<T, 64>(P, a);
    case 128:
      return by_head_dim<T, 128>(P, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 on success).  xd (batch, S, H, P), dA (batch,
// S, H), y (batch, S, H, P), states (batch, S / Q, H, P, N) and dacs
// (batch, S, H) are contiguous float32 device pointers, xd 16-byte
// aligned; B and C are (batch, S, N) of `dtype` (0 float32, 1 bfloat16)
// with unit stride in N and element strides b_sb / b_ss (c_sb / c_ss) over
// batch and sequence.  Q in {32, 64, 128}, P in {16, 32, 64}, 1 <= N <=
// 128, S % Q == 0; batch, S and H positive.
extern "C" int ssd_intra_chunk_launch(const float* xd, const float* dA,
                                      const void* B, const void* C, float* y,
                                      float* states, float* dacs, int dtype,
                                      int batch, int S, int H, int P, int N,
                                      int Q, int64_t b_sb, int64_t b_ss,
                                      int64_t c_sb, int64_t c_ss,
                                      void* stream) {
  if (N < 1 || N > kMaxState || Q <= 0 || S % Q != 0 || S / Q > 65535 ||
      batch > 65535 || batch < 1 || S < 1 || H < 1 ||
      reinterpret_cast<uintptr_t>(xd) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{xd, dA,   B,    C,    y,    states, dacs, batch, S,
               H,  N,    b_sb, b_ss, c_sb, c_ss,   (cudaStream_t)stream};
  if (dtype == 0) return (int)by_chunk<float>(Q, P, a);
  if (dtype == 1) return (int)by_chunk<__nv_bfloat16>(Q, P, a);
  return (int)cudaErrorInvalidValue;
}
