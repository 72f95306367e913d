// Fused neighbourhood gather + order-statistic aggregation for Hopper
// (sm_90a): the per-neighbourhood trimmed mean or median of the robust
// combination step.
//
// Replaces the Pallas TPU kernel
// repro/kernels/diffusion_mix.py::gather_robust_mix (_gather_robust_kernel
// with _bitonic_sort).  For every target k and column j:
//
//   v[s]   = member[k, s] > 0 ? W[idx[k, s], j] : +inf     s = 0 .. D-1
//   srt    = v sorted ascending
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
// M = 361,821,120 on an H100's 3.35 TB/s (6.91 ms at K = 8).  Its
// operations are one sort per distinct member set and column (min and max
// issue at half the float32 FMA rate) and a multiply and an add per slot
// of each active target: about 2 ms at either shape, so bytes bound it.
//
// What the design does about it.
// - Reads.  A block owns a group of R consecutive targets (the plan of
//   kernels/gather_mix.py::stage_plan) and walks column chunks (1024
//   columns for U <= 8, 512 above, so that two blocks fit an SM).  It
//   stages the group's U distinct rows of a chunk once, with 16-byte
//   cp.async copies one chunk ahead, rows of any phase
//   (gather_stage.cuh), and computes every output of the group from
//   shared memory.  Device reads are U/R times the stack, 1 on the
//   training ring and on FedAvg.
// - Sorts.  The sorted vector depends only on the member set, so targets
//   of a group whose realized member sets are equal share one sort: the
//   plan's `order` (kernels/gather_robust_mix.py::share_sorts) lists the
//   group's active targets set by set, the first of each set flagged as
//   its leader, then the inactive ones.  A thread sorts a column when it
//   meets a leader and applies each target's own wslot row to the values
//   it holds, skipping its zero weights (the sum starts at +0 and so is
//   never -0, and adding +-0 leaves it as it is).  A target whose wslot
//   row is also bit-equal to the one before it in the walk (flagged
//   "same") takes that target's result.  At FedAvg with every agent
//   active that is one sort and one contraction per column instead of
//   eight of each.  The network is the smallest in sort_networks.cuh for
//   D (19 compare-exchanges at D = 8 where the padded bitonic network
//   took 24), unrolled through a template on its width so that the
//   values stay in registers.  Targets whose slots are all members load
//   without a select per value; targets whose weights are all positive or
//   zero test a bit mask instead of each weight.
// - Writes.  Results and the inactive targets' own staged rows go through
//   a shared output tile to 16-byte stores.
//
// A table whose groups cannot stage a union of at most 16 rows (FedAvg at
// K > 16) takes the second route of this kernel: block b serves target
// b % K of a 1024-column chunk, gathering its members with 4-byte __ldg
// loads that the 50 MB L2 serves for the other K - 1 readers, and sorting
// per target and column.  The plan chooses the route (rows == nullptr:
// the one-target route); one launch either way.  D > 32 is refused (the
// wrapper raises ValueError).  Offsets are 64-bit: idx[k, s] * M + j
// passes 2^31 at K = 12 smollm.
//
// Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/gather_robust_mix.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "gather_stage.cuh"

namespace {

using namespace gather_stage;

constexpr int kMaxSlots = 32;
// flags of an `order` entry above the target's index
constexpr int kLeader = 1 << 30;
constexpr int kInactive = 1 << 29;
constexpr int kSame = 1 << 28;
constexpr int kTargetMask = kSame - 1;
// flags the kernel adds for itself: every slot is a member; some weight is
// neither positive nor zero (negative or nan)
constexpr int kFull = 1 << 27;
constexpr int kOddWeight = 1 << 26;

// Ascending sort of P values held in registers by the table's network.
template <int P>
__device__ __forceinline__ void sort_net(float (&v)[P]);

#define CX(i, j)                            \
  {                                         \
    const float lo_ = fminf(v[i], v[j]);    \
    const float hi_ = fmaxf(v[i], v[j]);    \
    v[i] = lo_;                             \
    v[j] = hi_;                             \
  }
#define SORT_NET(P, N, ...)                                          \
  template <>                                                        \
  __device__ __forceinline__ void sort_net<P>(float(&v)[P]) {        \
    (void)v;                                                         \
    __VA_ARGS__                                                      \
  }
#include "sort_networks.cuh"
#undef SORT_NET
#undef CX

// ---------------------------------------------------------------- group route

template <int P, int C>
__global__ void __launch_bounds__(kThreads, 2)
robust_group_kernel(const int* __restrict__ idx,
                    const float* __restrict__ member,
                    const float* __restrict__ wslot,
                    const float* __restrict__ W, float* __restrict__ out,
                    const int* __restrict__ rows,
                    const int* __restrict__ slot,
                    const int* __restrict__ order, int K, int D, int64_t M,
                    int R, int U, int64_t nchunks) {
  constexpr int S = C + 4;
  constexpr int V = C / kThreads;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem + kStages * U * S;                  // (R, S) outputs
  int4* tgt = reinterpret_cast<int4*>(tile + R * S);     // (R,) by order
  int2* ent = reinterpret_cast<int2*>(tgt + R);          // (R, D) by order
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
  float v[V][P];
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
      // by order position: each slot's staged position + phase (-1 for a
      // non-member) and weight, and the target's own row
      for (int e = threadIdx.x; e < nt * D; e += kThreads) {
        const int i = e / D;
        const int64_t k = __ldg(order + first + i) & kTargetMask;
        const int64_t ks = k * D + (e - i * D);
        const int r = __ldg(idx + ks);
        const int pos = __ldg(slot + ks) * S + phase_of(W + (int64_t)r * M);
        ent[e] = make_int2(__ldg(member + ks) > 0.0f ? pos : -1,
                           __float_as_int(__ldg(wslot + ks)));
      }
      // by order position: the target, its flags, its own row, and the
      // mask of its positive weights
      for (int i = threadIdx.x; i < nt; i += kThreads) {
        int o = __ldg(order + first + i);
        const int k = o & kTargetMask;
        const int64_t k0 = (int64_t)k * D;
        unsigned live = 0;
        o |= kFull;
        for (int s = 0; s < D; ++s) {
          const float w = __ldg(wslot + k0 + s);
          if (w > 0.0f) live |= 1u << s;
          else if (w != 0.0f) o |= kOddWeight;
          if (!(__ldg(member + k0 + s) > 0.0f)) o &= ~kFull;
        }
        const int r = __ldg(idx + k0);
        tgt[i] = make_int4(
            k - first, o, __ldg(slot + k0) * S + phase_of(W + (int64_t)r * M),
            (int)live);
        s_q[k - first] = phase_of(out + (int64_t)k * M);
      }
      __syncthreads();
      cur = it.g;
    }

    const float* buf = smem + (n % kStages) * U * S + threadIdx.x;
    float acc[V];
    for (int i = 0; i < nt; ++i) {
      const int4 tg = tgt[i];
      float* o = tile + tg.x * S + s_q[tg.x] + threadIdx.x;
      if (tg.y & kInactive) {     // its own float32 row, bit-exactly
#pragma unroll
        for (int c = 0; c < V; ++c) o[c * kThreads] = buf[tg.z + c * kThreads];
        continue;
      }
      if (tg.y & kSame) {         // the previous target's set and weights
#pragma unroll
        for (int c = 0; c < V; ++c) o[c * kThreads] = acc[c];
        continue;
      }
      const int2* e = ent + i * D;
      if (tg.y & kLeader) {       // the first target of a member set sorts
        // P == D up to 16 (sort_networks.cuh has every width there); the
        // slots past D and the non-members are +inf
        if (tg.y & kFull) {
#pragma unroll
          for (int s = 0; s < P; ++s) {
            const int pos = P <= 16 || s < D ? e[s].x : -1;
#pragma unroll
            for (int c = 0; c < V; ++c)
              v[c][s] = P <= 16 || pos >= 0 ? buf[pos + c * kThreads]
                                            : CUDART_INF_F;
          }
        } else {
#pragma unroll
          for (int s = 0; s < P; ++s) {
            const int pos = P <= 16 || s < D ? e[s].x : -1;
#pragma unroll
            for (int c = 0; c < V; ++c)
              v[c][s] = pos >= 0 ? buf[pos + c * kThreads] : CUDART_INF_F;
          }
        }
#pragma unroll
        for (int c = 0; c < V; ++c) sort_net<P>(v[c]);
      }
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = 0.0f;
      // slot order, a separate multiply and add, as the reference; a zero
      // weight adds +-0 to a sum that is never -0 and is skipped
      if (!(tg.y & kOddWeight)) {
        const unsigned live = (unsigned)tg.w;
#pragma unroll
        for (int s = 0; s < P; ++s) {
          if ((P <= 16 || s < D) && (live >> s & 1u)) {
            const float w = __int_as_float(e[s].y);
#pragma unroll
            for (int c = 0; c < V; ++c)
              acc[c] = __fadd_rn(acc[c], __fmul_rn(v[c][s], w));
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < P; ++s) {
          const float w = P <= 16 || s < D ? __int_as_float(e[s].y) : 0.0f;
          if (w != 0.0f) {
#pragma unroll
            for (int c = 0; c < V; ++c)
              acc[c] = __fadd_rn(acc[c],
                                 __fmul_rn(w > 0.0f ? v[c][s] : 0.0f, w));
          }
        }
      }
#pragma unroll
      for (int c = 0; c < V; ++c) o[c * kThreads] = acc[c];
    }
    __syncthreads();              // the tile is complete
    store_chunk<C>(out, tile, R, nt, M, it);
  }
  cp_async_wait<0>();
}

template <int P, int C>
cudaError_t group_shape(int K, int D, int64_t M, int R, int U, int* blocks,
                        size_t* smem) {
  const int64_t items = (int64_t)((K + R - 1) / R) * ((M + C - 1) / C);
  const size_t extra = (size_t)R * (sizeof(int4) + sizeof(int)) +
                       (size_t)R * D * sizeof(int2);
  *smem = smem_bytes<C>(U, R, extra);
  return grid_for(robust_group_kernel<P, C>, *smem, items, blocks);
}

template <int P, int C>
cudaError_t launch_group(const int* idx, const float* member,
                         const float* wslot, const float* W, float* out,
                         int K, int D, int64_t M, const int* rows,
                         const int* slot, const int* order, int R, int U,
                         cudaStream_t stream) {
  int blocks = 0;
  size_t smem = 0;
  cudaError_t err = group_shape<P, C>(K, D, M, R, U, &blocks, &smem);
  if (err != cudaSuccess) return err;
  robust_group_kernel<P, C><<<blocks, kThreads, smem, stream>>>(
      idx, member, wslot, W, out, rows, slot, order, K, D, M, R, U,
      (M + C - 1) / C);
  return cudaGetLastError();
}

// ----------------------------------------------------------- one-target route

constexpr int kCols = 4;             // columns per thread, one at a time
constexpr int kChunk = kThreads * kCols;
constexpr int kBlocksPerSM = 8;

template <int P>
__global__ void __launch_bounds__(kThreads)
robust_target_kernel(const int* __restrict__ idx,
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
      sort_net<P>(v);
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
cudaError_t launch_target(const int* idx, const float* member,
                          const float* wslot, const float* active,
                          const float* W, float* out, int K, int D,
                          int64_t M, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t nchunks = (M + kChunk - 1) / kChunk;
  const int64_t need = (int64_t)K * nchunks;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  const int blocks = (int)(need < cap ? need : cap);
  robust_target_kernel<P><<<blocks, kThreads, 0, stream>>>(
      idx, member, wslot, active, W, out, K, D, M, nchunks);
  return cudaGetLastError();
}

// The chunk of the group route: 1024 columns for U <= 8 (four columns a
// thread, whose values stay in registers up to 16 slots), 512 above, so
// that two blocks of 256 threads fit an SM.
template <int P, class Fn>
cudaError_t at_chunk(int U, Fn fn) {
  if constexpr (P <= 16)
    if (U <= 8) return fn(std::integral_constant<int, 1024>());
  return fn(std::integral_constant<int, 512>());
}

template <int P>
cudaError_t shape_of(int K, int D, int64_t M, int R, int U, int* shape) {
  int blocks = 0;
  size_t smem = 0;
  const cudaError_t err = at_chunk<P>(U, [&](auto c) {
    shape[3] = decltype(c)::value;
    return group_shape<P, decltype(c)::value>(K, D, M, R, U, &blocks, &smem);
  });
  shape[0] = blocks;
  shape[1] = kStages;
  shape[2] = (int)smem;
  return err;
}

template <int P>
cudaError_t launch(const int* idx, const float* member, const float* wslot,
                   const float* active, const float* W, float* out, int K,
                   int D, int64_t M, const int* rows, const int* slot,
                   const int* order, int R, int U, cudaStream_t stream) {
  if (rows == nullptr)
    return launch_target<P>(idx, member, wslot, active, W, out, K, D, M,
                            stream);
  return at_chunk<P>(U, [&](auto c) {
    return launch_group<P, decltype(c)::value>(
        idx, member, wslot, W, out, K, D, M, rows, slot, order, R, U, stream);
  });
}

}  // namespace

// every width of sort_networks.cuh, smallest first
#define REPRO_SORT_WIDTHS                                                  \
  REPRO_SORT_WIDTH(1) REPRO_SORT_WIDTH(2) REPRO_SORT_WIDTH(3)              \
  REPRO_SORT_WIDTH(4) REPRO_SORT_WIDTH(5) REPRO_SORT_WIDTH(6)              \
  REPRO_SORT_WIDTH(7) REPRO_SORT_WIDTH(8) REPRO_SORT_WIDTH(9)              \
  REPRO_SORT_WIDTH(10) REPRO_SORT_WIDTH(11) REPRO_SORT_WIDTH(12)           \
  REPRO_SORT_WIDTH(13) REPRO_SORT_WIDTH(14) REPRO_SORT_WIDTH(15)           \
  REPRO_SORT_WIDTH(16) REPRO_SORT_WIDTH(24) REPRO_SORT_WIDTH(32)

// Returns a cudaError_t (0 on success).  idx (K, D) int32; member, wslot
// (K, D) float32; active (K,) float32; W and out (K, M) float32: device
// pointers, row-major.  1 <= D <= 32.  rows (G, U), slot (K, D) and order
// (G R,) int32 are the plan of the group route, groups of R targets
// (G = ceil(K / R)); rows == nullptr takes the one-target route.
extern "C" int gather_robust_mix_launch(const int* idx, const float* member,
                                        const float* wslot,
                                        const float* active, const float* W,
                                        float* out, int K, int D, int64_t M,
                                        const int* rows, const int* slot,
                                        const int* order, int R, int U,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 0 || D <= 0 || D > kMaxSlots || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows != nullptr &&
      (slot == nullptr || order == nullptr || R < 1 || R > kMaxGroup ||
       U < 1 || U > kMaxRows || R * D > kMaxEntries))
    return (int)cudaErrorInvalidValue;
#define REPRO_SORT_WIDTH(P)                                                \
  if (D <= P)                                                              \
    return (int)launch<P>(idx, member, wslot, active, W, out, K, D, M,     \
                          rows, slot, order, R, U, s);
  REPRO_SORT_WIDTHS
#undef REPRO_SORT_WIDTH
  return (int)cudaErrorInvalidValue;
}

// The group route's launch for these sizes: shape = {blocks, ring depth,
// shared-memory bytes, chunk columns}.  Returns a cudaError_t.
extern "C" int gather_robust_mix_shape(int K, int D, int64_t M, int R, int U,
                                       int* shape) {
  if (D <= 0 || D > kMaxSlots) return (int)cudaErrorInvalidValue;
#define REPRO_SORT_WIDTH(P) \
  if (D <= P) return (int)shape_of<P>(K, D, M, R, U, shape);
  REPRO_SORT_WIDTHS
#undef REPRO_SORT_WIDTH
  return (int)cudaErrorInvalidValue;
}
