// Flash attention for Hopper (sm_90a): forward (K1), dq (K2) and dk/dv (K3).
//
// Replaces the three Pallas TPU kernels of bluefog_tpu/ops/flash_attention.py:
//   K1 bf_flash_fwd  <- _fwd_kernel  (launched by _fwd)
//   K2 bf_flash_dq   <- _dq_kernel   (with _bwd_tile)
//   K3 bf_flash_dkv  <- _dkv_kernel  (with _bwd_tile)
// Same function: scale 1/sqrt(D), mask value -1e30 (masked probabilities are
// exactly 0), f32 accumulation, O = acc / max(l, 1e-30), lse = m + log(l).
//
// Layout.  q, k, v, dO and O are (B, S, H, D) tensors read through their
// strides (unit stride along D), so the fused-QKV slices of the model need
// no fold transpose and no copy.  O, dq, dk and dv are written contiguous
// (B, S, H, D); lse and delta are f32 (B, H, S), dlse f32 (B, S, H).
//
// Types.  The element type is a build parameter: bf16, or float16 with
// -DFLASH_F16 (one library a dtype and instance; the same kernels, their
// wgmma on f16 operands, hopper.cuh).  float32 operands run in
// csrc/flash_attention_f32.cu; operands of mixed dtypes or float64 run
// there on float32 copies (ops/flash_attention.py).
//
// Head dims.  Three instances, D = 64, 128 and 256; a head dim Dt <= 256
// runs in the smallest instance D >= Dt, every Dt > 256 in the wide route
// of flash_wide.cuh (-DFLASH_D=0).  The tensor maps give the TMA the
// true Dt as the inner extent and the instance's 64-column boxes, so the
// columns past Dt arrive zero-filled: they add nothing to Q.K^T or dO.V^T
// and give zero output columns, which the epilogues do not store (they
// write the first Dt columns only).  Operands whose strides a tensor map
// cannot describe are copied by the wrapper into a padded buffer first.
//
// Bounds on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the main
// path's shape B=2, S=2048, H=16, D=128, causal (half the score matrix):
//   K1: 4*B*H*S*S*D/2 = 34.4 GFLOP -> 0.035 ms; 67 MB in/out -> 0.020 ms
//   K2: 6*B*H*S*S*D/2 = 51.5 GFLOP -> 0.052 ms; 101 MB in/out -> 0.030 ms
//   K3: 8*B*H*S*S*D/2 = 68.7 GFLOP -> 0.069 ms; 101 MB in/out -> 0.030 ms
// All three are bound by tensor-core operations: each K/V (or Q/dO) tile
// in shared memory is reused by a whole block of rows.  The full
// tensor-core rate needs wgmma fed by asynchronous loads.
//
// All three are warp-specialised wgmma kernels.  A block is 3 warpgroups:
// two consumers of 64 rows each, and a producer of which one warp works
// (setmaxnreg moves registers to the consumers).  The producer issues
// TMA loads through tensor maps on the caller's strides (the Python
// launch plan, ops/flash_attention.launch_plan, gives their dims, byte
// strides and boxes); rows past S arrive zero-filled, so ragged S needs no
// padding.  The streamed tiles pass through a 2-stage ring in shared
// memory with a full and an empty mbarrier per stage, so the next tile
// loads while the consumers work on this one.  Every product is a wgmma
// on 128-byte-swizzled tiles (hopper.cuh).  Masks are applied only on the
// tiles that cross the causal diagonal or the end of the sequence.
// Grid (B*H, row tiles): block order puts the heaviest causal tiles of
// every head first, so the short tiles fill the tail.
// At D = 256 the tiles shrink to fit 232,448 bytes of shared memory and a
// thread's registers: K1 streams 64-key tiles; K2 owns 64 query rows with
// one consumer warpgroup (256 threads, 64-key tiles); K3 owns 64 keys and
// its two consumer warpgroups split the work by role, one dV and one dK
// (each accumulator 128 registers a thread; both would not fit one).
//   K1: a block owns 128 query rows; Q arrives once, K and V tiles of 128
//     keys stream.  S = Q.K^T (m64n128k16, both operands K-major in shared
//     memory), the online softmax runs on the accumulator in registers,
//     P is converted there to 16-bit A fragments and O += P.V (m64nDk16)
//     takes V MN-major from shared memory: P never touches memory.
//   K2: a block owns 128 query rows; Q, dO and O arrive once, K and V
//     tiles of 128 keys stream as in K1.  First each thread computes
//     delta = rowsum(dO O) - dlse for its two rows from the O and dO tiles
//     in shared memory and writes it for K3 (this replaces a chain of torch
//     ops over two f32 copies of O and dO).  Per key tile, S = Q.K^T and
//     dP = dO.V^T are m64n128k16 (all K-major), committed as two groups so
//     that P is computed from S while dP is still in the tensor cores;
//     dS / scale = P (dP - delta) follows on the accumulators in registers
//     (a thread holds two rows, so lse and delta are four registers) and
//     is packed into 16-bit A fragments; dQ += dS.K (m64nDk16)
//     reads K MN-major from the same shared tile.  dQ takes the scale once
//     at the end and stays in registers: no atomics, deterministic.
//   K3: a block owns 128 keys; K and V arrive once, Q and dO tiles of 64
//     rows stream with their lse and delta slices (the producer warp
//     writes those, the TMA the tiles).  The S^T = K.Q^T and dP^T = V.dO^T
//     accumulators (m64n64k16, shared operands) start from -lse/scale and
//     -delta of their query columns, so P^T = exp2(acc * scale log2 e) and
//     dS^T / scale = P^T * acc need no lse or delta beside them in
//     registers: that is what keeps the 128 dK and dV accumulators of a
//     thread unspilled.  Then dV += P^T.dO and dK += dS^T.Q (m64nDk16, A
//     from registers, B MN-major); dK takes the scale once, at the end.
//     Both sums stay in registers: no atomics, no second pass,
//     deterministic.
// What bounds them now (PERF.md, kernel_ablations.py): with 8 computing
// warps per SM, the chain of each tile (TMA wait, a batch of wgmma, the
// softmax or the dS arithmetic on the CUDA cores, the next batch) is
// latency-bound: K1 reaches about 41%, K2 about 50% and K3 about 51% of
// the tensor-core bound.  In K2 the dQ product's own round trip (issue,
// wait) is about a third of the time; loads, stages and the exponentials
// are not what holds it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_wide.cuh"
#include "hopper.cuh"

namespace {

// The operands' element type: bf16, or float16 in a build with -DFLASH_F16
// (hopper.cuh's wgmma take the same type).
#ifdef FLASH_F16
typedef __half elem;
typedef __half2 elem2;
constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
__device__ __forceinline__ elem2 to_pair(float lo, float hi) { return __floats2half2_rn(lo, hi); }
__device__ __forceinline__ float2 from_pair(elem2 v) { return __half22float2(v); }
#else
typedef __nv_bfloat16 elem;
typedef __nv_bfloat162 elem2;
constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
__device__ __forceinline__ elem2 to_pair(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ float2 from_pair(elem2 v) { return __bfloat1622float2(v); }
#endif

using flash::kLn2;
using flash::kLog2e;
using flash::kMask;

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  elem2 v = to_pair(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns d and d + 1 of a row of Dt columns: one 4-byte store when Dt is
// even (d is even, so the pair is aligned), else one store per column.
__device__ __forceinline__ void store_pair(elem* p, int d, int Dt, float lo, float hi) {
  if ((Dt & 1) == 0) {
    if (d < Dt) *reinterpret_cast<uint32_t*>(p) = pack_f(lo, hi);
  } else {
    if (d < Dt) p[0] = wide::from_f<elem>(lo);
    if (d + 1 < Dt) p[1] = wide::from_f<elem>(hi);
  }
}

// Store the first Dt columns of a warp's 16 x D f32 accumulator as 16-bit
// rows of a contiguous (B, S, H, Dt) tensor; `base` points at (b, 0, h, 0).
template <int D>
__device__ __forceinline__ void store_rows(elem* base, int H, int S, int Dt, int row0,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1, int g, int t) {
  const long long rs = (long long)H * Dt;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * t;
    if (r0 < S) store_pair(base + r0 * rs + d, d, Dt, acc[n][0] * mul0, acc[n][1] * mul0);
    if (r1 < S) store_pair(base + r1 * rs + d, d, Dt, acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

// ---------------------------------------------------------------------------
// K1-K3: warp-specialised wgmma + TMA kernels (see the note above).
// ---------------------------------------------------------------------------
constexpr int kAlign = 1024;        // swizzled tiles start 1024-byte aligned
constexpr int kProducerRegs = 24;   // setmaxnreg budgets: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;  // = 64512 of the SM's 65536 registers

// Every block is kConsumers consumer warpgroups and one producer
// warpgroup; with two consumers the producer's registers move to them
// (setmaxnreg), with one the 256 threads take up to 255 registers each.
template <int D>
struct FwdTile {
  static constexpr int kConsumers = 2;
  static constexpr int kRows = 128;  // query rows per block
  static constexpr int kKeys = D > 128 ? 64 : 128;  // keys per pipeline stage
  static constexpr int kStages = 2;
  static constexpr uint32_t kQBytes = kRows * D * 2;
  static constexpr uint32_t kKVBytes = kKeys * D * 2;  // one K or V tile
  static constexpr int kSmem = kAlign + kQBytes + kStages * 2 * kKVBytes;
};

template <int D>
struct DqTile {
  static constexpr int kConsumers = D > 128 ? 1 : 2;
  static constexpr int kRows = 64 * kConsumers;  // query rows per block
  static constexpr int kKeys = D > 128 ? 64 : 128;  // keys per stage of the ring
  static constexpr int kStages = 2;  // a third does not fit beside Q, dO and O
  static constexpr uint32_t kRowBytes = kRows * D * 2;  // a Q, dO or O tile
  static constexpr uint32_t kKVBytes = kKeys * D * 2;   // one K or V tile
  static constexpr int kSmem = kAlign + 3 * kRowBytes + kStages * 2 * kKVBytes;
};

template <int D>
struct DkvTile {
  static constexpr int kConsumers = 2;
  static constexpr bool kRoles = D > 128;  // both warpgroups on the same keys: dV, dK
  static constexpr int kKeys = kRoles ? 64 : 128;  // keys per block
  static constexpr int kRows = 64;   // query rows per pipeline stage
  static constexpr int kStages = 2;
  static constexpr uint32_t kKVBytes = kKeys * D * 2;   // K or V
  static constexpr uint32_t kRowBytes = kRows * D * 2;  // a Q or dO tile
  // Q tile, dO tile, then lse (log2 units) and delta for its rows.
  static constexpr uint32_t kStageBytes =
      (2 * kRowBytes + 2 * kRows * 4 + kAlign - 1) / kAlign * kAlign;
  static constexpr int kSmem = kAlign + 2 * kKVBytes + kStages * kStageBytes;
};

template <typename T>
constexpr int threads_of() { return 128 * (T::kConsumers + 1); }

template <typename T>
__device__ __forceinline__ void producer_regs() {
  if constexpr (T::kConsumers == 2) hopper::setmaxnreg_dec<kProducerRegs>();
}

template <typename T>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (T::kConsumers == 2) hopper::setmaxnreg_inc<kConsumerRegs>();
}

// The thread's warpgroup, read from lane 0 so that the compiler knows it is
// the same for the whole warp: descriptors computed from it can then live
// in uniform registers.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// TMA of rows [row0, row0 + rows) of the (b, h) slab, as D/64 column
// blocks of (rows x 64) one after the other; columns past the map's head
// dim arrive as zeros.
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int row0, int h,
                                          int b) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf)
    hopper::tma_load_4d(dst + hf * rows * 128, map, bar, hf * 64, row0, h, b);
}

// The producer of K1 and K2: K and V tiles 0 .. n_kt - 1 of the (b, h) slab
// into the ring, a K tile then a V tile per stage.
template <typename T, int D>
__device__ __forceinline__ void stream_kv(unsigned char* sKV, const CUtensorMap* tk,
                                          const CUtensorMap* tv, uint64_t* full,
                                          uint64_t* empty, int n_kt, int h, int b) {
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % T::kStages;
    hopper::mbar_wait(&empty[st], ((kt / T::kStages) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[st], 2 * T::kKVBytes);
    unsigned char* sK = sKV + st * 2 * T::kKVBytes;
    load_rows<D>(sK, tk, &full[st], T::kKeys, kt * T::kKeys, h, b);
    load_rows<D>(sK + T::kKVBytes, tv, &full[st], T::kKeys, kt * T::kKeys, h, b);
  }
}

// K-major descriptor of rows [r0, r0 + ...) of a tile of `rows` rows, at
// k-step kk (columns 16kk..16kk+15).
__device__ __forceinline__ uint64_t desc_rows(uint32_t tile, int rows, int r0, int kk) {
  return hopper::desc_k(tile + (kk / 4) * rows * 128 + r0 * 128 + (kk % 4) * 32);
}

// MN-major descriptor of rows 16kk..16kk+15 of a tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_cols(uint32_t tile, int rows, int kk) {
  return hopper::desc_mn(tile + kk * 16 * 128, rows * 128);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The dot product of row r of two (rows x D) swizzled tiles (hopper.cuh),
// in f32, for every thread of a quad: thread t takes the row's 16-byte
// chunks t, t + 4, ...; quad_sum adds the four parts.
template <int D>
__device__ __forceinline__ float row_dot(const unsigned char* a, const unsigned char* b,
                                         int rows, int r, int t) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    const int c = 4 * j + t;
    const int off = (c / 8) * rows * 128 + r * 128 + ((c % 8) ^ (r % 8)) * 16;
    const uint4 x = *reinterpret_cast<const uint4*>(a + off);
    const uint4 y = *reinterpret_cast<const uint4*>(b + off);
    const elem2* x2 = reinterpret_cast<const elem2*>(&x);
    const elem2* y2 = reinterpret_cast<const elem2*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = from_pair(x2[e]), fy = from_pair(y2[e]);
      sum = fmaf(fx.x, fy.x, sum);
      sum = fmaf(fx.y, fy.y, sum);
    }
  }
  return quad_sum(sum);
}

// Element i of a thread's wgmma m64nN f32 accumulator lies in row
// g + 8 * ((i >> 1) & 1) of its warp's 16 rows and in column
// 8 * (i / 4) + 2t + (i & 1) (g = lane / 4, t = lane % 4): per 8 columns
// the m16n8 C layout, so the array reads as [N / 8][4] for store_rows.
// The pair (i, i + 1) shares a row; packed to 16 bits it is register i / 2 of
// the m16n8k16 A fragments of a product over these columns.
template <int N>
__device__ __forceinline__ const float (&as_frags(const float (&acc)[N]))[N / 4][4] {
  return reinterpret_cast<const float(&)[N / 4][4]>(acc);
}

// Keeps A-fragment registers alive, untouched, until the wgmma that reads
// them has completed: the compiler does not know the product reads them
// after the instruction that issues it.
template <int N>
__device__ __forceinline__ void keep_frags(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// A consumer warp is done with a ring stage.
__device__ __forceinline__ void release_stage(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(empty);
}

// ---------------------------------------------------------------------------
// K1: forward.  Grid (B*H, ceil(S/128)); block = 128 query rows, K/V
// tiles of 128 keys (64 at D = 256) stream up to the causal frontier.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(threads_of<FwdTile<D>>(), 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, elem* __restrict__ o,
                 float* __restrict__ lse, int H, int S, int Dt, float scale_log2,
                 int causal) {
  using T = FwdTile<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar_q, full[T::kStages], empty[T::kStages];
  unsigned char* sQ = align_smem(smem_raw);
  unsigned char* sKV = sQ + T::kQBytes;  // stage s: K tile, then V tile

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kRows;
  const int kend = causal ? min(S, q0 + T::kRows) : S;
  const int n_kt = (kend + T::kKeys - 1) / T::kKeys;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < T::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * T::kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == T::kConsumers) {
    // Producer: one thread issues every load.
    producer_regs<T>();
    if (threadIdx.x % 128 == 0) {
      hopper::mbar_arrive_expect_tx(&bar_q, T::kQBytes);
      load_rows<D>(sQ, &tq, &bar_q, T::kRows, q0, h, b);
      stream_kv<T, D>(sKV, &tk, &tv, full, empty, n_kt, h, b);
    }
  } else {
    // Consumers: warpgroup wg owns rows q0 + 64wg .. q0 + 64wg + 63.
    consumer_regs<T>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * 64;
    const int row[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
    const uint32_t aQ = hopper::smem_u32(sQ), aKV = hopper::smem_u32(sKV);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kMask, kMask};  // running max, log2 units
    float l[2] = {0.f, 0.f};      // per-thread partial row sums

    hopper::mbar_wait(&bar_q, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % T::kStages;
      hopper::mbar_wait(&full[st], (kt / T::kStages) & 1);
      const uint32_t aK = aKV + st * 2 * T::kKVBytes, aV = aK + T::kKVBytes;

      // S = Q . K^T
      float s[T::kKeys / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss(s, desc_rows(aQ, T::kRows, wg * 64, kk),
                         desc_rows(aK, T::kKeys, 0, kk), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // Online softmax; only tiles that cross the diagonal or the end of
      // the sequence are masked.
      const int k0 = kt * T::kKeys;
      if (k0 + T::kKeys > S || (causal && k0 + T::kKeys - 1 > row0)) {
#pragma unroll
        for (int i = 0; i < T::kKeys / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (col >= S || (causal && col > row[(i >> 1) & 1])) s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < T::kKeys / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
        corr[r] = exp2f(m[r] - mn);
        m[r] = mn;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      // P as 16-bit A fragments: pair (i, i + 1) is register i / 2.
      uint32_t p[T::kKeys / 4];
#pragma unroll
      for (int i = 0; i < T::kKeys / 2; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = exp2f(fmaf(s[i], scale_log2, -m[r]));
        const float p1 = exp2f(fmaf(s[i + 1], scale_log2, -m[r]));
        l[r] += p0 + p1;
        p[i / 2] = pack_f(p0, p1);
      }

      // O += P . V
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kKeys / 16; ++kk)
        hopper::wgmma_rs_tb(acc, &p[4 * kk], desc_cols(aV, T::kKeys, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      keep_frags(p);
      hopper::fence_regs(acc);
      release_stage(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    store_rows<D>(o + ((long long)b * S * H + h) * Dt, H, S, Dt, row0 + warp * 16,
                  as_frags(acc), 1.f / l[0], 1.f / l[1], g, t);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < S) lse[(long long)bh * S + row[r]] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dq (and delta for K3).  Grid (B*H, ceil(S/128)); block = 128 query
// rows, 128-key K/V tiles stream up to the causal frontier (D = 256: 64
// rows, one consumer warpgroup, 64-key tiles).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(threads_of<DqTile<D>>(), 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap to, const float* __restrict__ lse,
                const float* __restrict__ dlse, float* __restrict__ delta,
                elem* __restrict__ dq, int H, int S, int Dt, float scale,
                float scale_log2, int causal) {
  using T = DqTile<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar_q, full[T::kStages], empty[T::kStages];
  unsigned char* sQ = align_smem(smem_raw);
  unsigned char* sdO = sQ + T::kRowBytes;
  unsigned char* sO = sdO + T::kRowBytes;
  unsigned char* sKV = sO + T::kRowBytes;  // stage s: K tile, then V tile

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kRows;
  const int kend = causal ? min(S, q0 + T::kRows) : S;
  const int n_kt = (kend + T::kKeys - 1) / T::kKeys;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < T::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * T::kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == T::kConsumers) {
    // Producer: one thread issues every load.
    producer_regs<T>();
    if (threadIdx.x % 128 == 0) {
      hopper::mbar_arrive_expect_tx(&bar_q, 3 * T::kRowBytes);
      load_rows<D>(sQ, &tq, &bar_q, T::kRows, q0, h, b);
      load_rows<D>(sdO, &tdo, &bar_q, T::kRows, q0, h, b);
      load_rows<D>(sO, &to, &bar_q, T::kRows, q0, h, b);
      stream_kv<T, D>(sKV, &tk, &tv, full, empty, n_kt, h, b);
    }
  } else {
    // Consumers: warpgroup wg owns rows q0 + 64wg .. q0 + 64wg + 63.
    consumer_regs<T>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * 64;
    const int row[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
    const uint32_t aQ = hopper::smem_u32(sQ), adO = hopper::smem_u32(sdO);
    const uint32_t aKV = hopper::smem_u32(sKV);

    // The thread's two rows: lse in log2 units, and delta = rowsum(dO O) -
    // dlse, which K3 reads (rows past S: 0, so their dS is 0).
    hopper::mbar_wait(&bar_q, 0);
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = row[r] - q0;
      const float dot = row_dot<D>(sO, sdO, T::kRows, lr, t);
      const bool in = row[r] < S;
      lse2[r] = in ? lse[(long long)bh * S + row[r]] * kLog2e : 0.f;
      dlt[r] = in ? dot - dlse[((long long)b * S + row[r]) * H + h] : 0.f;
      if (t == 0 && in) delta[(long long)bh * S + row[r]] = dlt[r];
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % T::kStages;
      hopper::mbar_wait(&full[st], (kt / T::kStages) & 1);
      const uint32_t aK = aKV + st * 2 * T::kKVBytes, aV = aK + T::kKVBytes;

      // S = Q . K^T and dP = dO . V^T, committed as two groups: P is
      // computed from S while dP is still in the tensor cores.
      float s[T::kKeys / 2], dp[T::kKeys / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss(s, desc_rows(aQ, T::kRows, wg * 64, kk),
                         desc_rows(aK, T::kKeys, 0, kk), kk);
      hopper::wgmma_commit();  // S
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss(dp, desc_rows(adO, T::kRows, wg * 64, kk),
                         desc_rows(aV, T::kKeys, 0, kk), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);

      // P = exp2(S scale log2 e - lse log2 e) in place of S; masked entries
      // are 0, and only tiles that cross the diagonal or the end of the
      // sequence are masked.
      const int k0 = kt * T::kKeys;
      const bool mask = k0 + T::kKeys > S || (causal && k0 + T::kKeys - 1 > row0);
#pragma unroll
      for (int i = 0; i < T::kKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = hopper::exp2_ftz(fmaf(s[i], scale_log2, -lse2[r]));
        if (mask) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (col >= S || (causal && col > row[r])) p = 0.f;
        }
        s[i] = p;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);

      // dS / scale = P (dP - delta) as 16-bit A fragments: pair (i, i + 1)
      // is register i / 2.
      uint32_t ds[T::kKeys / 4];
#pragma unroll
      for (int i = 0; i < T::kKeys / 2; i += 2) {
        const int r = (i >> 1) & 1;
        ds[i / 2] = pack_f(s[i] * (dp[i] - dlt[r]), s[i + 1] * (dp[i + 1] - dlt[r]));
      }

      // dQ += dS . K, K read MN-major from the tile S used.
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kKeys / 16; ++kk)
        hopper::wgmma_rs_tb(acc, &ds[4 * kk], desc_cols(aK, T::kKeys, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      keep_frags(ds);
      hopper::fence_regs(acc);
      release_stage(&empty[st]);
    }

    // dQ takes the scale once, here.
    store_rows<D>(dq + ((long long)b * S * H + h) * Dt, H, S, Dt, row0 + warp * 16,
                  as_frags(acc), scale, scale, g, t);
  }
}

// ---------------------------------------------------------------------------
// K3: dk and dv.  Grid (B*H, ceil(S/128)); block = 128 keys, loop over
// 64-row q tiles from the causal frontier to the end.  At D = 256 a block
// owns 64 keys and its two consumer warpgroups take one role each.
// ---------------------------------------------------------------------------

// A consumer warpgroup of K3 over keys kw0 .. kw0 + 63 (rows kr0 .. kr0 + 63
// of the block's K and V tiles): dV += P^T.dO when kDV, dK += dS^T.Q when
// kDK.  Below D = 256 one warpgroup takes both.
template <typename T, int D, bool kDV, bool kDK>
__device__ __forceinline__ void dkv_consumer(const unsigned char* sRing, uint32_t aK,
                                             uint32_t aV, uint64_t* full, uint64_t* empty,
                                             int kw0, int kr0, int qt0, int n_it, int S,
                                             int H, int Dt, float scale, float scale_log2,
                                             int causal, elem* dk, elem* dv, long long off) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key[2] = {kw0 + warp * 16 + g, kw0 + warp * 16 + g + 8};

  float acc_k[kDK ? D / 2 : 1], acc_v[kDV ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    if constexpr (kDK) acc_k[i] = 0.f;
    if constexpr (kDV) acc_v[i] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    const int st = it % T::kStages;
    const int q0 = (qt0 + it) * T::kRows;
    hopper::mbar_wait(&full[st], (it / T::kStages) & 1);
    // A q tile whose every query precedes every key of this warpgroup
    // contributes nothing.
    if (!causal || q0 + T::kRows - 1 >= kw0) {
      const unsigned char* stage = sRing + st * T::kStageBytes;
      const uint32_t aQ = hopper::smem_u32(stage), aO = aQ + T::kRowBytes;
      const float* stat = reinterpret_cast<const float*>(stage + 2 * T::kRowBytes);

      // S^T - lse/scale = K . Q^T - lse/scale and dP^T - delta =
      // V . dO^T - delta, rows = this warpgroup's keys: the accumulators
      // start from the per-query terms, so no register holds lse or delta
      // beside them.
      float s[T::kRows / 2], dp[kDK ? T::kRows / 2 : 1];
#pragma unroll
      for (int i = 0; i < T::kRows / 2; i += 2) {
        const int c = 8 * (i / 4) + 2 * t;  // query of s[i] within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(stat + c);
        s[i] = l2.x;
        s[i + 1] = l2.y;
        if constexpr (kDK) {
          const float2 d2 = *reinterpret_cast<const float2*>(stat + T::kRows + c);
          dp[i] = d2.x;
          dp[i + 1] = d2.y;
        }
      }
      hopper::fence_regs(s);
      if constexpr (kDK) hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss(s, desc_rows(aK, T::kKeys, kr0, kk),
                         desc_rows(aQ, T::kRows, 0, kk), 1);
      if constexpr (kDK) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::wgmma_ss(dp, desc_rows(aV, T::kKeys, kr0, kk),
                           desc_rows(aO, T::kRows, 0, kk), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      if constexpr (kDK) hopper::fence_regs(dp);

      // P^T = exp2(s * scale log2 e) and dS^T / scale = P^T (dP^T - delta)
      // as 16-bit A fragments; masked entries are 0.
      const bool mask = q0 + T::kRows > S || (causal && q0 < kw0 + 63);
      uint32_t pa[kDV ? T::kRows / 4 : 1], da[kDK ? T::kRows / 4 : 1];
#pragma unroll
      for (int i = 0; i < T::kRows / 2; i += 2) {
        float p0 = hopper::exp2_ftz(s[i] * scale_log2);
        float p1 = hopper::exp2_ftz(s[i + 1] * scale_log2);
        if (mask) {
          const int kr = key[(i >> 1) & 1], qa = q0 + 8 * (i / 4) + 2 * t;
          if (qa >= S || (causal && kr > qa)) p0 = 0.f;
          if (qa + 1 >= S || (causal && kr > qa + 1)) p1 = 0.f;
        }
        if constexpr (kDV) pa[i / 2] = pack_f(p0, p1);
        if constexpr (kDK) da[i / 2] = pack_f(p0 * dp[i], p1 * dp[i + 1]);
      }

      // dV += P^T . dO ; dK += dS^T . Q
      if constexpr (kDV) hopper::fence_regs(acc_v);
      if constexpr (kDK) hopper::fence_regs(acc_k);
      hopper::wgmma_fence();
      if constexpr (kDV) {
#pragma unroll
        for (int kk = 0; kk < T::kRows / 16; ++kk)
          hopper::wgmma_rs_tb(acc_v, &pa[4 * kk], desc_cols(aO, T::kRows, kk));
      }
      if constexpr (kDK) {
#pragma unroll
        for (int kk = 0; kk < T::kRows / 16; ++kk)
          hopper::wgmma_rs_tb(acc_k, &da[4 * kk], desc_cols(aQ, T::kRows, kk));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      if constexpr (kDV) {
        keep_frags(pa);
        hopper::fence_regs(acc_v);
      }
      if constexpr (kDK) {
        keep_frags(da);
        hopper::fence_regs(acc_k);
      }
    }
    release_stage(&empty[st]);
  }

  if constexpr (kDK)
    store_rows<D>(dk + off, H, S, Dt, kw0 + warp * 16, as_frags(acc_k), scale, scale, g, t);
  if constexpr (kDV)
    store_rows<D>(dv + off, H, S, Dt, kw0 + warp * 16, as_frags(acc_v), 1.f, 1.f, g, t);
}

template <int D>
__global__ void __launch_bounds__(threads_of<DkvTile<D>>(), 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                 const float* __restrict__ delta, elem* __restrict__ dk,
                 elem* __restrict__ dv, int H, int S, int Dt, float scale,
                 float scale_log2, int causal) {
  using T = DkvTile<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bar_kv, full[T::kStages], empty[T::kStages];
  unsigned char* sK = align_smem(smem_raw);
  unsigned char* sV = sK + T::kKVBytes;
  unsigned char* sRing = sV + T::kKVBytes;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * T::kKeys;  // causal: the first key tiles carry the most work
  const int qt0 = causal ? k0 / T::kRows : 0;
  const int n_it = (S + T::kRows - 1) / T::kRows - qt0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar_kv, 1);
#pragma unroll
    for (int s = 0; s < T::kStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // every lane of the producer warp
      hopper::mbar_init(&empty[s], 4 * T::kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup();
  if (wg == T::kConsumers) {
    // Producer warp: lane 0 issues the TMA loads; every lane copies two
    // rows' -lse/scale and -delta (0 past S), the accumulators' start
    // values for S^T and dP^T below.
    producer_regs<T>();
    if (threadIdx.x % 128 < 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&bar_kv, 2 * T::kKVBytes);
        load_rows<D>(sK, &tk, &bar_kv, T::kKeys, k0, h, b);
        load_rows<D>(sV, &tv, &bar_kv, T::kKeys, k0, h, b);
      }
      const float* lse_bh = lse + (long long)bh * S;
      const float* delta_bh = delta + (long long)bh * S;
      const float neg_inv_scale = -1.f / scale;
      for (int it = 0; it < n_it; ++it) {
        const int st = it % T::kStages;
        const int q0 = (qt0 + it) * T::kRows;
        unsigned char* stage = sRing + st * T::kStageBytes;
        hopper::mbar_wait(&empty[st], ((it / T::kStages) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[st], 2 * T::kRowBytes);
          load_rows<D>(stage, &tq, &full[st], T::kRows, q0, h, b);
          load_rows<D>(stage + T::kRowBytes, &tdo, &full[st], T::kRows, q0, h, b);
        }
        float* stat = reinterpret_cast<float*>(stage + 2 * T::kRowBytes);
        for (int j = lane; j < T::kRows; j += 32) {
          const bool in = q0 + j < S;
          stat[j] = in ? lse_bh[q0 + j] * neg_inv_scale : 0.f;
          stat[T::kRows + j] = in ? -delta_bh[q0 + j] : 0.f;
        }
        hopper::mbar_arrive(&full[st]);
      }
    }
  } else {
    // Consumers: warpgroup wg owns keys k0 + 64wg .. k0 + 64wg + 63 and
    // both products, or at D = 256 the block's 64 keys and one product.
    consumer_regs<T>();
    const uint32_t aK = hopper::smem_u32(sK), aV = hopper::smem_u32(sV);
    const long long off = ((long long)b * S * H + h) * Dt;
    hopper::mbar_wait(&bar_kv, 0);
    if constexpr (T::kRoles) {
      if (wg == 0)
        dkv_consumer<T, D, true, false>(sRing, aK, aV, full, empty, k0, 0, qt0, n_it, S, H,
                                        Dt, scale, scale_log2, causal, dk, dv, off);
      else
        dkv_consumer<T, D, false, true>(sRing, aK, aV, full, empty, k0, 0, qt0, n_it, S, H,
                                        Dt, scale, scale_log2, causal, dk, dv, off);
    } else {
      dkv_consumer<T, D, true, true>(sRing, aK, aV, full, empty, k0 + wg * 64, wg * 64, qt0,
                                     n_it, S, H, Dt, scale, scale_log2, causal, dk, dv, off);
    }
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// -lcuda at build time).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One tensor map of the launch plan (ops/flash_attention.launch_plan):
// dims[4] innermost first (D, S, H, B), the byte strides of dims 1-3, and
// the box[4] one TMA load copies.
constexpr int kMapLen = 11;

cudaError_t make_map(CUtensorMap* map, const void* base, const long long* plan) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)plan[i];
    box[i] = (cuuint32_t)plan[7 + i];
  }
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)plan[4 + i];
  const CUresult r = encode(map, kMapType, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Grid, block and dynamic shared memory of a launch plan; the plan's
// threads and shared memory must be what the kernel's tile takes.
struct Launch {
  int grid_x, grid_y, threads, smem;
};

template <typename T>
cudaError_t check_launch(const int* launch, Launch* ln) {
  *ln = Launch{launch[0], launch[1], launch[2], launch[3]};
  if (ln->threads != threads_of<T>() || ln->smem != T::kSmem || ln->grid_x < 1 ||
      ln->grid_y < 1)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int S,
                int H, int Dt, const long long* maps, const int* launch, float scale,
                int causal, cudaStream_t st) {
  Launch ln;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = check_launch<FwdTile<D>>(launch, &ln)) != cudaSuccess ||
      (err = make_map(&tq, q, maps)) != cudaSuccess ||
      (err = make_map(&tk, k, maps + kMapLen)) != cudaSuccess ||
      (err = make_map(&tv, v, maps + 2 * kMapLen)) != cudaSuccess ||
      (err = prepare(flash_fwd_kernel<D>, ln.smem)) != cudaSuccess)
    return err;
  flash_fwd_kernel<D><<<dim3(ln.grid_x, ln.grid_y), ln.threads, ln.smem, st>>>(
      tq, tk, tv, (elem*)o, (float*)lse, H, S, Dt, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const void* o,
               const void* lse, const void* dlse, void* delta, void* dqo, int S, int H,
               int Dt, const long long* maps, const int* launch, float scale, int causal,
               cudaStream_t st) {
  Launch ln;
  CUtensorMap tq, tk, tv, tdo, to;
  cudaError_t err;
  if ((err = check_launch<DqTile<D>>(launch, &ln)) != cudaSuccess ||
      (err = make_map(&tq, q, maps)) != cudaSuccess ||
      (err = make_map(&tk, k, maps + kMapLen)) != cudaSuccess ||
      (err = make_map(&tv, v, maps + 2 * kMapLen)) != cudaSuccess ||
      (err = make_map(&tdo, dout, maps + 3 * kMapLen)) != cudaSuccess ||
      (err = make_map(&to, o, maps + 4 * kMapLen)) != cudaSuccess ||
      (err = prepare(flash_dq_kernel<D>, ln.smem)) != cudaSuccess)
    return err;
  flash_dq_kernel<D><<<dim3(ln.grid_x, ln.grid_y), ln.threads, ln.smem, st>>>(
      tq, tk, tv, tdo, to, (const float*)lse, (const float*)dlse, (float*)delta, (elem*)dqo,
      H, S, Dt, scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dko, void* dvo, int S, int H,
                int Dt, const long long* maps, const int* launch, float scale, int causal,
                cudaStream_t st) {
  Launch ln;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = check_launch<DkvTile<D>>(launch, &ln)) != cudaSuccess ||
      (err = make_map(&tq, q, maps)) != cudaSuccess ||
      (err = make_map(&tk, k, maps + kMapLen)) != cudaSuccess ||
      (err = make_map(&tv, v, maps + 2 * kMapLen)) != cudaSuccess ||
      (err = make_map(&tdo, dout, maps + 3 * kMapLen)) != cudaSuccess ||
      (err = prepare(flash_dkv_kernel<D>, ln.smem)) != cudaSuccess)
    return err;
  flash_dkv_kernel<D><<<dim3(ln.grid_x, ln.grid_y), ln.threads, ln.smem, st>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (elem*)dko, (elem*)dvo, H,
      S, Dt, scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes.  Tensors are bf16 (float16 in a
// -DFLASH_F16 build) except lse, dlse and delta (f32); D is the true head
// dim, D >= 1: 1 <= D <= 256 runs in the instance 64, 128 or 256 (the
// smallest at least D), D > 256 in the wide route (flash_wide.cuh); a build
// holds the one that -DFLASH_D names (0: the wide route), flash_common.cuh.
// Each kernel takes the launch plan of ops/flash_attention.launch_plan: in
// an instance `maps` holds one tensor map per operand (q, k, v[, dout[,
// o]]; kMapLen values each) and `launch` is (grid x, grid y, threads,
// dynamic shared-memory bytes); in the wide route `maps` holds four element
// strides per operand and `launch` is (grid x, grid y, grid z, threads,
// dynamic shared-memory bytes, copy bytes).  K2 reads dlse as contiguous
// (B, S, H) and writes delta (B, H, S) for K3.  Each returns the
// cudaError_t of the launch (0 on success).
// The head-dim instance of D (64, 128, 256, or the wide route) runs f.
template <typename F>
int dispatch(int D, F f) {
  int rc = (int)cudaErrorInvalidValue;
  flash::instance<64>(D, 0, f, &rc) || flash::instance<128>(D, 64, f, &rc) ||
      flash::instance<256>(D, 128, f, &rc) || flash::wide(D, f, &rc);
  return rc;
}

extern "C" {

int bf_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int S,
                 int H, int D, const long long* maps, const int* launch, float scale,
                 int causal, void* stream) {
  return dispatch(D, [&](auto d) {
    constexpr int DM = decltype(d)::value;
    if constexpr (DM == flash::kWide)
      return wide::fwd<elem, true>(q, k, v, o, lse, S, H, D, maps, launch, scale, causal,
                                   (cudaStream_t)stream);
    else
      return fwd<DM>(q, k, v, o, lse, S, H, D, maps, launch, scale, causal,
                     (cudaStream_t)stream);
  });
}

int bf_flash_dq(const void* q, const void* k, const void* v, const void* dout, const void* o,
                const void* lse, const void* dlse, void* delta, void* dqo, int S, int H, int D,
                const long long* maps, const int* launch, float scale, int causal,
                void* stream) {
  return dispatch(D, [&](auto d) {
    constexpr int DM = decltype(d)::value;
    if constexpr (DM == flash::kWide)
      return wide::dq<elem, true>(q, k, v, dout, o, lse, dlse, delta, dqo, S, H, D, maps,
                                  launch, scale, causal, (cudaStream_t)stream);
    else
      return dq<DM>(q, k, v, dout, o, lse, dlse, delta, dqo, S, H, D, maps, launch, scale,
                    causal, (cudaStream_t)stream);
  });
}

int bf_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dko, void* dvo, int S, int H,
                 int D, const long long* maps, const int* launch, float scale, int causal,
                 void* stream) {
  return dispatch(D, [&](auto d) {
    constexpr int DM = decltype(d)::value;
    if constexpr (DM == flash::kWide)
      return wide::dkv<elem, true>(q, k, v, dout, lse, delta, dko, dvo, S, H, D, maps, launch,
                                   scale, causal, (cudaStream_t)stream);
    else
      return dkv<DM>(q, k, v, dout, lse, delta, dko, dvo, S, H, D, maps, launch, scale,
                     causal, (cudaStream_t)stream);
  });
}

}  // extern "C"
