// Flash attention in float32 for Hopper (sm_90a): forward (K1), dq (K2) and
// dk/dv (K3) on the CUDA cores.
//
// Replaces the same three Pallas TPU kernels of
// bluefog_tpu/ops/flash_attention.py as csrc/flash_attention.cu, for float32
// operands (the JAX package feeds its kernels float32 at small head dims:
// examples/long_context_training.py, heads of 16):
//   K1 bf_flash_fwd_f32  <- _fwd_kernel
//   K2 bf_flash_dq_f32   <- _dq_kernel  (also writes delta for K3)
//   K3 bf_flash_dkv_f32  <- _dkv_kernel
// Same function as the bf16 kernels: scale 1/sqrt(D), mask value -1e30
// (masked probabilities are exactly 0), O = acc / max(l, 1e-30), lse = m +
// log(l), delta = rowsum(dO o) - dlse; every product and sum in float32.
// No TF32: one TF32 rounding of q and k puts about 1e-3 relative error
// into the scores, well over what the float32 twin holds.
//
// Layout.  q, k, v, dO and O are (B, S, H, Dt) float32 tensors read through
// their four element strides (the fused-QKV slices need no copy); O, dq, dk
// and dv are written contiguous (B, S, H, Dt); lse and delta are (B, H, S),
// dlse (B, S, H).
//
// Design: simple and right first.  A block of 256 threads owns 64 rows
// (K1, K2: queries; K3: keys) and streams 64-row tiles of the other
// operands (32 at DM = 256, so that four operand tiles fit shared memory)
// through shared memory with plain loads, zero past S and past Dt.  The
// threads form a 16 x 16 grid: thread (ty, tx) holds block rows ty + 16i
// and, of a score tile, streamed rows tx + 16j, and of an output row the
// head-dim columns tx + 16j.  Tiles are stored with an odd row stride, so
// that the 16 threads reading 16 different rows at one column hit 16
// banks.  Scores pass from the product threads to the output product
// through a shared tile.  Instances DM = 16, 64, 128, 256: a head dim Dt
// runs in the smallest DM >= Dt; the score loops run over Dt, the output
// columns past Dt are never stored.
//
// Bounds on the H100 SXM: 67 TFLOP/s float32 FMA on the CUDA cores, 3.35
// TB/s; every case is bound by operations.  At the long-context example's
// heads (Dt = 16) a score costs 4 flops a head-dim column in K1 and 8-12
// in K2 and K3 beside an exponential and several shared-memory reads;
// the kernels reach 8-20% of the FMA bound (PERF.md), the cause not
// profiled.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::kLn2;
using flash::kLog2e;
using flash::kMask;
constexpr int kThreads = 256;  // a 16 x 16 grid

template <int DM>
struct Tile {
  static constexpr int kBlock = 64;                   // the block's own rows
  static constexpr int kStream = DM > 128 ? 32 : 64;  // rows of a streamed tile
  static constexpr int kLd = DM + 1;        // operand tile row stride (odd)
  static constexpr int kPLd = kStream + 1;  // score tile row stride
  static constexpr int kRI = kBlock / 16;   // block rows a thread holds
  static constexpr int kCI = kStream / 16;  // score columns a thread holds
  static constexpr int kDI = DM / 16;       // output columns a thread holds
  static constexpr int kBlockFloats = kBlock * kLd;
  static constexpr int kStreamFloats = kStream * kLd;
  static constexpr int kScoreFloats = kBlock * kPLd;
  // Dynamic shared memory of each kernel, in bytes.
  static constexpr int kFwdSmem = 4 * (kBlockFloats + 2 * kStreamFloats + kScoreFloats);
  static constexpr int kDqSmem = 4 * (2 * kBlockFloats + 2 * kStreamFloats + kScoreFloats);
  static constexpr int kDkvSmem =
      4 * (2 * kBlockFloats + 2 * kStreamFloats + 2 * kScoreFloats + 2 * kStream);
};

// One (B, S, H, Dt) operand: its base and element strides.
struct Operand {
  const float* p;
  long long sb, ss, sh, sd;
};

__device__ __forceinline__ float load(const Operand& t, int b, int s, int h, int d) {
  return t.p[b * t.sb + s * t.ss + h * t.sh + d * t.sd];
}

// Rows row0 .. row0 + ROWS - 1 of the (b, h) slab into a shared tile of
// row stride DM + 1; zeros past S and past Dt.
template <int DM, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const Operand& t, int b, int h,
                                          int row0, int S, int Dt) {
  for (int i = threadIdx.x; i < ROWS * DM; i += kThreads) {
    const int r = i / DM, d = i % DM;
    const int s = row0 + r;
    dst[r * (DM + 1) + d] = (s < S && d < Dt) ? load(t, b, s, h, d) : 0.f;
  }
}

// Reductions over the 16 threads of one ty (half a warp).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// x[i][j] = row (ty + 16i) of `a` . row (tx + 16j) of `b` over the first Dt
// columns (`a`: the block tile, `b`: a streamed tile).
template <typename T>
__device__ __forceinline__ void dots(float (&x)[T::kRI][T::kCI], const float* a,
                                     const float* b, int ty, int tx, int Dt) {
#pragma unroll
  for (int i = 0; i < T::kRI; ++i)
#pragma unroll
    for (int j = 0; j < T::kCI; ++j) x[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < Dt; ++d) {
    float av[T::kRI], bv[T::kCI];
#pragma unroll
    for (int i = 0; i < T::kRI; ++i) av[i] = a[(ty + 16 * i) * T::kLd + d];
#pragma unroll
    for (int j = 0; j < T::kCI; ++j) bv[j] = b[(tx + 16 * j) * T::kLd + d];
#pragma unroll
    for (int i = 0; i < T::kRI; ++i)
#pragma unroll
      for (int j = 0; j < T::kCI; ++j) x[i][j] = fmaf(av[i], bv[j], x[i][j]);
  }
}

// acc[i][jd] += sum_c p[ty + 16i][c] * m[c][tx + 16jd]: a score tile times
// a streamed operand tile.
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[T::kRI][T::kDI], const float* p,
                                           const float* m, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < T::kStream; ++c) {
    float mv[T::kDI];
#pragma unroll
    for (int j = 0; j < T::kDI; ++j) mv[j] = m[c * T::kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < T::kRI; ++i) {
      const float pv = p[(ty + 16 * i) * T::kPLd + c];
#pragma unroll
      for (int j = 0; j < T::kDI; ++j) acc[i][j] = fmaf(pv, mv[j], acc[i][j]);
    }
  }
}

// Row `row` of a contiguous (B, S, H, Dt) output, its columns tx + 16j < Dt.
template <typename T>
__device__ __forceinline__ void store_row(float* out, int b, int row, int h, int H, int S,
                                          int Dt, const float (&acc)[T::kDI], float mul,
                                          int tx) {
  if (row >= S) return;
  float* base = out + (((long long)b * S + row) * H + h) * Dt;
#pragma unroll
  for (int j = 0; j < T::kDI; ++j) {
    const int d = tx + 16 * j;
    if (d < Dt) base[d] = acc[j] * mul;
  }
}

// ---------------------------------------------------------------------------
// K1: forward.  Grid (B*H, ceil(S/64)); block = 64 query rows, the heaviest
// causal tiles first.
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(Operand q, Operand k, Operand v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int S, int Dt, float scale_log2,
                     int causal) {
  using T = Tile<DM>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + T::kBlockFloats;
  float* sV = sK + T::kStreamFloats;
  float* sP = sV + T::kStreamFloats;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kBlock;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int kend = causal ? min(S, q0 + T::kBlock) : S;
  load_tile<DM, T::kBlock>(sQ, q, b, h, q0, S, Dt);

  float acc[T::kRI][T::kDI], m[T::kRI], l[T::kRI];
#pragma unroll
  for (int i = 0; i < T::kRI; ++i) {
    m[i] = kMask;  // running max, log2 units
    l[i] = 0.f;    // per-thread partial row sums
#pragma unroll
    for (int j = 0; j < T::kDI; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += T::kStream) {
    __syncthreads();  // the last tile's readers are done
    load_tile<DM, T::kStream>(sK, k, b, h, k0, S, Dt);
    load_tile<DM, T::kStream>(sV, v, b, h, k0, S, Dt);
    __syncthreads();

    float x[T::kRI][T::kCI];
    dots<T>(x, sQ, sK, ty, tx, Dt);
#pragma unroll
    for (int i = 0; i < T::kRI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < T::kCI; ++j) {
        const int col = k0 + tx + 16 * j;
        x[i][j] = (col >= S || (causal && col > row)) ? -INFINITY : x[i][j] * scale_log2;
        mx = fmaxf(mx, x[i][j]);
      }
      const float mn = fmaxf(m[i], group_max(mx));
      const float corr = exp2f(m[i] - mn);
      m[i] = mn;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < T::kDI; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < T::kCI; ++j) {
        const float p = exp2f(x[i][j] - mn);
        l[i] += p;
        sP[(ty + 16 * i) * T::kPLd + tx + 16 * j] = p;
      }
    }
    __syncthreads();
    accumulate<T>(acc, sP, sV, ty, tx);  // O += P . V
  }

#pragma unroll
  for (int i = 0; i < T::kRI; ++i) {
    const int row = q0 + ty + 16 * i;
    const float li = fmaxf(group_sum(l[i]), 1e-30f);
    store_row<T>(o, b, row, h, H, S, Dt, acc[i], 1.f / li, tx);
    if (tx == 0 && row < S) lse[(long long)bh * S + row] = (m[i] + log2f(li)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// K2: dq, and delta = rowsum(dO o) - dlse for K3.  Grid (B*H, ceil(S/64));
// block = 64 query rows, K/V tiles up to the causal frontier.
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32_kernel(Operand q, Operand k, Operand v, Operand dout, Operand o,
                    const float* __restrict__ lse, const float* __restrict__ dlse,
                    float* __restrict__ delta, float* __restrict__ dq, int H, int S, int Dt,
                    float scale, float scale_log2, int causal) {
  using T = Tile<DM>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + T::kBlockFloats;
  float* sK = sdO + T::kBlockFloats;
  float* sV = sK + T::kStreamFloats;
  float* sDS = sV + T::kStreamFloats;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kBlock;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int kend = causal ? min(S, q0 + T::kBlock) : S;
  load_tile<DM, T::kBlock>(sQ, q, b, h, q0, S, Dt);
  load_tile<DM, T::kBlock>(sdO, dout, b, h, q0, S, Dt);
  __syncthreads();

  // The thread's rows: lse in log2 units and delta (0 past S).
  float lse2[T::kRI], dlt[T::kRI];
#pragma unroll
  for (int i = 0; i < T::kRI; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < S;
    float part = 0.f;
    if (in)
      for (int d = tx; d < Dt; d += 16)
        part = fmaf(sdO[(ty + 16 * i) * T::kLd + d], load(o, b, row, h, d), part);
    part = group_sum(part);
    lse2[i] = in ? lse[(long long)bh * S + row] * kLog2e : 0.f;
    dlt[i] = in ? part - dlse[((long long)b * S + row) * H + h] : 0.f;
    if (tx == 0 && in) delta[(long long)bh * S + row] = dlt[i];
  }

  float acc[T::kRI][T::kDI];
#pragma unroll
  for (int i = 0; i < T::kRI; ++i)
#pragma unroll
    for (int j = 0; j < T::kDI; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += T::kStream) {
    __syncthreads();
    load_tile<DM, T::kStream>(sK, k, b, h, k0, S, Dt);
    load_tile<DM, T::kStream>(sV, v, b, h, k0, S, Dt);
    __syncthreads();

    float x[T::kRI][T::kCI], y[T::kRI][T::kCI];
    dots<T>(x, sQ, sK, ty, tx, Dt);   // S = Q . K^T
    dots<T>(y, sdO, sV, ty, tx, Dt);  // dP = dO . V^T
#pragma unroll
    for (int i = 0; i < T::kRI; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < T::kCI; ++j) {
        const int col = k0 + tx + 16 * j;
        float p = exp2f(fmaf(x[i][j], scale_log2, -lse2[i]));
        if (col >= S || (causal && col > row)) p = 0.f;
        // dS / scale = P (dP - delta)
        sDS[(ty + 16 * i) * T::kPLd + tx + 16 * j] = p * (y[i][j] - dlt[i]);
      }
    }
    __syncthreads();
    accumulate<T>(acc, sDS, sK, ty, tx);  // dQ += dS . K
  }

#pragma unroll
  for (int i = 0; i < T::kRI; ++i)
    store_row<T>(dq, b, q0 + ty + 16 * i, h, H, S, Dt, acc[i], scale, tx);
}

// ---------------------------------------------------------------------------
// K3: dk and dv.  Grid (B*H, ceil(S/64)); block = 64 keys, q tiles from the
// causal frontier to the end.
// ---------------------------------------------------------------------------
template <int DM>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32_kernel(Operand q, Operand k, Operand v, Operand dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int S, int Dt,
                     float scale, float scale_log2, int causal) {
  using T = Tile<DM>;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + T::kBlockFloats;
  float* sQ = sV + T::kBlockFloats;
  float* sdO = sQ + T::kStreamFloats;
  float* sPT = sdO + T::kStreamFloats;
  float* sDST = sPT + T::kScoreFloats;
  float* sL = sDST + T::kScoreFloats;  // the q tile's lse, log2 units
  float* sD = sL + T::kStream;         // and delta

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * T::kBlock;  // causal: the first key tiles carry the most work
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<DM, T::kBlock>(sK, k, b, h, k0, S, Dt);
  load_tile<DM, T::kBlock>(sV, v, b, h, k0, S, Dt);

  float acc_k[T::kRI][T::kDI], acc_v[T::kRI][T::kDI];
#pragma unroll
  for (int i = 0; i < T::kRI; ++i)
#pragma unroll
    for (int j = 0; j < T::kDI; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += T::kStream) {
    __syncthreads();
    load_tile<DM, T::kStream>(sQ, q, b, h, q0, S, Dt);
    load_tile<DM, T::kStream>(sdO, dout, b, h, q0, S, Dt);
    for (int j = threadIdx.x; j < T::kStream; j += kThreads) {
      const bool in = q0 + j < S;
      sL[j] = in ? lse_bh[q0 + j] * kLog2e : 0.f;
      sD[j] = in ? delta_bh[q0 + j] : 0.f;
    }
    __syncthreads();

    float x[T::kRI][T::kCI], y[T::kRI][T::kCI];
    dots<T>(x, sK, sQ, ty, tx, Dt);   // S^T = K . Q^T
    dots<T>(y, sV, sdO, ty, tx, Dt);  // dP^T = V . dO^T
#pragma unroll
    for (int i = 0; i < T::kRI; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < T::kCI; ++j) {
        const int c = tx + 16 * j, qr = q0 + c;
        float p = exp2f(fmaf(x[i][j], scale_log2, -sL[c]));
        if (qr >= S || (causal && key > qr)) p = 0.f;
        sPT[(ty + 16 * i) * T::kPLd + c] = p;
        sDST[(ty + 16 * i) * T::kPLd + c] = p * (y[i][j] - sD[c]);  // dS^T / scale
      }
    }
    __syncthreads();
    accumulate<T>(acc_v, sPT, sdO, ty, tx);  // dV += P^T . dO
    accumulate<T>(acc_k, sDST, sQ, ty, tx);  // dK += dS^T . Q
  }

#pragma unroll
  for (int i = 0; i < T::kRI; ++i) {
    const int key = k0 + ty + 16 * i;
    store_row<T>(dk, b, key, h, H, S, Dt, acc_k[i], scale, tx);
    store_row<T>(dv, b, key, h, H, S, Dt, acc_v[i], 1.f, tx);
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------
Operand operand(const void* p, const long long* strides) {
  return Operand{static_cast<const float*>(p), strides[0], strides[1], strides[2], strides[3]};
}

// The launch plan's (grid x, grid y, threads, dynamic shared-memory bytes)
// must be what the instance's tile takes.
bool check_launch(const int* launch, int smem) {
  return launch[0] >= 1 && launch[1] >= 1 && launch[2] == kThreads && launch[3] == smem;
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DM>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int S,
                int H, int Dt, const long long* st, const int* launch, float scale,
                int causal, cudaStream_t stream) {
  using T = Tile<DM>;
  if (!check_launch(launch, T::kFwdSmem)) return cudaErrorInvalidConfiguration;
  cudaError_t err = prepare(flash_fwd_f32_kernel<DM>, T::kFwdSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<DM><<<dim3(launch[0], launch[1]), kThreads, T::kFwdSmem, stream>>>(
      operand(q, st), operand(k, st + 4), operand(v, st + 8), (float*)o, (float*)lse, H, S,
      Dt, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int DM>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const void* o,
               const void* lse, const void* dlse, void* delta, void* dqo, int S, int H,
               int Dt, const long long* st, const int* launch, float scale, int causal,
               cudaStream_t stream) {
  using T = Tile<DM>;
  if (!check_launch(launch, T::kDqSmem)) return cudaErrorInvalidConfiguration;
  cudaError_t err = prepare(flash_dq_f32_kernel<DM>, T::kDqSmem);
  if (err != cudaSuccess) return err;
  flash_dq_f32_kernel<DM><<<dim3(launch[0], launch[1]), kThreads, T::kDqSmem, stream>>>(
      operand(q, st), operand(k, st + 4), operand(v, st + 8), operand(dout, st + 12),
      operand(o, st + 16), (const float*)lse, (const float*)dlse, (float*)delta, (float*)dqo,
      H, S, Dt, scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int DM>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dko, void* dvo, int S, int H,
                int Dt, const long long* st, const int* launch, float scale, int causal,
                cudaStream_t stream) {
  using T = Tile<DM>;
  if (!check_launch(launch, T::kDkvSmem)) return cudaErrorInvalidConfiguration;
  cudaError_t err = prepare(flash_dkv_f32_kernel<DM>, T::kDkvSmem);
  if (err != cudaSuccess) return err;
  flash_dkv_f32_kernel<DM><<<dim3(launch[0], launch[1]), kThreads, T::kDkvSmem, stream>>>(
      operand(q, st), operand(k, st + 4), operand(v, st + 8), operand(dout, st + 12),
      (const float*)lse, (const float*)delta, (float*)dko, (float*)dvo, H, S, Dt, scale,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

// The head-dim instance of D (16, 64, 128, 256) runs f.
template <typename F>
int dispatch(int D, F f) {
  int rc = (int)cudaErrorInvalidValue;
  flash::instance<16>(D, 0, f, &rc) || flash::instance<64>(D, 16, f, &rc) ||
      flash::instance<128>(D, 64, f, &rc) || flash::instance<256>(D, 128, f, &rc);
  return rc;
}

}  // namespace

// C interface, bound with ctypes.  Every tensor is float32; D is the true
// head dim, 1 <= D <= 256, and runs in the instance 16, 64, 128 or 256 (the
// smallest at least D; a build holds the one that -DFLASH_D names,
// flash_common.cuh).  `strides` holds four element strides (b, s, h, d)
// per operand (q, k, v[, dout[, o]]) and `launch` is the launch plan's
// (grid x, grid y, threads, dynamic shared-memory bytes)
// (ops/flash_attention.launch_plan).  Each returns the cudaError_t of the
// launch (0 on success).
extern "C" {

int bf_flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int S,
                     int H, int D, const long long* strides, const int* launch, float scale,
                     int causal, void* stream) {
  return dispatch(D, [&](auto d) {
    return fwd<decltype(d)::value>(q, k, v, o, lse, S, H, D, strides, launch, scale, causal,
                                   (cudaStream_t)stream);
  });
}

int bf_flash_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                    const void* o, const void* lse, const void* dlse, void* delta, void* dqo,
                    int S, int H, int D, const long long* strides, const int* launch,
                    float scale, int causal, void* stream) {
  return dispatch(D, [&](auto d) {
    return dq<decltype(d)::value>(q, k, v, dout, o, lse, dlse, delta, dqo, S, H, D, strides,
                                  launch, scale, causal, (cudaStream_t)stream);
  });
}

int bf_flash_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dko, void* dvo, int S, int H,
                     int D, const long long* strides, const int* launch, float scale,
                     int causal, void* stream) {
  return dispatch(D, [&](auto d) {
    return dkv<decltype(d)::value>(q, k, v, dout, lse, delta, dko, dvo, S, H, D, strides,
                                   launch, scale, causal, (cudaStream_t)stream);
  });
}

}  // extern "C"
