// The wide route of K1-K3: every head dim past 256, in bf16, float16 and
// float32 (one template a dtype; csrc/flash_attention.cu includes it for
// bf16 and float16, csrc/flash_attention_f32.cu for float32, each in its
// library built with -DFLASH_D=0).
//
// Why a route of its own: a block cannot hold a D-wide float32 accumulator
// past 256 columns (at D = 256, K3's two accumulators already take 256
// registers a thread, split over two warpgroups), nor D-wide tiles in
// 232,448 bytes of shared memory.  So the output's columns are split over
// grid z, in groups of kGroup = 128 (the registers of K3's dK and dV at 128
// columns are 128 a thread; float32 K3 takes one block a role, dV or dK,
// as the float32 kernels at D = 256 do), and the reduction over D in the
// score products runs in chunks of kChunk = 64 columns that stream through
// shared memory:
//   K1: S = sum_c Q_c . K_c^T over every chunk c of D, then the online
//       softmax, then O_g += P . V_g for the block's group g of columns;
//   K2: S and dP = sum_c dO_c . V_c^T over every chunk, then dQ_g += dS .
//       K_g; delta = rowsum(dO o) - dlse over the whole D first, chunk by
//       chunk;
//   K3: S^T = sum_c K_c . Q_c^T and dP^T = sum_c V_c . dO_c^T, then dV_g +=
//       P^T . dO_g and dK_g += dS^T . Q_g.
// Each group recomputes the scores over the whole D: (groups + 1) / 2 times
// the least work at D a multiple of 128 (D = 512: 2.5x).  Group 0 writes lse
// (K1) and delta (K2); every group computes the same values from the same
// products.
//
// A block is 4 warps (128 threads), 64 rows (K1, K2: queries; K3: keys),
// a warp 16 of them, FlashAttention-2 style as the float32 kernels of
// csrc/flash_attention_f32.cu: the scores stay in the warp's accumulators
// and feed the next product as its A operand.  Products on the tensor cores
// with mma.sync: bf16 and float16 in m16n8k16 (float32 accumulation),
// float32 in 3xTF32 m16n8k8 (mma_tf32.cuh), its score products in a fresh
// pair of accumulators a chunk, added in float32, so that no tensor-core
// chain runs over the whole D.  Every streamed piece (a chunk step: the
// chunk c of the block's rows and of the streamed tile's; a group step: the
// streamed tile's group columns, and in K3 its lse and delta) passes
// through one ring of kStages stages of cp.async, one __syncthreads() a
// step.  Rows past S and columns past Dt arrive as zeros (the copy's
// src-size).  16-bit operands are copied 16 bytes at a time (the wrapper
// copies an operand whose strides do not allow it into a padded buffer,
// as for the TMA route); float32 in the library's copy route, FLASH_COPY.
//
// A simple kernel, correct first: no warp specialisation, no wgmma, no TMA.
// Shared-memory rows are padded by 16 bytes (LD = 64 + 8 or 128 + 8 16-bit
// elements, 64 + 4 or 128 + 4 floats), so that the fragment loads of a warp
// hit distinct banks (as the float32 kernels' LD = DM + 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace wide {

using flash::kLn2;
using flash::kLog2e;

constexpr int kBlock = 64;    // rows a block owns
constexpr int kChunk = 64;    // columns of D a chunk step of the score products
constexpr int kGroup = 128;   // output columns a block (grid z)
constexpr int kStages = 3;    // ring stages
constexpr int kThreads = 128;

template <typename E>
struct Operand {
  const E* p;
  long long sb, ss, sh, sd;
};

// Conversions of one element.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// ---------------------------------------------------------------------------
// Products.  Mma<E>: kK, the reduction of one mma; A and B fragments; loads
// from row-major shared tiles of row stride LD; the A operand from score
// accumulators; d += a . b.
// ---------------------------------------------------------------------------
template <typename E>
struct Mma;

// float32: 3xTF32 m16n8k8 (mma_tf32.cuh's layouts).
template <>
struct Mma<float> {
  static constexpr int kK = 8;
  static constexpr bool kTwoLevel = true;  // a chunk's scores apart, then added
  using A = tf32::FragA;
  using B = tf32::FragB;
  template <int LD>
  __device__ static void load_a(A& a, const float* tile, int r0, int c0, int g, int t) {
    tf32::load_a<LD>(a, tile, r0, c0, g, t);
  }
  template <int LD>
  __device__ static void load_b_rows(B& b, const float* tile, int n0, int c0, int g, int t) {
    tf32::load_b_rows<LD>(b, tile, n0, c0, g, t);
  }
  template <int LD>
  __device__ static void load_b_cols(B& b, const float* tile, int r0, int c0, int g, int t) {
    tf32::load_b_cols<LD>(b, tile, r0, c0, g, t);
  }
  // k-step kk of a product over score columns: accumulator tile kk.
  __device__ static void acc_as_a(A& a, const float (*c)[4], int kk) {
    tf32::acc_as_a(a, c[kk]);
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) { tf32::mma3(d, a, b); }
  __device__ static void mma(float (&big)[4], float (&small)[4], const A& a, const B& b) {
    tf32::mma3(big, small, a, b);
  }
};

// bf16 and float16: m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane = 4 g + t:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//                     a3 (g + 8, 2t+8..)
//   B (16 x 8, col):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8):       c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
// so the C tiles of score columns 16kk..16kk+7 and 16kk+8..16kk+15 are,
// packed by pairs, the A fragment of k-step kk, no shuffle.
template <typename E>
struct Mma16 {
  static constexpr int kK = 16;
  static constexpr bool kTwoLevel = false;
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };
  __device__ static uint32_t word(const E* p) { return *reinterpret_cast<const uint32_t*>(p); }
  __device__ static uint32_t pair(const E* lo, const E* hi) {
    return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
           ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
  }
  __device__ static uint32_t pack(float lo, float hi);
  template <int LD>
  __device__ static void load_a(A& a, const E* tile, int r0, int c0, int g, int t) {
    const E* p = tile + (r0 + g) * LD + c0 + 2 * t;
    a.x[0] = word(p);
    a.x[1] = word(p + 8 * LD);
    a.x[2] = word(p + 8);
    a.x[3] = word(p + 8 * LD + 8);
  }
  // B of a product that reduces along a tile's rows: n = tile row n0 + g.
  template <int LD>
  __device__ static void load_b_rows(B& b, const E* tile, int n0, int c0, int g, int t) {
    const E* p = tile + (n0 + g) * LD + c0 + 2 * t;
    b.x[0] = word(p);
    b.x[1] = word(p + 8);
  }
  // B of a product that reduces down a tile's columns: k = tile rows r0 +
  // 2t, 2t + 1 (b0) and r0 + 2t + 8, 2t + 9 (b1); n = column c0 + g.
  template <int LD>
  __device__ static void load_b_cols(B& b, const E* tile, int r0, int c0, int g, int t) {
    const E* p = tile + (r0 + 2 * t) * LD + c0 + g;
    b.x[0] = pair(p, p + LD);
    b.x[1] = pair(p + 8 * LD, p + 9 * LD);
  }
  __device__ static void acc_as_a(A& a, const float (*c)[4], int kk) {
    a.x[0] = pack(c[2 * kk][0], c[2 * kk][1]);
    a.x[1] = pack(c[2 * kk][2], c[2 * kk][3]);
    a.x[2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a.x[3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b);
};

template <>
__device__ __forceinline__ uint32_t Mma16<__nv_bfloat16>::pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t Mma16<__half>::pack(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ void Mma16<__nv_bfloat16>::mma(float (&d)[4], const A& a,
                                                         const B& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]), "r"(b.x[1]));
}
template <>
__device__ __forceinline__ void Mma16<__half>::mma(float (&d)[4], const A& a, const B& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]), "r"(b.x[1]));
}

template <>
struct Mma<__nv_bfloat16> : Mma16<__nv_bfloat16> {};
template <>
struct Mma<__half> : Mma16<__half> {};

// ---------------------------------------------------------------------------
// Tiles.  Rows of a chunk tile are kChunk + pad elements, of a group tile
// kGroup + pad (pad: 16 bytes).  kStream: the streamed tile's rows (K1, K2:
// keys; K3: queries).
// ---------------------------------------------------------------------------
template <typename E>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(E); }
template <typename E>
__host__ __device__ constexpr int ld_chunk() { return kChunk + pad<E>(); }
template <typename E>
__host__ __device__ constexpr int ld_group() { return kGroup + pad<E>(); }
__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// A ring stage: the larger of a chunk step (CHUNK_ELEMS elements) and a
// group step (GROUP_BYTES), 16-byte aligned.
template <typename E, int CHUNK_ELEMS, int GROUP_BYTES>
__host__ __device__ constexpr int stage_bytes() {
  return round16(CHUNK_ELEMS * (int)sizeof(E) > GROUP_BYTES ? CHUNK_ELEMS * (int)sizeof(E)
                                                            : GROUP_BYTES);
}

template <typename E>
struct FwdTile {
  static constexpr int kStream = sizeof(E) == 4 ? 16 : 64;
  // chunk step: Q_c (kBlock rows), K_c (kStream); group step: V_g
  static constexpr int kStage =
      stage_bytes<E, (kBlock + kStream) * ld_chunk<E>(),
                  kStream * ld_group<E>() * (int)sizeof(E)>();
  static constexpr int kSmem = kStages * kStage;
};

template <typename E>
struct DqTile {
  static constexpr int kStream = sizeof(E) == 4 ? 32 : 64;
  // chunk step: Q_c, dO_c (kBlock rows), K_c, V_c (kStream); group step: K_g
  static constexpr int kStage =
      stage_bytes<E, 2 * (kBlock + kStream) * ld_chunk<E>(),
                  kStream * ld_group<E>() * (int)sizeof(E)>();
  static constexpr int kSmem = kStages * kStage + kBlock * 4;  // + the rows' delta
};

// float32: one block a role, dV or dK (grid y doubled), each 64
// accumulator registers a thread: both roles' 128 beside the 3xTF32
// fragments spilled.
template <typename E>
struct DkvTile {
  static constexpr int kStream = 16;
  static constexpr int kRoles = sizeof(E) == 4 ? 2 : 1;
  // chunk step: K_c, V_c (kBlock rows), Q_c, dO_c (kStream); group step:
  // Q_g, dO_g, then the rows' lse and delta (floats)
  static constexpr int kStage =
      stage_bytes<E, 2 * (kBlock + kStream) * ld_chunk<E>(),
                  2 * kStream * ld_group<E>() * (int)sizeof(E) + 2 * kStream * 4>();
  static constexpr int kSmem = kStages * kStage;
};

// Rows row0 .. row0 + ROWS - 1 and columns col0 .. col0 + COLS - 1 of the
// (b, h) slab of `t` into a shared tile of row stride LD through cp.async;
// zeros past S and past Dt.  VEC: 16-byte copies (unit stride along D,
// 16-byte multiples for the other strides and the base), else 4-byte ones
// (float32 only).
template <typename E, int ROWS, int COLS, int LD, bool VEC>
__device__ __forceinline__ void copy_tile(E* dst, const Operand<E>& t, int b, int h, int row0,
                                          int col0, int S, int Dt) {
  const E* slab = t.p + b * t.sb + h * t.sh;
  if constexpr (VEC) {
    constexpr int kPer = 16 / (int)sizeof(E), kSegs = COLS / kPer;
    for (int i = threadIdx.x; i < ROWS * kSegs; i += kThreads) {
      const int r = i / kSegs, c = kPer * (i % kSegs), s = row0 + r, d = col0 + c;
      const int n = s < S ? max(0, min(kPer, Dt - d)) : 0;
      tf32::cp_async16(dst + r * LD + c, n ? slab + s * t.ss + d : slab, (int)sizeof(E) * n);
    }
  } else {
    static_assert(sizeof(E) == 4, "4-byte copies move float32 elements");
    for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, c = i % COLS, s = row0 + r, d = col0 + c;
      const bool in = s < S && d < Dt;
      tf32::cp_async4(dst + r * LD + c, in ? slab + s * t.ss + d * t.sd : slab, in ? 4 : 0);
    }
  }
}

// Entries row0 .. row0 + ROWS - 1 of a contiguous row of statistics; zeros
// past S.
template <int ROWS>
__device__ __forceinline__ void copy_stats(float* dst, const float* src, int row0, int S) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool in = row0 + i < S;
    tf32::cp_async4(dst + i, in ? src + row0 + i : src, in ? 4 : 0);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// acc (16 x 8 NJ) += A-tile rows r0 .. r0 + 15 of `a` . (B-tile rows 0 ..
// 8 NJ - 1 of `bt`)^T over one chunk's kChunk columns; float32 in a fresh
// pair of accumulators, then added (Mma::kTwoLevel).
template <typename E, int NJ>
__device__ __forceinline__ void chunk_product(float (&acc)[NJ][4], const E* at, const E* bt,
                                              int r0, int g, int t) {
  using M = Mma<E>;
  constexpr int LD = ld_chunk<E>();
  float big[M::kTwoLevel ? NJ : 1][4], small[M::kTwoLevel ? NJ : 1][4];
  if constexpr (M::kTwoLevel) {
    zero(big);
    zero(small);
  }
#pragma unroll
  for (int ks = 0; ks < kChunk / M::kK; ++ks) {
    typename M::A a;
    M::template load_a<LD>(a, at, r0, M::kK * ks, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      typename M::B bk;
      M::template load_b_rows<LD>(bk, bt, 8 * j, M::kK * ks, g, t);
      if constexpr (M::kTwoLevel)
        M::mma(big[j], small[j], a, bk);
      else
        M::mma(acc[j], a, bk);
    }
  }
  if constexpr (M::kTwoLevel) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += big[j][e] + small[j][e];
  }
}

// out (16 x kGroup) += P (16 x 8 NJ, the score accumulators) . rows 0 ..
// 8 NJ - 1 of the group tile `bt`.
template <typename E, int NJ>
__device__ __forceinline__ void group_product(float (&out)[kGroup / 8][4],
                                              const float (&p)[NJ][4], const E* bt, int g,
                                              int t) {
  using M = Mma<E>;
  constexpr int LD = ld_group<E>();
#pragma unroll
  for (int kk = 0; kk < 8 * NJ / M::kK; ++kk) {
    typename M::A a;
    M::acc_as_a(a, p, kk);
#pragma unroll
    for (int n = 0; n < kGroup / 8; ++n) {
      typename M::B b;
      M::template load_b_cols<LD>(b, bt, M::kK * kk, 8 * n, g, t);
      M::mma(out[n], a, b);
    }
  }
}

// Row `row` of a contiguous (B, S, H, Dt) output, columns c0 .. c0 +
// kGroup - 1 (below Dt), from a warp's accumulators: half r (0: row g, 1:
// row g + 8).
template <typename E>
__device__ __forceinline__ void store_group(E* out, int b, int row, int h, int H, int S,
                                            int Dt, int c0, const float (&acc)[kGroup / 8][4],
                                            int r, float mul, int t) {
  if (row >= S) return;
  E* base = out + (((long long)b * S + row) * H + h) * Dt;
#pragma unroll
  for (int n = 0; n < kGroup / 8; ++n) {
    const int col = c0 + 8 * n + 2 * t;
    if (col < Dt) base[col] = from_f<E>(acc[n][2 * r] * mul);
    if (col + 1 < Dt) base[col + 1] = from_f<E>(acc[n][2 * r + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// K1.  Grid (B*H, ceil(S/64), ceil(Dt/128)); block = 64 query rows, the
// heaviest causal tiles first, key tiles up to the causal frontier; a
// key tile is ceil(Dt/64) chunk steps, then its group step.
// ---------------------------------------------------------------------------
template <typename E, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
wide_fwd_kernel(Operand<E> q, Operand<E> k, Operand<E> v, E* __restrict__ o,
                float* __restrict__ lse, int H, int S, int Dt, float scale_log2, int causal) {
  using T = FwdTile<E>;
  constexpr int BN = T::kStream, NJ = BN / 8, LDC = ld_chunk<E>(), LDG = ld_group<E>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock, c0 = blockIdx.z * kGroup;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;
  const int kend = causal ? min(S, q0 + kBlock) : S;
  const int ntiles = (kend + BN - 1) / BN, nc = (Dt + kChunk - 1) / kChunk;
  const int nsteps = ntiles * (nc + 1);
  auto stage = [&](int i) {
    return reinterpret_cast<E*>(smem_raw + (i % kStages) * T::kStage);
  };
  auto issue = [&](int i) {
    if (i < nsteps) {
      const int it = i / (nc + 1), c = i % (nc + 1);
      E* st = stage(i);
      if (c < nc) {
        copy_tile<E, kBlock, kChunk, LDC, VEC>(st, q, b, h, q0, c * kChunk, S, Dt);
        copy_tile<E, BN, kChunk, LDC, VEC>(st + kBlock * LDC, k, b, h, it * BN, c * kChunk, S,
                                           Dt);
      } else {
        copy_tile<E, BN, kGroup, LDG, VEC>(st, v, b, h, it * BN, c0, S, Dt);
      }
    }
    tf32::cp_async_commit();
  };

  float acc[kGroup / 8][4], s[NJ][4];
  zero(acc);
  float m[2] = {flash::kMask, flash::kMask};  // running max, log2 units
  float l[2] = {0.f, 0.f};                    // the lane's partial row sums
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < nsteps; ++i) {
    tf32::cp_async_wait<kStages - 2>();
    __syncthreads();  // step i has landed; step i - 1's stage is free
    issue(i + kStages - 1);
    const int it = i / (nc + 1), c = i % (nc + 1);
    const E* st = stage(i);
    if (c < nc) {
      if (c == 0) zero(s);
      chunk_product<E, NJ>(s, st, st + kBlock * LDC, r0, g, t);
      continue;
    }
    // The online softmax over the tile, in log2 units; masked logits -inf.
    const int k0 = it * BN;
    const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > q0 + r0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          if (col >= S || (causal && col > row)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      corr[r] = hopper::exp2_ftz(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kGroup / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = hopper::exp2_ftz(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    group_product<E, NJ>(acc, s, st, g, t);
  }
  tf32::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + g + 8 * r;
    const float li = fmaxf(l[r], 1e-30f);
    store_group<E>(o, b, row, h, H, S, Dt, c0, acc, r, 1.f / li, t);
    if (blockIdx.z == 0 && t == 0 && row < S)
      lse[(long long)bh * S + row] = (m[r] + log2f(li)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// K2: dq, and delta = rowsum(dO o) - dlse for K3.  Grid as K1's; block = 64
// query rows; a key tile is ceil(Dt/64) chunk steps (Q_c, dO_c, K_c, V_c),
// then its group step (K_g).
// ---------------------------------------------------------------------------
template <typename E, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
wide_dq_kernel(Operand<E> q, Operand<E> k, Operand<E> v, Operand<E> dout, Operand<E> o,
               const float* __restrict__ lse, const float* __restrict__ dlse,
               float* __restrict__ delta, E* __restrict__ dq, int H, int S, int Dt,
               float scale, float scale_log2, int causal) {
  using T = DqTile<E>;
  constexpr int BN = T::kStream, NJ = BN / 8, LDC = ld_chunk<E>(), LDG = ld_group<E>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sDelta = reinterpret_cast<float*>(smem_raw + kStages * T::kStage);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock, c0 = blockIdx.z * kGroup;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;
  const int kend = causal ? min(S, q0 + kBlock) : S;
  const int ntiles = (kend + BN - 1) / BN, nc = (Dt + kChunk - 1) / kChunk;
  const int nsteps = ntiles * (nc + 1);
  auto stage = [&](int i) {
    return reinterpret_cast<E*>(smem_raw + (i % kStages) * T::kStage);
  };

  // delta over the whole D, a chunk of O and dO at a time through stage 0:
  // two adjacent threads a row, 32 columns each.
  {
    E* sO = stage(0);
    E* sdO = sO + kBlock * LDC;
    const int row = threadIdx.x / 2, half = threadIdx.x % 2;
    float sum = 0.f;
    for (int c = 0; c < nc; ++c) {
      copy_tile<E, kBlock, kChunk, LDC, VEC>(sO, o, b, h, q0, c * kChunk, S, Dt);
      copy_tile<E, kBlock, kChunk, LDC, VEC>(sdO, dout, b, h, q0, c * kChunk, S, Dt);
      tf32::cp_async_commit();
      tf32::cp_async_wait<0>();
      __syncthreads();
#pragma unroll 8
      for (int d = 32 * half; d < 32 * half + 32; ++d)
        sum = fmaf(to_f(sdO[row * LDC + d]), to_f(sO[row * LDC + d]), sum);
      __syncthreads();  // read before the next chunk lands
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const int s_ = q0 + row;
    const float dl = s_ < S ? sum - dlse[((long long)b * S + s_) * H + h] : 0.f;
    if (half == 0) {
      sDelta[row] = dl;
      if (blockIdx.z == 0 && s_ < S) delta[(long long)bh * S + s_] = dl;
    }
    __syncthreads();
  }
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    lse2[r] = row < S ? lse[(long long)bh * S + row] * kLog2e : 0.f;
    dlt[r] = sDelta[r0 + g + 8 * r];
  }

  auto issue = [&](int i) {
    if (i < nsteps) {
      const int it = i / (nc + 1), c = i % (nc + 1);
      E* st = stage(i);
      if (c < nc) {
        const int d0 = c * kChunk;
        copy_tile<E, kBlock, kChunk, LDC, VEC>(st, q, b, h, q0, d0, S, Dt);
        copy_tile<E, kBlock, kChunk, LDC, VEC>(st + kBlock * LDC, dout, b, h, q0, d0, S, Dt);
        copy_tile<E, BN, kChunk, LDC, VEC>(st + 2 * kBlock * LDC, k, b, h, it * BN, d0, S, Dt);
        copy_tile<E, BN, kChunk, LDC, VEC>(st + (2 * kBlock + BN) * LDC, v, b, h, it * BN, d0,
                                           S, Dt);
      } else {
        copy_tile<E, BN, kGroup, LDG, VEC>(st, k, b, h, it * BN, c0, S, Dt);
      }
    }
    tf32::cp_async_commit();
  };

  float acc[kGroup / 8][4], x[NJ][4], y[NJ][4];
  zero(acc);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < nsteps; ++i) {
    tf32::cp_async_wait<kStages - 2>();
    __syncthreads();  // step i has landed; step i - 1's stage is free
    issue(i + kStages - 1);
    const int it = i / (nc + 1), c = i % (nc + 1);
    const E* st = stage(i);
    if (c < nc) {
      if (c == 0) {
        zero(x);
        zero(y);
      }
      chunk_product<E, NJ>(x, st, st + 2 * kBlock * LDC, r0, g, t);
      chunk_product<E, NJ>(y, st + kBlock * LDC, st + (2 * kBlock + BN) * LDC, r0, g, t);
      continue;
    }
    // P = exp(S scale - lse), 0 where masked; dS / scale = P (dP - delta).
    const int k0 = it * BN;
    const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > q0 + r0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = hopper::exp2_ftz(fmaf(x[j][e], scale_log2, -lse2[e >> 1]));
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          if (col >= S || (causal && col > row)) p = 0.f;
        }
        y[j][e] = p * (y[j][e] - dlt[e >> 1]);
      }
    group_product<E, NJ>(acc, y, st, g, t);
  }
  tf32::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r)
    store_group<E>(dq, b, q0 + r0 + g + 8 * r, h, H, S, Dt, c0, acc, r, scale, t);
}

// ---------------------------------------------------------------------------
// K3: dk and dv.  Grid (B*H, roles * ceil(S/64), ceil(Dt/128)); block = 64
// keys, the first key blocks (the most causal work) first; q tiles from the
// causal frontier to the end, each ceil(Dt/64) chunk steps (K_c, Q_c, and
// for dK V_c, dO_c), then its group step (dV: dO_g and lse; dK: Q_g, lse
// and delta).  float32 one block a role (kDv, kDk), 16-bit both (kBoth).
// ---------------------------------------------------------------------------
enum Role { kBoth, kDv, kDk };

template <typename E, bool VEC, int ROLE>
__device__ __forceinline__ void dkv_block(unsigned char* smem_raw, const Operand<E>& q,
                                          const Operand<E>& k, const Operand<E>& v,
                                          const Operand<E>& dout, const float* lse,
                                          const float* delta, E* dk, E* dv, int H, int S,
                                          int Dt, float scale, float scale_log2, int causal,
                                          int kb) {
  using T = DkvTile<E>;
  constexpr int BN = T::kStream, NJ = BN / 8, LDC = ld_chunk<E>(), LDG = ld_group<E>();
  constexpr bool kDoV = ROLE != kDk, kDoK = ROLE != kDv;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = kb * kBlock, c0 = blockIdx.z * kGroup;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;
  const int qstart = causal ? k0 : 0;
  const int ntiles = (S - qstart + BN - 1) / BN, nc = (Dt + kChunk - 1) / kChunk;
  const int nsteps = ntiles * (nc + 1);
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;
  auto stage = [&](int i) {
    return reinterpret_cast<E*>(smem_raw + (i % kStages) * T::kStage);
  };
  // Chunk step: K_c, V_c, Q_c, dO_c; group step: Q_g, dO_g, then lse and
  // delta (floats).  A role loads what it reads.
  auto issue = [&](int i) {
    if (i < nsteps) {
      const int it = i / (nc + 1), c = i % (nc + 1), qr0 = qstart + it * BN;
      E* st = stage(i);
      if (c < nc) {
        const int d0 = c * kChunk;
        copy_tile<E, kBlock, kChunk, LDC, VEC>(st, k, b, h, k0, d0, S, Dt);
        copy_tile<E, BN, kChunk, LDC, VEC>(st + 2 * kBlock * LDC, q, b, h, qr0, d0, S, Dt);
        if constexpr (kDoK) {
          copy_tile<E, kBlock, kChunk, LDC, VEC>(st + kBlock * LDC, v, b, h, k0, d0, S, Dt);
          copy_tile<E, BN, kChunk, LDC, VEC>(st + (2 * kBlock + BN) * LDC, dout, b, h, qr0, d0,
                                             S, Dt);
        }
      } else {
        float* stat = reinterpret_cast<float*>(st + 2 * BN * LDG);
        if constexpr (kDoK) copy_tile<E, BN, kGroup, LDG, VEC>(st, q, b, h, qr0, c0, S, Dt);
        if constexpr (kDoV)
          copy_tile<E, BN, kGroup, LDG, VEC>(st + BN * LDG, dout, b, h, qr0, c0, S, Dt);
        copy_stats<BN>(stat, lse_bh, qr0, S);
        if constexpr (kDoK) copy_stats<BN>(stat + BN, delta_bh, qr0, S);
      }
    }
    tf32::cp_async_commit();
  };

  float acc_k[kDoK ? kGroup / 8 : 1][4], acc_v[kDoV ? kGroup / 8 : 1][4];
  float x[NJ][4], y[kDoK ? NJ : 1][4];
  zero(acc_k);
  zero(acc_v);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < nsteps; ++i) {
    tf32::cp_async_wait<kStages - 2>();
    __syncthreads();  // step i has landed; step i - 1's stage is free
    issue(i + kStages - 1);
    const int it = i / (nc + 1), c = i % (nc + 1), qr0 = qstart + it * BN;
    const E* st = stage(i);
    if (c < nc) {
      if (c == 0) {
        zero(x);
        zero(y);
      }
      chunk_product<E, NJ>(x, st, st + 2 * kBlock * LDC, r0, g, t);
      if constexpr (kDoK)
        chunk_product<E, NJ>(y, st + kBlock * LDC, st + (2 * kBlock + BN) * LDC, r0, g, t);
      continue;
    }
    const E* sQ = st;
    const E* sdO = st + BN * LDG;
    const float* sL = reinterpret_cast<const float*>(st + 2 * BN * LDG);
    const float* sD = sL + BN;
    // P^T = exp(S^T scale - lse), 0 where masked; dS^T / scale = P^T (dP^T - delta).
    const bool edge = qr0 + BN > S || (causal && k0 + r0 + 15 > qr0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cq = 8 * j + 2 * t + (e & 1);
        float p = hopper::exp2_ftz(fmaf(x[j][e], scale_log2, -sL[cq] * kLog2e));
        if (edge) {
          const int key = k0 + r0 + g + 8 * (e >> 1), qr = qr0 + cq;
          if (qr >= S || (causal && key > qr)) p = 0.f;
        }
        x[j][e] = p;
        if constexpr (kDoK) y[j][e] = p * (y[j][e] - sD[cq]);
      }
    if constexpr (kDoV) group_product<E, NJ>(acc_v, x, sdO, g, t);
    if constexpr (kDoK) group_product<E, NJ>(acc_k, y, sQ, g, t);
  }
  tf32::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + g + 8 * r;
    if constexpr (kDoK) store_group<E>(dk, b, key, h, H, S, Dt, c0, acc_k, r, scale, t);
    if constexpr (kDoV) store_group<E>(dv, b, key, h, H, S, Dt, c0, acc_v, r, 1.f, t);
  }
}

template <typename E, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
wide_dkv_kernel(Operand<E> q, Operand<E> k, Operand<E> v, Operand<E> dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                E* __restrict__ dk, E* __restrict__ dv, int H, int S, int Dt, float scale,
                float scale_log2, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kb = blockIdx.y / DkvTile<E>::kRoles;
  if constexpr (DkvTile<E>::kRoles == 1) {
    dkv_block<E, VEC, kBoth>(smem_raw, q, k, v, dout, lse, delta, dk, dv, H, S, Dt, scale,
                             scale_log2, causal, kb);
  } else if (blockIdx.y % 2 == 0) {
    dkv_block<E, VEC, kDv>(smem_raw, q, k, v, dout, lse, delta, dk, dv, H, S, Dt, scale,
                           scale_log2, causal, kb);
  } else {
    dkv_block<E, VEC, kDk>(smem_raw, q, k, v, dout, lse, delta, dk, dv, H, S, Dt, scale,
                           scale_log2, causal, kb);
  }
}

// ---------------------------------------------------------------------------
// Host side.  `st` holds four element strides (b, s, h, d) per operand (q,
// k, v[, dout[, o]]) and `launch` is the launch plan's (grid x, grid y,
// grid z, threads, dynamic shared-memory bytes, copy bytes)
// (ops/flash_attention.launch_plan).
// ---------------------------------------------------------------------------
template <typename E>
Operand<E> operand(const void* p, const long long* st) {
  return Operand<E>{static_cast<const E*>(p), st[0], st[1], st[2], st[3]};
}

// grid y a multiple of the kernel's roles
template <bool VEC>
bool check_launch(const int* launch, int smem, int roles = 1) {
  return launch[0] >= 1 && launch[1] >= 1 && launch[1] % roles == 0 && launch[2] >= 1 &&
         launch[3] == kThreads && launch[4] == smem && launch[5] == (VEC ? 16 : 4);
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename E, bool VEC>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int S, int H,
                int Dt, const long long* st, const int* launch, float scale, int causal,
                cudaStream_t stream) {
  constexpr int smem = FwdTile<E>::kSmem;
  if (!check_launch<VEC>(launch, smem)) return cudaErrorInvalidConfiguration;
  auto kernel = wide_fwd_kernel<E, VEC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(launch[0], launch[1], launch[2]), kThreads, smem, stream>>>(
      operand<E>(q, st), operand<E>(k, st + 4), operand<E>(v, st + 8), (E*)o, (float*)lse, H,
      S, Dt, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename E, bool VEC>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const void* o,
               const void* lse, const void* dlse, void* delta, void* dqo, int S, int H, int Dt,
               const long long* st, const int* launch, float scale, int causal,
               cudaStream_t stream) {
  constexpr int smem = DqTile<E>::kSmem;
  if (!check_launch<VEC>(launch, smem)) return cudaErrorInvalidConfiguration;
  auto kernel = wide_dq_kernel<E, VEC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(launch[0], launch[1], launch[2]), kThreads, smem, stream>>>(
      operand<E>(q, st), operand<E>(k, st + 4), operand<E>(v, st + 8),
      operand<E>(dout, st + 12), operand<E>(o, st + 16), (const float*)lse,
      (const float*)dlse, (float*)delta, (E*)dqo, H, S, Dt, scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <typename E, bool VEC>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dko, void* dvo, int S, int H, int Dt,
                const long long* st, const int* launch, float scale, int causal,
                cudaStream_t stream) {
  constexpr int smem = DkvTile<E>::kSmem;
  if (!check_launch<VEC>(launch, smem, DkvTile<E>::kRoles)) return cudaErrorInvalidConfiguration;
  auto kernel = wide_dkv_kernel<E, VEC>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(launch[0], launch[1], launch[2]), kThreads, smem, stream>>>(
      operand<E>(q, st), operand<E>(k, st + 4), operand<E>(v, st + 8),
      operand<E>(dout, st + 12), (const float*)lse, (const float*)delta, (E*)dko, (E*)dvo, H,
      S, Dt, scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace wide
