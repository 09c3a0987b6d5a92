// Flash attention in float32 for Hopper (sm_90a): forward (K1), dq (K2) and
// dk/dv (K3) on the tensor cores in 3xTF32.
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
// log(l), delta = rowsum(dO o) - dlse.
//
// Layout.  q, k, v, dO and O are (B, S, H, Dt) float32 tensors read through
// their four element strides (the fused-QKV slices need no copy); O, dq, dk
// and dv are written contiguous (B, S, H, Dt); lse and delta are (B, H, S),
// dlse (B, S, H).  Instances DM = 16, 64, 128, 256: a head dim Dt runs in
// the smallest DM >= Dt; tile columns past Dt are zeros, and output columns
// past Dt are never stored.  Every Dt > 256 runs in the wide route
// (flash_wide.cuh, -DFLASH_D=0), in both copy routes.
//
// Every product in 3xTF32 (mma_tf32.cuh), mma.sync.m16n8k8 in
// TF32 with each float32 operand split into hi + lo, rounded to nearest
// (cvt.rna's rounding, in integer operations), and lo.hi + hi.lo + hi.hi
// summed in float32.  A TF32 product alone (one rounding to 11 significant
// bits) puts ~1e-3 relative error into the scores, over the 2e-5 the
// float32 twin holds; the split leaves ~2^-21 a product term: for
// unit-normal inputs at D = 256 a logit (scaled by 1/16) is off by ~16 x
// 2^-21 / 16 ~ 5e-7.  The tensor cores add into their accumulator with
// truncation, up to an ulp toward zero each time, so a chain of additions
// drifts with its length: the score products keep hi.hi apart from the
// small products where registers allow (kSplitAcc; K1 always), and at
// small DM a tile's P.V (K2: dS.K; K3: dK, dV) is summed apart and added
// in float32 (kTwoLevel), so that no tensor-core chain runs over a whole
// row of 4,096 keys.  Bound: 3 TF32 products for each float32 one, 495 / 3 = 165
// TFLOP/s on the H100 SXM, 2.5x the CUDA cores' 67; every case is bound by
// operations.
//
// Why mma.sync and not wgmma: wgmma takes TF32 only with both operands
// K-major in shared memory.  P.V-type products (P.V, P^T.dO, dS^T.Q) would
// need a transposed copy of V (dO, Q), and 3xTF32 the hi and lo of each B
// operand as two more tiles; at D = 256 that does not fit 232,448 bytes.
// mma.sync reads B from registers, so a warp splits its fragments as it
// loads them and shared memory holds one float32 copy of each tile.
//
// FlashAttention-2 layout: a warp owns 16 rows of the block (K1, K2:
// queries; K3: keys), 4 warps a block of 64.  The scores of a tile stay in the
// warp's accumulators: the row max and sum are two shuffles within a quad,
// and the accumulator feeds the next product as its A operand without a
// shuffle (acc_as_a: a lane holds score columns 2t and 2t + 1, which serve
// as k = t and t + 4, and B's rows are read in that order; K2's dS feeds
// dS.K so, the K tile of its scores read by columns).  K1's Q fragments
// stay split in registers at DM <= 64 and are split as they load at
// DM >= 128; K2 keeps Q's and dO's split fragments in registers at
// DM = 16, K3 K's and V's.  Where a block's grid gives one block an SM
// (B*H*S/64 ~ the SMs), two groups of 4 warps own the same 64 rows and
// take turns over the streamed tiles (kGroups: K1 at DM >= 128, K2 and K3
// at 64 and 128); group 1 hands its (m, l, O), its dQ or its
// dK, dV to group 0 through shared memory at the end.  K3 at DM = 256 splits by role, a block computing dV and
// another dK for the same 64 keys (grid y doubled), since a warp's dK and
// dV of 16 keys would take 256 accumulator registers; the dK block
// recomputes S^T.
//
// The streamed tiles (K1, K2: K and V; K3: q and dO with their lse and
// delta) come through a ring of cp.async, 2 stages (4 at DM = 16) of one
// tile a group: the next stages land while a stage is multiplied, one
// __syncthreads() a stage.  The wrapper picks the copy: 16-byte
// cp.async.cg where every operand has unit stride along D and 16-byte
// aligned rows and base, 4-byte copies otherwise (the fused-QKV slices at
// odd head dims); never a copy of the operand.  The route is a template
// flag: a runtime branch between the two in one kernel cost K1 and K3
// 10-25% on an H100 (PERF.md).  A library holds one route,
// -DFLASH_COPY=<bytes> (16 or 4), so that no nvcc compiles both.  K2
// reads its resident Q and dO, and the O of its delta, through the same
// copies before the ring starts.  Rows past S and columns past Dt arrive
// as zeros (the copy's src-size).
//
// Bank conflicts (no ncu on the card's machine, so by arithmetic): tiles
// have a row stride of LD = DM + 4 floats, 16-byte aligned rows for the
// copies, LD = 4 (mod 32) at DM = 64-256 and 20 at DM = 16.  K-major loads
// (load_a, load_b_rows: lane (g, t) reads row g, column t) hit bank 4g + t
// (16: 20g + t), 32 banks for 32 lanes; the P.V-side loads (load_b_cols:
// rows 2t and 2t + 1, column g) hit 8t + g and 8t + 4 + g (16: 8t + g and
// 8t + 20 + g), 32 banks each.  K2 reads its K tiles and K3 its q and dO
// tiles both ways with no swizzle.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_wide.cuh"
#include "hopper.cuh"
#include "mma_tf32.cuh"

#if !defined(FLASH_COPY) || (FLASH_COPY != 16 && FLASH_COPY != 4)
#error "build with -DFLASH_COPY=16 or 4: the copy route of this library"
#endif

namespace {

using flash::kLn2;
using flash::kLog2e;
using flash::kMask;
constexpr bool kVec = FLASH_COPY == 16;  // this library's copy route

// One (B, S, H, Dt) operand: its base and element strides.
struct Operand {
  const float* p;
  long long sb, ss, sh, sd;
};

// ---------------------------------------------------------------------------
// K1-K3 on the tensor cores.
// ---------------------------------------------------------------------------

// K1's tile: kGroups groups of 4 warps own the same 64 query rows, each
// group a warp per 16 rows, and take turns over the key tiles (kStream keys
// each): a stage of the ring holds kGroups tiles, one a group.  The groups
// merge their (m, l, O) through shared memory at the end.
template <int DM>
struct FwdTile {
  static constexpr int kGroups = DM >= 128 ? 2 : 1;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBlock = 64;
  static constexpr int kStream = DM == 256 ? 16 : DM == 128 ? 32 : 64;
  static constexpr int kLd = DM + 4;
  static constexpr int kStages = DM == 16 ? 4 : 2;
  static constexpr bool kQRegs = DM <= 64;     // Q's split fragments in registers
  static constexpr bool kTwoLevel = DM <= 64;  // a tile's P.V apart, then added
  static constexpr int kTileFloats = 2 * kStream * kLd;  // K, then V
  static constexpr int kSmem = 4 * (kBlock * kLd + kStages * kGroups * kTileFloats);
};

// K3's tile: kGroups groups of 4 warps own the same 64 keys and take turns
// over the query tiles (kStream rows each, with their lse and delta); at
// DM = 256 one block a role (dV, dK).  The groups add their dK and dV
// through shared memory at the end.
template <int DM>
struct DkvTile {
  static constexpr int kGroups = DM == 64 || DM == 128 ? 2 : 1;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBlock = 64;
  static constexpr int kStream = DM >= 128 ? 16 : 64;
  static constexpr int kRoles = DM == 256 ? 2 : 1;
  static constexpr int kLd = DM + 4;
  static constexpr int kStages = DM == 16 ? 4 : 2;
  static constexpr bool kKVRegs = DM <= 16;    // K's and V's split fragments in registers
  static constexpr bool kTwoLevel = DM <= 16;  // a tile's dK and dV apart, then added
  static constexpr bool kSplitAcc = DM == 16 || DM == 256;  // big and small score accumulators
  static constexpr int kTileFloats = 2 * kStream * kLd + 2 * kStream;  // q, dO, lse, delta
  static constexpr int kSmem = 4 * (2 * kBlock * kLd + kStages * kGroups * kTileFloats);
};

// K2's tile: as K1's, kGroups groups of 4 warps own the same 64 query rows
// and take turns over the key tiles (kStream keys each, K and V), with Q
// and dO resident beside the ring and delta of the 64 rows.  The groups
// add their dQ through shared memory at the end.  At DM = 256 one group:
// Q and dO take 133,120 bytes, so two groups' 16-key K and V tiles in two
// stages (another 133,120) do not fit a block's 232,448, and two groups
// over 8-key tiles ran 10% slower than one over 16-key tiles on an H100
// (PERF.md).
template <int DM>
struct DqTile {
  static constexpr int kGroups = DM == 64 || DM == 128 ? 2 : 1;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBlock = 64;
  static constexpr int kStream = DM == 256 ? 16 : DM == 128 ? 32 : 64;
  static constexpr int kLd = DM + 4;
  static constexpr int kStages = DM == 16 ? 4 : 2;
  static constexpr bool kRegs = DM <= 16;       // Q's and dO's split fragments in registers
  static constexpr bool kTwoLevel = DM <= 64;   // a tile's dS.K apart, then added
  static constexpr bool kSplitAcc = DM >= 128;  // big and small score accumulators
  static constexpr int kTileFloats = 2 * kStream * kLd;  // K, then V
  static constexpr int kSmem = 4 * (2 * kBlock * kLd + kBlock + kStages * kGroups * kTileFloats);
};

// Rows row0 .. row0 + ROWS - 1, columns 0 .. DM - 1, of the (b, h) slab of
// `t` into a shared tile of row stride LD through cp.async; zeros past S
// and past Dt.  VEC: 16-byte copies (unit stride along D, 16-byte aligned
// rows and base), else 4-byte ones.
template <int ROWS, int DM, int LD, int THREADS, bool VEC>
__device__ __forceinline__ void copy_tile(float* dst, const Operand& t, int b, int h,
                                          int row0, int S, int Dt) {
  const float* slab = t.p + b * t.sb + h * t.sh;
  if constexpr (VEC) {
    constexpr int kChunks = DM / 4;
    for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
      const int r = i / kChunks, c = 4 * (i % kChunks), s = row0 + r;
      const int n = s < S ? max(0, min(4, Dt - c)) : 0;
      tf32::cp_async16(dst + r * LD + c, n ? slab + s * t.ss + c : slab, 4 * n);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DM; i += THREADS) {
      const int r = i / DM, d = i % DM, s = row0 + r;
      const bool in = s < S && d < Dt;
      tf32::cp_async4(dst + r * LD + d, in ? slab + s * t.ss + d * t.sd : slab, in ? 4 : 0);
    }
  }
}

// Entries row0 .. row0 + ROWS - 1 of a contiguous row of statistics; zeros
// past S.
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_stats(float* dst, const float* src, int row0, int S) {
  for (int i = threadIdx.x; i < ROWS; i += THREADS) {
    const bool in = row0 + i < S;
    tf32::cp_async4(dst + i, in ? src + row0 + i : src, in ? 4 : 0);
  }
}

// Row `row` of a contiguous (B, S, H, Dt) output from a warp's m16n8
// accumulators: half r (0: row g, 1: row g + 8), columns 8n + 2t, 8n + 2t + 1.
template <int ND>
__device__ __forceinline__ void store_acc(float* out, int b, int row, int h, int H, int S,
                                          int Dt, const float (&acc)[ND][4], int r,
                                          float mul, int t) {
  if (row >= S) return;
  float* base = out + (((long long)b * S + row) * H + h) * Dt;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    if (col < Dt) base[col] = acc[n][2 * r] * mul;
    if (col + 1 < Dt) base[col + 1] = acc[n][2 * r + 1] * mul;
  }
}

template <int ND>
__device__ __forceinline__ void zero(float (&x)[ND][4]) {
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// A warp's accumulators into shared memory in fragment order (lane
// fastest: no bank conflicts), for the merge of two warp groups.
template <int ND>
__device__ __forceinline__ void put_acc(float* xch, const float (&acc)[ND][4], int lane) {
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) xch[(4 * n + e) * 32 + lane] = acc[n][e];
}

// ---------------------------------------------------------------------------
// K1: forward.  Grid (B*H, ceil(S/64)); block = 64 query rows, the heaviest
// causal tiles first; key tiles up to the causal frontier.
// ---------------------------------------------------------------------------
template <int DM, bool VEC>
__global__ void __launch_bounds__(FwdTile<DM>::kThreads, 1)
flash_fwd_f32_kernel(Operand q, Operand k, Operand v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int S, int Dt, float scale_log2,
                     int causal) {
  using T = FwdTile<DM>;
  constexpr int LD = T::kLd, BN = T::kStream, NJ = BN / 8, ND = DM / 8, G = T::kGroups;
  // The score product's steps over D: unrolled 4 at a time where Q's
  // fragments load from shared memory (the build's time grows with the
  // unrolled code), whole where they are registers.
  constexpr int kUnrollS = T::kQRegs ? ND : 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* ring = sQ + T::kBlock * LD;  // stage i: group g's K tile, then its V tile

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int grp = warp / 4, r0 = 16 * (warp % 4);  // the warp's rows in the block
  const int kend = causal ? min(S, q0 + T::kBlock) : S;
  const int ntiles = (kend + BN - 1) / BN;

  copy_tile<T::kBlock, DM, LD, T::kThreads, VEC>(sQ, q, b, h, q0, S, Dt);
  auto issue = [&](int i) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int it = i * G + gi;
      float* st = ring + ((i % T::kStages) * G + gi) * T::kTileFloats;
      if (it < ntiles) {
        copy_tile<BN, DM, LD, T::kThreads, VEC>(st, k, b, h, it * BN, S, Dt);
        copy_tile<BN, DM, LD, T::kThreads, VEC>(st + BN * LD, v, b, h, it * BN, S, Dt);
      }
    }
  };

  float acc[ND][4];
  zero(acc);
  float m[2] = {kMask, kMask};  // running max of rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};      // the lane's partial row sums
  tf32::FragA qf[T::kQRegs ? ND : 1];

  const int nsteps = (ntiles + G - 1) / G;  // ring stages of G tiles
#pragma unroll
  for (int i = 0; i < T::kStages - 1; ++i) {
    if (i < nsteps) issue(i);
    tf32::cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    tf32::cp_async_wait<T::kStages - 2>();
    __syncthreads();  // stage i has landed; stage i - 1 is free
    if (i + T::kStages - 1 < nsteps) issue(i + T::kStages - 1);
    tf32::cp_async_commit();
    const int it = i * G + grp;  // the group's tile
    if (it >= ntiles) continue;
    const float* sK = ring + ((i % T::kStages) * G + grp) * T::kTileFloats;
    const float* sV = sK + BN * LD;
    if constexpr (T::kQRegs) {
      if (i == 0) {
#pragma unroll
        for (int ks = 0; ks < ND; ++ks) tf32::load_a<LD>(qf[ks], sQ, r0, 8 * ks, g, t);
      }
    }

    // S = Q . K^T, hi.hi and the small products apart
    float s[NJ][4], s2[NJ][4];
    zero(s);
    zero(s2);
#pragma unroll kUnrollS
    for (int ks = 0; ks < ND; ++ks) {
      tf32::FragA a;
      if constexpr (T::kQRegs)
        a = qf[ks];
      else
        tf32::load_a<LD>(a, sQ, r0, 8 * ks, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        tf32::FragB bk;
        tf32::load_b_rows<LD>(bk, sK, 8 * j, 8 * ks, g, t);
        tf32::mma3(s[j], s2[j], a, bk);
      }
    }

    // The online softmax over the tile, in log2 units; masked logits -inf.
    const int k0 = it * BN;
    const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > q0 + r0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (s[j][e] + s2[j][e]) * scale_log2;
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
    if constexpr (!T::kTwoLevel) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = hopper::exp2_ftz(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }

    // O += P . V, P straight from the score accumulators; with kTwoLevel
    // the tile's product is summed apart and added in float32 (O = O corr
    // + P.V), so that no tensor-core chain runs over the whole row.
    float part[T::kTwoLevel ? ND : 1][4];
    zero(part);
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      tf32::FragA a;
      tf32::acc_as_a(a, s[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        tf32::FragB bv;
        tf32::load_b_cols<LD>(bv, sV, 8 * kk, 8 * n, g, t);
        if constexpr (T::kTwoLevel)
          tf32::mma3(part[n], a, bv);
        else
          tf32::mma3(acc[n], a, bv);
      }
    }
    if constexpr (T::kTwoLevel) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = fmaf(acc[n][e], corr[e >> 1], part[n][e]);
    }
  }
  tf32::cp_async_wait<0>();
  __syncthreads();  // every group done: the ring is free for the merge

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (G == 2) {
    // Group 1 hands its (m, l, O) to group 0, which merges and stores.
    float* xch = ring + (warp % 4) * (ND * 4 + 4) * 32;
    if (grp == 1) {
      put_acc<ND>(xch, acc, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xch[(ND * 4 + r) * 32 + lane] = m[r];
        xch[(ND * 4 + 2 + r) * 32 + lane] = l[r];
      }
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xch[(ND * 4 + r) * 32 + lane], l1 = xch[(ND * 4 + 2 + r) * 32 + lane];
      const float mn = fmaxf(m[r], m1);
      const float c0 = hopper::exp2_ftz(m[r] - mn), c1 = hopper::exp2_ftz(m1 - mn);
      m[r] = mn;
      l[r] = l[r] * c0 + l1 * c1;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          acc[n][e] = acc[n][e] * c0 + xch[(4 * n + e) * 32 + lane] * c1;
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    const float li = fmaxf(l[r], 1e-30f);
    store_acc<ND>(o, b, row, h, H, S, Dt, acc, r, 1.f / li, t);
    if (t == 0 && row < S) lse[(long long)bh * S + row] = (m[r] + log2f(li)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// K3: dk and dv.  Grid (B*H, roles * ceil(S/64)); block = 64 keys, the first
// key blocks (the most causal work) first; q tiles from the causal frontier
// to the end.
// ---------------------------------------------------------------------------
enum Role { kBoth, kDv, kDk };

template <int DM, int ROLE, bool VEC>
__device__ __forceinline__ void dkv_block(float* smem, const Operand& q, const Operand& k,
                                          const Operand& v, const Operand& dout,
                                          const float* lse, const float* delta, float* dk,
                                          float* dv, int H, int S, int Dt, float scale,
                                          float scale_log2, int causal, int kb) {
  using T = DkvTile<DM>;
  constexpr int LD = T::kLd, BN = T::kStream, NJ = BN / 8, ND = DM / 8, G = T::kGroups;
  constexpr bool kDoV = ROLE != kDk, kDoK = ROLE != kDv;
  constexpr int kUnrollS = T::kKVRegs ? ND : 4;  // as K1's
  float* sK = smem;
  float* sV = sK + T::kBlock * LD;
  float* ring = sV + T::kBlock * LD;  // stage i: group g's q, dO, lse, delta

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = kb * T::kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int grp = warp / 4, r0 = 16 * (warp % 4);  // the warp's keys in the block
  const int qstart = causal ? k0 : 0;
  const int ntiles = (S - qstart + BN - 1) / BN;
  const float* lse_bh = lse + (long long)bh * S;
  const float* delta_bh = delta + (long long)bh * S;

  copy_tile<T::kBlock, DM, LD, T::kThreads, VEC>(sK, k, b, h, k0, S, Dt);
  if constexpr (kDoK) copy_tile<T::kBlock, DM, LD, T::kThreads, VEC>(sV, v, b, h, k0, S, Dt);
  auto issue = [&](int i) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int it = i * G + gi;
      float* st = ring + ((i % T::kStages) * G + gi) * T::kTileFloats;
      if (it < ntiles) {
        const int q0 = qstart + it * BN;
        copy_tile<BN, DM, LD, T::kThreads, VEC>(st, q, b, h, q0, S, Dt);
        copy_tile<BN, DM, LD, T::kThreads, VEC>(st + BN * LD, dout, b, h, q0, S, Dt);
        copy_stats<BN, T::kThreads>(st + 2 * BN * LD, lse_bh, q0, S);
        if constexpr (kDoK) copy_stats<BN, T::kThreads>(st + 2 * BN * LD + BN, delta_bh, q0, S);
      }
    }
  };

  float acc_k[kDoK ? ND : 1][4], acc_v[kDoV ? ND : 1][4];
  zero(acc_k);
  zero(acc_v);
  tf32::FragA kf[T::kKVRegs ? ND : 1], vf[T::kKVRegs ? ND : 1];

  const int nsteps = (ntiles + G - 1) / G;  // ring stages of G tiles
#pragma unroll
  for (int i = 0; i < T::kStages - 1; ++i) {
    if (i < nsteps) issue(i);
    tf32::cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    tf32::cp_async_wait<T::kStages - 2>();
    __syncthreads();  // stage i has landed; stage i - 1 is free
    if (i + T::kStages - 1 < nsteps) issue(i + T::kStages - 1);
    tf32::cp_async_commit();
    const int it = i * G + grp;  // the group's tile
    if (it >= ntiles) continue;
    if constexpr (T::kKVRegs) {
      if (i == 0) {
#pragma unroll
        for (int ks = 0; ks < ND; ++ks) {
          tf32::load_a<LD>(kf[ks], sK, r0, 8 * ks, g, t);
          if constexpr (kDoK) tf32::load_a<LD>(vf[ks], sV, r0, 8 * ks, g, t);
        }
      }
    }
    const float* sQ = ring + ((i % T::kStages) * G + grp) * T::kTileFloats;
    const float* sdO = sQ + BN * LD;
    const float* sL = sdO + BN * LD;
    const float* sD = sL + BN;
    const int q0 = qstart + it * BN;

    // S^T = K . Q^T and dP^T = V . dO^T (with kSplitAcc hi.hi and the
    // small products apart)
    constexpr int NS = T::kSplitAcc ? NJ : 1;
    float x[NJ][4], y[kDoK ? NJ : 1][4], x2[NS][4], y2[kDoK ? NS : 1][4];
    zero(x);
    zero(y);
    zero(x2);
    zero(y2);
#pragma unroll kUnrollS
    for (int ks = 0; ks < ND; ++ks) {
      tf32::FragA a;
      if constexpr (T::kKVRegs)
        a = kf[ks];
      else
        tf32::load_a<LD>(a, sK, r0, 8 * ks, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        tf32::FragB bq;
        tf32::load_b_rows<LD>(bq, sQ, 8 * j, 8 * ks, g, t);
        if constexpr (T::kSplitAcc)
          tf32::mma3(x[j], x2[j], a, bq);
        else
          tf32::mma3(x[j], a, bq);
      }
      if constexpr (kDoK) {
        if constexpr (T::kKVRegs)
          a = vf[ks];
        else
          tf32::load_a<LD>(a, sV, r0, 8 * ks, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          tf32::FragB bo;
          tf32::load_b_rows<LD>(bo, sdO, 8 * j, 8 * ks, g, t);
          if constexpr (T::kSplitAcc)
            tf32::mma3(y[j], y2[j], a, bo);
          else
            tf32::mma3(y[j], a, bo);
        }
      }
    }
    if constexpr (T::kSplitAcc) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[j][e] += x2[j][e];
          if constexpr (kDoK) y[j][e] += y2[j][e];
        }
    }

    // P^T = exp(S^T scale - lse), 0 where masked; dS^T / scale = P^T (dP^T - delta).
    const bool edge = q0 + BN > S || (causal && k0 + r0 + 15 > q0);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float p = hopper::exp2_ftz(fmaf(x[j][e], scale_log2, -sL[c] * kLog2e));
        if (edge) {
          const int key = k0 + r0 + g + 8 * (e >> 1), qr = q0 + c;
          if (qr >= S || (causal && key > qr)) p = 0.f;
        }
        x[j][e] = p;
        if constexpr (kDoK) y[j][e] = p * (y[j][e] - sD[c]);
      }

    // dV += P^T . dO and dK += dS^T . Q, the scores straight from the
    // accumulators; with kTwoLevel the tile's products are summed apart and
    // added in float32.
    constexpr int NP = T::kTwoLevel ? ND : 1;
    float part_k[kDoK ? NP : 1][4], part_v[kDoV ? NP : 1][4];
    zero(part_k);
    zero(part_v);
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      if constexpr (kDoV) {
        tf32::FragA a;
        tf32::acc_as_a(a, x[kk]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          tf32::FragB bo;
          tf32::load_b_cols<LD>(bo, sdO, 8 * kk, 8 * n, g, t);
          if constexpr (T::kTwoLevel)
            tf32::mma3(part_v[n], a, bo);
          else
            tf32::mma3(acc_v[n], a, bo);
        }
      }
      if constexpr (kDoK) {
        tf32::FragA a;
        tf32::acc_as_a(a, y[kk]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          tf32::FragB bq;
          tf32::load_b_cols<LD>(bq, sQ, 8 * kk, 8 * n, g, t);
          if constexpr (T::kTwoLevel)
            tf32::mma3(part_k[n], a, bq);
          else
            tf32::mma3(acc_k[n], a, bq);
        }
      }
    }
    if constexpr (T::kTwoLevel) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kDoV) acc_v[n][e] += part_v[n][e];
          if constexpr (kDoK) acc_k[n][e] += part_k[n][e];
        }
    }
  }
  tf32::cp_async_wait<0>();
  __syncthreads();  // every group done: the ring is free for the merge

  if constexpr (G == 2) {
    // Group 1 hands its dK and dV to group 0, which adds and stores.
    float* xch = ring + (warp % 4) * (2 * ND * 4) * 32;
    if (grp == 1) {
      if constexpr (kDoK) put_acc<ND>(xch, acc_k, lane);
      if constexpr (kDoV) put_acc<ND>(xch + ND * 4 * 32, acc_v, lane);
    }
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kDoK) acc_k[n][e] += xch[(4 * n + e) * 32 + lane];
        if constexpr (kDoV) acc_v[n][e] += xch[(ND * 4 + 4 * n + e) * 32 + lane];
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + g + 8 * r;
    if constexpr (kDoK) store_acc<ND>(dk, b, key, h, H, S, Dt, acc_k, r, scale, t);
    if constexpr (kDoV) store_acc<ND>(dv, b, key, h, H, S, Dt, acc_v, r, 1.f, t);
  }
}

template <int DM, bool VEC>
__global__ void __launch_bounds__(DkvTile<DM>::kThreads, 1)
flash_dkv_f32_kernel(Operand q, Operand k, Operand v, Operand dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int S, int Dt,
                     float scale, float scale_log2, int causal) {
  using T = DkvTile<DM>;
  extern __shared__ __align__(16) float smem[];
  const int kb = blockIdx.y / T::kRoles;
  if constexpr (T::kRoles == 1) {
    dkv_block<DM, kBoth, VEC>(smem, q, k, v, dout, lse, delta, dk, dv, H, S, Dt, scale,
                              scale_log2, causal, kb);
  } else if (blockIdx.y % 2 == 0) {
    dkv_block<DM, kDv, VEC>(smem, q, k, v, dout, lse, delta, dk, dv, H, S, Dt, scale,
                            scale_log2, causal, kb);
  } else {
    dkv_block<DM, kDk, VEC>(smem, q, k, v, dout, lse, delta, dk, dv, H, S, Dt, scale,
                            scale_log2, causal, kb);
  }
}

// ---------------------------------------------------------------------------
// K2: dq, and delta = rowsum(dO o) - dlse for K3.  Grid (B*H, ceil(S/64));
// block = 64 query rows, the heaviest causal tiles first; key tiles up to
// the causal frontier.
// ---------------------------------------------------------------------------
template <int DM, bool VEC>
__global__ void __launch_bounds__(DqTile<DM>::kThreads, 1)
flash_dq_f32_kernel(Operand q, Operand k, Operand v, Operand dout, Operand o,
                    const float* __restrict__ lse, const float* __restrict__ dlse,
                    float* __restrict__ delta, float* __restrict__ dq, int H, int S, int Dt,
                    float scale, float scale_log2, int causal) {
  using T = DqTile<DM>;
  constexpr int LD = T::kLd, BN = T::kStream, NJ = BN / 8, ND = DM / 8, G = T::kGroups;
  constexpr int kUnrollS = T::kRegs ? ND : 4;  // as K1's
  constexpr int kRingFloats = T::kStages * G * T::kTileFloats;
  static_assert(kRingFloats >= T::kBlock * LD, "O's tile fits the ring");
  static_assert(G == 1 || kRingFloats >= 4 * ND * 4 * 32, "the groups' merge fits the ring");
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + T::kBlock * LD;
  float* sDelta = sdO + T::kBlock * LD;
  float* ring = sDelta + T::kBlock;  // O's tile first; then stage i: group g's K, V

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int grp = warp / 4, r0 = 16 * (warp % 4);  // the warp's rows in the block
  const int kend = causal ? min(S, q0 + T::kBlock) : S;
  const int ntiles = (kend + BN - 1) / BN;

  // Q, dO and O land; delta = rowsum(dO o) - dlse, kThreads / 64 adjacent
  // lanes a row, into shared memory and to K3's buffer.
  copy_tile<T::kBlock, DM, LD, T::kThreads, VEC>(sQ, q, b, h, q0, S, Dt);
  copy_tile<T::kBlock, DM, LD, T::kThreads, VEC>(sdO, dout, b, h, q0, S, Dt);
  copy_tile<T::kBlock, DM, LD, T::kThreads, VEC>(ring, o, b, h, q0, S, Dt);
  tf32::cp_async_commit();
  tf32::cp_async_wait<0>();
  __syncthreads();
  {
    constexpr int P = T::kThreads / T::kBlock;
    const int row = threadIdx.x / P, s = q0 + row;
    float sum = 0.f;
#pragma unroll 4
    for (int d = threadIdx.x % P; d < DM; d += P)
      sum = fmaf(sdO[row * LD + d], ring[row * LD + d], sum);
#pragma unroll
    for (int off = 1; off < P; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float dl = s < S ? sum - dlse[((long long)b * S + s) * H + h] : 0.f;
    if (threadIdx.x % P == 0) {
      sDelta[row] = dl;
      if (s < S) delta[(long long)bh * S + s] = dl;
    }
  }
  __syncthreads();  // delta is in shared memory; O's room is free for the ring

  // The lane's rows g and g + 8: lse in log2 units and delta (0 past S).
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    lse2[r] = row < S ? lse[(long long)bh * S + row] * kLog2e : 0.f;
    dlt[r] = sDelta[r0 + g + 8 * r];
  }
  tf32::FragA qf[T::kRegs ? ND : 1], df[T::kRegs ? ND : 1];
  if constexpr (T::kRegs) {
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) {
      tf32::load_a<LD>(qf[ks], sQ, r0, 8 * ks, g, t);
      tf32::load_a<LD>(df[ks], sdO, r0, 8 * ks, g, t);
    }
  }

  auto issue = [&](int i) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int it = i * G + gi;
      float* st = ring + ((i % T::kStages) * G + gi) * T::kTileFloats;
      if (it < ntiles) {
        copy_tile<BN, DM, LD, T::kThreads, VEC>(st, k, b, h, it * BN, S, Dt);
        copy_tile<BN, DM, LD, T::kThreads, VEC>(st + BN * LD, v, b, h, it * BN, S, Dt);
      }
    }
  };

  float acc[ND][4];
  zero(acc);
  const int nsteps = (ntiles + G - 1) / G;  // ring stages of G tiles
#pragma unroll
  for (int i = 0; i < T::kStages - 1; ++i) {
    if (i < nsteps) issue(i);
    tf32::cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    tf32::cp_async_wait<T::kStages - 2>();
    __syncthreads();  // stage i has landed; stage i - 1 is free
    if (i + T::kStages - 1 < nsteps) issue(i + T::kStages - 1);
    tf32::cp_async_commit();
    const int it = i * G + grp;  // the group's tile
    if (it >= ntiles) continue;
    const float* sK = ring + ((i % T::kStages) * G + grp) * T::kTileFloats;
    const float* sV = sK + BN * LD;

    // S = Q . K^T and dP = dO . V^T (with kSplitAcc hi.hi and the small
    // products apart)
    constexpr int NS = T::kSplitAcc ? NJ : 1;
    float x[NJ][4], y[NJ][4], x2[NS][4], y2[NS][4];
    zero(x);
    zero(y);
    zero(x2);
    zero(y2);
#pragma unroll kUnrollS
    for (int ks = 0; ks < ND; ++ks) {
      tf32::FragA a;
      if constexpr (T::kRegs)
        a = qf[ks];
      else
        tf32::load_a<LD>(a, sQ, r0, 8 * ks, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        tf32::FragB bk;
        tf32::load_b_rows<LD>(bk, sK, 8 * j, 8 * ks, g, t);
        if constexpr (T::kSplitAcc)
          tf32::mma3(x[j], x2[j], a, bk);
        else
          tf32::mma3(x[j], a, bk);
      }
      if constexpr (T::kRegs)
        a = df[ks];
      else
        tf32::load_a<LD>(a, sdO, r0, 8 * ks, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        tf32::FragB bv;
        tf32::load_b_rows<LD>(bv, sV, 8 * j, 8 * ks, g, t);
        if constexpr (T::kSplitAcc)
          tf32::mma3(y[j], y2[j], a, bv);
        else
          tf32::mma3(y[j], a, bv);
      }
    }
    if constexpr (T::kSplitAcc) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[j][e] += x2[j][e];
          y[j][e] += y2[j][e];
        }
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

    // dQ += dS . K, dS straight from the accumulators and the same K tile
    // read by columns; with kTwoLevel the tile's product is summed apart
    // and added in float32.
    float part[T::kTwoLevel ? ND : 1][4];
    zero(part);
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      tf32::FragA a;
      tf32::acc_as_a(a, y[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        tf32::FragB bk;
        tf32::load_b_cols<LD>(bk, sK, 8 * kk, 8 * n, g, t);
        if constexpr (T::kTwoLevel)
          tf32::mma3(part[n], a, bk);
        else
          tf32::mma3(acc[n], a, bk);
      }
    }
    if constexpr (T::kTwoLevel) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }
  }
  tf32::cp_async_wait<0>();
  __syncthreads();  // every group done: the ring is free for the merge

  if constexpr (G == 2) {
    // Group 1 hands its dQ to group 0, which adds and stores.
    float* xch = ring + (warp % 4) * (ND * 4) * 32;
    if (grp == 1) put_acc<ND>(xch, acc, lane);
    __syncthreads();
    if (grp == 1) return;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += xch[(4 * n + e) * 32 + lane];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    store_acc<ND>(dq, b, q0 + r0 + g + 8 * r, h, H, S, Dt, acc, r, scale, t);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------
Operand operand(const void* p, const long long* strides) {
  return Operand{static_cast<const float*>(p), strides[0], strides[1], strides[2], strides[3]};
}

// The launch plan's (grid x, grid y, threads, dynamic shared-memory bytes,
// copy bytes) must be what the instance's tile takes: grid y a multiple of
// the tile's roles, and the copies this library's route.
bool check_launch(const int* launch, int threads, int smem, int roles) {
  return launch[0] >= 1 && launch[1] >= 1 && launch[1] % roles == 0 &&
         launch[2] == threads && launch[3] == smem;
}
bool check_copy(const int* launch) { return launch[4] == FLASH_COPY; }

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DM>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int S,
                int H, int Dt, const long long* st, const int* launch, float scale,
                int causal, cudaStream_t stream) {
  using T = FwdTile<DM>;
  if (!check_launch(launch, T::kThreads, T::kSmem, 1) || !check_copy(launch))
    return cudaErrorInvalidConfiguration;
  auto kernel = flash_fwd_f32_kernel<DM, kVec>;
  cudaError_t err = prepare(kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(launch[0], launch[1]), T::kThreads, T::kSmem, stream>>>(
      operand(q, st), operand(k, st + 4), operand(v, st + 8), (float*)o, (float*)lse, H, S,
      Dt, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int DM>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout, const void* o,
               const void* lse, const void* dlse, void* delta, void* dqo, int S, int H,
               int Dt, const long long* st, const int* launch, float scale, int causal,
               cudaStream_t stream) {
  using T = DqTile<DM>;
  if (!check_launch(launch, T::kThreads, T::kSmem, 1) || !check_copy(launch))
    return cudaErrorInvalidConfiguration;
  auto kernel = flash_dq_f32_kernel<DM, kVec>;
  cudaError_t err = prepare(kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(launch[0], launch[1]), T::kThreads, T::kSmem, stream>>>(
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
  using T = DkvTile<DM>;
  if (!check_launch(launch, T::kThreads, T::kSmem, T::kRoles) || !check_copy(launch))
    return cudaErrorInvalidConfiguration;
  auto kernel = flash_dkv_f32_kernel<DM, kVec>;
  cudaError_t err = prepare(kernel, T::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(launch[0], launch[1]), T::kThreads, T::kSmem, stream>>>(
      operand(q, st), operand(k, st + 4), operand(v, st + 8), operand(dout, st + 12),
      (const float*)lse, (const float*)delta, (float*)dko, (float*)dvo, H, S, Dt, scale,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

// The head-dim instance of D (16, 64, 128, 256, or the wide route) runs f.
template <typename F>
int dispatch(int D, F f) {
  int rc = (int)cudaErrorInvalidValue;
  flash::instance<16>(D, 0, f, &rc) || flash::instance<64>(D, 16, f, &rc) ||
      flash::instance<128>(D, 64, f, &rc) || flash::instance<256>(D, 128, f, &rc) ||
      flash::wide(D, f, &rc);
  return rc;
}

}  // namespace

// C interface, bound with ctypes.  Every tensor is float32; D is the true
// head dim, D >= 1: 1 <= D <= 256 runs in the instance 16, 64, 128 or 256
// (the smallest at least D), D > 256 in the wide route (flash_wide.cuh); a
// build holds the one that -DFLASH_D names (0: the wide route),
// flash_common.cuh, in the copy route that -DFLASH_COPY names.
// `strides` holds four element strides (b, s, h, d) per operand (q, k,
// v[, dout[, o]]) and `launch` is the launch plan's (grid x, grid y,
// threads, dynamic shared-memory bytes, copy bytes); the wide route's is
// (grid x, grid y, grid z, threads, dynamic shared-memory bytes, copy
// bytes) (ops/flash_attention.launch_plan).  Each returns the cudaError_t
// of the launch (0 on success).
extern "C" {

int bf_flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int S,
                     int H, int D, const long long* strides, const int* launch, float scale,
                     int causal, void* stream) {
  return dispatch(D, [&](auto d) {
    constexpr int DM = decltype(d)::value;
    if constexpr (DM == flash::kWide)
      return wide::fwd<float, kVec>(q, k, v, o, lse, S, H, D, strides, launch, scale, causal,
                                    (cudaStream_t)stream);
    else
      return fwd<DM>(q, k, v, o, lse, S, H, D, strides, launch, scale, causal,
                     (cudaStream_t)stream);
  });
}

int bf_flash_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                    const void* o, const void* lse, const void* dlse, void* delta, void* dqo,
                    int S, int H, int D, const long long* strides, const int* launch,
                    float scale, int causal, void* stream) {
  return dispatch(D, [&](auto d) {
    constexpr int DM = decltype(d)::value;
    if constexpr (DM == flash::kWide)
      return wide::dq<float, kVec>(q, k, v, dout, o, lse, dlse, delta, dqo, S, H, D, strides,
                                   launch, scale, causal, (cudaStream_t)stream);
    else
      return dq<DM>(q, k, v, dout, o, lse, dlse, delta, dqo, S, H, D, strides, launch, scale,
                    causal, (cudaStream_t)stream);
  });
}

int bf_flash_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dko, void* dvo, int S, int H,
                     int D, const long long* strides, const int* launch, float scale,
                     int causal, void* stream) {
  return dispatch(D, [&](auto d) {
    constexpr int DM = decltype(d)::value;
    if constexpr (DM == flash::kWide)
      return wide::dkv<float, kVec>(q, k, v, dout, lse, delta, dko, dvo, S, H, D, strides,
                                    launch, scale, causal, (cudaStream_t)stream);
    else
      return dkv<DM>(q, k, v, dout, lse, delta, dko, dvo, S, H, D, strides, launch, scale,
                     causal, (cudaStream_t)stream);
  });
}

}  // extern "C"
