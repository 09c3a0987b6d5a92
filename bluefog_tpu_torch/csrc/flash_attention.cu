// Flash attention for Hopper (sm_90a): forward (K1), dq (K2) and dk/dv (K3).
//
// Replaces the three Pallas TPU kernels of bluefog_tpu/ops/flash_attention.py:
//   K1 bf_flash_fwd  <- _fwd_kernel  (launched by _fwd)
//   K2 bf_flash_dq   <- _dq_kernel   (with _bwd_tile)
//   K3 bf_flash_dkv  <- _dkv_kernel  (with _bwd_tile)
// Same function: scale 1/sqrt(D), mask value -1e30 (masked probabilities are
// exactly 0), f32 accumulation, O = acc / max(l, 1e-30), lse = m + log(l).
//
// Layout.  q, k, v and dO are read as (B, S, H, D) through their strides
// (unit stride along D), so the fused-QKV slices of the model need no fold
// transpose and no copy.  O, dq, dk and dv are written contiguous
// (B, S, H, D); lse and delta are f32 (B, H, S).
//
// Design.  The TPU walks a sequential grid dimension over K/V (or Q) blocks
// and carries the online-softmax state in VMEM scratch between grid steps.
// On Hopper blocks run in parallel and in no order, so each thread block
// owns one output tile and a loop inside the block walks the reduction
// tiles; the running state stays in registers.  One block = 4 warps; each
// warp owns 16 rows of the output tile and runs mma.sync m16n8k16
// (bf16 x bf16 -> f32) on fragments read from shared memory.  The
// probabilities and dS are re-packed from the accumulator layout straight
// into A fragments (no shared-memory round trip).  Causal tiles above the
// diagonal are never loaded; ragged S is masked (rows and keys >= S are
// zero-filled and their probabilities forced to 0), never refused.
//
// Bounds on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the main
// path's shape B=2, S=2048, H=16, D=128, causal (half the score matrix):
//   K1: 4*B*H*S*S*D/2 = 34.4 GFLOP -> 0.035 ms; 67 MB in/out -> 0.020 ms
//   K2: 6*B*H*S*S*D/2 = 51.5 GFLOP -> 0.052 ms; 84 MB in/out -> 0.025 ms
//   K3: 8*B*H*S*S*D/2 = 68.7 GFLOP -> 0.069 ms; 101 MB in/out -> 0.030 ms
// All three are bound by tensor-core operations, not bytes: each K/V (or
// Q/dO) tile is reused by 64 rows from shared memory.  This first version
// uses mma.sync with synchronous tile loads; wgmma, TMA and warp
// specialisation, which the full tensor-core rate needs, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;          // 4 warps
constexpr float kMask = -1e30f;        // the TPU kernels' _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive bf16 (even column) as one 32-bit register.
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from different rows: lo in bits 0-15, hi in bits 16-31.
__device__ __forceinline__ uint32_t pack_h(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16 cols, row-major) of a shared tile at
// (row0, col0); ld is the tile's row pitch in elements.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int row0, int col0, int g, int t) {
  const bf16* p = s + (row0 + g) * ld + col0 + 2 * t;
  a[0] = ld2(p);
  a[1] = ld2(p + 8 * ld);
  a[2] = ld2(p + 8);
  a[3] = ld2(p + 8 * ld + 8);
}

// B fragment (16 x 8, "col") whose column n is row (row0 + n) of a shared
// tile: B[kk][n] = tile[row0 + n][col0 + kk].  Used for X @ Y^T.
__device__ __forceinline__ void load_bt(uint32_t (&b)[2], const bf16* s, int ld,
                                        int row0, int col0, int g, int t) {
  const bf16* p = s + (row0 + g) * ld + col0 + 2 * t;
  b[0] = ld2(p);
  b[1] = ld2(p + 8);
}

// B fragment whose rows run along the tile's rows: B[kk][n] =
// tile[row0 + kk][col0 + n].  Used for P @ V-style products.
__device__ __forceinline__ void load_bn(uint32_t (&b)[2], const bf16* s, int ld,
                                        int row0, int col0, int g, int t) {
  const bf16* p = s + (row0 + 2 * t) * ld + col0 + g;
  b[0] = pack_h(p[0], p[ld]);
  b[1] = pack_h(p[8 * ld], p[9 * ld]);
}

// Copy rows [row0, row0 + ROWS) of a (S, D) slab with row stride `stride`
// into shared memory; rows >= S become zeros.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long stride,
                                          int row0, int S) {
  constexpr int LD = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(s + r * LD + c * 8) = v;
  }
}

// Store a warp's 16 x D f32 accumulator as bf16 rows of a contiguous
// (B, S, H, D) tensor; `base` points at (b, 0, h, 0).
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, int H, int S, int row0,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1, int g, int t) {
  const long long rs = (long long)H * D;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(base + r0 * rs + d) =
          pack_f(acc[n][0] * mul0, acc[n][1] * mul0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(base + r1 * rs + d) =
          pack_f(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

struct Strides {
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// K1: forward.  Grid (ceil(S/64), B*H); block = 64 query rows.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int S, Strides qs, Strides ks,
                 Strides vs, float scale_log2, int causal) {
  constexpr int BM = 64, BN = 64, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LD;
  bf16* sV = sK + BN * LD;

  // Heaviest causal tiles (the last q tiles) first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  load_tile<BM, D>(sQ, qb, qs.s, q0, S);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kMask, kMask};  // running max, log2 units
  float l[2] = {0.f, 0.f};      // per-thread partial row sums
  const int row[2] = {q0 + wrow + g, q0 + wrow + g + 8};

  const int kend = causal ? min(S, q0 + BM) : S;
  const int n_kt = (kend + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<BN, D>(sK, kb, ks.s, k0, S);
    load_tile<BN, D>(sV, vb, vs.s, k0, S);
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ, LD, wrow, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t bb[2];
        load_bt(bb, sK, LD, j * 8, kk * 16, g, t);
        mma16816(s[j], a, bb);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = col < S && (!causal || col <= row[e >> 1]);
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float corr0 = exp2f(m[0] - mx[0]), corr1 = exp2f(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    l[0] *= corr0;
    l[1] *= corr1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mx[0]);
      s[j][1] = exp2f(s[j][1] - mx[0]);
      s[j][2] = exp2f(s[j][2] - mx[1]);
      s[j][3] = exp2f(s[j][3] - mx[1]);
      l[0] += s[j][0] + s[j][1];
      l[1] += s[j][2] + s[j][3];
    }

    // acc += P @ V
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_f(s[2 * kk][0], s[2 * kk][1]),
                             pack_f(s[2 * kk][2], s[2 * kk][3]),
                             pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb[2];
        load_bn(bb, sV, LD, kk * 16, n * 8, g, t);
        mma16816(acc[n], a, bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  store_rows<D>(o + ((long long)b * S * H + h) * D, H, S, q0 + wrow, acc,
                1.f / l[0], 1.f / l[1], g, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < S) lse[(long long)bh * S + row[r]] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// K2: dq.  Grid (ceil(S/64), B*H); block = 64 query rows, loop over 64-key
// tiles up to the causal frontier.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int H, int S, Strides qs, Strides ks,
                Strides vs, Strides dos, float scale, float scale_log2, int causal) {
  constexpr int BM = 64, BN = 64, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BM * LD;
  bf16* sK = sdO + BM * LD;
  bf16* sV = sK + BN * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  load_tile<BM, D>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<BM, D>(sdO, dout + b * dos.b + h * dos.h, dos.s, q0, S);

  const int row[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < S;
    lse2[r] = in ? lse[(long long)bh * S + row[r]] * kLog2e : 0.f;
    dlt[r] = in ? delta[(long long)bh * S + row[r]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kend = causal ? min(S, q0 + BM) : S;
  const int n_kt = (kend + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<BN, D>(sK, kb, ks.s, k0, S);
    load_tile<BN, D>(sV, vb, vs.s, k0, S);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, sQ, LD, wrow, kk * 16, g, t);
      load_a(ado, sdO, LD, wrow, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t bk[2], bv[2];
        load_bt(bk, sK, LD, j * 8, kk * 16, g, t);
        load_bt(bv, sV, LD, j * 8, kk * 16, g, t);
        mma16816(s[j], aq, bk);    // S  = Q . K^T
        mma16816(dp[j], ado, bv);  // dP = dO . V^T
      }
    }
    // dS = P * (dP - delta) * scale, P = exp(S - lse); masked -> 0.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = col < S && row[r] < S && (!causal || col <= row[r]);
        const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - dlt[r]) * scale;
      }
    }
    // acc += dS @ K
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_f(s[2 * kk][0], s[2 * kk][1]),
                             pack_f(s[2 * kk][2], s[2 * kk][3]),
                             pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bb[2];
        load_bn(bb, sK, LD, kk * 16, n * 8, g, t);
        mma16816(acc[n], a, bb);
      }
    }
  }
  store_rows<D>(dq + ((long long)b * S * H + h) * D, H, S, q0 + wrow, acc,
                1.f, 1.f, g, t);
}

// ---------------------------------------------------------------------------
// K3: dk and dv.  Grid (ceil(S/64), B*H); block = 64 key rows, loop over
// 32-query tiles from the causal frontier to the end.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S,
                 Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                 float scale_log2, int causal) {
  constexpr int BN = 64, BQ = 32, LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;
  bf16* sdO = sQ + BQ * LD;
  float* sL = reinterpret_cast<float*>(sdO + BQ * LD);  // lse, log2 units
  float* sD = sL + BQ;                                  // delta

  const int kt = blockIdx.x;  // causal: the first key tiles carry the most work
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  load_tile<BN, D>(sK, k + b * ks.b + h * ks.h, ks.s, k0, S);
  load_tile<BN, D>(sV, v + b * vs.b + h * vs.h, vs.s, k0, S);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const int krow[2] = {k0 + wrow + g, k0 + wrow + g + 8};

  const int n_qt = (S + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<BQ, D>(sQ, qb, qs.s, q0, S);
    load_tile<BQ, D>(sdO, dob, dos.s, q0, S);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      sL[threadIdx.x] = r < S ? lse[(long long)bh * S + r] * kLog2e : 0.f;
      sD[threadIdx.x] = r < S ? delta[(long long)bh * S + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows = this warp's 16 keys.
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, sK, LD, wrow, kk * 16, g, t);
      load_a(av, sV, LD, wrow, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t bq[2], bdo[2];
        load_bt(bq, sQ, LD, j * 8, kk * 16, g, t);
        load_bt(bdo, sdO, LD, j * 8, kk * 16, g, t);
        mma16816(st[j], ak, bq);
        mma16816(dpt[j], av, bdo);
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qc = j * 8 + 2 * t + (e & 1);  // query within the tile
        const int qi = q0 + qc;
        const bool ok = qi < S && krow[r] < S && (!causal || krow[r] <= qi);
        const float p = ok ? exp2f(st[j][e] * scale_log2 - sL[qc]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sD[qc]) * scale;
      }
    }
    // dV += P^T @ dO ; dK += dS^T @ Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t ap[4] = {pack_f(st[2 * kk][0], st[2 * kk][1]),
                              pack_f(st[2 * kk][2], st[2 * kk][3]),
                              pack_f(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_f(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t ads[4] = {pack_f(dpt[2 * kk][0], dpt[2 * kk][1]),
                               pack_f(dpt[2 * kk][2], dpt[2 * kk][3]),
                               pack_f(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                               pack_f(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bdo[2], bq[2];
        load_bn(bdo, sdO, LD, kk * 16, n * 8, g, t);
        load_bn(bq, sQ, LD, kk * 16, n * 8, g, t);
        mma16816(acc_v[n], ap, bdo);
        mma16816(acc_k[n], ads, bq);
      }
    }
  }
  const long long off = ((long long)b * S * H + h) * D;
  store_rows<D>(dk + off, H, S, k0 + wrow, acc_k, 1.f, 1.f, g, t);
  store_rows<D>(dv + off, H, S, k0 + wrow, acc_v, 1.f, 1.f, g, t);
}

template <int D>
constexpr int fwd_smem() { return (64 + 64 + 64) * (D + 8) * 2; }
template <int D>
constexpr int dq_smem() { return (64 + 64 + 64 + 64) * (D + 8) * 2; }
template <int D>
constexpr int dkv_smem() { return (64 + 64 + 32 + 32) * (D + 8) * 2 + 2 * 32 * 4; }

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                int B, int S, int H, Strides qs, Strides ks, Strides vs,
                float scale, int causal, cudaStream_t st) {
  cudaError_t err = prepare(flash_fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid((S + 63) / 64, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, H, S,
      qs, ks, vs, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dqo, int B, int S, int H,
               Strides qs, Strides ks, Strides vs, Strides dos, float scale,
               int causal, cudaStream_t st) {
  cudaError_t err = prepare(flash_dq_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid((S + 63) / 64, B * H);
  flash_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dqo, H, S, qs, ks, vs, dos,
      scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dko, void* dvo, int B,
                int S, int H, Strides qs, Strides ks, Strides vs, Strides dos,
                float scale, int causal, cudaStream_t st) {
  cudaError_t err = prepare(flash_dkv_kernel<D>, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  dim3 grid((S + 63) / 64, B * H);
  flash_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dko, (bf16*)dvo, H, S, qs, ks,
      vs, dos, scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes.  Tensors are bf16 except lse/delta (f32);
// strides are in elements; D must be 64 or 128.  Each returns the
// cudaError_t of the launch (0 on success).
extern "C" {

int bf_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                 int B, int S, int H, int D, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh, float scale,
                 int causal, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return fwd<128>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, causal, st);
  if (D == 64) return fwd<64>(q, k, v, o, lse, B, S, H, qs, ks, vs, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int bf_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dqo, int B, int S, int H,
                int D, long long qsb, long long qss, long long qsh, long long ksb,
                long long kss, long long ksh, long long vsb, long long vss,
                long long vsh, long long dsb, long long dss, long long dsh,
                float scale, int causal, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dsb, dss, dsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return dq<128>(q, k, v, dout, lse, delta, dqo, B, S, H, qs, ks, vs, dos, scale, causal, st);
  if (D == 64)
    return dq<64>(q, k, v, dout, lse, delta, dqo, B, S, H, qs, ks, vs, dos, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int bf_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dko, void* dvo, int B,
                 int S, int H, int D, long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh, long long vsb,
                 long long vss, long long vsh, long long dsb, long long dss,
                 long long dsh, float scale, int causal, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dsb, dss, dsh};
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return dkv<128>(q, k, v, dout, lse, delta, dko, dvo, B, S, H, qs, ks, vs, dos, scale,
                    causal, st);
  if (D == 64)
    return dkv<64>(q, k, v, dout, lse, delta, dko, dvo, B, S, H, qs, ks, vs, dos, scale,
                   causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
