// Device code shared by the fused Swin block kernels for Hopper (sm_90a):
// swin_block_grouped.cu (K5, tiled forward), swin_block_fwd.cu (K1,
// training-patch forward), swin_block_pair_fwd.cu (K3, a block pair's
// forward) and the backward kernels swin_block_bwd.cu (K2) and
// swin_block_pair_bwd.cu (K4), whose window passes recompute the
// forward with this code.
//
// The unit of work is one 64-token window per CTA. Products are
// warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate). In bf16 the
// block body is staged: global operands (weights, x rows, the bias
// slices) stream through a cp.async ring (gemm64_staged) or are copied
// to shared memory by cp.async, and fragments come through ldmatrix;
// the forward kernels run it with 16 warps per window, the backward's
// recompute with 8. The f32 instantiation (the non-amp path and the
// checks) reads its operands straight from shared or global memory and
// runs plain FMA loops with 8 warps and the same fragment ownership.
// Every warp mapping keeps each output element's k16 order, so the
// staged and unstaged bf16 bodies give the same bits. Awkward widths are
// zero-padded by
// the wrappers' weight layouts (K = C -> multiple of 16, hd 30 -> 32,
// MLP hidden -> multiple of 16, output columns -> multiple of 8) and the
// kernels zero the matching activation columns, so every pad adds exact
// zeros.
//
// Rounding points follow srcaco2_tpu/ops/pallas/swin_block.py
// (_block_fwd_math, _cast_wb) with the f32 softmax: LN f32 -> T; qkv
// (f32 acc) -> T, + T bias -> T; scores f32 + f32 bias; f32 max/exp/sum;
// e -> T for P.V, times f32 1/r -> T; proj (f32 acc) + f32 bias -> f32
// residual; LN2 f32 -> T; fc1 (f32 acc) -> T, + T bias -> T; tanh-GELU in
// T (every op rounded to T); fc2 (f32 acc) + f32 bias -> f32 residual ->
// stored in T (or kept in f32 where a pair's block A feeds block B).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace swin {

constexpr int WS = 8;             // window side
constexpr int NW = WS * WS;       // tokens per window (one CTA)
constexpr int THREADS = 256;      // 8 warps
constexpr int NB = 4;             // n8 tiles per warp pass
constexpr float LN_EPS = 1e-5f;
constexpr float GELU_C = 0.7978845608028654f;   // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;
constexpr float GELU_A3 = 0.134145f;            // 3 * GELU_A

using bf16 = __nv_bfloat16;

// Threads per CTA of the forward kernels (K1, K3, K5): 16 warps over the
// staged bf16 body, 8 over the f32 one.
template <typename T>
constexpr int kFwdThreads = std::is_same_v<T, bf16> ? 2 * THREADS : THREADS;

__host__ __device__ inline int ceil_to(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

struct Dims {
  int c, heads, hd, ch;   // model widths
  int hp;                 // head width padded to 16 (K of Q.K^T)
  int ck;                 // C padded to 16 (K of qkv and fc1)
  int cn;                 // C padded to 8 (N of proj and fc2)
  int chp;                // MLP hidden width padded to 16
  int ca;                 // attention width heads * hp
};

__host__ __device__ inline Dims make_dims(int c, int heads, int ch) {
  Dims d;
  d.c = c;
  d.heads = heads;
  d.hd = c / heads;
  d.ch = ch;
  d.hp = ceil_to(d.hd, 16);
  d.ck = ceil_to(c, 16);
  d.cn = ceil_to(c, 8);
  d.chp = ceil_to(ch, 16);
  d.ca = d.heads * d.hp;
  return d;
}

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ inline T from_f32(float v);
template <> __device__ inline float from_f32<float>(float v) { return v; }
template <> __device__ inline bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// Round an f32 value to T and back: the rounding point of an op in T.
template <typename T> __device__ inline float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ inline uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The bf16 pair (r, k), (r, k + 1) of an operand as one mma register:
// row-major (element (r, k) at p[r * ld + k]) or, with kT, stored
// transposed (element (r, k) at p[k * ld + r]).
template <bool kT>
__device__ inline uint32_t ldpair(const bf16* p, int ld, int r, int k) {
  if constexpr (!kT) {
    return ld32(p + r * ld + k);
  } else {
    const uint32_t lo = __bfloat16_as_ushort(p[k * ld + r]);
    const uint32_t hi = __bfloat16_as_ushort(p[(k + 1) * ld + r]);
    return lo | (hi << 16);
  }
}

// Asynchronous 16-byte copy global -> shared (cp.async, L2 only); with
// `valid` false the 16 bytes are zero-filled and nothing is read.
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// Asynchronous 4-byte copy global -> shared (cp.async through L1).
__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N> __device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; r[i] is this lane's fragment of matrix i,
// as stored or, with kTrans, transposed.
template <bool kTrans>
__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// Two 8x8 b16 matrices (lanes 0-15 give the row addresses) into r[0],
// r[1].
template <bool kTrans>
__device__ inline void ldsm_x2(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1]) : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

__device__ inline void mma_bf16(float (&acc)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The mma A fragment of rows r0..r0+15, columns k..k+15 of a bf16
// operand in shared memory, row-major or (kT) stored transposed (element
// (r, k) at A[k * ld + r]). Rows must start on 16 bytes.
template <bool kT>
__device__ inline void ldsm_a(uint32_t (&a)[4], const bf16* A, int ld,
                              int r0, int k, int lane) {
  const int q = lane >> 3, i = lane & 7;
  if constexpr (!kT)
    ldsm_x4<false>(a, A + (r0 + i + ((q & 1) << 3)) * ld + k +
                          ((q >> 1) << 3));
  else
    ldsm_x4<true>(a, A + (k + i + ((q >> 1) << 3)) * ld + r0 +
                         ((q & 1) << 3));
}

// The mma B fragments of the two n8 tiles n0..n0+15 at k..k+15 of Bt
// ([N][K] row-major, or kT stored transposed): b[0], b[1] of the first
// tile, b[2], b[3] of the second.
template <bool kT>
__device__ inline void ldsm_b(uint32_t (&b)[4], const bf16* Bt, int ld,
                              int n0, int k, int lane) {
  const int q = lane >> 3, i = lane & 7;
  if constexpr (!kT)
    ldsm_x4<false>(b, Bt + (n0 + i + ((q >> 1) << 3)) * ld + k +
                          ((q & 1) << 3));
  else
    ldsm_x4<true>(b, Bt + (k + i + ((q & 1) << 3)) * ld + n0 +
                         ((q >> 1) << 3));
}

// The same for the one n8 tile n0..n0+7 (b[0], b[1]).
template <bool kT>
__device__ inline void ldsm_b1(uint32_t (&b)[4], const bf16* Bt, int ld,
                               int n0, int k, int lane) {
  const int q = (lane >> 3) & 1, i = lane & 7;
  if constexpr (!kT)
    ldsm_x2<false>(b, Bt + (n0 + i) * ld + k + (q << 3));
  else
    ldsm_x2<true>(b, Bt + (k + i + (q << 3)) * ld + n0);
}

// acc[j] += a . (tile j of b01 | b23) for the j < nvalid n8 tiles of a
// warp pass of N8 (1, 2 or 4) tiles; b23 is loaded by the caller only
// when nvalid > 2, b01[2..3] only when nvalid > 1.
template <int N8>
__device__ inline void mma_tiles(float (&acc)[N8][4], const uint32_t (&a)[4],
                                 const uint32_t (&b01)[4],
                                 const uint32_t (&b23)[4], int nvalid) {
  static_assert(N8 == 1 || N8 == 2 || N8 == 4, "1, 2 or 4 n8 tiles");
  mma_bf16(acc[0], a, b01[0], b01[1]);
  if constexpr (N8 > 1)
    if (nvalid > 1) mma_bf16(acc[1], a, b01[2], b01[3]);
  if constexpr (N8 > 2) {
    if (nvalid > 2) mma_bf16(acc[2], a, b23[0], b23[1]);
    if (nvalid > 3) mma_bf16(acc[3], a, b23[2], b23[3]);
  }
}

template <bool kT>
__device__ inline float elem(const float* p, int ld, int r, int k) {
  return kT ? p[k * ld + r] : p[r * ld + k];
}

// acc[j] += A[16 rows][K] * Bt[8 rows of tile j][K]^T for the j < nvalid
// n8 tiles. A and Bt point at the first row of the block (row-major) or
// its first column (transposed). Fragment ownership of mma.m16n8k16:
// g = lane / 4 owns rows g and g + 8, t = lane % 4 owns columns 2t,
// 2t + 1 of each n8 tile.
template <bool kTA, bool kTB>
__device__ inline void mma_rows(float (&acc)[NB][4], const bf16* A, int lda,
                                const bf16* Bt, int ldb, int K, int nvalid,
                                int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a0 = ldpair<kTA>(A, lda, g, k0 + 2 * t);
    const uint32_t a1 = ldpair<kTA>(A, lda, g + 8, k0 + 2 * t);
    const uint32_t a2 = ldpair<kTA>(A, lda, g, k0 + 2 * t + 8);
    const uint32_t a3 = ldpair<kTA>(A, lda, g + 8, k0 + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nvalid) {
        const uint32_t b0 = ldpair<kTB>(Bt, ldb, 8 * j + g, k0 + 2 * t);
        const uint32_t b1 = ldpair<kTB>(Bt, ldb, 8 * j + g, k0 + 2 * t + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
              "+f"(acc[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
}

// f32 version with the same ownership, as plain FMA loops.
template <bool kTA, bool kTB>
__device__ inline void mma_rows(float (&acc)[NB][4], const float* A,
                                int lda, const float* Bt, int ldb, int K,
                                int nvalid, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float lo = elem<kTA>(A, lda, g, k);
    const float hi = elem<kTA>(A, lda, g + 8, k);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nvalid) {
        const float b0 = elem<kTB>(Bt, ldb, 8 * j + 2 * t, k);
        const float b1 = elem<kTB>(Bt, ldb, 8 * j + 2 * t + 1, k);
        acc[j][0] = fmaf(lo, b0, acc[j][0]);
        acc[j][1] = fmaf(lo, b1, acc[j][1]);
        acc[j][2] = fmaf(hi, b0, acc[j][2]);
        acc[j][3] = fmaf(hi, b1, acc[j][3]);
      }
    }
  }
}

template <bool kT, typename T>
__device__ inline const T* row_block(const T* p, int ld, int r0) {
  return kT ? p + r0 : p + static_cast<size_t>(r0) * ld;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A warp's finished block of C (rows r0..r0+15, the j < nvalid n8
// tiles from column n0), handed to epi(row, col, v0, v1) for each column
// pair (col, col + 1).
template <int N8, typename Epi>
__device__ inline void epi_pairs(const float (&acc)[N8][4], int r0, int n0,
                                 int nvalid, int lane, Epi& epi) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    if (j < nvalid) {
      const int col = n0 + 8 * j + 2 * t;
      epi(r0 + g, col, acc[j][0], acc[j][1]);
      epi(r0 + g + 8, col, acc[j][2], acc[j][3]);
    }
  }
}

// The same, with an epilogue that returns a float2 (values at (row, col)
// and (row, col + 1)) to be summed per column over the warp's 16 rows:
// the sums land in cs[rb * ldcs + col] for row block rb = r0 / 16, in a
// fixed order (deterministic).
template <typename Epi>
__device__ inline void epi_colsum(const float (&acc)[NB][4], int r0, int n0,
                                  int nvalid, int lane, Epi& epi, float* cs,
                                  int ldcs) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < nvalid) {
      const int col = n0 + 8 * j + 2 * t;
      const float2 lo = epi(r0 + g, col, acc[j][0], acc[j][1]);
      const float2 hi = epi(r0 + g + 8, col, acc[j][2], acc[j][3]);
      float s0 = lo.x + hi.x, s1 = lo.y + hi.y;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (g == 0) {
        cs[(r0 / 16) * ldcs + col] = s0;
        cs[(r0 / 16) * ldcs + col + 1] = s1;
      }
    }
  }
}

// C[64][N] = A[64][K] . Bt[N][K]^T, handed to epi(row, col, v0, v1) for
// the column pair (col, col + 1). N is a multiple of 8 and K of 16. Warp
// w takes row block w % 4 and every other group of NB n8 tiles. kTA /
// kTB read A / Bt stored transposed (see ldpair).
template <typename T, bool kTA = false, bool kTB = false, typename Epi>
__device__ inline void gemm64(const T* A, int lda, const T* Bt, int ldb,
                              int K, int N, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16;
  for (int n0 = (warp >> 2) * 8 * NB; n0 < N; n0 += 2 * 8 * NB) {
    float acc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int nvalid = min(NB, (N - n0) / 8);
    mma_rows<kTA, kTB>(acc, row_block<kTA>(A, lda, r0), lda,
                       row_block<kTB>(Bt, ldb, n0), ldb, K, nvalid, lane);
    epi_pairs(acc, r0, n0, nvalid, lane, epi);
  }
}

// gemm64 whose epilogue returns a float2 summed per column over each
// warp's 16 rows (see epi_colsum).
template <typename T, typename Epi>
__device__ inline void gemm64_colsum(const T* A, int lda, const T* Bt,
                                     int ldb, int K, int N, Epi epi,
                                     float* cs, int ldcs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16;
  for (int n0 = (warp >> 2) * 8 * NB; n0 < N; n0 += 2 * 8 * NB) {
    float acc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int nvalid = min(NB, (N - n0) / 8);
    mma_rows<false, false>(acc, A + r0 * lda, lda, Bt + n0 * ldb, ldb, K,
                           nvalid, lane);
    epi_colsum(acc, r0, n0, nvalid, lane, epi, cs, ldcs);
  }
}

// gemm64 in bf16 with both operands in shared memory, fragments through
// ldmatrix (kTA / kTB: stored transposed, through ldmatrix.trans), over
// NT threads: warp w takes row block w % 4 and every (NT / 128)-th group
// of N8 n8 tiles (NT = 256, N8 = 4: gemm64's map). Each output element
// sums K in gemm64's k16 order, so the same result bit for bit. Rows
// start on 16 bytes; N is a multiple of 16 (of 8 with N8 = 1).
template <bool kTA, bool kTB, int NT = THREADS, int N8 = NB, typename Epi>
__device__ inline void gemm64_ldsm(const bf16* A, int lda, const bf16* Bt,
                                   int ldb, int K, int N, Epi epi) {
  constexpr int kGroups = NT / 128;   // warps per row block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16;
  for (int n0 = (warp >> 2) * 8 * N8; n0 < N; n0 += kGroups * 8 * N8) {
    float acc[N8][4];
#pragma unroll
    for (int j = 0; j < N8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int nvalid = min(N8, (N - n0) / 8);
    for (int k = 0; k < K; k += 16) {
      uint32_t a[4], b01[4], b23[4];
      ldsm_a<kTA>(a, A, lda, r0, k, lane);
      if constexpr (N8 == 1) ldsm_b1<kTB>(b01, Bt, ldb, n0, k, lane);
      else ldsm_b<kTB>(b01, Bt, ldb, n0, k, lane);
      if constexpr (N8 > 2)
        if (nvalid > 2) ldsm_b<kTB>(b23, Bt, ldb, n0 + 16, k, lane);
      mma_tiles(acc, a, b01, b23, nvalid);
    }
    epi_pairs(acc, r0, n0, nvalid, lane, epi);
  }
}

// The ring of gemm64_staged: RING_SLICES slices of 64 rows x 64 bf16
// columns at a 144-byte row stride (ldmatrix rows on distinct banks).
constexpr int LDR = 64 + 8;
constexpr int RING_SLICES = 8;
constexpr size_t RING_BYTES = RING_SLICES * 64 * LDR * sizeof(bf16);

// A bf16 product C[64][N] = A[64][K] . Bt[N][K]^T whose Bt (and, with
// kAG, A) lies in global memory: a weight, or workspace rows this CTA
// wrote before a barrier. The global operands stream through `ring` in
// slices of 64 rows of Bt (columns of C) by 64 of K, n-block after
// n-block, copied by cp.async (16 bytes, zero-filled past N and K) up to
// kStages - 1 stages ahead of the one that computes (8 stages of a Bt
// slice, or 4 of a Bt and an A slice); fragments come out of shared
// memory through ldmatrix. Over NT threads, warp w takes row block w % 4
// and the (w / 4)-th run of kN8 n8 tiles of each slice (8 warps: 4
// tiles, gemm64's block; 16 warps: 2); every output element sums K in
// gemm64's k16 order, so the result equals gemm64's bit for bit.
// tile_epi(acc, r0, n0, nvalid) takes a warp's finished block. A in
// shared memory (kAG false) has rows on 16 bytes; lda, ldb and K are
// multiples of 8, global rows start on 16 bytes. The call starts with a
// barrier (whatever the CTA read from the ring before is done); the
// caller synchronises the CTA after it.
template <bool kAG, int NT = THREADS, typename TileEpi>
__device__ inline void gemm64_staged(const bf16* A, int lda, const bf16* Bt,
                                     int ldb, int K, int N, bf16* ring,
                                     TileEpi tile_epi) {
  constexpr int kSlices = kAG ? 2 : 1;
  constexpr int kStages = RING_SLICES / kSlices;
  constexpr int kN8 = 8 * 128 / NT;     // n8 tiles per warp and slice
  constexpr int kPer = 512 / NT;        // 16-byte chunks per thread, slice
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16, nb = (warp >> 2) * 8 * kN8;
  const int nks = (K + 63) / 64, nst = nks * ((N + 63) / 64);
  // with kAG, the CTA's own workspace stores before this call are seen
  // by the copies' L2 reads
  if constexpr (kAG) __threadfence();
  __syncthreads();
  auto fill = [&](int st) {
    bf16* sb = ring + (st % kStages) * kSlices * 64 * LDR;
    const int n0 = st / nks * 64, k0 = st % nks * 64;
#pragma unroll
    for (int i = 0; i < kPer * kSlices; ++i) {   // 512 chunks per slice
      const int e = threadIdx.x + (i % kPer) * NT;
      const int row = e >> 3, col = (e & 7) * 8;
      const bool ok_k = k0 + col < K;
      if (i < kPer) {
        const bool ok = ok_k && n0 + row < N;
        cp_async16(sb + row * LDR + col,
                   Bt + (ok ? (n0 + row) * ldb + k0 + col : 0), ok);
      } else {
        cp_async16(sb + (64 + row) * LDR + col,
                   A + (ok_k ? row * lda + k0 + col : 0), ok_k);
      }
    }
  };
  float acc[kN8][4];
#pragma unroll
  for (int j = 0; j < kN8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) fill(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();    // stage st landed; stage st - 1's slot is free
    if (st + kStages - 1 < nst) fill(st + kStages - 1);
    cp_async_commit();
    const bf16* sb = ring + (st % kStages) * kSlices * 64 * LDR;
    const int n0 = st / nks * 64, k0 = st % nks * 64;
    const int nvalid = min(kN8, (N - n0 - nb) / 8);
    if (nvalid <= 0) continue;
    const int kw = min(64, K - k0);
    for (int kk = 0; kk < kw; kk += 16) {
      uint32_t a[4], b01[4], b23[4];
      if constexpr (kAG) ldsm_a<false>(a, sb + 64 * LDR, LDR, r0, kk, lane);
      else ldsm_a<false>(a, A, lda, r0, k0 + kk, lane);
      ldsm_b<false>(b01, sb, LDR, nb, kk, lane);
      if constexpr (kN8 > 2)
        if (nvalid > 2) ldsm_b<false>(b23, sb, LDR, nb + 16, kk, lane);
      mma_tiles(acc, a, b01, b23, nvalid);
    }
    if (k0 + 64 >= K) {
      tile_epi(acc, r0, n0 + nb, nvalid);
#pragma unroll
      for (int j = 0; j < kN8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
  }
  cp_async_wait<0>();
}

// gemm64 / gemm64_colsum through gemm64_staged.
template <bool kAG, int NT = THREADS, typename Epi>
__device__ inline void gemm64_st(const bf16* A, int lda, const bf16* Bt,
                                 int ldb, int K, int N, bf16* ring,
                                 Epi epi) {
  const int lane = threadIdx.x & 31;
  gemm64_staged<kAG, NT>(A, lda, Bt, ldb, K, N, ring,
                         [&](const auto& acc, int r0, int n0, int nvalid) {
                           epi_pairs(acc, r0, n0, nvalid, lane, epi);
                         });
}

template <typename Epi>
__device__ inline void gemm64_colsum_st(const bf16* A, int lda,
                                        const bf16* Bt, int ldb, int K,
                                        int N, bf16* ring, Epi epi,
                                        float* cs, int ldcs) {
  const int lane = threadIdx.x & 31;
  gemm64_staged<false>(A, lda, Bt, ldb, K, N, ring,
                       [&](const float (&acc)[NB][4], int r0, int n0,
                           int nvalid) {
                         epi_colsum(acc, r0, n0, nvalid, lane, epi, cs,
                                    ldcs);
                       });
}

// LayerNorm of the f32 rows of X into Y (T), zeroing the pad columns
// [c, ck) that the next product reads; the row mean and 1/std go to
// mu / rstd when given. One warp per row (NT threads).
template <typename T, int NT = THREADS>
__device__ inline void layer_norm(const float* X, int ldx, const float* gam,
                                  const float* bet, T* Y, int ldy,
                                  const Dims& d, float* mu_out = nullptr,
                                  float* rstd_out = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < NW; r += NT / 32) {
    const float* xr = X + r * ldx;
    float s = 0.f;
    for (int i = lane; i < d.c; i += 32) s += xr[i];
    const float mu = warp_sum(s) / d.c;
    float v = 0.f;
    for (int i = lane; i < d.c; i += 32) {
      const float xc = xr[i] - mu;
      v += xc * xc;
    }
    const float rstd = rsqrtf(warp_sum(v) / d.c + LN_EPS);
    for (int i = lane; i < d.ck; i += 32)
      Y[r * ldy + i] = from_f32<T>(
          i < d.c ? (xr[i] - mu) * rstd * gam[i] + bet[i] : 0.f);
    if (lane == 0 && mu_out) {
      mu_out[r] = mu;
      rstd_out[r] = rstd;
    }
  }
}

// The tanh term of the tanh-GELU with every op rounded to T (the JAX
// path computes it in the compute dtype, constants included).
template <typename T> __device__ inline float gelu_tanh(float u) {
  const float ga = rnd<T>(GELU_A), gc = rnd<T>(GELU_C);
  float z = rnd<T>(ga * u);
  z = rnd<T>(z * u);
  z = rnd<T>(z * u);
  z = rnd<T>(u + z);
  z = rnd<T>(gc * z);
  return rnd<T>(tanhf(z));
}

// gelu(u) from its tanh term th = gelu_tanh<T>(u).
template <typename T> __device__ inline float gelu_th(float u, float th) {
  return rnd<T>(rnd<T>(0.5f * u) * rnd<T>(1.f + th));
}

template <typename T> __device__ inline float gelu(float u) {
  return gelu_th<T>(u, gelu_tanh<T>(u));
}

// d gelu / du in T from th = gelu_tanh<T>(u), in the order of
// swin_block.py:_gelu_grad: 0.5 (1 + th) + 0.5 u sech2 c (1 + 3a u u).
template <typename T> __device__ inline float gelu_grad_th(float u,
                                                           float th) {
  const float gc = rnd<T>(GELU_C), ga3 = rnd<T>(GELU_A3);
  const float sech2 = rnd<T>(1.f - rnd<T>(th * th));
  const float t1 = rnd<T>(0.5f * rnd<T>(1.f + th));
  float t2 = rnd<T>(0.5f * u);
  t2 = rnd<T>(t2 * sech2);
  t2 = rnd<T>(t2 * gc);
  float w = rnd<T>(ga3 * u);
  w = rnd<T>(w * u);
  w = rnd<T>(1.f + w);
  t2 = rnd<T>(t2 * w);
  return rnd<T>(t1 + t2);
}

template <typename T> __device__ inline float gelu_grad(float u) {
  return gelu_grad_th<T>(u, gelu_tanh<T>(u));
}

// Block weights in the forward kernels' layout (ops/swin_block.py:
// PackedBlock): products `act @ W^T` with W stored (N, K) row-major.
struct FwdWeights {
  const float* g1;
  const float* b1;
  const void* wqkv;           // (heads, 3, hp, ck) T, q pre-scaled
  const void* bqkv;           // (heads, 3, hp) T
  const void* wproj;          // (cn, heads * hp) T
  const float* bproj;
  const float* g2;
  const float* b2;
  const void* w1;             // (chp, ck) T
  const void* bm1;            // (chp,) T
  const void* w2;             // (cn, chp) T
  const float* bm2;
};

// Takes the 12 weight pointers in PackedBlock order.
inline FwdWeights fwd_weights(const void* const* p) {
  return FwdWeights{static_cast<const float*>(p[0]),
                    static_cast<const float*>(p[1]), p[2], p[3], p[4],
                    static_cast<const float*>(p[5]),
                    static_cast<const float*>(p[6]),
                    static_cast<const float*>(p[7]), p[8], p[9], p[10],
                    static_cast<const float*>(p[11])};
}

// Shared-memory buffers of the block forward. Row strides carry 8
// spare elements (4 for f32 scores) so the 8 fragment rows of a warp
// fall on distinct banks.
template <typename T>
struct FwdSmem {
  float* X;    // [64][ldx] f32 residual rows
  T* Y;        // [64][ldy] LN output (ck columns)
  T* O;        // [64][ldo] attention output (heads * hp columns)
  T* Q;        // [64][ldq] one head's q
  T* K;        // [64][ldq] one head's k
  T* Vt;       // [hp][ldvt] one head's v, transposed
  float* S;    // [64][lds] scores
  T* P;        // [64][ldp] exp(s - max) in T
  float* rinv; // [64]
  T* H;        // [64][ldh] MLP hidden activations (forward kernels only)
  int ldx, ldy, ldo, ldq, ldvt, lds, ldp, ldh;
};

// The small weight vectors the staged body reads in its epilogues and
// LayerNorms, copied to shared memory (bf16): g1, b1, g2, b2, bproj (f32,
// c each), bqkv (T, 3 ca), bm1 (T, chp).
__host__ __device__ inline size_t vec_bytes(const Dims& d) {
  return sizeof(float) * 5 * d.c + sizeof(bf16) * (3 * d.ca + d.chp);
}

// The forward kernels' layout: H reuses the attention buffers. The
// staged (bf16) body adds the window's token table, the weight vectors
// and the ring of the staged products.
struct FwdLayout {
  size_t x, y, o, q, k, vt, s, p, rinv, h, tok, vec, ring, total;
};

template <typename T>
__host__ __device__ inline void fwd_strides(const Dims& d, int* ld) {
  ld[0] = d.c;            // ldx
  ld[1] = d.ck + 8;       // ldy
  ld[2] = d.ca + 8;       // ldo
  ld[3] = d.hp + 8;       // ldq
  ld[4] = NW + 8;         // ldvt
  ld[5] = NW + 4;         // lds
  ld[6] = NW + 8;         // ldp
  ld[7] = d.chp + 8;      // ldh
}

template <typename T>
__host__ __device__ inline FwdLayout make_fwd_layout(const Dims& d,
                                                     bool staged = false) {
  int ld[8];
  fwd_strides<T>(d, ld);
  FwdLayout L;
  size_t off = 0;
  L.x = off;    off = align16(off + sizeof(float) * NW * ld[0]);
  L.y = off;    off = align16(off + sizeof(T) * NW * ld[1]);
  L.o = off;    off = align16(off + sizeof(T) * NW * ld[2]);
  L.q = off;    off = align16(off + sizeof(T) * NW * ld[3]);
  L.k = off;    off = align16(off + sizeof(T) * NW * ld[3]);
  L.vt = off;   off = align16(off + sizeof(T) * d.hp * ld[4]);
  L.s = off;    off = align16(off + sizeof(float) * NW * ld[5]);
  L.p = off;    off = align16(off + sizeof(T) * NW * ld[6]);
  L.rinv = off; off = align16(off + sizeof(float) * NW);
  L.h = L.o;
  const size_t h_end = align16(L.h + sizeof(T) * NW * ld[7]);
  L.total = off > h_end ? off : h_end;
  L.tok = L.vec = L.ring = L.total;
  if (staged) {
    L.vec = align16(L.tok + sizeof(int) * NW);
    L.ring = align16(L.vec + vec_bytes(d));
    L.total = L.ring + RING_BYTES;
  }
  return L;
}

// Whether the staged forward's ring holds the window's 64 input rows of
// XT (they are staged there before the first product).
template <typename XT>
__host__ __device__ inline bool fwd_ring_fits(const Dims& d) {
  return NW * d.c * sizeof(XT) <= RING_BYTES;
}

template <typename T>
__device__ inline FwdSmem<T> fwd_smem(unsigned char* smem, const Dims& d,
                                      const FwdLayout& L) {
  int ld[8];
  fwd_strides<T>(d, ld);
  FwdSmem<T> s;
  s.X = reinterpret_cast<float*>(smem + L.x);
  s.Y = reinterpret_cast<T*>(smem + L.y);
  s.O = reinterpret_cast<T*>(smem + L.o);
  s.Q = reinterpret_cast<T*>(smem + L.q);
  s.K = reinterpret_cast<T*>(smem + L.k);
  s.Vt = reinterpret_cast<T*>(smem + L.vt);
  s.S = reinterpret_cast<float*>(smem + L.s);
  s.P = reinterpret_cast<T*>(smem + L.p);
  s.rinv = reinterpret_cast<float*>(smem + L.rinv);
  s.H = reinterpret_cast<T*>(smem + L.h);
  s.ldx = ld[0]; s.ldy = ld[1]; s.ldo = ld[2]; s.ldq = ld[3];
  s.ldvt = ld[4]; s.lds = ld[5]; s.ldp = ld[6]; s.ldh = ld[7];
  return s;
}

// Copy the block's small weight vectors to vec (vec_bytes(d), see
// there) and return the weights with those pointers swapped in. Plain
// loads: the copies are read after the CTA's next barrier.
template <int NT = THREADS>
__device__ inline FwdWeights stage_vectors(const FwdWeights& w,
                                           const Dims& d, float* vec) {
  const int c = d.c;
  bf16* tv = reinterpret_cast<bf16*>(vec + 5 * c);
  const float* src[5] = {w.g1, w.b1, w.g2, w.b2, w.bproj};
  for (int i = threadIdx.x; i < 5 * c; i += NT)
    vec[i] = src[i / c][i % c];
  const bf16* bq = static_cast<const bf16*>(w.bqkv);
  const bf16* bm = static_cast<const bf16*>(w.bm1);
  for (int i = threadIdx.x; i < 3 * d.ca + d.chp; i += NT)
    tv[i] = i < 3 * d.ca ? bq[i] : bm[i - 3 * d.ca];
  FwdWeights v = w;
  v.g1 = vec;
  v.b1 = vec + c;
  v.g2 = vec + 2 * c;
  v.b2 = vec + 3 * c;
  v.bproj = vec + 4 * c;
  v.bqkv = tv;
  v.bm1 = tv + 3 * d.ca;
  return v;
}

// Per-token operands the backward's recompute writes to global memory,
// rows in window order (CTA * 64 + local row), pads zero; and what the
// staged (bf16) body reads, in the forward kernels too.
template <typename T>
struct Spill {
  T* y;      // [M][ck]    LN1 output
  T* qkv;    // [M][3 ca]  q|k|v blocks of (head, hp) columns
  T* o;      // [M][ca]    attention output
  T* y2;     // [M][ck]    LN2 output
  T* u;      // [M][chp]   fc1 output
  T* hact;   // [M][chp]   GELU(u)
  float* mu1; float* rstd1; float* mu2; float* rstd2;   // smem [64] each
  // bf16 only: gelu'(u) in T ([64][ldgg], shared memory, in place of u),
  // the staged products' ring, and what stage_rows and stage_bias read
  T* gg;
  int ldgg;
  T* ring;
  const float* bias;   // (heads, t, t)
  const int* tok;      // smem [64]: the window's raster tokens
  int t;
  size_t row0;         // the patch's first raster row
};

// A staged forward's window: its raster tokens tok_of(r) copied to the
// layout's token table, and the Spill fields the staged body reads (the
// ring, the bias base (heads, t, t), the patch's first row). Ends with a
// barrier of the CTA.
template <typename T, typename TokOf>
__device__ inline Spill<T> fwd_stage(unsigned char* smem,
                                     const FwdLayout& L, TokOf tok_of,
                                     const float* bias, int t, size_t row0) {
  int* tok = reinterpret_cast<int*>(smem + L.tok);
  if (threadIdx.x < NW) tok[threadIdx.x] = tok_of(threadIdx.x);
  __syncthreads();
  Spill<T> sp{};
  sp.ring = reinterpret_cast<T*>(smem + L.ring);
  sp.bias = bias;
  sp.tok = tok;
  sp.t = t;
  sp.row0 = row0;
  return sp;
}

// Copy the window's 64 rows of c elements of src (raster rows row0 +
// tok[r]) to dst[r * c] in shared memory, 4 bytes per cp.async (rows
// start on 4 bytes: c is even), as one commit group.
template <int NT = THREADS, typename E>
__device__ inline void stage_rows(E* dst, const E* src, size_t row0,
                                  const int* tok, int c) {
  const int per = c * static_cast<int>(sizeof(E)) / 4;   // words per row
  char* d = reinterpret_cast<char*>(dst);
  for (int i = threadIdx.x; i < NW * per; i += NT) {
    const int r = i / per, w = i % per;
    cp_async4(d + (r * per + w) * 4,
              reinterpret_cast<const char*>(src + (row0 + tok[r]) * c) +
                  w * 4);
  }
  cp_async_commit();
}

// Copy head h's 64x64 slice of the (heads, t, t) bias, between the
// window's tokens tok[r] and tok[c], to dst[r * ld + c] with cp.async
// (one commit group): once per head instead of a gather per score.
template <int NT = THREADS>
__device__ inline void stage_bias(const float* bias, const int* tok, int t,
                                  int h, float* dst, int ld) {
  const float* bh = bias + static_cast<size_t>(h) * t * t;
  for (int i = threadIdx.x; i < NW * NW; i += NT) {
    const int r = i >> 6, c = i & 63;
    cp_async4(dst + r * ld + c, bh + static_cast<size_t>(tok[r]) * t + tok[c]);
  }
  cp_async_commit();
}

// Copy a [64][n] T block from shared memory to global rows.
template <typename T>
__device__ inline void store_rows(const T* src, int lds, T* dst, int ldd,
                                  int n) {
  for (int i = threadIdx.x; i < NW * n; i += THREADS) {
    const int r = i / n, cc = i % n;
    dst[static_cast<size_t>(r) * ldd + cc] = src[r * lds + cc];
  }
}

// Two adjacent output elements, each rounded to OT, as one store.
__device__ inline void store2(bf16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = from_f32<bf16>(a);
  v.y = from_f32<bf16>(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

__device__ inline void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The window's f32 rows X (c columns) to its raster rows row0 + tok[r]
// of out, rounded to OT, in column pairs (c is even).
template <int NT, typename OT>
__device__ inline void store_window(const float* X, int ldx, OT* out,
                                    size_t row0, const int* tok, int c) {
  const int half = c / 2;
  for (int i = threadIdx.x; i < NW * half; i += NT) {
    const int r = i / half, cc = 2 * (i % half);
    store2(out + (row0 + tok[r]) * c + cc, X[r * ldx + cc],
           X[r * ldx + cc + 1]);
  }
}

// One Swin block over the 64 tokens of this CTA's window, by NT
// threads. x_row(r) is the global row of local row r in x (and out);
// bias_at(h, r, c) the additive attention bias between local rows r and
// c for head h. Forward kernels (kRecompute false) write the block
// output to out. The backward's recompute (kRecompute true) skips fc2,
// keeps x2 in s.X, and writes the per-token operands and row statistics
// to sp.
// kStaged (bf16 only) runs the staged body: x's rows come through sp.ring
// (stage_rows), the weights stream through the ring (gemm64_staged),
// each head's bias slice is staged into the scores buffer (stage_bias)
// under the qkv product, the attention products take ldmatrix fragments,
// and (forward) fc2 adds the residual in place in s.X, whose rows then
// leave in column pairs through sp.tok (store_window); x_row and bias_at
// are not read. The unstaged body (f32, and the pair backward's forward
// phase) reads them from global memory, with 8 warps. Both give the
// same bits: every product keeps each output element's k16 order, each
// LayerNorm and softmax row is one warp's, and the staged bias is added
// once, as the unstaged epilogue adds it. With 16 warps (NT = 512) every
// product is split so that each warp owns a block of C: 2 n8 tiles per
// warp and ring slice, 2 of Q.K^T's 64 columns' tiles, 1 of P.V's.
// The residual input x (XT) and the output out (OT) are T or f32
// whatever the compute type T: the pair kernels feed block A's f32
// output, never rounded, to block B.
template <typename T, bool kRecompute, bool kStaged, int NT, typename XT,
          typename OT, typename RowOf, typename BiasAt>
__device__ inline void block_forward(const FwdWeights& wt, const Dims& d,
                                     const FwdSmem<T>& s, const XT* x,
                                     OT* out, RowOf x_row, BiasAt bias_at,
                                     const Spill<T>& sp) {
  static_assert(!kStaged || std::is_same_v<T, bf16>, "staged: bf16 only");
  static_assert(NT == THREADS || (kStaged && !kRecompute),
                "16 warps: the staged forward only");
  constexpr int kN8Qk = NT == THREADS ? NB : 2;   // n8 tiles: Q.K^T
  constexpr int kN8Pv = NT == THREADS ? NB : 1;   // and P.V
  const T* wqkv = static_cast<const T*>(wt.wqkv);
  const T* bqkv = static_cast<const T*>(wt.bqkv);
  const T* wproj = static_cast<const T*>(wt.wproj);
  const T* w1 = static_cast<const T*>(wt.w1);
  const T* bm1 = static_cast<const T*>(wt.bm1);
  const T* w2 = static_cast<const T*>(wt.w2);
  const int c = d.c, hp = d.hp;

  if constexpr (kStaged) {
    // x rows through the ring: no load chain per element
    const XT* xs = reinterpret_cast<const XT*>(sp.ring);
    stage_rows<NT>(reinterpret_cast<XT*>(sp.ring), x, sp.row0, sp.tok, c);
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < NW * c; i += NT)
      s.X[(i / c) * s.ldx + i % c] = to_f32(xs[i]);
  } else {
    for (int i = threadIdx.x; i < NW * c; i += NT) {
      const int r = i / c, cc = i % c;
      s.X[r * s.ldx + cc] = to_f32(x[x_row(r) * c + cc]);
    }
  }
  __syncthreads();
  layer_norm<T, NT>(s.X, s.ldx, wt.g1, wt.b1, s.Y, s.ldy, d,
                    kRecompute ? sp.mu1 : nullptr,
                    kRecompute ? sp.rstd1 : nullptr);
  __syncthreads();
  if constexpr (kRecompute) store_rows(s.Y, s.ldy, sp.y, d.ck, d.ck);

  for (int h = 0; h < d.heads; ++h) {
    const T* bq = bqkv + h * 3 * hp;
    const T* wq = wqkv + static_cast<size_t>(h) * 3 * hp * d.ck;
    auto qkv_epi = [&](int r, int col, float v0, float v1) {
      const float vs[2] = {v0, v1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = col + e;
        const T v = from_f32<T>(rnd<T>(vs[e]) + to_f32(bq[cc]));
        const int part = cc / hp, lane = cc % hp;
        if (part == 0) s.Q[r * s.ldq + lane] = v;
        else if (part == 1) s.K[r * s.ldq + lane] = v;
        else s.Vt[lane * s.ldvt + r] = v;
        if constexpr (kRecompute)
          sp.qkv[r * 3 * d.ca + (part * d.heads + h) * hp + lane] = v;
      }
    };
    if constexpr (kStaged) {
      stage_bias<NT>(sp.bias, sp.tok, sp.t, h, s.S, s.lds);
      gemm64_st<false, NT>(s.Y, s.ldy, wq, d.ck, d.ck, 3 * hp, sp.ring,
                           qkv_epi);
      __syncthreads();
      gemm64_ldsm<false, false, NT, kN8Qk>(
          s.Q, s.ldq, s.K, s.ldq, hp, NW,
          [&](int r, int col, float v0, float v1) {
            s.S[r * s.lds + col] += v0;
            s.S[r * s.lds + col + 1] += v1;
          });
    } else {
      gemm64<T>(s.Y, s.ldy, wq, d.ck, d.ck, 3 * hp, qkv_epi);
      __syncthreads();
      gemm64<T>(s.Q, s.ldq, s.K, s.ldq, hp, NW,
                [&](int r, int col, float v0, float v1) {
                  s.S[r * s.lds + col] = v0 + bias_at(h, r, col);
                  s.S[r * s.lds + col + 1] = v1 + bias_at(h, r, col + 1);
                });
    }
    __syncthreads();
    {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int r = warp; r < NW; r += NT / 32) {
        const float s0 = s.S[r * s.lds + lane];
        const float s1 = s.S[r * s.lds + lane + 32];
        const float m = warp_max(fmaxf(s0, s1));
        const float e0 = expf(s0 - m), e1 = expf(s1 - m);
        const float sum = warp_sum(e0 + e1);
        s.P[r * s.ldp + lane] = from_f32<T>(e0);
        s.P[r * s.ldp + lane + 32] = from_f32<T>(e1);
        if (lane == 0) s.rinv[r] = 1.f / sum;
      }
    }
    __syncthreads();
    auto pv_epi = [&](int r, int col, float v0, float v1) {
      s.O[r * s.ldo + h * hp + col] = from_f32<T>(v0 * s.rinv[r]);
      s.O[r * s.ldo + h * hp + col + 1] = from_f32<T>(v1 * s.rinv[r]);
    };
    if constexpr (kStaged)
      gemm64_ldsm<false, false, NT, kN8Pv>(s.P, s.ldp, s.Vt, s.ldvt, NW, hp,
                                           pv_epi);
    else
      gemm64<T>(s.P, s.ldp, s.Vt, s.ldvt, NW, hp, pv_epi);
    __syncthreads();
  }
  if constexpr (kRecompute) store_rows(s.O, s.ldo, sp.o, d.ca, d.ca);

  // x2 = x + (O . Wproj + bproj), in place in X
  auto proj_epi = [&](int r, int col, float v0, float v1) {
    if (col < c) s.X[r * s.ldx + col] += v0 + wt.bproj[col];
    if (col + 1 < c) s.X[r * s.ldx + col + 1] += v1 + wt.bproj[col + 1];
  };
  if constexpr (kStaged)
    gemm64_st<false, NT>(s.O, s.ldo, wproj, d.ca, d.ca, d.cn, sp.ring,
                         proj_epi);
  else
    gemm64<T>(s.O, s.ldo, wproj, d.ca, d.ca, d.cn, proj_epi);
  __syncthreads();
  layer_norm<T, NT>(s.X, s.ldx, wt.g2, wt.b2, s.Y, s.ldy, d,
                    kRecompute ? sp.mu2 : nullptr,
                    kRecompute ? sp.rstd2 : nullptr);
  __syncthreads();
  if constexpr (kRecompute) {
    store_rows(s.Y, s.ldy, sp.y2, d.ck, d.ck);
    // bf16: gelu'(u) goes to shared memory for the backward's dh
    // epilogue (exact in T); f32: u to the workspace
    auto fc1_epi = [&](int r, int col, float v0, float v1) {
      const float vs[2] = {v0, v1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float u = rnd<T>(rnd<T>(vs[e]) + to_f32(bm1[col + e]));
        if constexpr (kStaged) {
          const float th = gelu_tanh<T>(u);   // shared by both
          sp.gg[r * sp.ldgg + col + e] = from_f32<T>(gelu_grad_th<T>(u, th));
          sp.hact[r * d.chp + col + e] = from_f32<T>(gelu_th<T>(u, th));
        } else {
          sp.u[r * d.chp + col + e] = from_f32<T>(u);
          sp.hact[r * d.chp + col + e] = from_f32<T>(gelu<T>(u));
        }
      }
    };
    if constexpr (kStaged)
      gemm64_st<false>(s.Y, s.ldy, w1, d.ck, d.ck, d.chp, sp.ring, fc1_epi);
    else
      gemm64<T>(s.Y, s.ldy, w1, d.ck, d.ck, d.chp, fc1_epi);
    __syncthreads();
    return;
  } else {
    // h = GELU(y2 . W1 + bm1) -> H (T)
    auto gelu_epi = [&](int r, int col, float v0, float v1) {
      const float u0 = rnd<T>(rnd<T>(v0) + to_f32(bm1[col]));
      const float u1 = rnd<T>(rnd<T>(v1) + to_f32(bm1[col + 1]));
      s.H[r * s.ldh + col] = from_f32<T>(gelu<T>(u0));
      s.H[r * s.ldh + col + 1] = from_f32<T>(gelu<T>(u1));
    };
    if constexpr (kStaged)
      gemm64_st<false, NT>(s.Y, s.ldy, w1, d.ck, d.ck, d.chp, sp.ring,
                           gelu_epi);
    else
      gemm64<T>(s.Y, s.ldy, w1, d.ck, d.ck, d.chp, gelu_epi);
    __syncthreads();
    // out = x2 + (H . W2 + bm2)
    if constexpr (kStaged) {
      // in place in X (f32), then the rows leave in column pairs
      gemm64_st<false, NT>(s.H, s.ldh, w2, d.chp, d.chp, d.cn, sp.ring,
                           [&](int r, int col, float v0, float v1) {
                             float* xr = s.X + r * s.ldx;
                             if (col < c) xr[col] += v0 + wt.bm2[col];
                             if (col + 1 < c)
                               xr[col + 1] += v1 + wt.bm2[col + 1];
                           });
      __syncthreads();
      store_window<NT>(s.X, s.ldx, out, sp.row0, sp.tok, c);
    } else {
      gemm64<T>(s.H, s.ldh, w2, d.chp, d.chp, d.cn,
                [&](int r, int col, float v0, float v1) {
                  OT* orow = out + x_row(r) * c;
                  if (col < c)
                    orow[col] = from_f32<OT>(s.X[r * s.ldx + col] +
                                             (v0 + wt.bm2[col]));
                  if (col + 1 < c)
                    orow[col + 1] = from_f32<OT>(s.X[r * s.ldx + col + 1] +
                                                 (v1 + wt.bm2[col + 1]));
                });
    }
  }
}

// One block forward over every window of patch img (t tokens in raster
// order, windows read through the (t / 64, 64) index table idx) by the
// whole CTA (NT threads), one window after another: the pair kernels'
// unit, since a pair's second block needs all of the first one's output
// rows. L is the layout at smem (staged, with kStaged).
template <typename T, bool kStaged, int NT, typename XT, typename OT>
__device__ inline void patch_forward(const FwdWeights& w, const Dims& d,
                                     unsigned char* smem, const FwdLayout& L,
                                     const int* idx, const float* bias,
                                     int t, int img, const XT* x, OT* out) {
  const FwdSmem<T> s = fwd_smem<T>(smem, d, L);
  const size_t row0 = static_cast<size_t>(img) * t;
  const size_t tt = t;
  FwdWeights wv = w;
  if constexpr (kStaged)
    wv = stage_vectors<NT>(w, d, reinterpret_cast<float*>(smem + L.vec));
  for (int win = 0; win < t / NW; ++win) {
    const int* tok = idx + win * NW;
    Spill<T> sp{};
    if constexpr (kStaged)
      sp = fwd_stage<T>(smem, L, [&](int r) { return tok[r]; }, bias, t,
                        row0);
    block_forward<T, false, kStaged, NT>(
        wv, d, s, x, out, [&](int r) { return row0 + tok[r]; },
        [&](int h, int r, int c) {
          return bias[(h * tt + tok[r]) * tt + tok[c]];
        },
        sp);
    // the next window reuses shared memory; after the last one, every
    // output row of the patch is visible to the whole CTA
    __syncthreads();
  }
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename Kern>
inline cudaError_t allow_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace swin
