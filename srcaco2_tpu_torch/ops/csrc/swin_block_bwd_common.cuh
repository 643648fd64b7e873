// The fused Swin block backward's machinery, shared by swin_block_bwd.cu
// (K2, one block per call) and swin_block_pair_bwd.cu (K4, a block pair
// per call): the backward of one block over one 64-token window, the
// deterministic reduction pass and the workspace plan. Design notes are
// in swin_block_bwd.cu.
//
// Two rounding sets (kPair):
//  * false, _bwd_kernel's heads-batched branch (swin_block.py:460-527)
//    with the f32 softmax: p = e * T(1/r); dp rounded to T; rs rounded
//    to T; ds = p * T(dp - T(rs));
//  * true, _block_bwd_math (swin_block.py:583-628), which the pair
//    kernel runs: p = e * (1/r), dp, rs and ds all in f32.
// In both, du, dx2, do and the dq|dk|dv blocks round to T, ds rounds to
// T only as an operand of the dq / dk products, and every weight grad is
// f32. One departure from JAX in both: dbqkv sums the T-rounded dqkv in
// f32, where JAX rounds each partial sum to T.
#pragma once

#include <type_traits>

#include "swin_block_common.cuh"

namespace swin {

constexpr int KS = 32;             // token rows per staging step (f32)
constexpr int LDT = KS + 8;        // staged tile stride (f32)
constexpr int RS = 64;             // token rows per pipeline stage (bf16)
constexpr int NSTAGE = 4;          // pipeline stages (bf16)
constexpr int SPLIT_ROWS = 2048;   // token rows per split of a tile
constexpr int CS_ROWS = 256;       // column-sum partial rows per chunk
constexpr int N_CS = 7;            // column-sum outputs
constexpr int N_OUT = 13;          // f32 outputs of one block's backward
constexpr int MAX_BLOCKS = 2;      // blocks per call (K4: a pair)

// One weight product of the reduction: out[k][n] = sum_m A[m][k] B[m][n]
// over every token m, for k < kp, n < np; with `ones`, row kp of A is
// taken as ones and its row of out (the column sums of B) goes to bout.
struct Prod {
  const void* a;
  const void* b;
  float* out;
  float* bout;
  int lda, ldb, kp, np, ones;
  int tn, first, tiles;   // tiles along n, first tile id, tile count
};

// One block's backward: inputs, workspace and outputs. x, g and dx are
// (n_img, t, c) raster rows, each in T or f32 (the kernel's template
// arguments say which).
struct BlockBwd {
  const void* x;              // residual input
  const void* g;              // incoming grad of the block output
  void* dx;                   // grad of x
  const int* idx;             // (nwin, 64) raster token of each local row
  const float* bias;          // (heads, t, t)
  FwdWeights w;
  const void* wqkv_t;         // (cn, 3 ca) T, q pre-scaled
  const void* wproj_t;        // (ca, ck) T
  const void* w1_t;           // (cn, chp) T
  const void* w2_t;           // (chp, ck) T
  // workspace: per-token operands (T), rows in window order
  void* y; void* qkv; void* o; void* y2; void* u; void* hact;
  void* g_t; void* du; void* dx2; void* dqkv;
  float* ds;                  // (n_wins, heads, 64, 64)
  float* cs;                  // (n_wins * 4, ncs) column-sum partials
  float* part;                // (n_tiles, n_split, 64, 64)
  float* cs_part;             // (n_cs_chunks, ncs) column-sum chunk sums
  int* counters;              // (n_tiles + n_cs_cols,) tiles, then columns
  float* cs_out[N_CS];        // dbm2, dbm1, dg2, db2, dbproj, dg1, db1
  float* dbias;               // (heads, t, t)
  Prod prod[4];
};

struct BwdParams {
  BlockBwd blk[MAX_BLOCKS];
  int n_blocks;
  int t, nwin, n_img, n_wins, ncs, n_split, n_tiles;
  int n_cs_cols, n_cs_chunks;   // column-sum jobs: 32 columns x CS_ROWS rows
  int n_gemm_blocks, n_cs_blocks, n_db_blocks;   // reduction jobs per block
  Dims d;
};

// Offsets of the column sums inside a row of `cs`.
struct CsOff {
  int dbm2, dbm1, dg2, db2, dbproj, dg1, db1, n;
};

__host__ __device__ inline CsOff cs_off(const Dims& d) {
  CsOff o;
  o.dbm2 = 0;
  o.dbm1 = d.c;
  o.dg2 = d.c + d.chp;
  o.db2 = o.dg2 + d.c;
  o.dbproj = o.db2 + d.c;
  o.dg1 = o.dbproj + d.c;
  o.db1 = o.dg1 + d.c;
  o.n = o.db1 + d.c;
  return o;
}

// Shared memory of the window backward. The region r holds, in turn, the
// recompute's attention scratch, the backward's per-head attention
// scratch, and D (f32 [64][c]: dy2, later dy). dp is kept in T, or in
// f32 under the pair's rounding set. In bf16 the region r also holds
// GG (gelu'(u) in T, [64][chp + 8]) from the recompute's fc1 to the dh
// product, the ring of the staged products follows (RING_BYTES), and
// the attention backward keeps two heads' q, k, v there; vec holds
// copies of the block's small weight vectors. tok holds the window's
// raster tokens.
struct BwdLayout {
  size_t x, y, o, stats, tok, vec, r;
  size_t q, k, vt, s, p, rinv;       // recompute scratch
  size_t bs, bdp, bpc, bds;          // attention-backward scratch
  size_t ring, total;
};

// Whether the ring holds what the window backward stages there besides
// the products' slices: two heads' q, k, v (rows of hp + 8), and 64 rows
// of x or g (f32 at most).
__host__ __device__ inline bool ring_fits(const Dims& d) {
  return 6 * NW * (d.hp + 8) * sizeof(bf16) <= RING_BYTES &&
         NW * d.c * sizeof(float) <= RING_BYTES;
}

template <typename T, bool kPair>
using DpType = std::conditional_t<kPair, float, T>;

template <typename T, bool kPair>
__host__ __device__ inline BwdLayout make_bwd_layout(const Dims& d) {
  int ld[8];
  fwd_strides<T>(d, ld);
  BwdLayout L;
  size_t off = 0;
  L.x = off;     off = align16(off + sizeof(float) * NW * ld[0]);
  L.y = off;     off = align16(off + sizeof(T) * NW * ld[1]);
  L.o = off;     off = align16(off + sizeof(T) * NW * ld[2]);
  L.stats = off; off = align16(off + sizeof(float) * 4 * NW);
  L.tok = off;   off = align16(off + sizeof(int) * NW);
  L.vec = off;
  if (std::is_same_v<T, bf16>) off = align16(off + vec_bytes(d));
  L.r = off;
  size_t e = off;
  L.q = e;       e = align16(e + sizeof(T) * NW * ld[3]);
  L.k = e;       e = align16(e + sizeof(T) * NW * ld[3]);
  L.vt = e;      e = align16(e + sizeof(T) * d.hp * ld[4]);
  L.s = e;       e = align16(e + sizeof(float) * NW * ld[5]);
  L.p = e;       e = align16(e + sizeof(T) * NW * ld[6]);
  L.rinv = e;    e = align16(e + sizeof(float) * NW);
  size_t end = e;
  e = off;
  L.bs = e;      e = align16(e + sizeof(float) * NW * ld[5]);
  L.bdp = e;     e = align16(e + sizeof(DpType<T, kPair>) * NW * ld[6]);
  L.bpc = e;     e = align16(e + sizeof(T) * NW * ld[6]);
  L.bds = e;     e = align16(e + sizeof(T) * NW * ld[6]);
  end = e > end ? e : end;
  e = align16(off + sizeof(float) * NW * d.c);     // D
  end = e > end ? e : end;
  if (std::is_same_v<T, bf16>) {
    e = align16(off + sizeof(T) * NW * (d.chp + 8));   // GG
    end = e > end ? e : end;
  }
  L.ring = end;
  L.total = L.ring + (std::is_same_v<T, bf16> ? RING_BYTES : 0);
  return L;
}

// A LayerNorm backward over the 64 rows, one warp per row: with xh(r,
// cc) the normalised input and dxh(r, cc) the grad of it, out(r, cc,
// (dxh - mean(dxh) - xh mean(dxh xh)) rstd[r]) for cc < c.
template <typename XH, typename DXH, typename Out>
__device__ inline void ln_backward_rows(int c, const float* rstd, XH xh,
                                        DXH dxh, Out out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < NW; r += THREADS / 32) {
    float a = 0.f, bb = 0.f;
    for (int cc = lane; cc < c; cc += 32) {
      const float g = dxh(r, cc);
      a += g;
      bb += g * xh(r, cc);
    }
    const float m1 = warp_sum(a) / c, m2 = warp_sum(bb) / c;
    for (int cc = lane; cc < c; cc += 32)
      out(r, cc, (dxh(r, cc) - m1 - xh(r, cc) * m2) * rstd[r]);
  }
}

// Column sums of f(r, cc), cc < n, over each 16-row block, into
// cs[rb * ldcs + cc] (one thread per (block, column), fixed order).
template <typename F>
__device__ inline void colsum(float* cs, int ldcs, int n, F f) {
  for (int i = threadIdx.x; i < 4 * n; i += THREADS) {
    const int rb = i / n, cc = i % n;
    float acc = 0.f;
    for (int r = rb * 16; r < rb * 16 + 16; ++r) acc += f(r, cc);
    cs[rb * ldcs + cc] = acc;
  }
}

// The backward of block b over window `slot` (patch slot / nwin, window
// slot % nwin of that patch) by the whole CTA: the forward is recomputed
// from x (XT) by the body shared with the forward kernels, which also
// writes the per-token operands of the weight products to the workspace;
// in bf16 every product with a global operand (the weights, and the du
// and dq|dk|dv rows read back from the workspace) streams it through the
// ring (gemm64_staged), each head's q, k, v and bias slice are staged
// into shared memory (the next head's under this head's dq / dk), and
// the attention products take ldmatrix fragments: the sums and rounding
// points are those of the f32 code path's gemm64, in the same order;
// the chain fc2 -> GELU -> fc1 -> LN2 -> proj -> attention (per head,
// scores and softmax recomputed from the saved q, k) -> qkv -> LN1 then
// starts from the incoming grad g (GT) and writes dx (DT) through the
// window index table, the remaining per-token operands (g and du, dx2,
// dq|dk|dv in T), the window's ds (f32) for the bias grad, and
// column-sum partials (per 16-row block) of the bias and LayerNorm
// grads. The incoming grad enters dbm2 and dx2's residual branch
// unrounded and the products rounded to T, as in JAX.
template <typename T, bool kPair, typename XT, typename GT, typename DT>
__device__ inline void window_backward(const BwdParams& p, const BlockBwd& b,
                                       int slot, unsigned char* smem) {
  const Dims d = p.d;
  const BwdLayout L = make_bwd_layout<T, kPair>(d);
  const int img = slot / p.nwin, win = slot % p.nwin;
  const int* tok = b.idx + win * NW;
  const size_t row0 = static_cast<size_t>(img) * p.t;
  const size_t tt = p.t;
  const size_t srow = static_cast<size_t>(slot) * NW;   // workspace row
  const int c = d.c, hp = d.hp, ca = d.ca, ck = d.ck, chp = d.chp;
  const int ld3 = 3 * ca;
  using PT = DpType<T, kPair>;

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
  s.H = nullptr;
  s.ldx = ld[0]; s.ldy = ld[1]; s.ldo = ld[2]; s.ldq = ld[3];
  s.ldvt = ld[4]; s.lds = ld[5]; s.ldp = ld[6]; s.ldh = ld[7];
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  const float* mu1 = stats;
  const float* rstd1 = stats + NW;
  const float* mu2 = stats + 2 * NW;
  const float* rstd2 = stats + 3 * NW;

  // the window's raster tokens, read from shared memory from here on
  int* tok_s = reinterpret_cast<int*>(smem + L.tok);
  if (threadIdx.x < NW) tok_s[threadIdx.x] = tok[threadIdx.x];
  __syncthreads();

  // bf16: the small weight vectors from shared memory (read after
  // block_forward's first barrier)
  FwdWeights w = b.w;
  if constexpr (std::is_same_v<T, bf16>)
    w = stage_vectors(b.w, d, reinterpret_cast<float*>(smem + L.vec));

  Spill<T> sp;
  sp.y = static_cast<T*>(b.y) + srow * ck;
  sp.qkv = static_cast<T*>(b.qkv) + srow * ld3;
  sp.o = static_cast<T*>(b.o) + srow * ca;
  sp.y2 = static_cast<T*>(b.y2) + srow * ck;
  sp.u = static_cast<T*>(b.u) + srow * chp;
  sp.hact = static_cast<T*>(b.hact) + srow * chp;
  sp.mu1 = stats;
  sp.rstd1 = stats + NW;
  sp.mu2 = stats + 2 * NW;
  sp.rstd2 = stats + 3 * NW;
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  T* GG = reinterpret_cast<T*>(smem + L.r);   // gelu'(u), bf16
  sp.gg = GG;
  sp.ldgg = chp + 8;
  sp.ring = ring;
  sp.bias = b.bias;
  sp.tok = tok_s;
  sp.t = p.t;
  sp.row0 = row0;
  T* g_sp = static_cast<T*>(b.g_t) + srow * ck;
  T* du_sp = static_cast<T*>(b.du) + srow * chp;
  T* dx2_sp = static_cast<T*>(b.dx2) + srow * ck;
  T* dqkv_sp = static_cast<T*>(b.dqkv) + srow * ld3;
  float* cs = b.cs + static_cast<size_t>(slot) * 4 * p.ncs;
  const CsOff co = cs_off(d);

  const XT* x = static_cast<const XT*>(b.x);
  const GT* gin = static_cast<const GT*>(b.g);
  auto x_row = [&](int r) { return row0 + tok_s[r]; };
  auto bias_at = [&](int h, int r, int cc) {
    return b.bias[(h * tt + tok_s[r]) * tt + tok_s[cc]];
  };
  block_forward<T, true, std::is_same_v<T, bf16>, THREADS>(
      w, d, s, x, static_cast<T*>(nullptr), x_row, bias_at, sp);

  float* X = s.X;     // x2, then dx2 (f32)
  T* Y = s.Y;         // g in T, then dx2 (T)
  T* O = s.O;         // do (T)
  const int ldx = s.ldx, ldy = s.ldy, ldo = s.ldo, ldp = s.ldp,
            lds = s.lds;
  float* D = reinterpret_cast<float*>(smem + L.r);    // dy2, then dy
  float* BS = reinterpret_cast<float*>(smem + L.bs);  // p (f32)
  PT* DP = reinterpret_cast<PT*>(smem + L.bdp);
  T* PC = reinterpret_cast<T*>(smem + L.bpc);         // p in T
  T* DS = reinterpret_cast<T*>(smem + L.bds);
  const T* wqkv_t = static_cast<const T*>(b.wqkv_t);
  const T* wproj_t = static_cast<const T*>(b.wproj_t);
  const T* w1_t = static_cast<const T*>(b.w1_t);
  const T* w2_t = static_cast<const T*>(b.w2_t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr bool kBf16 = std::is_same_v<T, bf16>;

  // g rows in T (zero pads) -> Y, and to the workspace for dW2; in bf16
  // the rows come through the ring
  const GT* gs = reinterpret_cast<const GT*>(ring);
  auto stage_g = [&] {
    stage_rows(reinterpret_cast<GT*>(ring), gin, row0, tok_s, c);
    cp_async_wait<0>();
    __syncthreads();
  };
  if constexpr (kBf16) stage_g();
  for (int i = threadIdx.x; i < NW * ck; i += THREADS) {
    const int r = i / ck, cc = i % ck;
    const GT gv = cc >= c ? GT{} : kBf16 ? gs[r * c + cc]
                                          : gin[x_row(r) * c + cc];
    const T v = cc < c ? from_f32<T>(to_f32(gv)) : from_f32<T>(0.f);
    Y[r * ldy + cc] = v;
    g_sp[r * ck + cc] = v;
  }
  __syncthreads();
  // g unrounded: Y holds it exactly when it comes in T; an f32 g (the
  // pair's block A) is read from the ring where staged (bf16), else
  // again from global memory
  auto gval = [&](int r, int cc) -> float {
    if constexpr (std::is_same_v<GT, T>) return to_f32(Y[r * ldy + cc]);
    else if constexpr (kBf16) return to_f32(gs[r * c + cc]);
    else return to_f32(gin[x_row(r) * c + cc]);
  };
  colsum(cs + co.dbm2, p.ncs, c, gval);
  // dh = g . W2^T; du = dh * gelu'(u) (f32) -> T to the workspace;
  // column sums of the f32 du give dbm1
  auto du_epi = [&](int r, int col, float v0, float v1) -> float2 {
    float gg0, gg1;
    if constexpr (kBf16) {
      gg0 = to_f32(GG[r * sp.ldgg + col]);
      gg1 = to_f32(GG[r * sp.ldgg + col + 1]);
    } else {
      gg0 = gelu_grad<T>(to_f32(sp.u[r * chp + col]));
      gg1 = gelu_grad<T>(to_f32(sp.u[r * chp + col + 1]));
    }
    const float du0 = v0 * gg0;
    const float du1 = v1 * gg1;
    du_sp[r * chp + col] = from_f32<T>(du0);
    du_sp[r * chp + col + 1] = from_f32<T>(du1);
    return make_float2(du0, du1);
  };
  if constexpr (kBf16)
    gemm64_colsum_st(Y, ldy, w2_t, ck, ck, chp, ring, du_epi, cs + co.dbm1,
                     p.ncs);
  else
    gemm64_colsum<T>(Y, ldy, w2_t, ck, ck, chp, du_epi, cs + co.dbm1,
                     p.ncs);
  __syncthreads();
  // dy2 = du . W1^T (f32) -> D
  auto dy2_epi = [&](int r, int col, float v0, float v1) {
    if (col < c) D[r * c + col] = v0;
    if (col + 1 < c) D[r * c + col + 1] = v1;
  };
  if constexpr (kBf16)
    gemm64_st<true>(du_sp, chp, w1_t, chp, chp, d.cn, ring, dy2_epi);
  else
    gemm64<T>(du_sp, chp, w1_t, chp, chp, d.cn, dy2_epi);
  __syncthreads();
  if constexpr (kBf16 && !std::is_same_v<GT, T>) stage_g();   // for gval
  // LN2 backward: dg2, db2 column sums (need x2), then per row
  // dx2 = g + (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd
  colsum(cs + co.dg2, p.ncs, c, [&](int r, int cc) {
    return D[r * c + cc] * ((X[r * ldx + cc] - mu2[r]) * rstd2[r]);
  });
  colsum(cs + co.db2, p.ncs, c,
         [&](int r, int cc) { return D[r * c + cc]; });
  __syncthreads();
  ln_backward_rows(
      c, rstd2,
      [&](int r, int cc) { return (X[r * ldx + cc] - mu2[r]) * rstd2[r]; },
      [&](int r, int cc) { return D[r * c + cc] * w.g2[cc]; },
      [&](int r, int cc, float v) {
        v += gval(r, cc);
        X[r * ldx + cc] = v;
        Y[r * ldy + cc] = from_f32<T>(v);
      });
  __syncthreads();
  colsum(cs + co.dbproj, p.ncs, c,
         [&](int r, int cc) { return X[r * ldx + cc]; });
  store_rows(Y, ldy, dx2_sp, ck, ck);
  // do = dx2 . Wproj^T -> O (T)
  auto do_epi = [&](int r, int col, float v0, float v1) {
    O[r * ldo + col] = from_f32<T>(v0);
    O[r * ldo + col + 1] = from_f32<T>(v1);
  };
  if constexpr (kBf16)
    gemm64_st<false>(Y, ldy, wproj_t, ck, ck, ca, ring, do_epi);
  else
    gemm64<T>(Y, ldy, wproj_t, ck, ck, ca, do_epi);
  __syncthreads();

  // attention backward, one head at a time. In bf16 each head's q, k, v
  // (two buffers of rows of hp + 8 in the ring) and its bias slice (in
  // BS) are staged by cp.async, the next head's under this head's dq / dk
  const int ldh = hp + 8;
  auto stage_qkv = [&](int h) {
    T* dst = ring + (h & 1) * 3 * NW * ldh;
    const int cpr = hp / 8;   // 16-byte chunks per row
    for (int i = threadIdx.x; i < 3 * NW * cpr; i += THREADS) {
      const int part = i / (NW * cpr), rem = i % (NW * cpr);
      const int r = rem / cpr, ch = rem % cpr * 8;
      cp_async16(dst + (part * NW + r) * ldh + ch,
                 sp.qkv + r * ld3 + (part * d.heads + h) * hp + ch, true);
    }
    cp_async_commit();
  };
  if constexpr (kBf16) {
    stage_qkv(0);
    stage_bias(b.bias, tok_s, p.t, 0, BS, lds);
  }
  for (int h = 0; h < d.heads; ++h) {
    const T* qh = sp.qkv + h * hp;
    const T* kh = sp.qkv + (d.heads + h) * hp;
    const T* vh = sp.qkv + (2 * d.heads + h) * hp;
    const T* doh = O + h * hp;
    const T* qs = ring + (h & 1) * 3 * NW * ldh;    // staged (bf16)
    const T* ks = qs + NW * ldh;
    const T* vs = ks + NW * ldh;
    if constexpr (kBf16) {
      cp_async_wait<0>();
      __syncthreads();
      // the other buffer was last read by head h - 1
      if (h + 1 < d.heads) stage_qkv(h + 1);
      gemm64_ldsm<false, false>(qs, ldh, ks, ldh, hp, NW,
                                [&](int r, int col, float v0, float v1) {
                                  BS[r * lds + col] += v0;
                                  BS[r * lds + col + 1] += v1;
                                });
    } else {
      gemm64<T>(qh, ld3, kh, ld3, hp, NW,
                [&](int r, int col, float v0, float v1) {
                  BS[r * lds + col] = v0 + bias_at(h, r, col);
                  BS[r * lds + col + 1] = v1 + bias_at(h, r, col + 1);
                });
    }
    __syncthreads();
    // p = e * (1/r) in f32 (1/r rounded to T in K2's set); its T
    // rounding feeds dv = p^T . do
    for (int r = warp; r < NW; r += THREADS / 32) {
      const float s0 = BS[r * lds + lane], s1 = BS[r * lds + lane + 32];
      const float m = warp_max(fmaxf(s0, s1));
      const float e0 = expf(s0 - m), e1 = expf(s1 - m);
      const float inv = 1.f / warp_sum(e0 + e1);
      const float ri = kPair ? inv : rnd<T>(inv);
      BS[r * lds + lane] = e0 * ri;
      BS[r * lds + lane + 32] = e1 * ri;
      PC[r * ldp + lane] = from_f32<T>(e0 * ri);
      PC[r * ldp + lane + 32] = from_f32<T>(e1 * ri);
    }
    __syncthreads();
    // dp = do . v^T (-> T in K2's set); dv = p^T . do -> T
    auto dp_epi = [&](int r, int col, float v0, float v1) {
      DP[r * ldp + col] = from_f32<PT>(v0);
      DP[r * ldp + col + 1] = from_f32<PT>(v1);
    };
    auto dv_epi = [&](int r, int col, float v0, float v1) {
      T* row = dqkv_sp + r * ld3 + (2 * d.heads + h) * hp;
      row[col] = from_f32<T>(v0);
      row[col + 1] = from_f32<T>(v1);
    };
    if constexpr (kBf16) {
      gemm64_ldsm<false, false>(doh, ldo, vs, ldh, hp, NW, dp_epi);
      gemm64_ldsm<true, true>(PC, ldp, doh, ldo, NW, hp, dv_epi);
    } else {
      gemm64<T>(doh, ldo, vh, ld3, hp, NW, dp_epi);
      gemm64<T, true, true>(PC, ldp, doh, ldo, NW, hp, dv_epi);
    }
    __syncthreads();
    // rs = sum_j dp p (f32); ds = p * (dp - rs) (f32; K2's set rounds
    // rs and dp - rs to T): to the workspace for the bias grad, in T for
    // dq / dk
    for (int r = warp; r < NW; r += THREADS / 32) {
      const float p0 = BS[r * lds + lane], p1 = BS[r * lds + lane + 32];
      const float dp0 = to_f32(DP[r * ldp + lane]);
      const float dp1 = to_f32(DP[r * ldp + lane + 32]);
      const float rsum = warp_sum(dp0 * p0 + dp1 * p1);
      float ds0, ds1;
      if constexpr (kPair) {
        ds0 = p0 * (dp0 - rsum);
        ds1 = p1 * (dp1 - rsum);
      } else {
        const float rs = rnd<T>(rsum);
        ds0 = p0 * rnd<T>(dp0 - rs);
        ds1 = p1 * rnd<T>(dp1 - rs);
      }
      float* dsr = b.ds + ((static_cast<size_t>(slot) * d.heads + h) * NW
                           + r) * NW;
      dsr[lane] = ds0;
      dsr[lane + 32] = ds1;
      DS[r * ldp + lane] = from_f32<T>(ds0);
      DS[r * ldp + lane + 32] = from_f32<T>(ds1);
    }
    __syncthreads();
    // dq = ds . k, dk = ds^T . q (q pre-scaled: no extra scale)
    auto dq_epi = [&](int r, int col, float v0, float v1) {
      T* row = dqkv_sp + r * ld3 + h * hp;
      row[col] = from_f32<T>(v0);
      row[col + 1] = from_f32<T>(v1);
    };
    auto dk_epi = [&](int r, int col, float v0, float v1) {
      T* row = dqkv_sp + r * ld3 + (d.heads + h) * hp;
      row[col] = from_f32<T>(v0);
      row[col + 1] = from_f32<T>(v1);
    };
    if constexpr (kBf16) {
      if (h + 1 < d.heads) stage_bias(b.bias, tok_s, p.t, h + 1, BS, lds);
      gemm64_ldsm<false, true>(DS, ldp, ks, ldh, NW, hp, dq_epi);
      gemm64_ldsm<true, true>(DS, ldp, qs, ldh, NW, hp, dk_epi);
    } else {
      gemm64<T, false, true>(DS, ldp, kh, ld3, NW, hp, dq_epi);
      gemm64<T, true, true>(DS, ldp, qh, ld3, NW, hp, dk_epi);
    }
    __syncthreads();
  }

  // dy = dqkv . Wqkv^T (f32) -> D
  if constexpr (kBf16)
    gemm64_st<true>(dqkv_sp, ld3, wqkv_t, ld3, ld3, d.cn, ring, dy2_epi);
  else
    gemm64<T>(dqkv_sp, ld3, wqkv_t, ld3, ld3, d.cn, dy2_epi);
  __syncthreads();
  // LN1 backward (x read again: in bf16 staged in the ring), then dx =
  // dx2 + dx_ln1
  const XT* xs = reinterpret_cast<const XT*>(ring);
  if constexpr (kBf16) {
    stage_rows(reinterpret_cast<XT*>(ring), x, row0, tok_s, c);
    cp_async_wait<0>();
    __syncthreads();
  }
  auto xhat1 = [&](int r, int cc) {
    const float xv = kBf16 ? to_f32(xs[r * c + cc])
                           : to_f32(x[x_row(r) * c + cc]);
    return (xv - mu1[r]) * rstd1[r];
  };
  colsum(cs + co.dg1, p.ncs, c,
         [&](int r, int cc) { return D[r * c + cc] * xhat1(r, cc); });
  colsum(cs + co.db1, p.ncs, c,
         [&](int r, int cc) { return D[r * c + cc]; });
  DT* dx = static_cast<DT*>(b.dx);
  ln_backward_rows(
      c, rstd1, xhat1,
      [&](int r, int cc) { return D[r * c + cc] * w.g1[cc]; },
      [&](int r, int cc, float v) {
        dx[x_row(r) * c + cc] = from_f32<DT>(X[r * ldx + cc] + v);
      });
}

// Zero every block's tile and column-sum counters (one CTA of the window
// pass does it; the reduction pass runs after the window pass in stream
// order).
__device__ inline void zero_counters(const BwdParams& p) {
  for (int k = 0; k < p.n_blocks; ++k)
    for (int i = threadIdx.x; i < p.n_tiles + p.n_cs_cols; i += THREADS)
      p.blk[k].counters[i] = 0;
}

// acc += the split's A^T.B in f32: A^T and B^T staged KS tokens at a
// time, FMA loops (the f32 instantiation's product).
__device__ inline void split_product(float (&acc)[NB][4], const Prod& pr,
                                     int k0, int n0, size_t m_beg,
                                     size_t m_end, const float* A,
                                     const float* B, unsigned char* smem) {
  float* At = reinterpret_cast<float*>(smem);   // [64 k][LDT] A^T
  float* Bt = At + 64 * LDT;                    // [64 n][LDT] B^T
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = (warp & 3) * 16, nb = (warp >> 2) * 8 * NB;
  for (size_t m0 = m_beg; m0 < m_end; m0 += KS) {
    for (int e = threadIdx.x; e < 64 * KS; e += THREADS) {
      const int mm = e / 64, kk = e % 64;
      const size_t m = m0 + mm;
      const int k = k0 + kk, n = n0 + kk;
      float av = 0.f;
      if (k < pr.kp) av = A[m * pr.lda + k];
      else if (pr.ones && k == pr.kp) av = 1.f;
      At[kk * LDT + mm] = av;
      Bt[kk * LDT + mm] = n < pr.np ? B[m * pr.ldb + n] : 0.f;
    }
    __syncthreads();
    mma_rows<false, false>(acc, At + rb * LDT, LDT, Bt + nb * LDT, LDT, KS,
                           NB, lane);
    __syncthreads();
  }
}

// acc += the split's A^T.B in bf16: a ring of NSTAGE slices of RS
// tokens of A (the tile's 64 k columns) and of B (its 64 n columns),
// token-major as the workspace stores them, filled by cp.async 16-byte
// copies NSTAGE - 1 slices ahead of the one that computes; both mma
// operands come out of the ring through ldmatrix.trans. Columns past an
// operand's width are zero-filled; row kp of A^T is taken as ones when
// pr.ones (the fragment registers of that row are set to bf16 1.0).
__device__ inline void split_product(float (&acc)[NB][4], const Prod& pr,
                                     int k0, int n0, size_t m_beg,
                                     size_t m_end, const bf16* A,
                                     const bf16* B, unsigned char* smem) {
  bf16* ring = reinterpret_cast<bf16*>(smem);   // [NSTAGE][A, B][RS][LDR]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = (warp & 3) * 16, nb = (warp >> 2) * 8 * NB;
  const int nst = static_cast<int>((m_end - m_beg) / RS);
  auto fill = [&](int st) {
    bf16* sa = ring + (st % NSTAGE) * 2 * RS * LDR;
    bf16* sb = sa + RS * LDR;
    const size_t m0 = m_beg + static_cast<size_t>(st) * RS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {     // 2 x 512 chunks of 16 bytes
      const int e = threadIdx.x + i * THREADS;
      const int row = (e & 511) >> 3, col = (e & 7) * 8;
      if (i < 2) {
        const bool ok = k0 + col < pr.lda;
        cp_async16(sa + row * LDR + col,
                   A + (m0 + row) * pr.lda + (ok ? k0 + col : 0), ok);
      } else {
        const bool ok = n0 + col < pr.ldb;
        cp_async16(sb + row * LDR + col,
                   B + (m0 + row) * pr.ldb + (ok ? n0 + col : 0), ok);
      }
    }
  };
  const int one = pr.ones ? pr.kp - k0 - rb : -1;
  const int g = lane >> 2;
  const bool one_lo = one >= 0 && one < 8 && g == one;
  const bool one_hi = one >= 8 && one < 16 && g == one - 8;
  constexpr uint32_t kOnes = 0x3F803F80u;   // two bf16 1.0
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < nst) fill(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();    // slice st landed; slice st - 1 is free
    if (st + NSTAGE - 1 < nst) fill(st + NSTAGE - 1);
    cp_async_commit();
    const bf16* sa = ring + (st % NSTAGE) * 2 * RS * LDR;
    const bf16* sb = sa + RS * LDR;
#pragma unroll
    for (int kk = 0; kk < RS; kk += 16) {
      // the slices hold A^T and B^T transposed: token-major
      uint32_t a[4], b01[4], b23[4];
      ldsm_a<true>(a, sa, LDR, rb, kk, lane);
      ldsm_b<true>(b01, sb, LDR, nb, kk, lane);
      ldsm_b<true>(b23, sb, LDR, nb + 16, kk, lane);
      if (one_lo) a[0] = a[2] = kOnes;
      if (one_hi) a[1] = a[3] = kOnes;
      mma_tiles(acc, a, b01, b23, NB);
    }
  }
  cp_async_wait<0>();
}

// One split of one 64x64 tile of a weight product; the last split of
// the tile to finish sums the splits' partials in order. Jobs run split
// by split, so the CTAs in flight read one token range, which L2 then
// serves to every tile.
template <typename T>
__device__ inline void reduce_tile(const BwdParams& p, const BlockBwd& b,
                                   int job, unsigned char* smem) {
  __shared__ int last;
  const int tile = job % p.n_tiles, split = job / p.n_tiles;
  int pi = 0;
  while (tile >= b.prod[pi].first + b.prod[pi].tiles) ++pi;
  const Prod& pr = b.prod[pi];
  const int local = tile - pr.first;
  const int k0 = (local / pr.tn) * 64, n0 = (local % pr.tn) * 64;
  const size_t m_all = static_cast<size_t>(p.n_wins) * NW;
  const size_t m_beg = static_cast<size_t>(split) * SPLIT_ROWS;
  const size_t m_end = m_beg + SPLIT_ROWS < m_all ? m_beg + SPLIT_ROWS
                                                   : m_all;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = (warp & 3) * 16, nb = (warp >> 2) * 8 * NB;
  const int g = lane >> 2, t = lane & 3;
  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  split_product(acc, pr, k0, n0, m_beg, m_end, static_cast<const T*>(pr.a),
                static_cast<const T*>(pr.b), smem);
  float* part = b.part + (static_cast<size_t>(tile) * p.n_split + split)
      * 4096;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int col = nb + 8 * j + 2 * t;
    part[(rb + g) * 64 + col] = acc[j][0];
    part[(rb + g) * 64 + col + 1] = acc[j][1];
    part[(rb + g + 8) * 64 + col] = acc[j][2];
    part[(rb + g + 8) * 64 + col + 1] = acc[j][3];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(b.counters + tile, 1) == p.n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = b.part + static_cast<size_t>(tile) * p.n_split
      * 4096;
  for (int e = threadIdx.x; e < 4096; e += THREADS) {
    const int k = k0 + e / 64, n = n0 + e % 64;
    if (n >= pr.np) continue;
    float sum = 0.f;
    for (int q = 0; q < p.n_split; ++q) sum += __ldcg(parts + q * 4096 + e);
    if (k < pr.kp) pr.out[static_cast<size_t>(k) * pr.np + n] = sum;
    else if (pr.ones && k == pr.kp) pr.bout[n] = sum;
  }
}

// The column sums in two levels, each in a fixed order: a job sums one
// chunk of CS_ROWS partial rows of 32 columns (8 warps over interleaved
// rows, then the warps in order) into the chunk's row of cs_part; the
// last chunk of those columns to finish sums the chunks in order.
__device__ inline void reduce_colsums(const BwdParams& p, const BlockBwd& b,
                                      int job, unsigned char* smem) {
  __shared__ int last;
  float* red = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31, sl = threadIdx.x >> 5;
  const int cb = job % p.n_cs_cols, chunk = job / p.n_cs_cols;
  const int col = cb * 32 + lane;
  const int rows = p.n_wins * 4;
  const int r_end = min(rows, (chunk + 1) * CS_ROWS);
  float s = 0.f;
  if (col < p.ncs)
    for (int r = chunk * CS_ROWS + sl; r < r_end; r += 8)
      s += b.cs[static_cast<size_t>(r) * p.ncs + col];
  red[sl * 32 + lane] = s;
  __syncthreads();
  if (sl == 0 && col < p.ncs) {
    float tot = 0.f;
    for (int q = 0; q < 8; ++q) tot += red[q * 32 + lane];
    b.cs_part[static_cast<size_t>(chunk) * p.ncs + col] = tot;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(b.counters + p.n_tiles + cb, 1) == p.n_cs_chunks - 1;
  __syncthreads();
  if (!last || sl != 0 || col >= p.ncs) return;
  __threadfence();
  float tot = 0.f;
  for (int q = 0; q < p.n_cs_chunks; ++q)
    tot += __ldcg(b.cs_part + static_cast<size_t>(q) * p.ncs + col);
  const int c = p.d.c, chp = p.d.chp;
  if (col < c) {
    b.cs_out[0][col] = tot;
  } else if (col < c + chp) {
    b.cs_out[1][col - c] = tot;
  } else {
    const int k = col - c - chp;
    b.cs_out[2 + k / c][k % c] = tot;
  }
}

// 256 entries of the bias grad per block: the windows' ds summed over
// the patches; zero between tokens of different windows.
__device__ inline void reduce_dbias(const BwdParams& p, const BlockBwd& b,
                                    int job, unsigned char* smem) {
  int* win_of = reinterpret_cast<int*>(smem);
  int* pos_of = win_of + p.t;
  for (int i = threadIdx.x; i < p.t; i += THREADS) {
    win_of[b.idx[i]] = i / NW;
    pos_of[b.idx[i]] = i % NW;
  }
  __syncthreads();
  const size_t tt = p.t;
  const size_t e = static_cast<size_t>(job) * THREADS + threadIdx.x;
  if (e >= p.d.heads * tt * tt) return;
  const int h = static_cast<int>(e / (tt * tt));
  const int i = static_cast<int>((e / tt) % tt), j = static_cast<int>(e % tt);
  const int wi = win_of[i];
  float sum = 0.f;
  if (wi == win_of[j]) {
    for (int img = 0; img < p.n_img; ++img)
      sum += b.ds[((static_cast<size_t>(img * p.nwin + wi) * p.d.heads + h)
                   * NW + pos_of[i]) * NW + pos_of[j]];
  }
  b.dbias[e] = sum;
}

template <typename T>
__device__ inline void reduce_job(const BwdParams& p, const BlockBwd& b,
                                  int job, unsigned char* smem) {
  if (job < p.n_gemm_blocks) {
    reduce_tile<T>(p, b, job, smem);
    return;
  }
  job -= p.n_gemm_blocks;
  if (job < p.n_cs_blocks) {
    reduce_colsums(p, b, job, smem);
    return;
  }
  reduce_dbias(p, b, job - p.n_cs_blocks, smem);
}

// The reduction pass: every block's weight-product tiles, column sums
// and bias grad, one job per CTA. The block is picked by a branch so
// that its fields are read with constant offsets.
template <typename T>
__global__ void __launch_bounds__(THREADS)
swin_block_bwd_reduce_kernel(const BwdParams p) {
  static_assert(MAX_BLOCKS == 2, "one branch per block");
  extern __shared__ __align__(16) unsigned char smem[];
  const int per = p.n_gemm_blocks + p.n_cs_blocks + p.n_db_blocks;
  const int cta = blockIdx.x;
  const int job = cta % per;
  if (cta < per) reduce_job<T>(p, p.blk[0], job, smem);
  else reduce_job<T>(p, p.blk[1], job, smem);
}

// Host side: one block's workspace layout and the reduction's job table.
struct Plan {
  Dims d;
  int t, nwin, n_img, n_wins, ncs, n_split, n_tiles, n_cs_cols, n_cs_chunks;
  size_t m;
  size_t off[15];   // y qkv o y2 u hact g du dx2 dqkv | ds cs part cs_part
                    // counters
  size_t total;
  int tn[4], tiles[4];
};

inline size_t align256(size_t v) { return (v + 255) / 256 * 256; }

inline Plan make_plan(size_t elt, int n_img, int t, int c, int heads,
                      int ch) {
  Plan P;
  P.d = make_dims(c, heads, ch);
  const Dims& d = P.d;
  P.t = t;
  P.nwin = t / NW;
  P.n_img = n_img;
  P.n_wins = n_img * P.nwin;
  P.m = static_cast<size_t>(P.n_wins) * NW;
  P.ncs = cs_off(d).n;
  P.n_split = static_cast<int>((P.m + SPLIT_ROWS - 1) / SPLIT_ROWS);
  P.n_cs_cols = (P.ncs + 31) / 32;
  P.n_cs_chunks = (P.n_wins * 4 + CS_ROWS - 1) / CS_ROWS;
  const int kp[4] = {d.c + 1, d.ca, d.c, d.ch};   // qkv carries a ones row
  const int np[4] = {3 * d.ca, d.c, d.ch, d.c};
  P.n_tiles = 0;
  for (int i = 0; i < 4; ++i) {
    P.tn[i] = (np[i] + 63) / 64;
    P.tiles[i] = ((kp[i] + 63) / 64) * P.tn[i];
    P.n_tiles += P.tiles[i];
  }
  const size_t widths[10] = {
      static_cast<size_t>(d.ck), static_cast<size_t>(3 * d.ca),
      static_cast<size_t>(d.ca), static_cast<size_t>(d.ck),
      static_cast<size_t>(d.chp), static_cast<size_t>(d.chp),
      static_cast<size_t>(d.ck), static_cast<size_t>(d.chp),
      static_cast<size_t>(d.ck), static_cast<size_t>(3 * d.ca)};
  size_t off = 0;
  for (int i = 0; i < 10; ++i) {
    P.off[i] = off;
    off = align256(off + elt * P.m * widths[i]);
  }
  P.off[10] = off;
  off = align256(off + sizeof(float) * P.n_wins * heads * NW * NW);
  P.off[11] = off;
  off = align256(off + sizeof(float) * P.n_wins * 4 * P.ncs);
  P.off[12] = off;
  off = align256(off + sizeof(float) * static_cast<size_t>(P.n_tiles)
                 * P.n_split * 4096);
  P.off[13] = off;
  off = align256(off + sizeof(float) * static_cast<size_t>(P.n_cs_chunks)
                 * P.ncs);
  P.off[14] = off;
  off = align256(off + sizeof(int) * (P.n_tiles + P.n_cs_cols));
  P.total = off;
  return P;
}

// The shapes and job counts of a call over `n_blocks` blocks.
inline void set_shapes(BwdParams& p, const Plan& P, int n_blocks) {
  p.n_blocks = n_blocks;
  p.t = P.t;
  p.nwin = P.nwin;
  p.n_img = P.n_img;
  p.n_wins = P.n_wins;
  p.ncs = P.ncs;
  p.n_split = P.n_split;
  p.n_tiles = P.n_tiles;
  p.n_cs_cols = P.n_cs_cols;
  p.n_cs_chunks = P.n_cs_chunks;
  p.n_gemm_blocks = P.n_tiles * P.n_split;
  p.n_cs_blocks = P.n_cs_cols * P.n_cs_chunks;
  p.n_db_blocks = static_cast<int>(
      (static_cast<size_t>(P.d.heads) * P.t * P.t + THREADS - 1) / THREADS);
  p.d = P.d;
}

// Bind one block: io = idx, bias, the 12 forward weights (PackedBlock
// order), the 4 backward ones (PackedBwd order); ws = its P.total bytes
// of workspace; outs = the 13 f32 outputs dwqkv (C, 3 ca), dbqkv (3 ca),
// dwproj (ca, C), dw1 (C, ch), dw2 (ch, C), dbm2 (C), dbm1 (chp), dg2,
// db2, dbproj, dg1, db1 (C each), dbias (heads, t, t).
inline void bind_block(BlockBwd& b, const Plan& P, const void* x,
                       const void* g, void* dx, const void* const* io,
                       unsigned char* ws, const void* const* outs) {
  const Dims& d = P.d;
  b.x = x;
  b.g = g;
  b.dx = dx;
  b.idx = static_cast<const int*>(io[0]);
  b.bias = static_cast<const float*>(io[1]);
  b.w = fwd_weights(io + 2);
  b.wqkv_t = io[14];
  b.wproj_t = io[15];
  b.w1_t = io[16];
  b.w2_t = io[17];
  void** spills[10] = {&b.y, &b.qkv, &b.o, &b.y2, &b.u, &b.hact,
                       &b.g_t, &b.du, &b.dx2, &b.dqkv};
  for (int i = 0; i < 10; ++i) *spills[i] = ws + P.off[i];
  b.ds = reinterpret_cast<float*>(ws + P.off[10]);
  b.cs = reinterpret_cast<float*>(ws + P.off[11]);
  b.part = reinterpret_cast<float*>(ws + P.off[12]);
  b.cs_part = reinterpret_cast<float*>(ws + P.off[13]);
  b.counters = reinterpret_cast<int*>(ws + P.off[14]);
  float* o[N_OUT];
  for (int i = 0; i < N_OUT; ++i)
    o[i] = static_cast<float*>(const_cast<void*>(outs[i]));
  for (int i = 0; i < N_CS; ++i) b.cs_out[i] = o[5 + i];
  b.dbias = o[12];
  // dWqkv = y^T dqkv (+ ones: dbqkv), dWproj = o^T dx2, dW1 = y2^T du,
  // dW2 = hact^T g
  const void* a[4] = {b.y, b.o, b.y2, b.hact};
  const void* bb[4] = {b.dqkv, b.dx2, b.du, b.g_t};
  const int lda[4] = {d.ck, d.ca, d.ck, d.chp};
  const int ldb[4] = {3 * d.ca, d.ck, d.chp, d.ck};
  const int kp[4] = {d.c, d.ca, d.c, d.ch};
  const int np[4] = {3 * d.ca, d.c, d.ch, d.c};
  float* out[4] = {o[0], o[2], o[3], o[4]};
  int first = 0;
  for (int i = 0; i < 4; ++i) {
    b.prod[i] = Prod{a[i], bb[i], out[i], i == 0 ? o[1] : nullptr,
                     lda[i], ldb[i], kp[i], np[i], i == 0 ? 1 : 0,
                     P.tn[i], first, P.tiles[i]};
    first += P.tiles[i];
  }
}

// Dynamic shared memory of the reduction pass: the largest of its jobs'
// (the bf16 product's ring, the f32 product's staged tiles).
template <typename T>
size_t reduce_smem(const BwdParams& p) {
  size_t red = std::is_same_v<T, bf16> ? NSTAGE * 2 * RS * LDR * sizeof(T)
                                       : 2 * 64 * LDT * sizeof(T);
  if (red < 8 * 32 * sizeof(float)) red = 8 * 32 * sizeof(float);
  if (red < 2 * sizeof(int) * p.t) red = 2 * sizeof(int) * p.t;
  return red;
}

// Launch the reduction pass over every block of p.
template <typename T>
int launch_reduce(const BwdParams& p, cudaStream_t stream) {
  const size_t red = reduce_smem<T>(p);
  cudaError_t err = allow_smem(swin_block_bwd_reduce_kernel<T>, red);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_bwd_reduce_kernel<T>
      <<<p.n_blocks * (p.n_gemm_blocks + p.n_cs_blocks + p.n_db_blocks),
         THREADS, red, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace swin
