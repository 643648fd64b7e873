// Grouped fused Swin block, forward only, for Hopper (sm_90a).
//
// Replaces srcaco2_tpu/ops/pallas/swin_block.py:_fwd_kernel_grouped: one
// whole Swin block (LN1, qkv, windowed multi-head attention with an
// additive bias, proj + residual, LN2, tanh-GELU MLP + residual) over the
// 2ws x 2ws tiles of the tiled full-image path, each tile taking its
// (nh, T, T) bias from a small group table by a per-tile group id.
//
// What bounds it on the card: at the serving shapes (x8 SwinIR, C=180,
// 6 heads, batch 8 at 64x64 LR) one call does ~18.5 GFLOP of matrix
// products and moves ~30 MB, so it is bound by operations: ~19 us on an
// H100 SXM at the bf16 tensor-core peak, against ~9 us for the bytes.
//
// Design. The tile's base bias is block-diagonal over its four ws x ws
// windows with -1e9 off the diagonal blocks; exp(s - 1e9 - m) is exactly
// 0 in f32, so attention inside each 64-token window over that window's
// 64x64 slice of the group bias is the same function at a quarter of the
// attention FLOPs. One CTA (8 warps) owns one window: its residual rows
// (f32), the LN output, one head's q/k/v, the scores and the MLP hidden
// activations all stay in shared memory, so x is read once and the block
// output written once. The first design is deliberately simple: products
// are warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate) with weight
// fragments read straight from global memory (they stay resident in L2),
// no TMA, no wgmma, no pipelining; the f32 instantiation (the non-amp
// path and the checks) uses plain FMA loops with the same tiling. The
// awkward widths are zero-padded: the wrapper lays the weights out
// transposed and padded (K = C -> multiple of 16, hd 30 -> 32, MLP hidden
// -> multiple of 16, output columns -> multiple of 8) and the kernel zeroes
// the matching activation columns, so every pad adds exact zeros.
//
// Rounding points follow srcaco2_tpu/ops/pallas/swin_block.py
// (_block_fwd_math, _cast_wb) with the f32 softmax: LN f32 -> T; qkv
// (f32 acc) -> T, + T bias -> T; scores f32 + f32 bias; f32 max/exp/sum;
// e -> T for P.V, times f32 1/r -> T; proj (f32 acc) + f32 bias -> f32
// residual; LN2 f32 -> T; fc1 (f32 acc) -> T, + T bias -> T; tanh-GELU in
// T (every op rounded to T); fc2 (f32 acc) + f32 bias -> f32 residual ->
// stored in T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WS = 8;             // window side
constexpr int NW = WS * WS;       // tokens per window (one CTA)
constexpr int TL = 2 * WS;        // tile side
constexpr int TT = TL * TL;       // tokens per tile
constexpr int THREADS = 256;      // 8 warps
constexpr int NB = 4;             // n8 tiles per warp pass
constexpr float LN_EPS = 1e-5f;
constexpr float GELU_C = 0.7978845608028654f;   // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;

using bf16 = __nv_bfloat16;

__host__ __device__ inline int ceil_to(int v, int m) {
  return (v + m - 1) / m * m;
}

struct Dims {
  int c, heads, hd, ch;   // model widths
  int hp;                 // head width padded to 16 (K of Q.K^T)
  int ck;                 // C padded to 16 (K of qkv and fc1)
  int cn;                 // C padded to 8 (N of proj and fc2)
  int chp;                // MLP hidden width padded to 16
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
  return d;
}

// Shared-memory layout, byte offsets. Row strides carry 8 spare elements
// (4 for f32 scores) so the 8 fragment rows of a warp fall on distinct
// banks. The MLP hidden buffer H reuses the attention buffers.
struct Layout {
  int ldx, ldy, ldo, ldq, ldvt, lds, ldp, ldh;
  size_t x, y, o, q, k, vt, s, p, rinv, h, total;
};

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  L.ldx = d.c;
  L.ldy = d.ck + 8;
  L.ldo = d.heads * d.hp + 8;
  L.ldq = d.hp + 8;
  L.ldvt = NW + 8;
  L.lds = NW + 4;
  L.ldp = NW + 8;
  L.ldh = d.chp + 8;
  size_t off = 0;
  L.x = off;    off = align16(off + sizeof(float) * NW * L.ldx);
  L.y = off;    off = align16(off + sizeof(T) * NW * L.ldy);
  L.o = off;    off = align16(off + sizeof(T) * NW * L.ldo);
  L.q = off;    off = align16(off + sizeof(T) * NW * L.ldq);
  L.k = off;    off = align16(off + sizeof(T) * NW * L.ldq);
  L.vt = off;   off = align16(off + sizeof(T) * d.hp * L.ldvt);
  L.s = off;    off = align16(off + sizeof(float) * NW * L.lds);
  L.p = off;    off = align16(off + sizeof(T) * NW * L.ldp);
  L.rinv = off; off = align16(off + sizeof(float) * NW);
  L.h = L.o;
  size_t h_end = align16(L.h + sizeof(T) * NW * L.ldh);
  L.total = off > h_end ? off : h_end;
  return L;
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

// acc[j] += A[16 rows][K] * Bt[8 rows of tile j][K]^T for the j < nvalid
// n8 tiles. Fragment ownership of mma.m16n8k16: g = lane / 4 owns rows g
// and g + 8, t = lane % 4 owns columns 2t, 2t + 1 of each n8 tile.
__device__ inline void mma_rows(float (&acc)[NB][4], const bf16* A, int lda,
                                const bf16* Bt, int ldb, int K, int nvalid,
                                int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a0 = ld32(A + g * lda + k0 + 2 * t);
    const uint32_t a1 = ld32(A + (g + 8) * lda + k0 + 2 * t);
    const uint32_t a2 = ld32(A + g * lda + k0 + 2 * t + 8);
    const uint32_t a3 = ld32(A + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nvalid) {
        const bf16* b = Bt + (8 * j + g) * ldb + k0 + 2 * t;
        const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
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
__device__ inline void mma_rows(float (&acc)[NB][4], const float* A,
                                int lda, const float* Bt, int ldb, int K,
                                int nvalid, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float lo = A[g * lda + k], hi = A[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nvalid) {
        const float b0 = Bt[(8 * j + 2 * t) * ldb + k];
        const float b1 = Bt[(8 * j + 2 * t + 1) * ldb + k];
        acc[j][0] = fmaf(lo, b0, acc[j][0]);
        acc[j][1] = fmaf(lo, b1, acc[j][1]);
        acc[j][2] = fmaf(hi, b0, acc[j][2]);
        acc[j][3] = fmaf(hi, b1, acc[j][3]);
      }
    }
  }
}

// C[64][N] = A[64][K] . Bt[N][K]^T, handed to epi(row, col, v0, v1) for
// the column pair (col, col + 1). N is a multiple of 8 and K of 16. Warp
// w takes row block w % 4 and every other group of NB n8 tiles.
template <typename T, typename Epi>
__device__ inline void gemm64(const T* A, int lda, const T* Bt, int ldb,
                              int K, int N, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  for (int n0 = (warp >> 2) * 8 * NB; n0 < N; n0 += 2 * 8 * NB) {
    float acc[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int nvalid = min(NB, (N - n0) / 8);
    mma_rows(acc, A + r0 * lda, lda, Bt + n0 * ldb, ldb, K, nvalid, lane);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < nvalid) {
        const int col = n0 + 8 * j + 2 * t;
        epi(r0 + g, col, acc[j][0], acc[j][1]);
        epi(r0 + g + 8, col, acc[j][2], acc[j][3]);
      }
    }
  }
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

// LayerNorm of the f32 rows of X into Y (T), zeroing the pad columns
// [c, ck) that the next product reads. One warp per row.
template <typename T>
__device__ inline void layer_norm(const float* X, int ldx, const float* gam,
                                  const float* bet, T* Y, int ldy,
                                  const Dims& d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < NW; r += THREADS / 32) {
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
  }
}

// tanh-GELU with every op rounded to T (the JAX path computes it in the
// compute dtype, constants included).
template <typename T> __device__ inline float gelu(float u) {
  const float ga = rnd<T>(GELU_A), gc = rnd<T>(GELU_C);
  float z = rnd<T>(ga * u);
  z = rnd<T>(z * u);
  z = rnd<T>(z * u);
  z = rnd<T>(u + z);
  z = rnd<T>(gc * z);
  const float th = rnd<T>(tanhf(z));
  return rnd<T>(rnd<T>(0.5f * u) * rnd<T>(1.f + th));
}

struct Params {
  const void* x;
  void* out;
  const int* gid;
  const float* bias;          // (G, heads, TT, TT)
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
  int n_groups;
  Dims d;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
swin_block_grouped_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims d = p.d;
  const Layout L = make_layout<T>(d);
  float* X = reinterpret_cast<float*>(smem + L.x);
  T* Y = reinterpret_cast<T*>(smem + L.y);
  T* O = reinterpret_cast<T*>(smem + L.o);
  T* Q = reinterpret_cast<T*>(smem + L.q);
  T* K = reinterpret_cast<T*>(smem + L.k);
  T* Vt = reinterpret_cast<T*>(smem + L.vt);
  float* S = reinterpret_cast<float*>(smem + L.s);
  T* P = reinterpret_cast<T*>(smem + L.p);
  float* rinv = reinterpret_cast<float*>(smem + L.rinv);
  T* H = reinterpret_cast<T*>(smem + L.h);

  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const T* wqkv = static_cast<const T*>(p.wqkv);
  const T* bqkv = static_cast<const T*>(p.bqkv);
  const T* wproj = static_cast<const T*>(p.wproj);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* bm1 = static_cast<const T*>(p.bm1);
  const T* w2 = static_cast<const T*>(p.w2);

  const int tile = blockIdx.x >> 2, win = blockIdx.x & 3;
  const int grp = p.gid[tile];
  if (grp < 0 || grp >= p.n_groups) __trap();
  // in-tile token index of the window's local row r (raster order)
  auto tok = [win](int r) {
    return ((win >> 1) * WS + r / WS) * TL + (win & 1) * WS + r % WS;
  };
  const size_t row0 = static_cast<size_t>(tile) * TT;
  const int c = d.c, hp = d.hp;

  for (int i = threadIdx.x; i < NW * c; i += THREADS) {
    const int r = i / c, cc = i % c;
    X[r * L.ldx + cc] = to_f32(x[(row0 + tok(r)) * c + cc]);
  }
  __syncthreads();
  layer_norm<T>(X, L.ldx, p.g1, p.b1, Y, L.ldy, d);
  __syncthreads();

  for (int h = 0; h < d.heads; ++h) {
    const T* bq = bqkv + h * 3 * hp;
    gemm64<T>(Y, L.ldy, wqkv + static_cast<size_t>(h) * 3 * hp * d.ck,
              d.ck, d.ck, 3 * hp,
              [&](int r, int col, float v0, float v1) {
                const float vs[2] = {v0, v1};
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int cc = col + e;
                  const T v = from_f32<T>(
                      rnd<T>(vs[e]) + to_f32(bq[cc]));
                  if (cc < hp) Q[r * L.ldq + cc] = v;
                  else if (cc < 2 * hp) K[r * L.ldq + cc - hp] = v;
                  else Vt[(cc - 2 * hp) * L.ldvt + r] = v;
                }
              });
    __syncthreads();
    const float* bias_h =
        p.bias + (static_cast<size_t>(grp) * d.heads + h) * TT * TT;
    gemm64<T>(Q, L.ldq, K, L.ldq, hp, NW,
              [&](int r, int col, float v0, float v1) {
                const float* br = bias_h + tok(r) * TT;
                S[r * L.lds + col] = v0 + br[tok(col)];
                S[r * L.lds + col + 1] = v1 + br[tok(col + 1)];
              });
    __syncthreads();
    {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int r = warp; r < NW; r += THREADS / 32) {
        const float s0 = S[r * L.lds + lane], s1 = S[r * L.lds + lane + 32];
        const float m = warp_max(fmaxf(s0, s1));
        const float e0 = expf(s0 - m), e1 = expf(s1 - m);
        const float sum = warp_sum(e0 + e1);
        P[r * L.ldp + lane] = from_f32<T>(e0);
        P[r * L.ldp + lane + 32] = from_f32<T>(e1);
        if (lane == 0) rinv[r] = 1.f / sum;
      }
    }
    __syncthreads();
    gemm64<T>(P, L.ldp, Vt, L.ldvt, NW, hp,
              [&](int r, int col, float v0, float v1) {
                O[r * L.ldo + h * hp + col] = from_f32<T>(v0 * rinv[r]);
                O[r * L.ldo + h * hp + col + 1] = from_f32<T>(v1 * rinv[r]);
              });
    __syncthreads();
  }

  // x2 = x + (O . Wproj + bproj), in place in X
  gemm64<T>(O, L.ldo, wproj, d.heads * hp, d.heads * hp, d.cn,
            [&](int r, int col, float v0, float v1) {
              if (col < c) X[r * L.ldx + col] += v0 + p.bproj[col];
              if (col + 1 < c) X[r * L.ldx + col + 1] += v1 + p.bproj[col + 1];
            });
  __syncthreads();
  layer_norm<T>(X, L.ldx, p.g2, p.b2, Y, L.ldy, d);
  __syncthreads();
  gemm64<T>(Y, L.ldy, w1, d.ck, d.ck, d.chp,
            [&](int r, int col, float v0, float v1) {
              const float u0 = rnd<T>(rnd<T>(v0) + to_f32(bm1[col]));
              const float u1 = rnd<T>(rnd<T>(v1) + to_f32(bm1[col + 1]));
              H[r * L.ldh + col] = from_f32<T>(gelu<T>(u0));
              H[r * L.ldh + col + 1] = from_f32<T>(gelu<T>(u1));
            });
  __syncthreads();
  gemm64<T>(H, L.ldh, w2, d.chp, d.chp, d.cn,
            [&](int r, int col, float v0, float v1) {
              T* orow = out + (row0 + tok(r)) * c;
              if (col < c)
                orow[col] = from_f32<T>(X[r * L.ldx + col] + (v0 + p.bm2[col]));
              if (col + 1 < c)
                orow[col + 1] =
                    from_f32<T>(X[r * L.ldx + col + 1] + (v1 + p.bm2[col + 1]));
            });
}

template <typename T>
int launch(const Params& p, int n_tiles, cudaStream_t stream) {
  const Layout L = make_layout<T>(p.d);
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_grouped_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_grouped_kernel<T>
      <<<n_tiles * 4, THREADS, L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (bound with ctypes). Pointers are device pointers laid out
// as documented in Params; compute_bf16 selects the bf16 instantiation
// (x, out and the T weights in bf16) or the f32 one. Returns the CUDA
// error code of the launch (0 on success). Window side is fixed at 8
// (T = 256 tokens per tile).
extern "C" int swin_block_grouped_fwd(
    int compute_bf16, const void* x, void* out, const int* gid,
    const float* bias, const float* g1, const float* b1, const void* wqkv,
    const void* bqkv, const void* wproj, const float* bproj, const float* g2,
    const float* b2, const void* w1, const void* bm1, const void* w2,
    const float* bm2, int n_tiles, int n_groups, int c, int heads, int ch,
    void* stream) {
  Params p{x,  out, gid, bias, g1, b1, wqkv, bqkv, wproj, bproj,
           g2, b2,  w1,  bm1,  w2, bm2, n_groups, make_dims(c, heads, ch)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compute_bf16 ? launch<bf16>(p, n_tiles, s)
                      : launch<float>(p, n_tiles, s);
}

extern "C" const char* swin_block_grouped_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
