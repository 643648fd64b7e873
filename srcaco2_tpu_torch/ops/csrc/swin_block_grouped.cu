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
// attention FLOPs. One CTA owns one window: its residual rows (f32), the
// LN output, one head's q/k/v, the scores and the MLP hidden activations
// all stay in shared memory, so x is read once and the block output
// written once. The block body (swin_block_common.cuh) is shared with the
// training-patch forward (K1) and the backward's recompute (K2); it is
// latency-bound here, so in bf16 it runs staged (cp.async copies and
// ring, ldmatrix fragments) with 16 warps per window, and in f32
// unstaged with 8.
#include "swin_block_common.cuh"

namespace {

using namespace swin;

constexpr int TL = 2 * WS;        // tile side
constexpr int TT = TL * TL;       // tokens per tile

struct Params {
  const void* x;
  void* out;
  const int* gid;
  const float* bias;          // (G, heads, TT, TT)
  FwdWeights w;
  int n_groups;
  Dims d;
};

template <typename T>
__global__ void __launch_bounds__(kFwdThreads<T>)
swin_block_grouped_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStaged = std::is_same_v<T, bf16>;
  const FwdLayout L = make_fwd_layout<T>(p.d, kStaged);
  const FwdSmem<T> s = fwd_smem<T>(smem, p.d, L);
  const int tile = blockIdx.x >> 2, win = blockIdx.x & 3;
  const int grp = p.gid[tile];
  if (grp < 0 || grp >= p.n_groups) __trap();
  // in-tile token index of the window's local row r (raster order)
  auto tok = [win](int r) {
    return ((win >> 1) * WS + r / WS) * TL + (win & 1) * WS + r % WS;
  };
  const size_t row0 = static_cast<size_t>(tile) * TT;
  const float* bias_g =
      p.bias + static_cast<size_t>(grp) * p.d.heads * TT * TT;
  FwdWeights w = p.w;
  Spill<T> sp{};
  if constexpr (kStaged) {
    w = stage_vectors<kFwdThreads<T>>(p.w, p.d,
                                      reinterpret_cast<float*>(smem + L.vec));
    sp = fwd_stage<T>(smem, L, tok, bias_g, TT, row0);
  }
  block_forward<T, false, kStaged, kFwdThreads<T>>(
      w, p.d, s, static_cast<const T*>(p.x), static_cast<T*>(p.out),
      [&](int r) { return row0 + tok(r); },
      [&](int h, int r, int c) {
        return bias_g[(static_cast<size_t>(h) * TT + tok(r)) * TT + tok(c)];
      },
      sp);
}

template <typename T>
int launch(const Params& p, int n_tiles, cudaStream_t stream) {
  constexpr bool kStaged = std::is_same_v<T, bf16>;
  if (kStaged && !fwd_ring_fits<T>(p.d))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdLayout L = make_fwd_layout<T>(p.d, kStaged);
  cudaError_t err = allow_smem(swin_block_grouped_kernel<T>, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_grouped_kernel<T>
      <<<n_tiles * 4, kFwdThreads<T>, L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (bound with ctypes). Pointers are device pointers laid out
// as documented in Params and ops/swin_block.py:PackedBlock;
// compute_bf16 selects the bf16 instantiation (x, out and the T weights
// in bf16) or the f32 one. Returns the CUDA error code of the launch
// (0 on success). Window side is fixed at 8 (T = 256 tokens per tile).
extern "C" int swin_block_grouped_fwd(
    int compute_bf16, const void* x, void* out, const int* gid,
    const float* bias, const float* g1, const float* b1, const void* wqkv,
    const void* bqkv, const void* wproj, const float* bproj, const float* g2,
    const float* b2, const void* w1, const void* bm1, const void* w2,
    const float* bm2, int n_tiles, int n_groups, int c, int heads, int ch,
    void* stream) {
  Params p{x, out, gid, bias,
           FwdWeights{g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2,
                      bm2},
           n_groups, make_dims(c, heads, ch)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compute_bf16 ? launch<bf16>(p, n_tiles, s)
                      : launch<float>(p, n_tiles, s);
}

// Dynamic shared memory of the kernel per CTA, in bytes.
extern "C" long long swin_block_grouped_smem(int compute_bf16, int c,
    int heads, int ch) {
  return static_cast<long long>(
      compute_bf16
          ? make_fwd_layout<bf16>(make_dims(c, heads, ch), true).total
          : make_fwd_layout<float>(make_dims(c, heads, ch)).total);
}

extern "C" const char* swin_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
