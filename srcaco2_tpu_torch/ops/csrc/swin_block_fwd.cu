// Fused Swin block forward over training patches, for Hopper (sm_90a).
//
// Replaces srcaco2_tpu/ops/pallas/swin_block.py:_fwd_kernel (K1), the
// forward of the custom-VJP block op that the training step runs once
// per Swin block: LN1, qkv (q pre-scaled), multi-head attention with the
// additive (nh, T, T) bias and an f32 softmax, proj + residual, LN2,
// tanh-GELU MLP + residual, over (B, T, C) patches of T <= 256 tokens in
// raster order.
//
// What bounds it on the card: at the flagship training shapes (B = 128
// patches of 16x16 tokens, C = 180, 6 heads, MLP 360, bf16) one call
// does ~18.5 GFLOP of matrix products (windowed attention) and moves
// ~24 MB, so it is bound by operations: ~19 us at the bf16 tensor-core
// peak, against ~7 us for the bytes.
//
// Design. The TPU kernel runs full T x T attention in raster order with
// the cyclic shift and window partition folded into the bias (-1e9 off
// the windows). exp(s - 1e9 - m) is exactly 0 in f32, so attention
// inside each 64-token window is the same function; a 256-token patch
// at C = 180 does not fit in shared memory anyway. One CTA owns one
// window: it reads its 64 rows of x, and its 64x64 blocks of the bias,
// through the window index table (ops/swin_block.py:window_index: the
// roll by -shift and the window partition), runs the block body shared
// with K5 (swin_block_common.cuh) and writes its rows of the output
// through the same table. At these shapes the body is latency-bound, not
// bound by operations or bytes: in bf16 it runs staged (x rows, bias
// slices and weight vectors copied to shared memory by cp.async, the
// weights streamed through a cp.async ring, ldmatrix fragments) with 16
// warps per window, so that more warps hide each other's latencies; the
// f32 instantiation runs the unstaged body with 8.
#include "swin_block_common.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;
  void* out;
  const int* idx;             // (nwin, 64) raster token of each local row
  const float* bias;          // (heads, t, t)
  FwdWeights w;
  int t, nwin;
  Dims d;
};

template <typename T>
__global__ void __launch_bounds__(kFwdThreads<T>) swin_block_fwd_kernel(
    const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStaged = std::is_same_v<T, bf16>;
  const FwdLayout L = make_fwd_layout<T>(p.d, kStaged);
  const FwdSmem<T> s = fwd_smem<T>(smem, p.d, L);
  const int img = blockIdx.x / p.nwin, win = blockIdx.x % p.nwin;
  const int* tok = p.idx + win * NW;
  const size_t row0 = static_cast<size_t>(img) * p.t;
  const size_t tt = p.t;
  FwdWeights w = p.w;
  Spill<T> sp{};
  if constexpr (kStaged) {
    w = stage_vectors<kFwdThreads<T>>(p.w, p.d,
                                      reinterpret_cast<float*>(smem + L.vec));
    sp = fwd_stage<T>(smem, L, [&](int r) { return tok[r]; }, p.bias, p.t,
                      row0);
  }
  block_forward<T, false, kStaged, kFwdThreads<T>>(
      w, p.d, s, static_cast<const T*>(p.x), static_cast<T*>(p.out),
      [&](int r) { return row0 + tok[r]; },
      [&](int h, int r, int c) {
        return p.bias[(h * tt + tok[r]) * tt + tok[c]];
      },
      sp);
}

template <typename T>
int launch(const Params& p, int n_img, cudaStream_t stream) {
  constexpr bool kStaged = std::is_same_v<T, bf16>;
  if (kStaged && !fwd_ring_fits<T>(p.d))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdLayout L = make_fwd_layout<T>(p.d, kStaged);
  cudaError_t err = allow_smem(swin_block_fwd_kernel<T>, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_fwd_kernel<T>
      <<<n_img * p.nwin, kFwdThreads<T>, L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (bound with ctypes). ptrs holds device pointers: x, out,
// idx, bias, then the 12 weights in ops/swin_block.py:PackedBlock order.
// compute_bf16 selects the bf16 instantiation (x, out and the T weights
// in bf16) or the f32 one. t = 64 * nwin tokens per patch. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int swin_block_fwd(int compute_bf16, const void* const* ptrs,
                              int n_img, int t, int c, int heads, int ch,
                              void* stream) {
  Params p{ptrs[0],
           const_cast<void*>(ptrs[1]),
           static_cast<const int*>(ptrs[2]),
           static_cast<const float*>(ptrs[3]),
           fwd_weights(ptrs + 4),
           t,
           t / NW,
           make_dims(c, heads, ch)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compute_bf16 ? launch<bf16>(p, n_img, s)
                      : launch<float>(p, n_img, s);
}

// Dynamic shared memory of the kernel per CTA, in bytes.
extern "C" long long swin_block_fwd_smem(int compute_bf16, int c,
    int heads, int ch) {
  return static_cast<long long>(
      compute_bf16
          ? make_fwd_layout<bf16>(make_dims(c, heads, ch), true).total
          : make_fwd_layout<float>(make_dims(c, heads, ch)).total);
}

extern "C" const char* swin_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
