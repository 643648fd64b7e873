// Fused Swin block pair forward over training patches, for Hopper
// (sm_90a).
//
// Replaces srcaco2_tpu/ops/pallas/swin_block.py:_fwd_kernel_pair (K3),
// the forward of the pair-fused op that the training step runs once per
// (no-shift, shift) pair of Swin blocks when SRCACO2_SWIN_PAIR=1: block
// A (shift 0) then block B (shift ws/2), with A's output fed to B in
// f32. The per-block path rounds the stream to the compute type between
// blocks; this one rounds only B's output.
//
// What bounds it on the card: at the flagship training shapes (B = 128
// patches of 16x16 tokens, C = 180, 6 heads, MLP 360, bf16) one call
// does ~37 GFLOP of matrix products (two blocks, windowed attention) and
// must move ~28 MB (x, out, two biases, two weight sets), so it is bound
// by operations: ~37 us at the bf16 tensor-core peak.
//
// Design. A's 64-token windows (shift 0) and B's (shift 4) tile the
// same 256 tokens differently, so B's first window needs A's output of
// the whole patch. One CTA owns one patch: it runs A over each of the
// patch's windows with the block body shared with K1/K5
// (swin_block_common.cuh; in bf16 staged, with 16 warps, B's f32 input
// rows staged as K1's are), writing A's output rows in f32 to a scratch
// array in global memory (n_img x t x C f32, ~23.6 MB at batch 128, which
// stays in L2), then, after a barrier of the CTA, B over each of its
// windows, reading its input rows from that scratch and writing the
// output in the compute type. Both read their windows through their
// window index tables (ops/swin_block.py:window_index). A's output is
// never rounded to the compute type.
#include "swin_block_common.cuh"

namespace {

using namespace swin;

struct Params {
  const void* x;              // (n_img, t, c) T
  void* out;                  // (n_img, t, c) T
  float* mid;                 // (n_img, t, c) f32: A's output
  const int* idx[2];          // A, B: (nwin, 64) raster token per row
  const float* bias[2];       // A, B: (heads, t, t)
  FwdWeights w[2];
  int t;
  Dims d;
};

template <typename T>
__global__ void __launch_bounds__(kFwdThreads<T>) swin_block_pair_fwd_kernel(
    const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStaged = std::is_same_v<T, bf16>;
  constexpr int kThreads = kFwdThreads<T>;
  const FwdLayout L = make_fwd_layout<T>(p.d, kStaged);
  const int img = blockIdx.x;
  patch_forward<T, kStaged, kThreads>(p.w[0], p.d, smem, L, p.idx[0],
                                      p.bias[0], p.t, img,
                                      static_cast<const T*>(p.x), p.mid);
  patch_forward<T, kStaged, kThreads>(p.w[1], p.d, smem, L, p.idx[1],
                                      p.bias[1], p.t, img,
                                      static_cast<const float*>(p.mid),
                                      static_cast<T*>(p.out));
}

template <typename T>
int launch(const Params& p, int n_img, cudaStream_t stream) {
  constexpr bool kStaged = std::is_same_v<T, bf16>;
  // block B's f32 input rows are staged in the ring
  if (kStaged && !fwd_ring_fits<float>(p.d))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdLayout L = make_fwd_layout<T>(p.d, kStaged);
  cudaError_t err = allow_smem(swin_block_pair_fwd_kernel<T>, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_pair_fwd_kernel<T>
      <<<n_img, kFwdThreads<T>, L.total, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (bound with ctypes). ptrs holds device pointers: x, out,
// the f32 scratch (n_img * t * c floats), then for block A and then
// block B: idx, bias and the 12 weights in ops/swin_block.py:PackedBlock
// order. compute_bf16 selects the bf16 instantiation (x, out and the T
// weights in bf16) or the f32 one. t = 64 * nwin tokens per patch.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int swin_block_pair_fwd(int compute_bf16, const void* const* ptrs,
                                   int n_img, int t, int c, int heads,
                                   int ch, void* stream) {
  Params p{};
  p.x = ptrs[0];
  p.out = const_cast<void*>(ptrs[1]);
  p.mid = static_cast<float*>(const_cast<void*>(ptrs[2]));
  for (int k = 0; k < 2; ++k) {
    const void* const* blk = ptrs + 3 + 14 * k;
    p.idx[k] = static_cast<const int*>(blk[0]);
    p.bias[k] = static_cast<const float*>(blk[1]);
    p.w[k] = fwd_weights(blk + 2);
  }
  p.t = t;
  p.d = make_dims(c, heads, ch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compute_bf16 ? launch<bf16>(p, n_img, s)
                      : launch<float>(p, n_img, s);
}

// Dynamic shared memory of the kernel per CTA, in bytes.
extern "C" long long swin_block_pair_fwd_smem(int compute_bf16, int c,
    int heads, int ch) {
  return static_cast<long long>(
      compute_bf16
          ? make_fwd_layout<bf16>(make_dims(c, heads, ch), true).total
          : make_fwd_layout<float>(make_dims(c, heads, ch)).total);
}

extern "C" const char* swin_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
