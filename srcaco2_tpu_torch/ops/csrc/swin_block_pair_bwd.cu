// Fused Swin block pair backward over training patches, for Hopper
// (sm_90a).
//
// Replaces srcaco2_tpu/ops/pallas/swin_block.py:_bwd_kernel_pair (K4),
// the backward of the pair-fused op: recompute block A (shift 0) with
// its output, which is block B's (shift ws/2) f32 input; run B's
// backward from dout; then A's backward fed B's dx in f32; dx, 2 x 12
// weight grads and the grads of both (nh, T, T) biases, summed over
// every patch.
//
// What bounds it on the card: at the flagship training shapes (B = 128
// patches of 16x16 tokens, C = 180, 6 heads, MLP 360, bf16) one call
// does ~107 GFLOP of matrix products (two block backwards as K2 counts
// them, plus A's fc2, whose output B needs) and must move ~46 MB (x,
// dout, dx, the two biases and their grads, the weights and the grads),
// so it is bound by operations: ~108 us at the bf16 tensor-core peak.
//
// Design. Two kernels, both deterministic, reusing K2's machinery
// (swin_block_bwd_common.cuh).
//  1. swin_block_pair_bwd_window_kernel, one CTA per patch, in three
//     phases separated by barriers of the CTA, each looping over the
//     patch's four 64-token windows (B's windows tile the patch
//     differently from A's, so each phase needs all of the previous
//     phase's rows of the patch):
//       a. A's forward (the body shared with K1), its output kept in f32
//          in a scratch array in global memory (L2-resident);
//       b. B's recompute and backward (K2's window body) from that f32
//          input and dout, writing B's dx in f32 to a second scratch
//          array, and B's per-token operands, ds and column-sum partials
//          to B's workspace;
//       c. A's recompute and backward from x and B's f32 dx, writing dx
//          in the compute type and A's operands to A's workspace.
//  2. swin_block_bwd_reduce_kernel (K2's reduction), over both blocks in
//     one launch: the 8 weight products, both blocks' column sums and
//     both bias grads.
//
// Rounding points are _block_bwd_math's (swin_block.py:583-628), which
// the pair kernel runs, not _bwd_kernel's: p = e * (1/r) with 1/r in
// f32, dp in f32, ds = p * (dp - rs) in f32 (rounded to T only as an
// operand of the dq / dk products); du, dx2, do and dq|dk|dv round to T
// as in K2. The incoming grad of A (B's dx) is never rounded: it enters
// dbm2 and dx2's residual branch in f32 and the products in T. The same
// dbqkv departure as K2: the T-rounded dqkv is summed in f32.
#include "swin_block_bwd_common.cuh"

namespace {

using namespace swin;

template <typename T>
__global__ void __launch_bounds__(THREADS)
swin_block_pair_bwd_window_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.x == 0) zero_counters(p);
  const int img = blockIdx.x;
  const BlockBwd& a = p.blk[0];
  const BlockBwd& b = p.blk[1];
  // a. A's forward: x (T) -> B's input (f32)
  patch_forward<T, false, THREADS>(
      a.w, p.d, smem, make_fwd_layout<T>(p.d), a.idx, a.bias, p.t, img,
      static_cast<const T*>(a.x), static_cast<float*>(const_cast<void*>(b.x)));
  // b. B's backward: input f32, grad dout (T), dx f32 (A's grad)
  for (int win = 0; win < p.nwin; ++win) {
    window_backward<T, true, float, T, float>(p, b, img * p.nwin + win,
                                              smem);
    __syncthreads();
  }
  // c. A's backward: input x (T), grad f32, dx (T)
  for (int win = 0; win < p.nwin; ++win) {
    window_backward<T, true, T, float, T>(p, a, img * p.nwin + win, smem);
    __syncthreads();
  }
}

template <typename T>
size_t window_smem(const Dims& d) {
  const size_t f = make_fwd_layout<T>(d).total;
  const size_t b = make_bwd_layout<T, true>(d).total;
  return f > b ? f : b;
}

template <typename T>
int launch(const BwdParams& p, cudaStream_t stream) {
  if (std::is_same_v<T, bf16> && !ring_fits(p.d))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = window_smem<T>(p.d);
  cudaError_t err = allow_smem(swin_block_pair_bwd_window_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_pair_bwd_window_kernel<T>
      <<<p.n_img, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<T>(p, stream);
}

// The pair's workspace: A's and B's K2 workspaces, then the f32 scratch
// of A's output and of B's dx.
struct PairPlan {
  Plan blk;
  size_t mid, dmid, total;
};

inline PairPlan make_pair_plan(int compute_bf16, int n_img, int t, int c,
                               int heads, int ch) {
  PairPlan P;
  P.blk = make_plan(compute_bf16 ? 2 : 4, n_img, t, c, heads, ch);
  const size_t rows = sizeof(float) * static_cast<size_t>(n_img) * t * c;
  P.mid = 2 * P.blk.total;
  P.dmid = align256(P.mid + rows);
  P.total = align256(P.dmid + rows);
  return P;
}

}  // namespace

// Bytes of workspace swin_block_pair_bwd needs for these shapes.
extern "C" long long swin_block_pair_bwd_workspace(int compute_bf16,
                                                   int n_img, int t, int c,
                                                   int heads, int ch) {
  return static_cast<long long>(
      make_pair_plan(compute_bf16, n_img, t, c, heads, ch).total);
}

// C interface (bound with ctypes). ptrs holds device pointers: x, dout,
// dx, the workspace (swin_block_pair_bwd_workspace bytes), then for
// block A and then block B, 31 each: idx, bias, the 12 forward weights
// (ops/swin_block.py:PackedBlock order), the 4 backward ones (PackedBwd
// order) and the 13 f32 outputs dwqkv (C, 3 ca), dbqkv (3 ca), dwproj
// (ca, C), dw1 (C, ch), dw2 (ch, C), dbm2 (C), dbm1 (chp), dg2, db2,
// dbproj, dg1, db1 (C each), dbias (heads, t, t). compute_bf16 selects
// the bf16 instantiation (x, dout, dx and the T weights in bf16) or the
// f32 one. t = 64 * nwin tokens per patch. Returns the CUDA error code
// of the launches (0 on success).
extern "C" int swin_block_pair_bwd(int compute_bf16, const void* const* ptrs,
                                   int n_img, int t, int c, int heads,
                                   int ch, void* stream) {
  const PairPlan P = make_pair_plan(compute_bf16, n_img, t, c, heads, ch);
  unsigned char* ws =
      static_cast<unsigned char*>(const_cast<void*>(ptrs[3]));
  float* mid = reinterpret_cast<float*>(ws + P.mid);
  float* dmid = reinterpret_cast<float*>(ws + P.dmid);
  const void* const* io_a = ptrs + 4;
  const void* const* io_b = ptrs + 4 + 31;
  BwdParams p{};
  set_shapes(p, P.blk, 2);
  bind_block(p.blk[0], P.blk, ptrs[0], dmid, const_cast<void*>(ptrs[2]),
             io_a, ws, io_a + 18);
  bind_block(p.blk[1], P.blk, mid, ptrs[1], dmid, io_b, ws + P.blk.total,
             io_b + 18);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compute_bf16 ? launch<bf16>(p, s) : launch<float>(p, s);
}

// Dynamic shared memory of the per-patch kernel per CTA, in bytes.
extern "C" long long swin_block_pair_bwd_smem(int compute_bf16, int c,
    int heads, int ch) {
  const Dims d = make_dims(c, heads, ch);
  return static_cast<long long>(compute_bf16 ? window_smem<bf16>(d)
                                             : window_smem<float>(d));
}

extern "C" const char* swin_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
