// Fused Swin block backward over training patches, for Hopper (sm_90a).
//
// Replaces srcaco2_tpu/ops/pallas/swin_block.py:_bwd_kernel (K2), the
// backward of the custom-VJP block op: recompute the block forward, then
// dx, the 12 weight grads and the grad of the (nh, T, T) attention bias,
// summed over every patch.
//
// What bounds it on the card: at the flagship training shapes (B = 128
// patches of 16x16 tokens, C = 180, 6 heads, MLP 360, bf16) one call
// does ~55 GFLOP of matrix products (recompute, dx chain and weight
// products, windowed attention) and must move ~26 MB (x, dout, dx, the
// bias and its grad, the weights), so it is bound by operations: ~56 us
// at the bf16 tensor-core peak.
//
// Design. Two kernels, both deterministic.
//  1. swin_block_bwd_window_kernel, one CTA per 64-token window (the
//     TPU kernel's full T x T attention is the same function, see
//     swin_block_fwd.cu): the forward is recomputed by the body shared
//     with K1/K5 (swin_block_common.cuh), which also writes the
//     per-token operands of the weight products (LN outputs, q|k|v,
//     attention output, fc1 output and activation) to a workspace in
//     global memory, rows in window order. The backward then runs the
//     chain fc2 -> GELU -> fc1 -> LN2 -> proj -> attention (per head,
//     scores and softmax recomputed from the saved q, k) -> qkv -> LN1,
//     writes dx through the window index table, writes the remaining
//     per-token operands (dout, du, dx2, dq|dk|dv), each window's ds
//     (f32) for the bias grad, and column-sum partials (per 16-row
//     block) of the bias and LayerNorm grads. Shared memory holds the
//     f32 residual rows, the LN / grad rows in T, the attention output
//     or its grad, and one head's scratch; intermediates that do not
//     fit go through the workspace, which the next product reads back
//     (L2-resident). In bf16 a 72 KB ring streams every global operand
//     (the weights, and the du and dq|dk|dv rows read back) in 64 x 64
//     slices by cp.async, up to 7 slices ahead, and the products take
//     ldmatrix fragments; x and g rows, each head's q, k, v and 64 x 64
//     bias slice, the small weight vectors and gelu'(u) are staged in
//     shared memory once. A window needs ~221 KB in bf16 and ~217 KB in
//     f32: one CTA of 8 warps per SM, and the pass is bound by latency
//     (a window takes ~630K SM cycles for ~66 MFLOP), not by bytes or
//     operations.
//  2. swin_block_bwd_reduce_kernel: the weight grads are sums over every
//     token of every patch (512 windows at B = 128), written by hand
//     as tiled A^T.B products over the workspace: dWqkv = y^T dqkv (plus
//     a row of ones for dbqkv), dWproj = o^T dx2, dW1 = y2^T du, dW2 =
//     hact^T dout. Each 64x64 output tile is split over 2048-token
//     ranges; each split writes a partial, and the last split to finish
//     (an atomic counter per tile) sums the partials in a fixed order.
//     In bf16 a split streams 64-token slices of A and B through a
//     4-stage cp.async ring into mma.sync by ldmatrix.trans (both are
//     token-major); jobs run split by split, so the CTAs in flight share
//     one token range in L2. The same launch sums the column-sum
//     partials (two fixed-order levels: chunks of 256 partial rows, then
//     the chunks) and, per bias entry, the windows' ds over the patches;
//     entries outside a window are exactly zero and are written as
//     zeros.
//
// Rounding points follow _bwd_kernel's heads-batched branch
// (swin_block.py:460-527) with the f32 softmax: du, dx2, dp and the
// dq|dk|dv blocks round to T; p = e * T(1/r) in f32; rs and ds in f32
// (ds - the grad of the bias - is summed in f32, and rounded to T for
// the dq / dk products); dp - T(rs) in T; every weight grad in f32. The
// GELU grad runs in T with the expression order of _gelu_grad. One
// departure: dbqkv sums the T-rounded dqkv in f32 where JAX rounds each
// grid program's partial sum to T.
//
// The window body, the reduction pass and the workspace plan live in
// swin_block_bwd_common.cuh, shared with the pair backward (K4).
#include "swin_block_bwd_common.cuh"

namespace {

using namespace swin;

template <typename T>
__global__ void __launch_bounds__(THREADS)
swin_block_bwd_window_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.x == 0) zero_counters(p);
  window_backward<T, false, T, T, T>(p, p.blk[0], blockIdx.x, smem);
}

template <typename T>
int launch(const BwdParams& p, cudaStream_t stream) {
  if (std::is_same_v<T, bf16> && !ring_fits(p.d))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = make_bwd_layout<T, false>(p.d).total;
  cudaError_t err = allow_smem(swin_block_bwd_window_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  swin_block_bwd_window_kernel<T>
      <<<p.n_wins, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce<T>(p, stream);
}

}  // namespace

// Bytes of workspace swin_block_bwd needs for these shapes.
extern "C" long long swin_block_bwd_workspace(int compute_bf16, int n_img,
                                              int t, int c, int heads,
                                              int ch) {
  return static_cast<long long>(
      make_plan(compute_bf16 ? 2 : 4, n_img, t, c, heads, ch).total);
}

// C interface (bound with ctypes). ptrs holds device pointers: x, dout,
// dx, idx, bias; the 12 forward weights (ops/swin_block.py:PackedBlock
// order) and the 4 backward ones (PackedBwd order); the workspace
// (swin_block_bwd_workspace bytes); then the f32 outputs dwqkv (C, 3 ca),
// dbqkv (3 ca), dwproj (ca, C), dw1 (C, ch), dw2 (ch, C), dbm2 (C),
// dbm1 (chp), dg2, db2, dbproj, dg1, db1 (C each) and dbias (heads, t, t).
// compute_bf16 selects the bf16 instantiation (x, dout, dx and the T
// weights in bf16) or the f32 one. t = 64 * nwin tokens per patch.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int swin_block_bwd(int compute_bf16, const void* const* ptrs,
                              int n_img, int t, int c, int heads, int ch,
                              void* stream) {
  const Plan P = make_plan(compute_bf16 ? 2 : 4, n_img, t, c, heads, ch);
  BwdParams p{};
  set_shapes(p, P, 1);
  bind_block(p.blk[0], P, ptrs[0], ptrs[1], const_cast<void*>(ptrs[2]),
             ptrs + 3,
             static_cast<unsigned char*>(const_cast<void*>(ptrs[21])),
             ptrs + 22);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return compute_bf16 ? launch<bf16>(p, s) : launch<float>(p, s);
}

// Dynamic shared memory of the per-window kernel per CTA, in bytes.
extern "C" long long swin_block_bwd_smem(int compute_bf16, int c,
    int heads, int ch) {
  const Dims d = make_dims(c, heads, ch);
  return static_cast<long long>(
      compute_bf16 ? make_bwd_layout<bf16, false>(d).total
                   : make_bwd_layout<float, false>(d).total);
}

extern "C" const char* swin_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
