#!/usr/bin/env python3
"""Device time of K2's (swin_block_bwd) window pass and of each of its
reduction pass's three job kinds (weight-product tiles, column sums,
dbias) alone, on one NVIDIA card, at the flagship's training shapes
(bf16, shift 4, 128 patches of 16x16 tokens, C=180, 6 heads, MLP 360).

    python3 scripts/k2_reduce_jobs.py

The package launches the three job kinds in one kernel and has no
switch to run one alone, so this script writes a scratch source into a
temporary directory: a copy of K2's window kernel and a kernel that runs
one contiguous range of the reduction's jobs (`reduce_job`), both over
the package's own headers. It builds that source with nvcc, runs the
window pass once to fill the workspace, then times each job kind with
CUDA events (the median of 5 rounds of 10 calls; each call of a job
kind first zeroes the workspace's counters with cudaMemsetAsync, a few
microseconds that the times include). Prints one JSON line.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SCRATCH = r'''
#include "swin_block_bwd_common.cuh"
using namespace swin;

__global__ void __launch_bounds__(THREADS) window_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  window_backward<bf16, false, bf16, bf16, bf16>(p, p.blk[0], blockIdx.x,
                                                 smem);
}

__global__ void __launch_bounds__(THREADS)
jobs_kernel(const BwdParams p, int first) {
  extern __shared__ __align__(16) unsigned char smem[];
  reduce_job<bf16>(p, p.blk[0], first + blockIdx.x, smem);
}

// what: 0 the window pass, 1 the weight-product tiles, 2 the column
// sums, 3 dbias. ptrs as swin_block_bwd takes them (bf16 only).
extern "C" int run(int what, const void* const* ptrs, int n_img, int t,
                   int c, int heads, int ch, void* stream) {
  const Plan P = make_plan(2, n_img, t, c, heads, ch);
  BwdParams p{};
  set_shapes(p, P, 1);
  unsigned char* ws = static_cast<unsigned char*>(const_cast<void*>(ptrs[21]));
  bind_block(p.blk[0], P, ptrs[0], ptrs[1], const_cast<void*>(ptrs[2]),
             ptrs + 3, ws, ptrs + 22);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (what == 0) {
    const size_t smem = make_bwd_layout<bf16, false>(p.d).total;
    cudaError_t err = allow_smem(window_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_kernel<<<p.n_wins, THREADS, smem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  // the counters close the workspace
  unsigned char* ctr = reinterpret_cast<unsigned char*>(p.blk[0].counters);
  cudaMemsetAsync(ctr, 0, P.total - (ctr - ws), s);
  const int first[3] = {0, p.n_gemm_blocks, p.n_gemm_blocks + p.n_cs_blocks};
  const int count[3] = {p.n_gemm_blocks, p.n_cs_blocks, p.n_db_blocks};
  const size_t red = reduce_smem<bf16>(p);
  cudaError_t err = allow_smem(jobs_kernel, red);
  if (err != cudaSuccess) return static_cast<int>(err);
  jobs_kernel<<<count[what - 1], THREADS, red, s>>>(p, first[what - 1]);
  return static_cast<int>(cudaGetLastError());
}
'''


def build(tmp):
    from srcaco2_tpu_torch.ops import build as B
    src, lib = os.path.join(tmp, 'k2_jobs.cu'), os.path.join(tmp, 'k2_jobs.so')
    with open(src, 'w') as f:
        f.write(SCRATCH)
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, '-I', str(B.CSRC), '-o', lib,
                    src], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).run
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('k2_reduce_jobs: no CUDA device visible', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from srcaco2_tpu_torch.ops import swin_block as sb
    dev, dt, shift = torch.device('cuda'), torch.bfloat16, cs.WS // 2
    gen = torch.Generator().manual_seed(0)
    x, params, bias, dout = cs.train_block_inputs(dev, gen, shift)
    xd, dd = x.to(dt), dout.to(dt)
    idx = sb._window_index_on(cs.PATCH, cs.PATCH, cs.WS, shift, str(dev))
    packed = sb.pack_block_params(params, cs.HEADS, dt)
    packed_bwd = sb.pack_block_bwd_params(params, cs.HEADS, dt)
    n, t, c = xd.shape
    _, _, ws_bytes = sb._bwd_kernel('swin_block_bwd')
    ws = torch.empty(int(ws_bytes(1, n, t, c, cs.HEADS, cs.CH)),
                     dtype=torch.uint8, device=dev)
    dx = torch.empty_like(xd)
    gp, dbias = sb._grad_buffers(xd, cs.HEADS, cs.CH)
    ptrs = sb._ptrs([xd, dd, dx, idx, bias, *packed, *packed_bwd, ws,
                     *(gp[k] for k in sb._GRAD_ORDER), dbias])
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        fn = build(tmp)

        def call(what):
            rc = fn(what, ptrs, n, t, c, cs.HEADS, cs.CH, stream)
            if rc:
                raise RuntimeError(f'scratch launch {what}: CUDA error {rc}')

        call(0)
        torch.cuda.synchronize()
        names = ('window_pass', 'weight_tiles', 'column_sums', 'dbias')
        ms = {name: cs.cuda_ms(lambda w=w: call(w))
              for w, name in enumerate(names)}
    print(json.dumps(dict(phase='k2_reduce_jobs', shape=list(xd.shape),
                          dtype='bf16', shift=shift, ms=ms,
                          nvidia_smi=cs.nvidia_smi_line())))
    return 0


if __name__ == '__main__':
    sys.exit(main())
