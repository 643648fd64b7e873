#!/usr/bin/env python3
"""Where one window of K2's (swin_block_bwd) window pass spends its
time, on one NVIDIA card, at the flagship's training shapes (bf16,
shift 4, 128 patches of 16x16 tokens, C=180, 6 heads, MLP 360).

    python3 scripts/k2_window_phases.py

The package has no probes, so this script copies the kernel sources into
a temporary directory and inserts, after fixed lines of that copy, a
probe: a CTA-wide barrier, then thread 0 of CTA 0 reads clock64(). It
builds a scratch kernel that runs the copy's window pass over every
window (CTA 0 among 511 others, as in the real launch), and prints one
JSON line: the SM cycles between consecutive probes of CTA 0, phase by
phase, and each phase's share. The probes' barriers add a little time of
their own. A line of the sources that moved fails the script.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PROBE = '''
__device__ unsigned long long swp_clk[32];
#define SWP(i) do { __syncthreads(); \\
  if (blockIdx.x == 0 && threadIdx.x == 0) swp_clk[i] = clock64(); } while (0)
'''

# (file, anchor, probe index, phase that ends at the probe); the probe
# goes after the anchor, or before it when the index is negative
PROBES = [
    ('swin_block_bwd_common.cuh',
     '  const BwdLayout L = make_bwd_layout<T, kPair>(d);\n', 0, 'start'),
    ('swin_block_common.cuh',
     '  if constexpr (kRecompute) store_rows(s.Y, s.ldy, sp.y, d.ck, d.ck);\n',
     1, 'recompute: x rows, LN1'),
    ('swin_block_common.cuh',
     '  if constexpr (kRecompute) store_rows(s.O, s.ldo, sp.o, d.ca, d.ca);\n',
     2, 'recompute: qkv and attention, 6 heads'),
    ('swin_block_common.cuh',
     'd.cn, proj_epi);\n  __syncthreads();\n', 3, 'recompute: proj'),
    ('swin_block_common.cuh',
     '    store_rows(s.Y, s.ldy, sp.y2, d.ck, d.ck);\n', 4, 'recompute: LN2'),
    ('swin_block_common.cuh',
     'd.chp, fc1_epi);\n    __syncthreads();\n', 5, 'recompute: fc1, GELU'),
    ('swin_block_bwd_common.cuh',
     '    g_sp[r * ck + cc] = v;\n  }\n  __syncthreads();\n', 6, 'g rows'),
    ('swin_block_bwd_common.cuh',
     '  colsum(cs + co.dbm2, p.ncs, c, gval);\n', 7, 'dbm2 column sums'),
    ('swin_block_bwd_common.cuh',
     '                     p.ncs);\n  __syncthreads();\n', 8,
     'dh = g.W2^T, GELU grad, dbm1'),
    ('swin_block_bwd_common.cuh',
     '  if constexpr (kBf16 && !std::is_same_v<GT, T>) stage_g();', -9,
     'dy2 = du.W1^T'),
    ('swin_block_bwd_common.cuh', '  colsum(cs + co.dbproj, p.ncs, c,', -10,
     'LN2 backward'),
    ('swin_block_bwd_common.cuh', 'ca, do_epi);\n  __syncthreads();\n', 11,
     'dbproj, dx2 rows, do = dx2.Wproj^T'),
    ('swin_block_bwd_common.cuh', '  // dy = dqkv . Wqkv^T (f32) -> D\n', -12,
     'attention backward, 6 heads'),
    ('swin_block_bwd_common.cuh', '  // LN1 backward (x read again', -13,
     'dy = dqkv.Wqkv^T'),
    ('swin_block_bwd_common.cuh',
     '        dx[x_row(r) * c + cc] = from_f32<DT>(X[r * ldx + cc] + v);\n'
     '      });\n', 14, 'LN1 backward, dx'),
]

# probes inside the head loops: the values read are the last head's;
# (file, anchor, index, step that ends at the probe, index it starts at)
HEAD_PROBES = [
    ('swin_block_common.cuh', '    const T* wq = wqkv + static_cast<size_t>(h)'
     ' * 3 * hp * d.ck;\n', 20, None, None),
    ('swin_block_common.cuh', '                           qkv_epi);\n'
     '      __syncthreads();\n', 21, 'recompute: bias slice, qkv', 20),
    ('swin_block_common.cuh', '    {\n      const int warp = threadIdx.x >> 5,'
     ' lane = threadIdx.x & 31;\n      for (int r = warp; r < NW;', -22,
     'recompute: S = q.k^T', 21),
    ('swin_block_common.cuh', '        if (lane == 0) s.rinv[r] = 1.f / sum;\n'
     '      }\n    }\n    __syncthreads();\n', 23, 'recompute: softmax',
     22),
    (None, None, 2, 'recompute: P.V, o rows', 23),
    ('swin_block_bwd_common.cuh',
     '      if (h + 1 < d.heads) stage_qkv(h + 1);\n', 25, None, None),
    ('swin_block_bwd_common.cuh', '    // p = e * (1/r) in f32', -26,
     'backward: S = q.k^T', 25),
    ('swin_block_bwd_common.cuh', '    // dp = do . v^T (-> T', -27,
     'backward: softmax', 26),
    ('swin_block_bwd_common.cuh', '    // rs = sum_j dp p (f32)', -28,
     'backward: dp, dv', 27),
    ('swin_block_bwd_common.cuh', '    // dq = ds . k, dk = ds^T . q', -29,
     'backward: ds', 28),
    (None, None, 12, 'backward: dq, dk', 29),
]

SCRATCH = r'''
#include "swin_block_bwd_common.cuh"
using namespace swin;

__global__ void __launch_bounds__(THREADS) window_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  window_backward<bf16, false, bf16, bf16, bf16>(p, p.blk[0], blockIdx.x,
                                                 smem);
}

extern "C" int run(const void* const* ptrs, int n_img, int t, int c,
                   int heads, int ch, unsigned long long* clk) {
  const Plan P = make_plan(2, n_img, t, c, heads, ch);
  BwdParams p{};
  set_shapes(p, P, 1);
  bind_block(p.blk[0], P, ptrs[0], ptrs[1], const_cast<void*>(ptrs[2]),
             ptrs + 3,
             static_cast<unsigned char*>(const_cast<void*>(ptrs[21])),
             ptrs + 22);
  const size_t smem = make_bwd_layout<bf16, false>(p.d).total;
  cudaError_t err = allow_smem(window_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_kernel<<<p.n_wins, THREADS, smem>>>(p);
  err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaMemcpyFromSymbol(clk, swp_clk, sizeof(unsigned long long) * 32));
}
'''


def patch(csrc, tmp):
    """Copy the sources to tmp with the probes inserted."""
    for f in os.listdir(csrc):
        shutil.copy(os.path.join(csrc, f), tmp)
    texts = {}
    probes = [p[:3] for p in PROBES] + [p[:3] for p in HEAD_PROBES if p[0]]
    for name, anchor, idx in probes:
        path = os.path.join(tmp, name)
        s = texts.get(name) or open(path).read()
        if s.count(anchor) != 1:
            raise RuntimeError(f'{name}: the probe line {anchor!r} moved')
        probe = f'  SWP({abs(idx)});\n'
        s = s.replace(anchor, anchor + probe if idx >= 0 else probe + anchor)
        texts[name] = s
    common = texts['swin_block_common.cuh']
    texts['swin_block_common.cuh'] = common.replace(
        'namespace swin {\n', 'namespace swin {\n' + PROBE, 1)
    for name, s in texts.items():
        with open(os.path.join(tmp, name), 'w') as f:
            f.write(s)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('k2_window_phases: no CUDA device visible', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from srcaco2_tpu_torch.ops import build as B
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
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        patch(str(B.CSRC), tmp)
        src, lib = os.path.join(tmp, 'phases.cu'), os.path.join(tmp, 'ph.so')
        with open(src, 'w') as f:
            f.write(SCRATCH)
        subprocess.run([B._nvcc(), *B.NVCC_FLAGS, '-I', tmp, '-o', lib, src],
                       check=True, capture_output=True, text=True)
        fn = ctypes.CDLL(lib).run
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        clk = (ctypes.c_ulonglong * 32)()
        for _ in range(2):      # the second run is the one read
            rc = fn(ptrs, n, t, c, cs.HEADS, cs.CH, clk)
            if rc:
                raise RuntimeError(f'scratch window pass: CUDA error {rc}')
    marks = sorted(PROBES, key=lambda p: abs(p[2]))
    total = clk[abs(marks[-1][2])] - clk[0]
    phases = [dict(phase=m[3], cycles=clk[abs(m[2])] - clk[abs(prev[2])],
                   share=(clk[abs(m[2])] - clk[abs(prev[2])]) / total)
              for prev, m in zip(marks, marks[1:])]
    last_head = [dict(step=p[3], cycles=clk[abs(p[2])] - clk[p[4]])
                 for p in HEAD_PROBES if p[3]]
    print(json.dumps(dict(phase='k2_window_phases', shape=list(xd.shape),
                          dtype='bf16', shift=shift, cta=0,
                          window_cycles=total, phases=phases,
                          last_head=last_head,
                          nvidia_smi=cs.nvidia_smi_line())))
    return 0


if __name__ == '__main__':
    sys.exit(main())
