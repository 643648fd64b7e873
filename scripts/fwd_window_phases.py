#!/usr/bin/env python3
"""Where one window of the Swin-block forward body spends its time, on
one NVIDIA card: K5 (swin_block_grouped) at the flagship's serving shapes
(bf16, 128 tiles of 16x16 tokens, C=180, 6 heads, MLP 360).

    python3 scripts/fwd_window_phases.py [CSRC_DIR ...]

The package has no probes, so for each kernel source directory (default:
srcaco2_tpu_torch/ops/csrc; another one, e.g. a `git archive` of an
earlier commit's, to compare) this script copies the sources into a
temporary directory and inserts, after fixed lines of that copy, a
probe: a CTA-wide barrier, then thread 0 of CTA 0 reads clock64(). It
builds the copy of swin_block_grouped.cu, runs it over every window
(CTA 0 among 511 others, as in the real launch) and prints one JSON line
per directory: the SM cycles between consecutive probes of CTA 0, phase
by phase, each phase's share, and the steps of the last head. Thread 0
also logs its own clock, without a barrier, at fixed points of every
ring stage of the staged products (gemm64_staged), and `ring` sums them
per product: the prologue (the first fills), the wait for each stage's
copies, the barrier, and the work (the next fill, the mma steps, the
epilogue) as warp 0 sees them. The probes' barriers and the log's
stores (its length is kept in shared memory) add a little time of their
own. A probed line that moved fails the script; each probe lists the
line as the forward body has it now and, where it differs, as it had it
before the staged body.
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
constexpr int SWP_LOG = 1024;
__device__ unsigned long long swp_ev[SWP_LOG];
__device__ int swp_code[SWP_LOG];
__device__ int swp_n;
__shared__ int swp_ns;     // the log's length, kept in shared memory
#define SWE(code) do { if (blockIdx.x == 0 && threadIdx.x == 0 && \\
  swp_ns < SWP_LOG) { swp_ev[swp_ns] = clock64(); \\
  swp_code[swp_ns++] = code; } } while (0)
'''

KERNEL = 'swin_block_grouped.cu'
COMMON = 'swin_block_common.cuh'

# (file, anchors, occurrences, probe index, phase that ends at the
# probe); the first anchor found `occurrences` times gets a probe after
# each occurrence, or before it when the index is negative
PROBES = [
    (KERNEL, ('  extern __shared__ __align__(16) unsigned char smem[];\n',),
     1, 0, 'start'),
    (COMMON, ('  const int c = d.c, hp = d.hp;\n',), 1, 1,
     'setup: group id, token table, weight vectors'),
    (COMMON, ('  if constexpr (kRecompute) store_rows(s.Y, s.ldy, sp.y, d.ck, '
              'd.ck);\n',), 1, 2, 'x rows, LN1'),
    (COMMON, ('  if constexpr (kRecompute) store_rows(s.O, s.ldo, sp.o, d.ca, '
              'd.ca);\n',), 1, 3, 'attention, 6 heads'),
    (COMMON, ('d.cn, proj_epi);\n  __syncthreads();\n',), 1, 4, 'proj'),
    (COMMON, ('kRecompute ? sp.rstd2 : nullptr);\n  __syncthreads();\n',), 1,
     5, 'LN2'),
    (COMMON, ('d.chp, gelu_epi);\n    __syncthreads();\n',
              'from_f32<T>(gelu<T>(u1));\n              });\n'
              '    __syncthreads();\n'), 1, 6, 'fc1, GELU'),
    (KERNEL, ('      sp);\n', '      Spill<T>{});\n'), 1, 7,
     'fc2, output rows'),
]

# probes inside the head loop: the values read are the last head's;
# (file, anchors, occurrences, index, step that ends at the probe, index
# it starts at)
HEAD_PROBES = [
    (COMMON, ('    const T* wq = wqkv + static_cast<size_t>(h) * 3 * hp * '
              'd.ck;\n',), 1, 20, None, None),
    # the staged and the unstaged branch
    (COMMON, ('qkv_epi);\n      __syncthreads();\n',), 2, 21,
     'bias slice (staged body), qkv', 20),
    (COMMON, ('    {\n      const int warp = threadIdx.x >> 5, lane = '
              'threadIdx.x & 31;\n      for (int r = warp; r < NW;',), 1, -22,
     'S = q.k^T + bias', 21),
    (COMMON, ('        if (lane == 0) s.rinv[r] = 1.f / sum;\n      }\n'
              '    }\n    __syncthreads();\n',), 1, 23, 'softmax', 22),
    (None, None, None, 3, 'P.V, o columns', 23),
]

# thread 0's log in gemm64_staged: (anchor, code, after the anchor)
RING_EVENTS = [
    ('  if constexpr (kAG) __threadfence();\n  __syncthreads();\n', 4, True),
    ('    cp_async_wait<kStages - 2>();\n', 0, False),
    ('    cp_async_wait<kStages - 2>();\n', 1, True),
    ("    __syncthreads();    // stage st landed; stage st - 1's slot is "
     'free\n', 2, True),
    ('  cp_async_wait<0>();\n}\n', 3, False),
]
RING_START, RING_TOP, RING_WAITED, RING_BARRIER, RING_END = 4, 0, 1, 2, 3

READ = '''
extern "C" int swp_read(unsigned long long* clk, unsigned long long* ev,
                        int* code, int* n) {
  using namespace swin;
  cudaError_t e = cudaMemcpyFromSymbol(clk, swp_clk, sizeof(*clk) * 32);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(ev, swp_ev, sizeof(*ev) * SWP_LOG);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(code, swp_code, sizeof(*code) * SWP_LOG);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, swp_n, sizeof(*n));
  return static_cast<int>(e);
}
'''


def patch(csrc, tmp):
    """Copy the sources to tmp with the probes inserted."""
    for f in os.listdir(csrc):
        if f.endswith(('.cu', '.cuh')):
            shutil.copy(os.path.join(csrc, f), tmp)
    texts = {}
    probes = [p[:4] for p in PROBES] + [p[:4] for p in HEAD_PROBES if p[0]]
    for name, anchors, count, idx in probes:
        s = texts.get(name) or open(os.path.join(tmp, name)).read()
        anchor = next((a for a in anchors if s.count(a) == count), None)
        if anchor is None:
            raise RuntimeError(f'{name}: the probe line {anchors[0]!r} '
                               'moved')
        probe = f'  SWP({abs(idx)});\n'
        s = s.replace(anchor, anchor + probe if idx >= 0 else probe + anchor)
        texts[name] = s
    common = texts[COMMON]
    for anchor, code, after in RING_EVENTS:
        if common.count(anchor) != 1:
            raise RuntimeError(f'{COMMON}: the ring line {anchor!r} moved')
        probe = f'    SWE({code});\n'
        common = common.replace(anchor, anchor + probe if after
                                else probe + anchor)
    texts[COMMON] = common.replace('namespace swin {\n',
                                   'namespace swin {\n' + PROBE, 1)
    kernel = texts[KERNEL]
    kernel = kernel.replace('  SWP(0);\n',
                            '  SWP(0);\n  if (threadIdx.x == 0) swp_ns = 0;\n')
    kernel = kernel.replace('  SWP(7);\n',
                            '  SWP(7);\n  if (blockIdx.x == 0 && '
                            'threadIdx.x == 0) swp_n = swp_ns;\n')
    texts[KERNEL] = kernel + READ
    for name, s in texts.items():
        with open(os.path.join(tmp, name), 'w') as f:
            f.write(s)


def phases(clk):
    """{window_cycles, phases, last_head} from one run's clock reads."""
    marks = sorted(PROBES, key=lambda p: abs(p[3]))
    total = clk[abs(marks[-1][3])] - clk[0]
    out = [dict(phase=m[4], cycles=clk[abs(m[3])] - clk[abs(prev[3])],
                share=(clk[abs(m[3])] - clk[abs(prev[3])]) / total)
           for prev, m in zip(marks, marks[1:])]
    head = [dict(step=p[4], cycles=clk[abs(p[3])] - clk[p[5]])
            for p in HEAD_PROBES if p[4]]
    return dict(window_cycles=total, phases=out, last_head=head)


def ring(ev, code, n):
    """Per staged product, in call order: its stages and thread 0's
    cycles in the prologue, in waiting for each stage's copies, in the
    stage barrier and in the work after it (to the next stage's top, or
    to the product's end)."""
    out, cur, last = [], None, {}
    for i in range(n):
        c, t = code[i], ev[i]
        if c == RING_START:
            cur = dict(stages=0, prologue=0, wait=0, barrier=0, work=0)
        elif cur is None:
            continue
        elif c == RING_TOP:
            if cur['stages']:
                cur['work'] += t - last[RING_BARRIER]
            else:
                cur['prologue'] = t - last[RING_START]
            cur['stages'] += 1
        elif c == RING_WAITED:
            cur['wait'] += t - last[RING_TOP]
        elif c == RING_BARRIER:
            cur['barrier'] += t - last[RING_WAITED]
        elif c == RING_END:
            cur['work'] += t - last[RING_BARRIER]
            out.append(cur)
            cur = None
        last[c] = t
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('fwd_window_phases: no CUDA device visible', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from srcaco2_tpu_torch.ops import build as B
    from srcaco2_tpu_torch.ops import swin_block as sb
    dirs = sys.argv[1:] or [str(B.CSRC)]
    dev, dt = torch.device('cuda'), torch.bfloat16
    x, params, groups, gid = cs.block_inputs(dev, torch.Generator()
                                             .manual_seed(0))
    xd = x.to(dt)
    packed = sb.pack_block_params(params, cs.HEADS, dt)
    out = torch.empty_like(xd)
    n_tiles, _, c = xd.shape
    args = [1, xd.data_ptr(), out.data_ptr(), gid.data_ptr(),
            groups.data_ptr(), *(t.data_ptr() for t in packed), n_tiles,
            groups.shape[0], c, cs.HEADS, cs.CH,
            torch.cuda.current_stream().cuda_stream]
    smi = cs.nvidia_smi_line()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for i, d in enumerate(dirs):     # one nvcc per directory, together
            src_dir = os.path.join(tmp, str(i))
            os.makedirs(src_dir)
            patch(d, src_dir)
            lib = os.path.join(src_dir, 'ph.so')
            jobs.append((d, lib, subprocess.Popen(
                [B._nvcc(), *B.NVCC_FLAGS, '-I', src_dir, '-o', lib,
                 os.path.join(src_dir, KERNEL)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        for d, lib, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f'nvcc failed for {d}:\n{log}')
        for d, lib, _ in jobs:
            so = ctypes.CDLL(lib)
            fn = so.swin_block_grouped_fwd
            fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 16 \
                + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            clk = (ctypes.c_ulonglong * 32)()
            ev = (ctypes.c_ulonglong * 1024)()
            code = (ctypes.c_int * 1024)()
            n = ctypes.c_int()
            for _ in range(2):      # the second run is the one read
                rc = fn(*args)
                torch.cuda.synchronize()
                if rc or so.swp_read(clk, ev, code, ctypes.byref(n)):
                    raise RuntimeError(f'{d}: probed K5 failed ({rc})')
            label = os.path.relpath(os.path.abspath(d), ROOT)
            print(json.dumps(dict(phase='fwd_window_phases', csrc=label,
                                  kernel='swin_block_grouped',
                                  shape=list(xd.shape), dtype='bf16', cta=0,
                                  **phases(clk),
                                  ring=ring(ev, code, n.value),
                                  nvidia_smi=smi)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
