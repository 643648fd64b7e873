#!/usr/bin/env python3
"""The Swin-block forward kernels K5 (swin_block_grouped), K1
(swin_block_fwd) and K3 (swin_block_pair_fwd) of this tree against the
same kernels built from other source directories, on one NVIDIA card:
outputs bit for bit and times, at chip_smoke.py's shapes.

    python3 scripts/fwd_csrc_compare.py CSRC_DIR [CSRC_DIR ...]

Each CSRC_DIR holds kernel sources (e.g. an earlier commit's
srcaco2_tpu_torch/ops/csrc from `git archive`, or a scratch variant of
this tree's). Its three forward sources are built with the package's
flags in a temporary directory, and the package's wrappers are bound to
them in turn, so every version gets the same inputs through the same
Python code. For each kernel: whether each version's bf16 and f32
outputs equal this tree's bit for bit (and the largest difference), and
each version's bf16 time, the mean of two medians of chip_smoke.py's
cuda_ms taken in the order this tree, the others, the others reversed,
this tree. Prints one JSON line.
"""
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEMS = ('swin_block_grouped', 'swin_block_fwd', 'swin_block_pair_fwd')


def build(dirs, tmp):
    """[{stem: CDLL}] of each directory's forward sources."""
    from srcaco2_tpu_torch.ops import build as B
    jobs = []
    for i, d in enumerate(dirs):
        for stem in STEMS:
            lib = os.path.join(tmp, f'{stem}-{i}.so')
            jobs.append((i, stem, lib, subprocess.Popen(
                [B._nvcc(), *B.NVCC_FLAGS, '-o', lib,
                 os.path.join(d, f'{stem}.cu')], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = [{} for _ in dirs]
    for i, stem, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {dirs[i]}/{stem}.cu:\n{log}')
        libs[i][stem] = ctypes.CDLL(lib)
    return libs


@contextlib.contextmanager
def bound_to(libs):
    """The package's wrappers launch the kernels of `libs` ({stem: CDLL};
    None: the package's own)."""
    from srcaco2_tpu_torch.ops import swin_block as sb
    saved = sb.library
    if libs is not None:
        sb.library = lambda stem: libs[stem]
    sb._fwd_kernel.cache_clear()
    sb._grouped_kernel.cache_clear()
    try:
        yield
    finally:
        sb.library = saved
        sb._fwd_kernel.cache_clear()
        sb._grouped_kernel.cache_clear()


def cases(dev):
    """{kernel: fn(dtype) -> a call of its wrapper on seeded inputs}."""
    import torch
    import chip_smoke as cs
    from srcaco2_tpu_torch.ops import swin_block as sb
    gen = torch.Generator().manual_seed(0)
    x5, p5, groups, gid = cs.block_inputs(dev, gen)
    x1, p1, b1, _ = cs.train_block_inputs(dev, gen, cs.WS // 2)
    idx1 = sb._window_index_on(cs.PATCH, cs.PATCH, cs.WS, cs.WS // 2,
                               str(dev))
    x3, _, pa, ba, pb, bb = cs.pair_inputs(dev, gen)
    idx3 = [sb._window_index_on(cs.PATCH, cs.PATCH, cs.WS, s, str(dev))
            for s in (0, cs.WS // 2)]

    def k5(dt):
        xd, pk = x5.to(dt), sb.pack_block_params(p5, cs.HEADS, dt)
        return lambda: sb.fused_swin_block_grouped(
            xd, p5, groups, gid, heads=cs.HEADS, compute_dtype=dt, packed=pk)

    def k1(dt):
        xd, pk = x1.to(dt), sb.pack_block_params(p1, cs.HEADS, dt)
        return lambda: sb.swin_block_fwd(xd, b1, idx1, pk, heads=cs.HEADS,
                                         compute_dtype=dt)

    def k3(dt):
        xd = x3.to(dt)
        (pk_a, pk_b), _ = cs.pair_packs(pa, pb, dt)
        return lambda: sb.swin_block_pair_fwd(
            xd, ba, idx3[0], pk_a, bb, idx3[1], pk_b, heads=cs.HEADS,
            compute_dtype=dt)

    return dict(swin_block_grouped=k5, swin_block_fwd=k1,
                swin_block_pair_fwd=k3)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('fwd_csrc_compare: no CUDA device visible', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from srcaco2_tpu_torch.ops import build as B
    dirs = sys.argv[1:]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    B.build_all()
    dev = torch.device('cuda')
    labels = ['this tree'] + [os.path.relpath(os.path.abspath(d), ROOT)
                              for d in dirs]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        versions = [None] + build(dirs, tmp)
        for name, make in cases(dev).items():
            rec = dict(bit_identical={}, max_abs_diff={}, ms={})
            for dt_name, dt in (('bf16', torch.bfloat16),
                                ('f32', torch.float32)):
                call = make(dt)
                outs = []
                for libs in versions:
                    with bound_to(libs):
                        outs.append(call())
                torch.cuda.synchronize()
                for label, o in zip(labels[1:], outs[1:]):
                    rec['bit_identical'].setdefault(label, {})[dt_name] = \
                        cs.bit_identical(outs[0], o)
                    rec['max_abs_diff'].setdefault(label, {})[dt_name] = \
                        float((outs[0].float() - o.float()).abs().max())
                del outs
            call = make(torch.bfloat16)
            order = list(range(len(versions)))
            times = {i: [] for i in order}
            for i in order + order[::-1]:
                with bound_to(versions[i]):
                    times[i].append(cs.cuda_ms(call))
            rec['ms'] = {labels[i]: sum(t) / len(t) for i, t in times.items()}
            rec['ms_each'] = {labels[i]: t for i, t in times.items()}
            out[name] = rec
    print(json.dumps(dict(phase='fwd_csrc_compare', versions=labels,
                          kernels=out, nvidia_smi=cs.nvidia_smi_line())))
    return 0


if __name__ == '__main__':
    sys.exit(main())
