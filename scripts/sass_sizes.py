#!/usr/bin/env python3
"""SASS instruction count of every kernel of the port's CUDA sources, on
a machine with the CUDA toolkit (nvcc and cuobjdump).

    python3 scripts/sass_sizes.py [CSRC_DIR ...]

Each `*.cu` of each directory (default: srcaco2_tpu_torch/ops/csrc) is
compiled to a cubin with the package's flags in a temporary directory,
and `cuobjdump -sass` is counted per function. Prints one JSON line
{directory: {kernel: instructions}}; 16 bytes each on sm_90a.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def sizes(csrc, tmp):
    from srcaco2_tpu_torch.ops import build as B
    flags = [f for f in B.NVCC_FLAGS if f not in ('-shared', '-Xcompiler',
                                                  '-fPIC')]
    objdump = os.path.join(os.path.dirname(B._nvcc()), 'cuobjdump')
    srcs = sorted(Path(csrc).glob('*.cu'))
    procs = [(src, subprocess.Popen(
        [B._nvcc(), *flags, '-cubin', '-o',
         os.path.join(tmp, f'{src.stem}.cubin'), str(src)]))
        for src in srcs]
    out = {}
    for src, proc in procs:
        if proc.wait():
            raise RuntimeError(f'nvcc failed for {src}')
        sass = subprocess.run([objdump, '-sass',
                               os.path.join(tmp, f'{src.stem}.cubin')],
                              check=True, capture_output=True,
                              text=True).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r'Function : (\S+)', line)
            if m:
                name = m.group(1)
                out[name] = 0
            elif name and re.match(r'\s+/\*[0-9a-f]{4,}\*/', line):
                out[name] += 1
    return out


def main() -> int:
    dirs = sys.argv[1:] or [str(ROOT / 'srcaco2_tpu_torch/ops/csrc')]
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps({d: sizes(d, tmp) for d in dirs}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
