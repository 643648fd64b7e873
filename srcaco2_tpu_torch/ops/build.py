"""Lazy nvcc build of the port's CUDA sources, bound with ctypes.

Every `csrc/*.cu` is compiled on first use into a shared library with a
plain C interface, under `build/` next to this file (listed in
.gitignore). The library's name carries a hash of its source and flags,
so an edited source is rebuilt and an unchanged one is reused. Nothing
here runs on import: the CPU test machines have no nvcc.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD = Path(__file__).resolve().parent / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (PATH or /usr/local/cuda/bin): '
                           'the CUDA kernels build only on a machine with '
                           'the CUDA toolkit')
    return path


def _target(src: Path) -> Path:
    """The library of one source: its name hashes the source, every
    header under csrc/ (a source may include any of them) and the
    flags, so an edited header rebuilds its includers."""
    h = hashlib.sha1(src.read_bytes())
    for hdr in sorted(CSRC.glob('*.cuh')):
        h.update(hdr.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD / f'{src.stem}-{h.hexdigest()[:12]}.so'


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Build every source whose library is missing, one nvcc process per
    source, all started together. verbose adds `-Xptxas -v` (registers,
    shared memory, spills per kernel). Returns {source stem: compiler
    output} for the sources built by this call; raises with the
    compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC.glob('*.cu')):
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS,
               *(('-Xptxas', '-v') if verbose else ()),
               '-o', str(tmp), str(src)]
        jobs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    logs, failed = {}, []
    for stem, (proc, tmp, out) in jobs.items():
        logs[stem], _ = proc.communicate()
        if proc.returncode:
            failed.append(stem)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + ', '.join(
            f'{s}.cu:\n{logs[s]}' for s in failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, built first if needed."""
    build_all()
    return ctypes.CDLL(str(_target(CSRC / f'{stem}.cu')))
