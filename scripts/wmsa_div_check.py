#!/usr/bin/env python3
"""K6's softmax divisions (window_attention.cu: div_fast, div_scaled)
against the correctly rounded f32 quotient, on one NVIDIA card.

    python3 scripts/wmsa_div_check.py [--pairs N]

The mma body divides each probability's numerator e in [0, 1] by its
row sum in [1, 64] without the compiler's division, whose slow path
takes zero numerators and denormal quotients: div_fast where every
quotient of a warp's row is normal, div_scaled where one may not be.
This script copies the two device functions out of the source, builds
them into a small test kernel with the package's nvcc flags, and
compares div_scaled(e, sum) on every pair, and div_fast(e, sum) on the
pairs with e = 0 or e >= 2^-100, bit for bit with the f64 quotient
rounded to f32, which is the correctly rounded f32 quotient
(53 >= 2 * 24 + 2), for N random pairs (default
2^26): e log-uniform over [2^-149, 1] with random mantissas, with an
extra eighth drawn below 2^-100 (the denormal quotients' path), some
exact zeros and ones, and sum with random mantissas over [1, 64].
Prints one JSON line with the counts of pairs that differ (0 is the
pass), and exits 1 if any does.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNEL = r'''
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
%s
__global__ void div_check_kernel(const float* e, const float* s, float* p,
                                 float* f, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i < n) {
    p[i] = div_scaled(e[i], s[i]);
    f[i] = div_fast(e[i], s[i]);
  }
}
extern "C" int div_check(const float* e, const float* s, float* p, float* f,
                         long long n, void* stream) {
  div_check_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(e, s, p, f, n);
  return static_cast<int>(cudaGetLastError());
}
'''


def device_functions(src: str) -> str:
    """div_fast and div_scaled as the source has them."""
    start = src.index('__device__ inline float div_fast(')
    end = src.index('__device__ inline float div_scaled(')
    end = src.index('\n}\n', end) + 3
    return src[start:end]


def inputs(n, gen, dev):
    import torch
    mant = 1 + torch.rand(n, generator=gen, dtype=torch.float64)
    expo = torch.randint(-149, 1, (n,), generator=gen)
    small = torch.rand(n, generator=gen) < 0.125
    expo = torch.where(small, torch.randint(-149, -100, (n,), generator=gen),
                       expo)
    e = torch.ldexp(mant, expo.double()).float()
    e = torch.where(e > 1, torch.ones_like(e), e)
    e[: n // 64] = 0.0
    e[n // 64: n // 32] = 1.0
    s = torch.ldexp(1 + torch.rand(n, generator=gen, dtype=torch.float64),
                    torch.randint(0, 6, (n,), generator=gen).double()).float()
    return e.to(dev), s.to(dev)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--pairs', type=int, default=1 << 26)
    n = ap.parse_args().pairs
    if not torch.cuda.is_available():
        print('wmsa_div_check: no CUDA device visible', file=sys.stderr)
        return 2
    from srcaco2_tpu_torch.ops import build as B
    src = (ROOT / 'srcaco2_tpu_torch/ops/csrc/window_attention.cu').read_text()
    with tempfile.TemporaryDirectory() as tmp:
        cu, lib = os.path.join(tmp, 'div_check.cu'), os.path.join(tmp, 'd.so')
        Path(cu).write_text(KERNEL % device_functions(src))
        r = subprocess.run([B._nvcc(), *B.NVCC_FLAGS, '-o', lib, cu],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f'nvcc failed:\n{r.stdout}{r.stderr}')
        fn = ctypes.CDLL(lib).div_check
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        dev = torch.device('cuda')
        gen = torch.Generator().manual_seed(0)
        bad = bad_fast = small = denormal = 0
        worst = None
        for lo in range(0, n, 1 << 24):
            m = min(1 << 24, n - lo)
            e, s = inputs(m, gen, dev)
            p, f = torch.empty_like(e), torch.empty_like(e)
            rc = fn(e.data_ptr(), s.data_ptr(), p.data_ptr(), f.data_ptr(),
                    m, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f'launch failed: CUDA error {rc}')
            want = (e.double() / s.double()).float().view(torch.int32)
            diff = p.view(torch.int32) != want
            fast = (e == 0) | (e >= 2.0 ** -100)
            bad += int(diff.sum())
            bad_fast += int(((f.view(torch.int32) != want) & fast).sum())
            small += int((e < 2.0 ** -100).sum())
            denormal += int((want.view(torch.float32) < 2.0 ** -126).sum())
            if worst is None and bool(diff.any()):
                i = int(diff.nonzero()[0])
                worst = dict(e=float(e[i]), sum=float(s[i]), got=float(p[i]),
                             want=float(want.view(torch.float32)[i]))
    import chip_smoke as cs
    print(json.dumps(dict(phase='wmsa_div_check', pairs=n,
                          div_scaled_differ=bad, div_fast_differ=bad_fast,
                          below_2_100=small, denormal_quotients=denormal,
                          first_difference=worst,
                          nvidia_smi=cs.nvidia_smi_line())))
    return 1 if bad or bad_fast else 0


if __name__ == '__main__':
    sys.exit(main())
