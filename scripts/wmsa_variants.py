#!/usr/bin/env python3
"""K6 (windowed attention forward, window_attention.cu) built from one or
more source directories, timed side by side on one NVIDIA card at the
eval shape (bf16, 512 windows of 64 tokens, C=180, 6 heads, the shift-4
mask of a 64x64 image), with scratch copies that take parts of a body
away, step B of the mma body's redesign, and copies that keep less
precision.

    python3 scripts/wmsa_variants.py [--split] [--split-mma] [--ring]
                                     [--precision] [--masks]
                                     [LABEL=CSRC_DIR ...]

Each CSRC_DIR holds kernel sources (default: this tree's
srcaco2_tpu_torch/ops/csrc as `tree`; another, e.g. an earlier commit's
from `git archive`, to compare). Its window_attention.cu is built with
the package's flags in a temporary directory and its C entries are
called directly: the fma body (`window_attention_fwd`, every version
has it) and, where the source has it, the mma body
(`window_attention_mma_fwd`). Copies of the first directory's source
(the others' with --split):
- --split, the fma body: `no_products` (both FMA loops removed),
  `const_loads` (the global loads of q, k and v replaced by constants),
  `no_stores` (the output stores skipped at run time, the work that
  feeds them kept);
- --split-mma, the mma body: `mma_no_copy` (the window's qkv block not
  copied in), `mma_no_bias_mask` (the bias and mask not read),
  `mma_no_products` (both products' mma.sync calls removed, with the
  fragment loads and the softmax that feed only them), `mma_no_stores`
  (the output tile not stored) and `mma_plain_div` (the softmax's
  division left to the compiler, whose slow path takes denormal
  quotients and zero numerators);
- --ring, `ring`: step B of the mma body (RING below: persistent CTAs
  on a two-buffer bulk-copy ring), which lost to the shipped body; kept
  as the source of its measurement and of the bulk-copy / mbarrier
  helpers that K2 and K4 may take up;
- --precision, `mma_no_p_lo` and `mma_s_bf16` (PRECISION below).
The split copies' outputs are meaningless; the others are compared as
a whole build's and held to chip_smoke.py's wmsa_precision. A copy
whose anchor is not found once fails the script. With --masks, each
whole build's bodies are also timed with an all-zero mask
(`@zero_mask`) and with none (`@no_mask`).

For every build and body: the median ms of chip_smoke.py's graph_ms
(CUDA-graph replays of 20 calls), the mean of two rounds taken in the
order listed and then reversed; for whole builds, the output against
the plain version (window_attention_ref) and against the first build's
fma body (the number of elements that differ and the largest
difference), wmsa_precision's record, and two calls compared bit for
bit. Prints one JSON line.
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

STEM = 'window_attention'

# fma-body scratch copies: (name, [(anchor, replacement)]); an anchor that
# spans a loop names its first line and the loop is cut to its closing
# brace
SPLITS = {
    'no_products': [
        ('  for (int d = 0; d < hd; ++d) {\n', None),
        ('  for (int j = 0; j < n; ++j) {\n', None)],
    'const_loads': [
        ('    qT[d * QLD + i] = to_f32(row[0]) * p.scale;\n'
         '    ks[i * kld + d] = to_f32(row[p.c]);\n'
         '    vs[i * hd + d] = to_f32(row[2 * p.c]);\n',
         '    (void)row;\n'
         '    qT[d * QLD + i] = 0.25f * p.scale;\n'
         '    ks[i * kld + d] = 0.5f;\n'
         '    vs[i * hd + d] = 1.0f;\n')],
    'no_stores': [
        ('    if (on0) out[', '    if (on0 && p.scale < 0.f) out['),
        ('    if (on1) out[', '    if (on1 && p.scale < 0.f) out[')],
}
# mma-body scratch copies (--split-mma)
SPLITS_MMA = {
    'mma_no_copy': [
        ('  copy_in(tile, p.qkv + static_cast<size_t>(win) * n * c3, '
         '2 * n * c3, tid);\n', '')],
    'mma_no_bias_mask': [
        ('      const float2 b = BiasRows<TB>::widen(bias.v[hf][nt]);\n',
         '      const float2 b = make_float2(0.f, 0.f);\n'),
        ('        const float2 m = ld_pair(mrow + j);\n',
         '        const float2 m = make_float2(0.f, 0.f);\n'),
        ('  if (warp < units)\n    load_bias(', '  if (false)\n    load_bias('),
        ('    if (u != warp)\n      load_bias(', '    if (false)\n      load_bias(')],
    'mma_no_products': [
        ('      swin::mma_bf16(s[nt], a, in0 ? swin::ld32(k + d0) : 0u,\n'
         '                     in1 ? swin::ld32(k + d1) : 0u);\n', ''),
        ('      swin::mma_bf16(o[nd], hi, b0, b1);\n'
         '      swin::mma_bf16(o[nd], lo, b0, b1);\n', '')],
    'mma_plain_div': [
        ('    if (__any_sync(0xffffffffu, small)) {', '    if (true) {'),
        ('        s[nt][2 * hf] = div_scaled(s[nt][2 * hf], sum);\n'
         '        s[nt][2 * hf + 1] = div_scaled(s[nt][2 * hf + 1], sum);\n',
         '        s[nt][2 * hf] = s[nt][2 * hf] / sum;\n'
         '        s[nt][2 * hf + 1] = s[nt][2 * hf + 1] / sum;\n')],
    'mma_no_stores': [
        ('  copy_out(p.out + static_cast<size_t>(win) * n * p.c, otile,\n',
         '  if (p.scale < 0.f)\n'
         '  copy_out(p.out + static_cast<size_t>(win) * n * p.c, otile,\n')],
}


# step B of the mma body (--ring): persistent CTAs (one per SM, 16 warps)
# walking windows b, b + G, ... through two buffers of the window's qkv
# block and mask, each filled by bulk copies (cp.async.bulk, one thread,
# completion on an mbarrier) while the other window computes; the output
# tile leaves as in step A. Replaces step A's kernel and launch.
RING = r"""// mbarrier and bulk-copy helpers (sm_90)
__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ inline void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

struct RingLayout {
  size_t buf, otile, mask, bar, total;
};
constexpr size_t MASK_BYTES = sizeof(float) * MAX_N * MASK_LD;
__host__ __device__ inline RingLayout ring_layout(int c) {
  RingLayout L;
  L.buf = swin::align16(sizeof(bf16) * MAX_N * 3 * static_cast<size_t>(c));
  L.otile = 2 * L.buf;
  L.mask = L.otile + swin::align16(sizeof(bf16) * MAX_N *
                                   static_cast<size_t>(c));
  L.bar = L.mask + 2 * MASK_BYTES;
  L.total = L.bar + 2 * sizeof(uint64_t);
  return L;
}

// Window `win`'s qkv block and mask into buffer s, completing a phase of
// bar[s]: bulk copies by thread 0 where everything is 16-byte aligned,
// else copies by every thread, waited on here.
__device__ inline void fill(const MmaParams& p, unsigned char* smem,
                           const RingLayout& L, int s, int win, int tid) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar) + s;
  bf16* dst = reinterpret_cast<bf16*>(smem + s * L.buf);
  float* mdst = reinterpret_cast<float*>(smem + L.mask + s * MASK_BYTES);
  const int n = p.n, bytes = 2 * n * 3 * p.c;
  const bf16* src = p.qkv + static_cast<size_t>(win) * n * 3 * p.c;
  const float* msrc =
      p.mask ? p.mask + static_cast<size_t>(win % p.n_mask) * n * n : nullptr;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0
      && (!msrc || (n % 4 == 0 && (reinterpret_cast<uintptr_t>(msrc) & 15) == 0));
  if (aligned) {
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(bar, bytes + (msrc ? 4 * n * n : 0));
      bulk_load(dst, src, bytes, bar);
      if (msrc)
        for (int i = 0; i < n; ++i)
          bulk_load(mdst + i * MASK_LD, msrc + i * n, 4 * n, bar);
    }
  } else {
    copy_in(dst, src, bytes, tid);
    if (msrc) copy_mask(mdst, msrc, n, tid);
    swin::cp_async_commit();
    swin::cp_async_wait<0>();
    __syncthreads();
    if (tid == 0) mbar_arrive(bar);
  }
}

template <int HP, typename TB>
__global__ void __launch_bounds__(MMA_THREADS, 1)
window_attention_mma_kernel(const MmaParams p, int w) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  const RingLayout L = ring_layout(p.c);
  bf16* otile = reinterpret_cast<bf16*>(wsmem + L.otile);
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsmem + L.bar);
  const int n = p.n, c3 = 3 * p.c, G = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
  }
  for (int e = n * c3 / 2 + tid; e < MAX_N * c3 / 2; e += MMA_THREADS) {
    reinterpret_cast<uint32_t*>(wsmem)[e] = 0u;
    reinterpret_cast<uint32_t*>(wsmem + L.buf)[e] = 0u;
  }
  __syncthreads();
  for (int s = 0; s < 2; ++s)
    if (blockIdx.x + s * G < w) fill(p, wsmem, L, s, blockIdx.x + s * G, tid);

  const TB* bias = static_cast<const TB*>(p.bias);
  const bool bias_pair =
      (n & 1) == 0 && (reinterpret_cast<uintptr_t>(bias) % (2 * sizeof(TB))) == 0;
  const int row_tiles = (n + 15) / 16;
  int it = 0;
  for (int win = blockIdx.x; win < w; win += G, ++it) {
    const int s = it & 1;
    mbar_wait(&bar[s], (it >> 1) & 1);
    const bf16* tile = reinterpret_cast<const bf16*>(wsmem + s * L.buf);
    const float* mask =
        p.mask ? reinterpret_cast<const float*>(wsmem + L.mask + s * MASK_BYTES)
               : nullptr;
    for (int u = warp; u < p.heads * row_tiles; u += MMA_WARPS) {
      BiasRows<TB> rows;
      load_bias(rows, bias, n, u / row_tiles, 16 * (u % row_tiles), lane,
                bias_pair);
      attend_unit<HP, TB>(p, tile, otile, rows, mask, u / row_tiles,
                          16 * (u % row_tiles), lane);
    }
    __syncthreads();    // buffer s read, the output tile complete
    if (win + 2 * G < w) fill(p, wsmem, L, s, win + 2 * G, tid);
    copy_out(p.out + static_cast<size_t>(win) * n * p.c, otile,
             2 * n * p.c, tid);
    __syncthreads();    // the output tile free
  }
}

template <int HP, typename TB>
int launch_mma(const MmaParams& p, int w, cudaStream_t stream) {
  const size_t smem = ring_layout(p.c).total;
  static int smem_set = 0;
  if (smem_set < static_cast<int>(smem)) {
    cudaError_t err = cudaFuncSetAttribute(
        window_attention_mma_kernel<HP, TB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = static_cast<int>(smem);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_attention_mma_kernel<HP, TB>, MMA_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = w < sms * per_sm ? w : sms * per_sm;
  window_attention_mma_kernel<HP, TB><<<grid, MMA_THREADS, smem, stream>>>(
      p, w);
  return static_cast<int>(cudaGetLastError());
}

"""
RING_EDITS = [
    ('constexpr int MMA_WARPS = 8;', 'constexpr int MMA_WARPS = 16;'),
    ('template <int HP, typename TB>\n__global__ void __launch_bounds__'
     '(MMA_THREADS, 2)\n', 'template <typename TB>\nint launch_mma_hp(', RING),
]


# scratch copies of the mma body that keep less precision than it does
# (--precision): `mma_no_p_lo` (the P_lo pass over v removed) and
# `mma_s_bf16` (the scaled scores rounded to bf16); chip_smoke.py's
# wmsa_precision must refuse both
PRECISION = {
    'mma_no_p_lo': [('      swin::mma_bf16(o[nd], lo, b0, b1);\n', '')],
    'mma_s_bf16': [
        ('      float a0 = s[nt][2 * hf] * p.scale + b.x;\n'
         '      float a1 = s[nt][2 * hf + 1] * p.scale + b.y;\n',
         '      float a0 = __bfloat162float(__float2bfloat16(\n'
         '          s[nt][2 * hf] * p.scale)) + b.x;\n'
         '      float a1 = __bfloat162float(__float2bfloat16(\n'
         '          s[nt][2 * hf + 1] * p.scale)) + b.y;\n')],
}
# copies whose outputs are compared as a whole build's
COMPARED = {'ring', *PRECISION}


def cut_loop(src, first_line):
    """src without the loop that starts at `first_line` (to its closing
    brace)."""
    start = src.index(first_line)
    depth, i = 0, start
    while True:
        ch = src[i]
        if ch == '{':
            depth += 1
        elif ch == '}':
            depth -= 1
            if depth == 0:
                break
        i += 1
    return src[:start] + src[i + 2:]


def variant(src, edits):
    """src with each edit: (anchor, replacement), (first line of a loop,
    None: the loop cut) or (start anchor, end anchor, replacement of the
    text from the start anchor up to the end anchor)."""
    for edit in edits:
        for anchor in edit[:-1] if len(edit) == 3 else edit[:1]:
            if src.count(anchor) != 1:
                raise RuntimeError(f'anchor not found once: {anchor!r}')
        if len(edit) == 3:
            a, b = src.index(edit[0]), src.index(edit[1])
            src = src[:a] + edit[2] + src[b:]
        elif edit[1] is None:
            src = cut_loop(src, edit[0])
        else:
            src = src.replace(*edit)
    return src


def build(versions, tmp):
    """{label: CDLL} of each (label, source dir, edits or None)."""
    from srcaco2_tpu_torch.ops import build as B
    jobs = []
    for label, d, edits in versions:
        work = os.path.join(tmp, label.replace('/', '_'))
        os.makedirs(work)
        for f in Path(d).iterdir():
            if f.suffix in ('.cu', '.cuh'):
                text = f.read_text()
                if f.name == f'{STEM}.cu' and edits:
                    text = variant(text, edits)
                Path(work, f.name).write_text(text)
        lib = os.path.join(work, f'{STEM}.so')
        jobs.append((label, lib, subprocess.Popen(
            [B._nvcc(), *B.NVCC_FLAGS, '-o', lib,
             os.path.join(work, f'{STEM}.cu')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {label}:\n{log}')
        libs[label] = ctypes.CDLL(lib)
    return libs


def bodies(lib):
    """{body: fn(qkv, bias_bf16, bias_f32, mask, out)} of one library."""
    import torch
    import chip_smoke as cs
    stream = lambda: torch.cuda.current_stream().cuda_stream
    w, n, c, heads = cs.WMSA_W, cs.WMSA_N, cs.C, cs.HEADS
    scale = (c // heads) ** -0.5
    err = lib.swin_error_name
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p

    def check(rc, what):
        if rc:
            raise RuntimeError(f'{what}: CUDA error {rc} ({err(rc).decode()})')

    fma = lib.window_attention_fwd
    fma.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fma.restype = ctypes.c_int
    ptr = lambda m: None if m is None else m.data_ptr()
    nw = lambda m: 0 if m is None else m.shape[0]
    out = {'fma': lambda q, b16, b32, m, o: check(fma(
        1, q.data_ptr(), b32.data_ptr(), ptr(m), o.data_ptr(), w, n, c,
        heads, nw(m), scale, stream()), 'fma')}
    if hasattr(lib, 'window_attention_mma_fwd'):
        mma = lib.window_attention_mma_fwd
        mma.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_void_p])
        mma.restype = ctypes.c_int
        out['mma'] = lambda q, b16, b32, m, o: check(mma(
            q.data_ptr(), b16.data_ptr(), 1, ptr(m), o.data_ptr(), w, n, c,
            heads, nw(m), scale, stream()), 'mma')
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('wmsa_variants: no CUDA device visible', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from srcaco2_tpu_torch.ops import window_attention as wa
    args = sys.argv[1:]
    split = '--split' in args
    split_mma = '--split-mma' in args
    ring = '--ring' in args
    precision = '--precision' in args
    masks = '--masks' in args
    dirs = [a.split('=', 1) for a in args if not a.startswith('--')]
    dirs = dirs or [('tree', str(ROOT / 'srcaco2_tpu_torch/ops/csrc'))]
    versions = [(label, d, None) for label, d in dirs]
    if split:
        versions += [(f'{label}/{name}', d, edits) for label, d in dirs
                     for name, edits in SPLITS.items()]
    if ring:
        versions += [(f'{label}/ring', d, RING_EDITS) for label, d in dirs[:1]]
    if precision:
        versions += [(f'{label}/{name}', d, edits) for label, d in dirs[:1]
                     for name, edits in PRECISION.items()]
    if split_mma:
        versions += [(f'{label}/{name}', d, edits) for label, d in dirs[:1]
                     for name, edits in SPLITS_MMA.items()]
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    _, qkv, bias, mask, _ = cs.wmsa_cases(dev, gen)[1]
    q = qkv.to(torch.bfloat16)
    b16 = bias.to(torch.bfloat16)
    b32 = b16.float()
    ref16 = wa.window_attention_ref(q, b16, mask, cs.HEADS)
    ref = ref16.float()
    rec = dict(shape=list(q.shape), heads=cs.HEADS, mask='shift 4 (nW=64)',
               versions=[v[0] for v in versions], ms={}, ms_each={},
               vs_plain={}, vs_first_fma={}, bit_identical_twice={},
               precision={})
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(versions, tmp)
        calls = [(f'{label}:{body}', fn) for label, _, _ in versions
                 for body, fn in bodies(libs[label]).items()]
        first = None
        for key, fn in calls:
            if '/' in key and key.split('/')[1].split(':')[0] not in COMPARED:
                continue        # a split copy: no output to compare
            o1, o2 = (torch.empty(q.shape[0], q.shape[1], cs.C,
                                  dtype=q.dtype, device=dev)
                      for _ in range(2))
            fn(q, b16, b32, mask, o1)
            fn(q, b16, b32, mask, o2)
            torch.cuda.synchronize()
            rec['bit_identical_twice'][key] = cs.bit_identical(o1, o2)
            d = (o1.float() - ref).abs()
            rec['vs_plain'][key] = dict(n_differ=int((d > 0).sum()),
                                        max_abs=float(d.max()))
            rec['precision'][key] = cs.wmsa_precision(o1, ref16, q)
            if first is None:
                first = o1.float()
            d = (o1.float() - first).abs()
            rec['vs_first_fma'][key] = dict(n_differ=int((d > 0).sum()),
                                            max_abs=float(d.max()))
        o = torch.empty(q.shape[0], q.shape[1], cs.C, dtype=q.dtype,
                        device=dev)
        times = {k: [] for k, _ in calls}
        for key, fn in calls + calls[::-1]:
            times[key].append(cs.graph_ms(lambda: fn(q, b16, b32, mask, o)))
        rec['ms'] = {k: sum(t) / len(t) for k, t in times.items()}
        rec['ms_each'] = times
        if masks:
            for key, fn in calls:
                if '/' in key:
                    continue
                for name, m in (('zero_mask', torch.zeros_like(mask)),
                                ('no_mask', None)):
                    rec['ms'][f'{key}@{name}'] = cs.graph_ms(
                        lambda: fn(q, b16, b32, m, o))
    rec['bound_ms'] = cs.bound(
        4 * cs.WMSA_W * cs.HEADS * cs.WMSA_N ** 2 * (cs.C // cs.HEADS),
        q.numel() * 2 + q.shape[0] * q.shape[1] * cs.C * 2
        + b16.numel() * 2 + mask.numel() * 4)
    rec['nvidia_smi'] = cs.nvidia_smi_line()
    print(json.dumps(dict(phase='wmsa_variants', **rec)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
