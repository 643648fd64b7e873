#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srcaco2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out-dir DIR]

With --out-dir, the nvcc log (-Xptxas -v) and a JSON record of the run
are written to DIR as well.

Phases, each printing one JSON line; any failure exits non-zero:
  card          name and power limit (nvidia-smi), torch and CUDA versions
  build         nvcc build of every kernel source under
                srcaco2_tpu_torch/ops/csrc
  kernel_check  each kernel against its plain PyTorch version on the card
                at the serving shapes, f32 and bf16, with stated tolerances
  kernel_time   median ms of each kernel and its plain version beside the
                least time the card could take (bound)
  serve         the x8 SwinIR flagship (bf16, random seeded weights, full
                depth) served through SRServer: 3 requests, one with a
                ragged tail; launch counts of the main path; images/s;
                plain-path vs kernel-path agreement
  serve_profile device time of one served batch by kernel (torch.profiler)
  kernels       the kernels line (one JSON object)
followed by the nvidia-smi line and, last, the {"ok": true, ...} line.
Imports nothing of JAX or of the JAX package.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM, NVIDIA data sheet: dense bf16 tensor-core peak, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# flagship (README.md:91-100, config/net_defaults.py): x8 SwinIR, C=180,
# 6 stages x 6 blocks of 6 heads, window 8, MLP ratio 2, served at
# batch 8 on 64x64 LR (512^2 out)
BATCH, LR, SCALE, C, HEADS, CH, WS = 8, 64, 8, 180, 6, 360, 8
TOL = {
    # f32: the kernel and the plain version differ only in the order of
    # their f32 sums (K <= 360)
    'f32': dict(atol=1e-3, rtol=0.0),
    # bf16: both round activations and weights to bf16 at the same
    # points, but a different f32 sum order can flip a bf16 rounding
    # (2^-8 relative) inside the block and of the stored output, whose
    # step is 2^-7 * |out| (0.031 for |out| in [4, 8))
    'bf16': dict(atol=3e-2, rtol=2.0 ** -7),
}


def emit(phase, **kw):
    rec = {'phase': phase, **kw}
    print(json.dumps(rec), flush=True)
    return rec


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5, per=10):
    """Median over `reps` rounds of the mean device time of `per`
    back-to-back calls (CUDA events), after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def block_inputs(dev, gen):
    """Seeded block inputs at the serving shapes: unit-variance tiles,
    one block's weights, the shifted layout's group table and groups."""
    import torch
    from srcaco2_tpu_torch.models import swin_fused as sf
    from srcaco2_tpu_torch.ops import swin_block as sb
    tl = 2 * WS
    n_tiles = BATCH * (LR // tl) ** 2

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev)

    params = {
        'ln1_weight': 1 + randn(C, std=0.1), 'ln1_bias': randn(C, std=0.1),
        'qkv_kernel': randn(C, 3 * C, std=C ** -0.5),
        'qkv_bias': randn(3 * C, std=0.02),
        'proj_kernel': randn(C, C, std=C ** -0.5),
        'proj_bias': randn(C, std=0.02),
        'ln2_weight': 1 + randn(C, std=0.1), 'ln2_bias': randn(C, std=0.1),
        'mlp1_kernel': randn(C, CH, std=C ** -0.5),
        'mlp1_bias': randn(CH, std=0.02),
        'mlp2_kernel': randn(CH, C, std=CH ** -0.5),
        'mlp2_bias': randn(C, std=0.02)}
    table = randn(1, (2 * WS - 1) ** 2, HEADS, std=0.02)
    rel = sb.build_attn_bias(table, tl, tl, WS, shifts=(0,))
    masks = torch.as_tensor(sf._tile_group_masks(WS, WS // 2)).to(dev)
    groups = (rel[0][None] + masks[:, None]).contiguous()
    gid = torch.as_tensor(
        sf._tile_layout(BATCH, LR, LR, WS, WS // 2).gid).to(dev)
    x = randn(n_tiles, tl * tl, C)
    return x, params, groups, gid


def block_bound(x, packed, groups, gid):
    """(bound ms, 'operations' or 'bytes') of one grouped block call:
    the larger of its matrix-product FLOPs (windowed attention, model
    widths) over the bf16 peak and its bytes (inputs read once, output
    written once) over the memory rate."""
    tokens = x.shape[0] * x.shape[1]
    flops = tokens * (2 * (3 * C * C + C * C + 2 * C * CH)
                      + 2 * 2 * WS * WS * C)
    nbytes = 2 * x.numel() * x.element_size() + groups.numel() * 4 \
        + gid.numel() * 4 + sum(t.numel() * t.element_size()
                                for t in packed)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def profile_batch(srv, lr_u8, ms_per_batch):
    """Device time of one served batch by device activity (kernels and
    copies, torch.profiler), and the device's busy share of the batch's
    unprofiled wall time `ms_per_batch`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.from_numpy(lr_u8).to(srv.device)
    srv._serve(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        srv._serve(x)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise RuntimeError('the profiler recorded no device time')
    return dict(device_ms=device_ms, ms_per_batch=ms_per_batch,
                device_busy_share=device_ms / ms_per_batch,
                top=[dict(name=k[:80], ms=ms, calls=n, share=ms / device_ms)
                     for k, ms, n in rows[:10]])


def flagship_args():
    from srcaco2_tpu_torch.config.net_defaults import init_net_g
    args = {'scale': SCALE, 'n_channels': 1, 'h_size': 128, 'amp': True}
    netG = init_net_g({'net_type': 'SwinIR'}, args)
    netG['swinir_upsampler'] = 'pixelshuffledirect'
    args['netG'] = netG
    return args


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out-dir', help='also write logs and a JSON record '
                    'of the run here')
    out_dir = ap.parse_args().out_dir
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 2
    import numpy as np
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.models.swin_fused import FusedBlockStack
    from srcaco2_tpu_torch.inference.serve import SRServer
    from srcaco2_tpu_torch.ops import build, swin_block as sb

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 = true f32
    dev = torch.device('cuda')
    smi = nvidia_smi_line()
    emit('card', nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    if out_dir:
        with open(os.path.join(out_dir, 'build_log.txt'), 'w') as f:
            for stem, log in logs.items():
                f.write(f'== {stem}.cu\n{log}\n')
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    emit('build', seconds=build_s, built=sorted(logs), ptxas=ptxas)

    gen = torch.Generator().manual_seed(0)
    x, params, groups, gid = block_inputs(dev, gen)
    errs = {}
    for name, dt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        xd = x.to(dt)
        out_k = sb.fused_swin_block_grouped(xd, params, groups, gid,
                                            heads=HEADS, compute_dtype=dt)
        torch.cuda.synchronize()
        out_r = sb.swin_block_grouped_ref(xd, params, groups, gid,
                                          heads=HEADS, compute_dtype=dt)
        diff = (out_k.float() - out_r.float()).abs()
        ref_abs = out_r.float().abs()
        tol = TOL[name]
        bad = int((diff > tol['atol'] + tol['rtol'] * ref_abs).sum())
        errs[name] = dict(max_abs_err=float(diff.max()),
                          max_rel_err=float((diff / ref_abs.clamp_min(1e-3))
                                            .max()),
                          n_outside=bad, finite=bool(
                              torch.isfinite(out_k.float()).all()), **tol)
    rec = emit('kernel_check', kernel='swin_block_grouped',
               shape=list(x.shape), heads=HEADS, groups=groups.shape[0],
               **errs)
    if any(e['n_outside'] or not e['finite'] for e in errs.values()):
        print('chip_smoke: kernel_check failed', file=sys.stderr)
        return 1

    xb = x.to(torch.bfloat16)
    packed = sb.pack_block_params(params, HEADS, torch.bfloat16)
    kernel_ms = cuda_ms(lambda: sb.fused_swin_block_grouped(
        xb, params, groups, gid, heads=HEADS, compute_dtype=torch.bfloat16,
        packed=packed))
    plain_ms = cuda_ms(lambda: sb.swin_block_grouped_ref(
        xb, params, groups, gid, heads=HEADS, compute_dtype=torch.bfloat16))
    bound_ms, bound_by, flops, nbytes = block_bound(xb, packed, groups, gid)
    emit('kernel_time', kernel='swin_block_grouped', dtype='bf16',
         ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by, flops=flops, bytes=nbytes,
         tflops=flops / kernel_ms / 1e9, nvidia_smi=smi)
    del x, xb, params, groups, gid, packed

    args = flagship_args()
    state = define_g(args, dev, seed=0).state_dict()
    srv = SRServer(args=args, state_dict=state, batch_size=BATCH,
                   lr_hw=(LR, LR), device=dev)
    rng = np.random.default_rng(0)
    req_a = rng.integers(0, 256, (11, 1, LR, LR), dtype=np.uint8)
    req_b = rng.integers(0, 256, (BATCH, 1, LR, LR), dtype=np.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sb.fused_swin_block_grouped.launches = 0
    t0 = time.perf_counter()
    out_a = srv(req_a)          # 2 forwards: 8, then 3 padded to 8
    out_b = srv(req_b)
    out_c = srv(req_b)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = sb.fused_swin_block_grouped.launches
    forwards = 4
    n_blocks = sum(m.depth for m in srv.model.modules()
                   if isinstance(m, FusedBlockStack))
    peak_mem = torch.cuda.max_memory_allocated()
    ok_shapes = (out_a.shape == (11, 1, LR * SCALE, LR * SCALE)
                 and out_b.shape == (BATCH, 1, LR * SCALE, LR * SCALE)
                 and out_a.dtype == np.uint8 and out_b.dtype == np.uint8)
    deterministic = bool(np.array_equal(out_b, out_c))
    ips = srv.throughput(iters=10)

    # plain path vs kernel path on one batch: swap the block function of
    # every stage for the plain version
    stacks = [m for m in srv.model.modules() if isinstance(m, FusedBlockStack)]

    def plain_op(*a, packed=None, **k):
        del packed
        return sb.swin_block_grouped_ref(*a, **k)

    with torch.inference_mode():
        l_im = torch.from_numpy(req_b).to(dev).float() / 255.0
        y_k = srv.model(l_im)
        for m in stacks:
            m.block_op = plain_op
        y_p = srv.model(l_im)
        out_p = srv(req_b)
        for m in stacks:
            m.block_op = sb.fused_swin_block_grouped
        # reference: the same weights through the plain path in true f32
        torch.backends.cudnn.allow_tf32 = False
        ref_model = define_g({**args, 'amp': False}, dev)
        ref_model.load_state_dict(state)
        for m in ref_model.modules():
            if isinstance(m, FusedBlockStack):
                m.block_op = plain_op
        y_32 = ref_model(l_im)
        del ref_model
    err_k, err_p = (y_k - y_32).abs(), (y_p - y_32).abs()
    udiff = np.abs(out_p.astype(np.int16) - out_b.astype(np.int16))
    finite = bool(torch.isfinite(y_k).all() and torch.isfinite(y_p).all())
    # the kernel path may not be further from the f32 reference than the
    # plain bf16 path is (bf16 rounding noise grows over 36 random-weight
    # blocks; the two bf16 paths differ by that noise, not by a bias)
    close = bool(err_k.mean() <= 1.25 * err_p.mean()
                 and err_k.max() <= 2.0 * err_p.max())
    serve = emit(
        'serve', model='SwinIR x8 pixelshuffledirect C=180 6x6 heads 6 '
        'ws 8, bf16 compute, random weights (seed 0)',
        batch=BATCH, lr_hw=[LR, LR], requests=[11, BATCH, BATCH],
        forwards=forwards, blocks_per_forward=n_blocks, launches=launches,
        setup_seconds=srv.setup_seconds, serve_seconds=serve_s,
        images_per_s=ips, ms_per_batch=1e3 * BATCH / ips,
        max_memory_allocated=peak_mem, shapes_ok=ok_shapes,
        deterministic=deterministic, finite=finite,
        out_kernel_vs_plain_max_abs=float((y_k - y_p).abs().max()),
        out_kernel_vs_f32_mean_abs=float(err_k.mean()),
        out_kernel_vs_f32_max_abs=float(err_k.max()),
        out_plain_vs_f32_mean_abs=float(err_p.mean()),
        out_plain_vs_f32_max_abs=float(err_p.max()),
        kernel_as_close_as_plain=close,
        u8_equal_share=float((udiff == 0).mean()),
        u8_within1_share=float((udiff <= 1).mean()),
        u8_max_diff=int(udiff.max()),
        u8_share_0=float((out_b == 0).mean()),
        u8_share_255=float((out_b == 255).mean()), nvidia_smi=smi)
    if not (ok_shapes and deterministic and finite
            and launches == n_blocks * forwards and n_blocks == 36
            and close):
        print('chip_smoke: serve failed', file=sys.stderr)
        return 1
    prof = emit('serve_profile', **profile_batch(srv, req_b,
                                                 serve['ms_per_batch']),
                nvidia_smi=smi)

    kernels = [{
        'name': 'swin_block_grouped', 'route': 'cuda',
        'source': 'srcaco2_tpu_torch/ops/csrc/swin_block_grouped.cu',
        'replaces': 'srcaco2_tpu/ops/pallas/swin_block.py:1039',
        'launches': launches, 'max_abs_err': errs['bf16']['max_abs_err'],
        'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by,
        # no single PyTorch call computes a whole Swin block
        'library_ms': None}]
    emit('kernels', kernels=[{'name': k['name'],
                              'tpu': 'srcaco2_tpu/ops/pallas/swin_block.py:'
                              '_fwd_kernel_grouped',
                              'check_passed': True} for k in kernels])
    if out_dir:
        with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as f:
            json.dump({'kernel_check': rec, 'serve': serve,
                       'serve_profile': prof, 'kernels': kernels}, f,
                      indent=1)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
