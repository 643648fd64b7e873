#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (srcaco2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out-dir DIR]

With --out-dir, the nvcc log (-Xptxas -v) and a JSON record of the run
are written to DIR as well.

Phases, in this order, each printing one JSON line; any failure exits
non-zero:
  card          name and power limit (nvidia-smi), torch and CUDA versions
  build         nvcc build of every kernel source under
                srcaco2_tpu_torch/ops/csrc; each kernel's shared memory,
                registers and spills (-Xptxas -v)
  kernel_check  K5 (tiled block forward) against its plain PyTorch
                version on the card at the serving shapes, f32 and bf16,
                with stated tolerances; two K5 calls on the same inputs
                must agree bit for bit
  kernel_time   median ms of K5 and its plain version beside the least
                time the card could take (bound)
  kernel_check_train  K1 (block forward) and K2 (block backward: dx, 12
                weight grads, dbias) against their plain versions at
                bench.py's training shapes, shifts 0 and 4, f32 and bf16;
                two K1 calls, and two K2 calls, on the same inputs must
                agree bit for bit
  kernel_time_train   median ms of K1 and K2 and of their plain versions
                beside their bounds; K2's window and reduction passes
                apart (torch.profiler), and its reduction's four weight
                products through torch.matmul (a yardstick)
  kernel_check_pair   K3 (pair forward) and K4 (pair backward: dx, 24
                weight grads, both dbias) against their plain versions at
                the same shapes (blocks with shifts 0 and 4), f32 and bf16;
                two K3 calls, and two K4 calls, must agree bit for bit
  kernel_time_pair    median ms of K3 and K4 and of their plain versions
                beside their bounds; K4's passes and yardstick as K2's
  kernel_check_wmsa   K6 (windowed attention forward) against its plain
                version, f32 and bf16: the eval shape (512 windows of 64
                tokens, C=180, 6 heads) with no mask and with the shift-4
                mask of a 64x64 image, JAX's test shape (12 windows, 4
                heads of 16, a random 0/-100 mask per window), 7x7
                windows (N=49: unaligned window blocks), hd 64 (C=256, 4
                heads) and C=512 (over the mma body's budget); in bf16
                both bodies where the mma body takes the shape, each
                also within one bf16 ulp plus 2^-15 of |v| of the plain
                version and differing from it in at most 1% of the
                outputs, two mma calls bit for bit, the mma body with an
                f32 bias, and _k6_body's choice against the library's own
                shape rule; K6 raises under grad
  kernel_time_wmsa    median ms of K6 (the mma body), of the fma body and
                of the plain version beside the bound, and of
                F.scaled_dot_product_attention on the same q, k, v with a
                prebuilt additive mask (the library time); call by call,
                and the kernels also as CUDA-graph replays (graph_ms)
  serve         the x8 SwinIR flagship (bf16, random seeded weights, full
                depth) served through SRServer: 3 requests, one with a
                ragged tail; launch counts of the main path; images/s;
                plain-path vs kernel-path agreement
  serve_profile device time of one served batch by kernel (torch.profiler)
  eval_unfused  the unfused x8 flagship (use_pallas_attn, bf16, random
                seeded weights, full depth) through make_eval_forward at
                batch 8 on 64x64 LR: 36 K6 launches per forward, all
                of the mma body, and no K1-K5; images/s, ms per batch, peak memory; the K6 path no
                further from an f32 plain-path reference than the bf16
                plain path; the metrics on the card against the CPU
  eval_unfused_profile  device time of one eval forward by kernel
  train_compare one step's loss and grads through the kernels against the
                plain versions (batch 16, bf16 and f32) from the flagship's
                seeded initial weights
  train_compare_pair  the same with every stack's blocks run as pairs
                (K3 + K4 against their plain versions)
  train         the flagship train step (bf16 over f32 params, random
                seeded weights, full depth) at batch 128 of 16x16 LR
                patches: warm-up, 10 timed steps, launch counts (36 K1, 36
                K2, 0 K5, one update check and one update launch per
                step), ms/step, patches/s, peak memory, loss, skip /
                corrupt flags
  update_pass   the train step's update pass (csrc/fused_update.cu)
                against the eager chain it replaces, on the trained
                flagship's f32 parameters, Adam state and its own grads at
                batch 128: three steps, the second skipped for a NaN grad;
                parameters, moments, counts and flags bit for bit; the
                device ms of the check and the update launch
                (torch.profiler) beside the bound by bytes, and the eager
                chain's device ms
  train_profile device time of one train step by kernel (torch.profiler)
  train_pair    the train step with every stack's `pair` on (what
                SRCACO2_SWIN_PAIR=1 selects): warm-up, 10 timed steps,
                launch counts (18 K3, 18 K4, 0 K1, K2 or K5 per step),
                ms/step, patches/s, peak memory, loss, flags
  train_pair_profile  device time of one pair step by kernel
  windowed_check  the default x2 SwinIR (full width, pixelshuffle) through
                FusedBlockStack's windowed path: one training step's loss
                and grads at batch 8 on 48x48 LR patches on the card
                against the CPU (f32 with TF32 off: 1e-5 / 1e-4; bf16:
                1e-2 / 3e-2, a grad whose bf16 noise floor is above 1.5e-2
                held to that floor, see windowed_check), and an f32 eval
                forward at 40x40 LR; no kernel launches on these paths
  windowed_profile  that config's train step (f32, batch 8 of 48x48 LR)
                in this process: ms/step over 5 steps, peak memory, no
                K1-K6 launch (the update pass's only), the device time of
                one step by kernel
  entry_x8      `python -m srcaco2_tpu_torch.main` with the README's flags
                (x8, batch 64, amp, pixelshuffledirect, l2 + 5 SSIM(19),
                ROI eval and selection) on a synthetic dataset (128 / 8 /
                8 images of 512^2, 3 epochs: 6 steps), then `python -m
                srcaco2_tpu_torch.eval`; gates: exit codes, passed.txt,
                checkpoint step, best model, tracker rows, eval equal to
                the final test, 36 K1 + 36 K2 per step and 36 K5 per
                validation / test forward (run_stats.json), nothing else
                but the update pass's launches in each train step
  options_check the training options that are off by default, card
                against the port's CPU path in f32 with TF32 off: each
                of the 13 other loss terms (each hist / kde metric),
                value and input grad (1e-5 relative / 1e-6 absolute);
                Otsu and the chamfer EDT bit for bit on 8 synthetic
                512^2 tiles; the EDT*ROI origin weights (1e-6);
                assemble with every local aug and ppiw at the x8
                entry's shapes from CPU draws (uint8 levels compared
                where the card's division by 255 is one ulp off); the
                card's origin draw (chi-square, 8 x 8 bins, p = 1e-3);
                both regularizers on the flagship's params (orth 1e-4,
                clip exactly); the zero derivative vectors of the
                flagship's prediction on that batch and norm_laplace's
                grad there (NaN where a Laplacian is 0); the card's ms
                for the options' work at the entry's shapes
  entry_opts    entry_x8 with every option: EDT*ROI sampling, the three
                local augs at probability 1, ppiw with l1, the other
                loss terms but norm_img_grad and norm_laplace (hist KL,
                kde BH; see ENTRY), orth every 2 and clip every 3 steps;
                entry_x8's gates, every logged term finite on the steps
                not skipped, the skipped steps counted and not all
  ddp_check     the port's data-parallel train step on 2 ranks (parallel/
                mesh.py; NCCL with a card each on two cards, else 2
                processes on card 0 over gloo) against the one-process
                step over the same global batch and draws: the
                flagship at batch 128 (64 per rank) in f32 (params, Adam
                moments, EMA within 1e-5 relative L2) and bf16
                (bf16_grads_held against the f32 steps); 36 K1 and 36 K2
                per step on each rank; MemNet (zoo_check's depth, f32,
                batch 8): running statistics within 1e-6; a NaN in rank
                1's shard skips the step on both ranks; per rank ms per
                step, the gradient all-reduce's ms and bytes, peak
                memory; the bf16 step in this process with a world-of-one
                NCCL grid against no grid, in turns (the layer's cost)
  entry_ddp     entry_x8 under `python -m torch.distributed.run
                --nproc_per_node min(2, cards) -m srcaco2_tpu_torch.main
                --distributed True` (NCCL), then `eval` in one process;
                entry_x8's gates, only rank 0 writes in the experiment
                tree (audited), the final params bit-equal to
                entry_x8's with one card (a world of one)
  native_check  the host lattice ops (losses/crf.py, ops/pam.py; native/
                built with g++): dense_crf_loss's value and gradient and
                permutohedral_attention on CUDA tensors equal to the same
                calls on CPU tensors and returned on the card; their ms
  reconstruct_profile  the reconstruct task's train step in this process
                (the flagship at upscale 1, 16x16 patches of 64x64 LR
                images and their blur chain, batch 64): 5 timed steps,
                36 K1 + 36 K2 per step, peak memory, the device time of
                one step by kernel and the busy share
  diagnosis_check  the diagnosis studies and the reference .pth loader
                (srcaco2_tpu_torch/diagnosis) on a synthetic x2 set of
                512^2 HR images: the k-NN restoration of one test image
                (65,536 queries) against the 3x3 patch dictionary of 16
                train images; on 1,024 evenly spaced queries the card's
                neighbours (chunked_knn, in one block and in blocks of
                100,000 dictionary rows) equal to the CPU's, and the
                image's atoms there the ones the CPU's neighbours draw;
                exact-match restoration with the k-NN fallback bit-equal
                to the CPU on a central 32x32 crop; the Wiener study at
                the four balances against the CPU (DIAG_TOL); a
                reference-layout .pth of the x8 flagship
                (nearest_flagship weights) through eval_pretrained_pth
                under utils/profiling.trace_window: rows equal to the
                port's eval of the same weights within 1e-6, 36 K5 per
                forward and no other kernel, CUDA kernel events in the
                Chrome trace, the card's peak memory; the same .pth twice
                in a made-up tree (discover_pth_checkpoints,
                eval_pth_batch); ms and peak memory of each step
  entry_reconstruct  entry_x8's flags plus --task reconstruct (the blurred
                LR -> the LR at scale 1, 16x16 LR patches: K1 + K2; 64x64
                validation / test images: K5); entry_x8's gates; then on
                its experiment reevaluate_reconstruct 'fake' equal to
                eval within 1e-6, its _bicubic floor the PSNR of the
                blurred input against its target in numpy (1e-4 dB), 36
                K5 per forward; 'real' on 2 images (input == target);
                noise_study at sigma 0 and 20 on 4 images (sigma 0 equal
                to reevaluate, the sigma-20 noise in the input); `python -m srcaco2_tpu_torch.eval_all`
                over the tree: one 'ok' row equal to eval; the figure
                recorded as skipped where matplotlib is missing
  entry_x2      the same at the defaults (x2, h_size 96: the windowed path
                in training, no K1 / K2; f32; batch 8; 32 / 4 / 4 images,
                2 epochs: 8 steps; K5 in f32 on 256x256 LR validation);
                ms per step, patches/s and peak memory
  zoo_check     each zoo net (DFCAN, SRCNN, VDSR, MSLapSRN, SRFBN, ENLCN,
                ACT, OmniSR, NLSN, GRL, DRRN, MemNet, DBPN, ProSR,
                DSR-Splines, CSR-CNN, EDSR-LIIF; and CSR-CNN's snet_type3
                and segmentation task with ce) at full width, x8 (the
                depths of nine of them cut: ZOO_CHECK_NETG), from
                the same seeded weights on the card and the CPU: one
                training step's loss and grads at batch 4 of 16x16 LR
                (SRCNN, CSR-CNN: the 128x128 pre-upscale), l2 + 5 SSIM(19), f32
                with TF32 off (1e-5 /
                1e-4; a grad over that held in float64 on both devices)
                and bf16 (1e-2 / 3e-2 by windowed_check's floor rule where
                a CPU control shows the rule can hold the net; the median
                bf16 noise); every op of the card's f32 and bf16 steps
                held to float64 on its own inputs (op_replay); an f32
                eval forward at 64x64 LR (1e-5 of max |out|); SRFBN's
                4 steps and MSLapSRN's and ProSR's 2 levels in
                the loss; NLSN with the same injected rotations on both
                devices and its hash codes compared, DSR-Splines' knots
                compared (where any differ, the step or forward is held
                op by op: op_replay holds argmax, floor and the stable
                sort equal); no kernel launch; see zoo_check
  zoo_train     each zoo net's train step (bf16 over f32 params): DFCAN
                as bench.py's step (batch 128, 10 timed steps), the
                others at the README's batch 64 (5 timed steps; from NLSN
                on 3; MemNet with its per-pass checkpoint, DBPN with its
                per-block one); ms/step, patches/s, peak memory; the
                device time of one step by kernel and the device's busy
                share for ZOO_PROFILED (DFCAN with the FFT's share); then
                SRFBN with srfbn_remat_steps and DBPN without
                dbpn_remat_blocks: ms/step and peak memory beside the
                default's, one step's loss and grads bit-equal to the
                default step's; EDSR-LIIF's gather backward at its step's
                shape run twice, bit-equal, against the CPU's and
                index_add_
  entry_zoo     `main` with the README's flags (x8, batch 64, amp, l2 + 5
                SSIM(19), ROI eval and selection) and `eval` for each zoo
                net on one synthetic dataset (128 / 4 / 4 images of
                512^2, 1 epoch of 2 steps), up to six nets at a time,
                each process held to its share of the card and the
                running shares within its free memory; the gates of
                entry_x8 with no kernel launch; SRCNN's,
                MemNet's and CSR-CNN's best models served through
                SRServer (3 requests, a ragged tail; MemNet with its
                saved running statistics; SRCNN and CSR-CNN on the
                pre-upscale)
  kernels       the kernels line (K1-K6, one JSON object)
followed by the nvidia-smi line and, last, the {"ok": true, ...} line.
Imports nothing of JAX or of the JAX package.
"""
import argparse
import contextlib
import json
import math
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
# matrix-product FLOPs of one token through a block forward: qkv, proj
# and the MLP at the model widths, attention inside its 64-token window
FWD_FLOPS_PER_TOKEN = (2 * (3 * C * C + C * C + 2 * C * CH)
                       + 2 * 2 * WS * WS * C)
# ... and through a block backward from x: the forward without fc2
# (recomputed: the kernel gets x, not the intermediates), the dx chain,
# the weight products and the windowed attention backward
BWD_FLOPS_PER_TOKEN = (2 * (3 * C * C + C * C + C * CH) + 2 * 2 * WS * WS * C
                       + 2 * (4 * C * CH + 8 * C * C) + 2 * 4 * WS * WS * C)
# training step (bench.py:77-126): batch 128 of 16x16 LR patches (h_size
# 128 at x8), T = 256 tokens per patch; 256 synthetic 512^2 HR images
TRAIN_B, PATCH, H_SIZE, N_IMG = 128, 16, 128, 256
# K6 at the eval shape: the flagship's 64-token windows over batch 8 at
# 64x64 LR
WMSA_W, WMSA_N = BATCH * (LR // WS) ** 2, WS * WS
WMSA_TOL = {
    # f32: only the order of the f32 sums differs (the JAX test's bound)
    'f32': dict(atol=2e-5, rtol=0.0),
    # bf16: both round the f32 result once, so one output ulp
    'bf16': dict(atol=1e-2, rtol=2.0 ** -7),
}
# K6 in bf16, beside WMSA_TOL (wmsa_precision): both bodies keep the f32
# function to ~2^-17 of the largest |v| that an output's sum takes (the
# mma body's q.k^T products are exact, P is split into bf16 hi + lo), so
# every output lies within one bf16 ulp of the plain version's plus
# 2^-15 of that |v|, and few outputs differ at all (0.2% at the eval
# shape). A body that dropped the P_lo pass, or rounded the scores to
# bf16, misses both.
WMSA_VMAX_SHARE = 2.0 ** -15
WMSA_DIFFER_MAX = 0.01
TRAIN_TOL = {
    # f32: only the order of f32 sums differs (K <= 360 inside a
    # window, 32768 tokens in the weight grads)
    'f32': dict(out_atol=1e-3, grad_rtol=1e-4),
    # bf16: both round at the same points; a different f32 sum order can
    # flip a bf16 rounding (2^-8 relative) of an intermediate
    'bf16': dict(rel_l2=2e-2),
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


def graph_ms(fn, reps=5, per=20):
    """Median over `reps` replays of a CUDA graph of `per` back-to-back
    calls of fn, per call (CUDA events): the device time without the
    host's cost of each call, which a kernel of tens of microseconds
    behind a Python wrapper does not hide."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    # the graph's private memory pool holds the outputs of its calls:
    # release it now, not when the graph object is collected
    graph.reset()
    return statistics.median(times)


def block_inputs(dev, gen, n_tiles=BATCH * (LR // (2 * WS)) ** 2):
    """Seeded block inputs at the serving shapes: unit-variance tiles,
    one block's weights, the shifted layout's group table and groups."""
    import torch
    from srcaco2_tpu_torch.models import swin_fused as sf
    from srcaco2_tpu_torch.ops import swin_block as sb
    tl = 2 * WS

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
    flops = x.shape[0] * x.shape[1] * FWD_FLOPS_PER_TOKEN
    nbytes = 2 * x.numel() * x.element_size() + groups.numel() * 4 \
        + gid.numel() * 4 + sum(t.numel() * t.element_size()
                                for t in packed)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def train_block_inputs(dev, gen, shift):
    """Seeded inputs of one training-patch block at bench.py's shapes:
    B patches of 16x16 tokens (unit variance), one block's weights, the
    (nh, T, T) bias of `shift` from a random table, and a unit-variance
    upstream grad."""
    import torch
    from srcaco2_tpu_torch.ops import swin_block as sb
    x, params, _, _ = block_inputs(dev, gen, n_tiles=TRAIN_B)
    table = (torch.randn((1, (2 * WS - 1) ** 2, HEADS), generator=gen)
             * 0.02).to(dev)
    bias = sb.build_attn_bias(table, PATCH, PATCH, WS, shifts=(shift,))[0]
    dout = torch.randn(x.shape, generator=gen).to(dev)
    return x, params, bias.contiguous(), dout


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm()
                 .clamp_min(1e-30))


def check_tensors(pairs, dtype, elementwise_out=False):
    """{name: errors and 'ok'} of each (kernel, plain) tensor pair under
    TRAIN_TOL[dtype]: f32 outputs ('out') within out_atol and every
    other tensor within grad_rtol max|plain|; bf16 within rel_l2, with
    elementwise_out also the output within K5's elementwise rule."""
    import torch
    errs = {}
    for k, (a, b) in pairs.items():
        diff = (a.float() - b.float()).abs()
        e = dict(max_abs=float(diff.max()),
                 ref_max=float(b.float().abs().max()),
                 rel_l2=_rel_l2(a, b),
                 finite=bool(torch.isfinite(a.float()).all()))
        tol = TRAIN_TOL[dtype]
        if dtype == 'f32':
            lim = tol['out_atol'] if k == 'out' else \
                tol['grad_rtol'] * e['ref_max']
            e['ok'] = e['max_abs'] <= lim
        else:
            e['ok'] = e['rel_l2'] <= tol['rel_l2']
            if k == 'out' and elementwise_out:
                e['n_outside'] = int((diff > TOL['bf16']['atol']
                                      + TOL['bf16']['rtol']
                                      * b.float().abs()).sum())
                e['ok'] = e['ok'] and e['n_outside'] == 0
        e['ok'] = e['ok'] and e['finite']
        errs[k] = e
    return errs


def bit_identical(first, second):
    """Whether two calls' outputs (tensors, dicts of tensors, nested in
    tuples) are equal bit for bit."""
    import torch
    if isinstance(first, dict):
        return all(bit_identical(first[k], second[k]) for k in first)
    if isinstance(first, (tuple, list)):
        return all(bit_identical(a, b) for a, b in zip(first, second))
    return bool(torch.equal(first.flatten().view(torch.uint8),
                            second.flatten().view(torch.uint8)))


def kernel_check_train(dev, gen):
    """K1 and K2 (dx, the 12 weight grads, dbias) against their plain
    versions at bench.py's shapes, shifts 0 and ws/2, f32 and bf16.
    Also: dbias is exactly zero off the window blocks."""
    import torch
    from srcaco2_tpu_torch.ops import swin_block as sb
    recs, ok = [], True
    for shift in (0, WS // 2):
        x, params, bias, dout = train_block_inputs(dev, gen, shift)
        idx = sb._window_index_on(PATCH, PATCH, WS, shift, str(dev))
        mask, _ = sb._mask_and_index_on(PATCH, PATCH, WS, shift, str(dev))
        off_window = (mask != 0)[None].expand(HEADS, -1, -1)
        for name, dt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
            xd, dd = x.to(dt), dout.to(dt)
            packed = sb.pack_block_params(params, HEADS, dt)
            packed_bwd = sb.pack_block_bwd_params(params, HEADS, dt)
            out_k = sb.swin_block_fwd(xd, bias, idx, packed, heads=HEADS,
                                      compute_dtype=dt)
            fwd_same = bit_identical(out_k, sb.swin_block_fwd(
                xd, bias, idx, packed, heads=HEADS, compute_dtype=dt))
            dx_k, gp, db_k = sb.swin_block_bwd(
                xd, dd, bias, idx, packed, packed_bwd, heads=HEADS,
                compute_dtype=dt, ch=CH)
            g_k = sb.unpack_block_grads(gp, HEADS, C, CH)
            again = sb.swin_block_bwd(
                xd, dd, bias, idx, packed, packed_bwd, heads=HEADS,
                compute_dtype=dt, ch=CH)
            same = bit_identical((dx_k, gp, db_k), again)
            del again
            torch.cuda.synchronize()
            out_r = sb.swin_block_ref(xd, params, bias, heads=HEADS,
                                      compute_dtype=dt)
            dx_r, g_r, db_r = sb.swin_block_bwd_ref(
                xd, dd, params, bias, heads=HEADS, compute_dtype=dt)
            pairs = {'out': (out_k, out_r), 'dx': (dx_k, dx_r),
                     'dbias': (db_k, db_r),
                     **{k: (g_k[k], g_r[k]) for k in sb.BLOCK_KEYS}}
            errs = check_tensors(pairs, name, elementwise_out=True)
            zero_off = bool((db_k[off_window] == 0).all())
            rec = dict(shift=shift, dtype=name, dbias_zero_off_window=zero_off,
                       fwd_bit_identical_twice=fwd_same,
                       bwd_bit_identical_twice=same,
                       all_ok=all(e['ok'] for e in errs.values()) and zero_off
                       and same and fwd_same, errs=errs,
                       tol=TRAIN_TOL[name])
            recs.append(rec)
            ok = ok and rec['all_ok']
            del out_k, dx_k, gp, db_k, out_r, dx_r, g_r, db_r, pairs
    return recs, ok


def bound(flops, nbytes):
    """The least time of `flops` matrix-product operations and `nbytes`
    bytes: the larger of the two over the bf16 peak and the memory
    rate, and which of them bounds it."""
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                flops=flops, bytes=nbytes)


def train_bounds(tokens, nbytes_fwd, nbytes_bwd):
    """Bounds of K1 and K2 over `tokens` tokens: matrix-product FLOPs of
    the windowed work (64-token windows, model widths) against bytes.
    K2's work is BWD_FLOPS_PER_TOKEN's."""
    return dict(fwd=bound(tokens * FWD_FLOPS_PER_TOKEN, nbytes_fwd),
                bwd=bound(tokens * BWD_FLOPS_PER_TOKEN, nbytes_bwd))


def pass_ms(fn, n=10):
    """Device ms per call of the two passes of a backward kernel (its
    window kernel and its reduction kernel), from torch.profiler over n
    calls of fn after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = dict(window_pass_ms=0.0, reduce_pass_ms=0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ('reduce_pass_ms' if 'reduce_kernel' in e.key else
               'window_pass_ms' if 'window_kernel' in e.key else None)
        if key:
            out[key] += e.self_device_time_total / 1e3 / n
    if not (out['window_pass_ms'] > 0 and out['reduce_pass_ms'] > 0):
        raise RuntimeError(f'the profiler did not see both passes: {out}')
    return out


def reduce_library_ms(dev, gen, m=TRAIN_B * PATCH * PATCH):
    """A yardstick for the backward's reduction pass, never on the main
    path: its four weight products y^T dqkv, o^T dx2, y2^T du and hact^T
    g as torch.matmul(A.T, B) on bf16 operands of the workspace's shapes
    (m tokens, the kernels' padded widths), median ms of each and their
    sum."""
    import torch
    from srcaco2_tpu_torch.ops import swin_block as sb
    pd = sb._pads(C, HEADS, CH)
    ca = HEADS * pd.hp
    shapes = dict(dwqkv=(pd.ck, 3 * ca), dwproj=(ca, pd.ck),
                  dw1=(pd.ck, pd.chp), dw2=(pd.chp, pd.ck))
    out = {}
    for name, (ka, nb) in shapes.items():
        a = torch.randn((m, ka), generator=gen).to(dev, torch.bfloat16)
        b = torch.randn((m, nb), generator=gen).to(dev, torch.bfloat16)
        out[name] = cuda_ms(lambda: torch.matmul(a.T, b))
    out['total'] = sum(out.values())
    return out


def kernel_time_train(dev, gen):
    """Median ms of K1 and K2 and of their plain versions (bf16, shift
    ws/2, bench.py's shapes), beside their bounds; K2's window and
    reduction passes apart, and the reduction's weight products through
    torch.matmul as a yardstick."""
    import torch
    from srcaco2_tpu_torch.ops import swin_block as sb
    shift, dt = WS // 2, torch.bfloat16
    x, params, bias, dout = train_block_inputs(dev, gen, shift)
    xd, dd = x.to(dt), dout.to(dt)
    idx = sb._window_index_on(PATCH, PATCH, WS, shift, str(dev))
    packed = sb.pack_block_params(params, HEADS, dt)
    packed_bwd = sb.pack_block_bwd_params(params, HEADS, dt)
    fwd_ms = cuda_ms(lambda: sb.swin_block_fwd(
        xd, bias, idx, packed, heads=HEADS, compute_dtype=dt))

    def run_bwd():
        return sb.swin_block_bwd(xd, dd, bias, idx, packed, packed_bwd,
                                 heads=HEADS, compute_dtype=dt, ch=CH)

    bwd_ms = cuda_ms(run_bwd)
    passes = pass_ms(run_bwd)
    lib = reduce_library_ms(dev, gen, xd.shape[0] * xd.shape[1])
    fwd_plain = cuda_ms(lambda: sb.swin_block_ref(
        xd, params, bias, heads=HEADS, compute_dtype=dt), reps=3, per=3)
    bwd_plain = cuda_ms(lambda: sb.swin_block_bwd_ref(
        xd, dd, params, bias, heads=HEADS, compute_dtype=dt), reps=3, per=3)
    wbytes = sum(t.numel() * t.element_size() for t in packed)
    wbytes_bwd = sum(t.numel() * t.element_size() for t in packed_bwd)
    act = xd.numel() * xd.element_size()
    nb_bias = bias.numel() * 4
    grads = sum(p.numel() for p in params.values()) * 4
    bounds = train_bounds(xd.shape[0] * xd.shape[1],
                          2 * act + nb_bias + wbytes,
                          3 * act + 2 * nb_bias + wbytes + wbytes_bwd
                          + grads)
    return dict(
        fwd=dict(kernel='swin_block_fwd', ms=fwd_ms, plain_ms=fwd_plain,
                 **bounds['fwd'], tflops=bounds['fwd']['flops'] / fwd_ms
                 / 1e9),
        bwd=dict(kernel='swin_block_bwd', ms=bwd_ms, plain_ms=bwd_plain,
                 **bounds['bwd'], tflops=bounds['bwd']['flops'] / bwd_ms
                 / 1e9, **passes, reduce_matmul_ms=lib),
        shape=list(xd.shape), dtype='bf16', shift=shift)


def pair_inputs(dev, gen):
    """Seeded inputs of one block pair at bench.py's shapes: x and dout
    as train_block_inputs makes them, block A's weights and bias (shift
    0), block B's (shift ws/2)."""
    x, params_a, bias_a, dout = train_block_inputs(dev, gen, 0)
    _, params_b, bias_b, _ = train_block_inputs(dev, gen, WS // 2)
    return x, dout, params_a, bias_a, params_b, bias_b


def pair_packs(params_a, params_b, dt):
    from srcaco2_tpu_torch.ops import swin_block as sb
    return ([sb.pack_block_params(p, HEADS, dt) for p in (params_a, params_b)],
            [sb.pack_block_bwd_params(p, HEADS, dt)
             for p in (params_a, params_b)])


def kernel_check_pair(dev, gen):
    """K3 and K4 (dx, both blocks' 12 weight grads and dbias) against
    their plain versions at bench.py's shapes, f32 and bf16, under
    TRAIN_TOL's rules. Also: each dbias is exactly zero off its window
    blocks; and in bf16 the kernels' output and dx are closer to the
    plain pair than to two chained plain blocks (which round A's output
    and B's dx to bf16 and round the softmax backward as K2 does), so
    the kernels keep the pair's f32 intermediates."""
    import torch
    from srcaco2_tpu_torch.ops import swin_block as sb
    x, dout, pa, ba, pb, bb = pair_inputs(dev, gen)
    idx = [sb._window_index_on(PATCH, PATCH, WS, s, str(dev))
           for s in (0, WS // 2)]
    off = [(sb._mask_and_index_on(PATCH, PATCH, WS, s, str(dev))[0] != 0)
           [None].expand(HEADS, -1, -1) for s in (0, WS // 2)]
    recs, ok = [], True
    for name, dt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        xd, dd = x.to(dt), dout.to(dt)
        (pk_a, pk_b), (pw_a, pw_b) = pair_packs(pa, pb, dt)
        out_k = sb.swin_block_pair_fwd(xd, ba, idx[0], pk_a, bb, idx[1],
                                       pk_b, heads=HEADS, compute_dtype=dt)
        fwd_same = bit_identical(out_k, sb.swin_block_pair_fwd(
            xd, ba, idx[0], pk_a, bb, idx[1], pk_b, heads=HEADS,
            compute_dtype=dt))
        dx_k, gpa, dba_k, gpb, dbb_k = sb.swin_block_pair_bwd(
            xd, dd, ba, idx[0], pk_a, pw_a, bb, idx[1], pk_b, pw_b,
            heads=HEADS, compute_dtype=dt, ch=CH)
        ga_k = sb.unpack_block_grads(gpa, HEADS, C, CH)
        gb_k = sb.unpack_block_grads(gpb, HEADS, C, CH)
        again = sb.swin_block_pair_bwd(
            xd, dd, ba, idx[0], pk_a, pw_a, bb, idx[1], pk_b, pw_b,
            heads=HEADS, compute_dtype=dt, ch=CH)
        same = bit_identical((dx_k, gpa, dba_k, gpb, dbb_k), again)
        del again
        torch.cuda.synchronize()
        out_r = sb.swin_block_pair_ref(xd, pa, ba, pb, bb, heads=HEADS,
                                       compute_dtype=dt)
        dx_r, ga_r, dba_r, gb_r, dbb_r = sb.swin_block_pair_bwd_ref(
            xd, dd, pa, ba, pb, bb, heads=HEADS, compute_dtype=dt)
        pairs = {'out': (out_k, out_r), 'dx': (dx_k, dx_r),
                 'dbias_a': (dba_k, dba_r), 'dbias_b': (dbb_k, dbb_r),
                 **{f'{k}_a': (ga_k[k], ga_r[k]) for k in sb.BLOCK_KEYS},
                 **{f'{k}_b': (gb_k[k], gb_r[k]) for k in sb.BLOCK_KEYS}}
        errs = check_tensors(pairs, name)
        zero_off = bool((dba_k[off[0]] == 0).all()
                        and (dbb_k[off[1]] == 0).all())
        rec = dict(dtype=name, dbias_zero_off_window=zero_off,
                   fwd_bit_identical_twice=fwd_same,
                   bwd_bit_identical_twice=same,
                   all_ok=all(e['ok'] for e in errs.values()) and zero_off
                   and same and fwd_same,
                   worst_rel_l2=max(errs, key=lambda k: errs[k]['rel_l2']),
                   errs=errs, tol=TRAIN_TOL[name])
        if name == 'bf16':
            mid = sb.swin_block_ref(xd, pa, ba, heads=HEADS, compute_dtype=dt)
            out_c = sb.swin_block_ref(mid, pb, bb, heads=HEADS,
                                      compute_dtype=dt)
            dmid, _, _ = sb.swin_block_bwd_ref(mid, dd, pb, bb, heads=HEADS,
                                               compute_dtype=dt)
            dx_c, _, _ = sb.swin_block_bwd_ref(xd, dmid, pa, ba, heads=HEADS,
                                               compute_dtype=dt)
            rec['vs_chain'] = {k: dict(kernel_vs_pair=_rel_l2(a, r),
                                       kernel_vs_chain=_rel_l2(a, ch),
                                       pair_vs_chain=_rel_l2(r, ch))
                               for k, a, r, ch in (('out', out_k, out_r, out_c),
                                                   ('dx', dx_k, dx_r, dx_c))}
            rec['closer_to_pair'] = all(
                v['kernel_vs_pair'] < v['kernel_vs_chain']
                for v in rec['vs_chain'].values())
            rec['all_ok'] = rec['all_ok'] and rec['closer_to_pair']
            # the noise of another sum order: the plain pair on the CPU
            # against the plain pair on the card, first 8 patches
            cpu = [t[:8].cpu() for t in (xd, dd)]
            cpu_p = [{k: v.cpu() for k, v in p.items()} for p in (pa, pb)]
            out_cpu = sb.swin_block_pair_ref(cpu[0], cpu_p[0], ba.cpu(),
                                             cpu_p[1], bb.cpu(), heads=HEADS,
                                             compute_dtype=dt)
            dx_cpu = sb.swin_block_pair_bwd_ref(
                cpu[0], cpu[1], cpu_p[0], ba.cpu(), cpu_p[1], bb.cpu(),
                heads=HEADS, compute_dtype=dt)[0]
            rec['plain_card_vs_cpu_8_patches'] = dict(
                out=_rel_l2(out_r[:8].cpu(), out_cpu),
                dx=_rel_l2(dx_r[:8].cpu(), dx_cpu))
            rec['kernel_vs_plain_8_patches'] = dict(
                out=_rel_l2(out_k[:8], out_r[:8]),
                dx=_rel_l2(dx_k[:8], dx_r[:8]))
            del mid, out_c, dmid, dx_c
        recs.append(rec)
        ok = ok and rec['all_ok']
        del out_k, dx_k, gpa, gpb, out_r, dx_r, ga_r, gb_r, pairs
    return recs, ok


def kernel_time_pair(dev, gen):
    """Median ms of K3 and K4 and of their plain versions (bf16,
    bench.py's shapes), beside their bounds: K3 does two block forwards;
    K4 two block backwards as K2 counts them plus A's fc2, whose output
    B's recompute needs."""
    import torch
    from srcaco2_tpu_torch.ops import swin_block as sb
    dt = torch.bfloat16
    x, dout, pa, ba, pb, bb = pair_inputs(dev, gen)
    xd, dd = x.to(dt), dout.to(dt)
    idx = [sb._window_index_on(PATCH, PATCH, WS, s, str(dev))
           for s in (0, WS // 2)]
    (pk_a, pk_b), (pw_a, pw_b) = pair_packs(pa, pb, dt)
    fwd_ms = cuda_ms(lambda: sb.swin_block_pair_fwd(
        xd, ba, idx[0], pk_a, bb, idx[1], pk_b, heads=HEADS,
        compute_dtype=dt))

    def run_bwd():
        return sb.swin_block_pair_bwd(xd, dd, ba, idx[0], pk_a, pw_a, bb,
                                      idx[1], pk_b, pw_b, heads=HEADS,
                                      compute_dtype=dt, ch=CH)

    bwd_ms = cuda_ms(run_bwd)
    passes = pass_ms(run_bwd)
    # the pair's reduction runs both blocks' products
    lib = {k: 2 * v for k, v in reduce_library_ms(
        dev, gen, xd.shape[0] * xd.shape[1]).items()}
    fwd_plain = cuda_ms(lambda: sb.swin_block_pair_ref(
        xd, pa, ba, pb, bb, heads=HEADS, compute_dtype=dt), reps=3, per=3)
    bwd_plain = cuda_ms(lambda: sb.swin_block_pair_bwd_ref(
        xd, dd, pa, ba, pb, bb, heads=HEADS, compute_dtype=dt),
        reps=3, per=3)
    tokens = xd.shape[0] * xd.shape[1]
    act = xd.numel() * xd.element_size()
    nb_bias = ba.numel() * 4
    wbytes = sum(t.numel() * t.element_size() for t in (*pk_a, *pk_b))
    wbytes_bwd = sum(t.numel() * t.element_size() for t in (*pw_a, *pw_b))
    grads = 2 * sum(p.numel() for p in pa.values()) * 4
    fwd = bound(2 * tokens * FWD_FLOPS_PER_TOKEN,
                2 * act + 2 * nb_bias + wbytes)
    bwd = bound(tokens * (2 * BWD_FLOPS_PER_TOKEN + 2 * CH * C),
                3 * act + 4 * nb_bias + wbytes + wbytes_bwd + grads)
    return dict(
        fwd=dict(kernel='swin_block_pair_fwd', ms=fwd_ms, plain_ms=fwd_plain,
                 **fwd, tflops=fwd['flops'] / fwd_ms / 1e9),
        bwd=dict(kernel='swin_block_pair_bwd', ms=bwd_ms, plain_ms=bwd_plain,
                 **bwd, tflops=bwd['flops'] / bwd_ms / 1e9, **passes,
                 reduce_matmul_ms=lib),
        shape=list(xd.shape), dtype='bf16', shifts=[0, WS // 2])


def profile_device(fn, wall_ms, groups=None, host_ops=True):
    """Device time of one call of fn by device activity (kernels and
    copies, torch.profiler), and the device's busy share of the call's
    unprofiled wall time `wall_ms`; with `groups` ({label: substrings}),
    also the device ms and share of the activities whose lower-cased
    name holds one of a label's substrings (`group_ms`). With host_ops
    False the profiler traces the device alone (the host's ops of a
    step of thousands cost tens of seconds to trace and sort), and
    traces the host too only where that recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    rows = []
    for acts in (([ProfilerActivity.CUDA],) if not host_ops else ()) + (
            [ProfilerActivity.CPU, ProfilerActivity.CUDA],):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if rows:
            break
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms <= 0:
        raise RuntimeError('the profiler recorded no device time')
    out = dict(device_ms=device_ms, wall_ms=wall_ms,
               device_busy_share=device_ms / wall_ms,
               top=[dict(name=k[:80], ms=ms, calls=n, share=ms / device_ms)
                    for k, ms, n in rows[:12]])
    for label, subs in (groups or {}).items():
        ms = sum(r[1] for r in rows if any(t in r[0].lower() for t in subs))
        out.setdefault('group_ms', {})[label] = dict(
            ms=ms, share=ms / device_ms)
    return out


def smem_bytes(build):
    """Dynamic shared memory of each kernel at the flagship widths, as
    the kernels' own layout code computes it."""
    import ctypes
    out = {}
    for stem in ('swin_block_grouped', 'swin_block_fwd', 'swin_block_bwd',
                 'swin_block_pair_fwd', 'swin_block_pair_bwd'):
        fn = getattr(build.library(stem), f'{stem}_smem')
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
        out[stem] = {dt: int(fn(bf, C, HEADS, CH))
                     for dt, bf in (('bf16', 1), ('f32', 0))}
    lib = build.library('window_attention')
    fn = lib.window_attention_smem
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    out['window_attention'] = int(fn(C, HEADS))
    fn = lib.window_attention_mma_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    out['window_attention_mma'] = int(fn(WS * WS, C, HEADS))
    return out


def ptxas_kernels(logs):
    """{kernel<type>: registers, stack and spill bytes} of every kernel
    entry in the nvcc logs (-Xptxas -v)."""
    import re
    out, name = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                k = re.search(r'\d+([a-z][a-z_]*_kernel)(I?)', m.group(1))
                name = k.group(1) if k else m.group(1)
                if k and k.group(2):    # a template over the compute type
                    hp = re.search(r'_kernelILi(\d+)E', m.group(1))
                    name += ('<' + (f'{hp.group(1)}, ' if hp else '')
                             + ('bf16' if 'bfloat16' in m.group(1)
                                else 'f32') + '>')
                out[name] = {}
            m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill '
                          r'stores, (\d+) bytes spill loads', ln)
            if m and name:
                out[name].update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
            m = re.search(r'Used (\d+) registers', ln)
            if m and name:
                out[name]['registers'] = int(m.group(1))
    return out


def train_config():
    """bench.py's training setup: l2 + 5 neg-SSIM (window 19), Adam at
    the defaults (lr 2e-4, L2 weight decay 1e-4), uniform 128^2 HR / 16^2
    LR patches with the dihedral augment."""
    from srcaco2_tpu_torch.config.defaults import get_config
    from srcaco2_tpu_torch.data import pipeline as P
    args = get_config()
    args.update(l2=True, ssim=True, ssim_lambda=5.0, ssim_window_s=19)
    return args, P.PipeConfig(scale=SCALE, h_size=H_SIZE)


def train_data(dev, seed=0):
    """Synthetic uint8 stacks on the card (bench.py:120-126): N_IMG HR
    512^2 and LR 64^2 images, and a generator for the batch draws."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    hr = torch.randint(0, 256, (N_IMG, 512, 512, 1), generator=gen,
                       device=dev, dtype=torch.uint8)
    lr = torch.randint(0, 256, (N_IMG, 512 // SCALE, 512 // SCALE, 1),
                       generator=gen, device=dev, dtype=torch.uint8)
    return hr, lr, gen


def step_inputs(gen, cfg, n):
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    idxs = torch.randint(0, N_IMG, (n,), generator=gen, device=gen.device)
    return idxs, P.draw(gen, n, cfg, (512, 512))


def train_setup(dev):
    """The flagship (full depth and width, bf16 over f32 params, random
    seeded weights) in training mode, its state, its train step and the
    synthetic data."""
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.schedule import build_optimizer
    from srcaco2_tpu_torch.train.state import TrainState
    from srcaco2_tpu_torch.train.steps import make_train_step
    args = flagship_args()
    targs, cfg = train_config()
    model = define_g(args, dev, seed=0).train()
    master = build_loss(targs)
    tx = build_optimizer(targs['train'])
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, master, tx, 'SwinIR', cfg,
                           steps_per_epoch=1000)
    hr, lr, gen = train_data(dev)
    return dict(model=model, state=state, step=step, hr=hr, lr=lr, gen=gen,
                cfg=cfg, master=master, args=args, tx=tx)


def block_stacks(model, pair=None):
    """The model's FusedBlockStacks, with `pair` set on each if given."""
    from srcaco2_tpu_torch.models.swin_fused import FusedBlockStack
    stacks = [m for m in model.modules() if isinstance(m, FusedBlockStack)]
    if pair is not None:
        for m in stacks:
            m.pair = pair
    return stacks


def kernel_wrappers():
    """{short name: wrapper} of every kernel, K1-K6."""
    from srcaco2_tpu_torch.ops.launches import kernel_wrappers
    return kernel_wrappers()


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0
    bodies = kernel_wrappers()['wmsa'].body_launches
    for k in bodies:
        bodies[k] = 0


def read_launches():
    from srcaco2_tpu_torch.ops.launches import launch_counts
    return launch_counts()


# the train step's update pass (ops/fused_update.py): its check and
# update launches
UPDATE_KERNELS = ('update_check', 'update_apply')


def swin_launches(launches):
    """The launch counts of K1-K6 alone."""
    return {k: v for k, v in launches.items() if k not in UPDATE_KERNELS}


def update_launched(launches, steps, tables=None):
    """Each of `steps` train steps took the update pass: as many check
    launches as update launches, `tables` of each a step (the leaf
    table's launches; any whole number where None)."""
    n = launches['update_check']
    if n != launches['update_apply'] or steps <= 0:
        return False
    return n == tables * steps if tables else n >= steps and n % steps == 0


def train_phase(ctx, smi, steps=10, pair=False):
    """The train step at batch TRAIN_B, every stack's blocks run one by
    one (K1 + K2) or, with `pair`, as pairs (K3 + K4): one warm-up
    step, then `steps` timed steps with the launch counts read around
    them."""
    import torch
    step, state, cfg = ctx['step'], ctx['state'], ctx['cfg']
    hr, lr, gen, model = ctx['hr'], ctx['lr'], ctx['gen'], ctx['model']
    stacks = block_stacks(model, pair)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, holder, ok = step(state, hr, lr, *step_inputs(gen, cfg, TRAIN_B))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    inputs = [step_inputs(gen, cfg, TRAIN_B) for _ in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    flags = torch.zeros((), device=hr.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idxs, draws in inputs:
        state, holder, ok = step(state, hr, lr, idxs, draws)
        flags = flags + holder['_flags']
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    n_blocks = sum(m.depth for m in stacks)
    rec = dict(
        model='SwinIR x8 pixelshuffledirect C=180 6x6 heads 6 ws 8, bf16 '
        'compute over f32 params, random weights (seed 0), model.train()',
        blocks='pairs (K3 + K4)' if pair else 'one by one (K1 + K2)',
        loss_terms='l2 + 5 neg-SSIM(19)', optimizer='Adam lr 2e-4 wd 1e-4',
        batch=TRAIN_B, h_size=H_SIZE, lr_patch=[PATCH, PATCH],
        steps=steps, warmup_s=warm_s, ms_per_step=1e3 * dt / steps,
        patches_per_s=TRAIN_B * steps / dt,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        loss=float(holder['total']),
        loss_finite=bool(torch.isfinite(holder['total'])),
        flags_sum=float(flags), step=int(state.step),
        blocks_per_step=n_blocks, launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()},
        nvidia_smi=smi)
    per_block = 0 if pair else n_blocks * steps
    per_pair = n_blocks // 2 * steps if pair else 0
    ok = (rec['loss_finite'] and rec['flags_sum'] == 0 and n_blocks == 36
          and launches['fwd'] == per_block
          and launches['bwd'] == per_block
          and launches['pair_fwd'] == per_pair
          and launches['pair_bwd'] == per_pair
          and launches['grouped'] == 0 and launches['wmsa'] == 0
          and update_launched(launches, steps, tables=1))
    return rec, ok


def _clone_tree(x):
    return x.clone() if hasattr(x, 'clone') else {
        k: _clone_tree(v) for k, v in x.items()}


def _kernel_device_ms(fn, names):
    """{name: (device ms, launches)} of the kernels whose names hold each
    of `names`, over one call of fn (torch.profiler, the device alone)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    out = {n: (sum(e.self_device_time_total for e in rows if n in e.key)
               / 1e3, sum(e.count for e in rows if n in e.key))
           for n in names}
    out['all'] = (sum(e.self_device_time_total for e in rows) / 1e3,
                  sum(e.count for e in rows))
    return out


def update_pass_check(ctx, smi, steps=3, nan_step=1, reps=20):
    """The update pass against the eager chain (train/steps.py:
    _eager_update, with the eager finite checks) from two copies of the
    flagship's trained state (f32 parameters, Adam with L2 decay, its
    moments and counts), over `steps` steps on the step's own grads at
    batch TRAIN_B (the convolutions' grads channels-last, as autograd
    returns them), step `nan_step` with a NaN in one grad: every
    parameter, moment and count, and the ok / corrupt flags, bit for
    bit. Then the device ms of each launch over `reps` steps of the pass
    beside its bound by bytes, and the eager chain's device ms of one
    step. Returns (record, ok)."""
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.ops import fused_update as FU
    from srcaco2_tpu_torch.train.state import TrainState, all_finite
    from srcaco2_tpu_torch.train.steps import _eager_update, loss_and_grads
    model, state, tx = ctx['model'], ctx['state'], ctx['tx']
    idxs, draws = step_inputs(ctx['gen'], ctx['cfg'], TRAIN_B)
    batch = P.assemble(ctx['hr'], ctx['lr'], idxs, draws, ctx['cfg'])
    loss, _, _, grads = loss_and_grads(
        model, ctx['master'], 'SwinIR', state.params, batch,
        torch.zeros((), dtype=torch.int32, device=idxs.device), state.elb_t)
    bad_grads = dict(grads)
    first = next(iter(bad_grads))
    bad_grads[first] = grads[first].clone()
    bad_grads[first].view(-1)[0] = float('nan')

    def copy():
        return TrainState(step=state.step.clone(),
                          params=_clone_tree(state.params),
                          opt_state=_clone_tree(state.opt_state),
                          elb_t=state.elb_t.clone())

    def leaves(st):
        out = {f'p.{k}': v for k, v in st.params.items()}
        for group, sub in st.opt_state.items():
            for f, v in sub.items():
                if torch.is_tensor(v):
                    out[f'{group}.{f}'] = v
                else:
                    out.update({f'{group}.{f}.{k}': t
                                for k, t in v.items()})
        return out

    def eager_step(st, g):
        ok = torch.isfinite(loss) & all_finite(g)
        safe = {k: torch.where(ok, x, torch.zeros_like(x))
                for k, x in g.items()}
        _eager_update(tx, st, safe, ok, 0.0)
        return ok, ~all_finite(st.params)

    eager, fused = copy(), copy()
    fu = FU.FusedUpdate(tx.options)
    mismatched, flags_ok = [], True
    for i in range(steps):
        g = bad_grads if i == nan_step else grads
        ok, bad = eager_step(eager, g)
        flags = fu.begin(loss, g, fused)
        fu.apply()
        flags_ok = flags_ok and (
            (bool(flags[0]), bool(flags[1]), bool(ok), bool(bad))
            == (i != nan_step, False, i != nan_step, False))
        want, got = leaves(eager), leaves(fused)
        mismatched += [f'{i}:{k}' for k, w in want.items()
                       if not torch.equal(got[k], w)]
    n = sum(p.numel() for p in state.params.values())
    n_state = {FU.PLAIN: 0, FU.ADAM: 2, FU.AMSGRAD: 3, FU.TRACE: 1,
               FU.NESTEROV: 1}[fu.kind]
    # the check reads the grads; the update reads the grads and reads
    # and writes the parameters and each state
    check_bytes, update_bytes = 4 * n, 4 * n * (1 + 2 * (1 + n_state))

    def run_pass():
        for _ in range(reps):
            fu.begin(loss, grads, fused)
            fu.apply()
    dev_ms = _kernel_device_ms(run_pass, ('check_kernel', 'update_kernel'))
    eager_ms = _kernel_device_ms(lambda: eager_step(eager, grads), ())
    rec = dict(
        model='SwinIR x8 flagship after the train phase, f32 parameters, '
        'Adam lr 2e-4 wd 1e-4 (MultiStepLR)', batch=TRAIN_B,
        n_params=n, n_leaves=len(state.params), tables=len(fu._tabs),
        steps=steps, nan_step=nan_step, flags_ok=flags_ok,
        mismatched=mismatched[:20], n_mismatched=len(mismatched),
        check_ms=dev_ms['check_kernel'][0] / reps,
        update_ms=dev_ms['update_kernel'][0] / reps,
        launches_per_step={k: dev_ms[k][1] / reps
                           for k in ('check_kernel', 'update_kernel')},
        check_bound=bound(0, check_bytes),
        update_bound=bound(0, update_bytes),
        eager_device_ms=eager_ms['all'][0],
        eager_kernels=eager_ms['all'][1], nvidia_smi=smi)
    rec['pass_ms'] = rec['check_ms'] + rec['update_ms']
    ok = (flags_ok and not mismatched and rec['tables'] == 1
          and rec['launches_per_step'] == {'check_kernel': 1.0,
                                           'update_kernel': 1.0})
    return rec, ok


def compare_paths(dev, ctx, n=16, pair=False):
    """One step's loss and grads through the kernels and through the
    plain versions (every stack's fused block, or with `pair` its fused
    pair, swapped), from the same weights and batch of n patches, in
    bf16 (the flagship) and in f32 (the same weights with amp off)."""
    import functools
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.ops import swin_block as sb
    from srcaco2_tpu_torch.train.steps import loss_and_grads
    idxs, draws = step_inputs(ctx['gen'], ctx['cfg'], n)
    batch = P.assemble(ctx['hr'], ctx['lr'], idxs, draws, ctx['cfg'])
    attr = 'pair_op' if pair else 'fused_op'
    kernel_op = sb.fused_swin_block_pair if pair else sb.fused_swin_block
    plain = functools.partial(kernel_op, plain=True)
    out = {}
    f32_model = define_g({**ctx['args'], 'amp': False}, dev)
    f32_model.load_state_dict(ctx['model'].state_dict())
    allow = torch.backends.cudnn.allow_tf32
    for name, model in (('bf16', ctx['model']), ('f32', f32_model)):
        torch.backends.cudnn.allow_tf32 = name != 'f32'
        params = dict(model.named_parameters())
        stacks = block_stacks(model, pair)
        runs = {}
        for path in ('kernel', 'plain'):
            for m in stacks:
                setattr(m, attr, plain if path == 'plain' else kernel_op)
            loss, _, _, grads = loss_and_grads(model, ctx['master'],
                                               'SwinIR', params, batch, 0,
                                               1.0)
            runs[path] = (float(loss), grads)
        for m in stacks:
            setattr(m, attr, kernel_op)
        (lk, gk), (lp, gp) = runs['kernel'], runs['plain']
        rel = {k: _rel_l2(gk[k], gp[k]) for k in gk}
        worst = max(rel, key=rel.get)
        tol = dict(loss_rtol=1e-2, grad_rel_l2=3e-2) if name == 'bf16' \
            else dict(loss_rtol=1e-5, grad_rel_l2=1e-4)
        out[name] = dict(loss_kernel=lk, loss_plain=lp,
                         loss_rel=abs(lk - lp) / abs(lp),
                         grad_rel_l2_max=rel[worst], worst_param=worst,
                         grads_finite=all(bool(torch.isfinite(g).all())
                                          for g in gk.values()), **tol)
        out[name]['ok'] = (out[name]['loss_rel'] <= tol['loss_rtol']
                           and rel[worst] <= tol['grad_rel_l2']
                           and out[name]['grads_finite'])
    torch.backends.cudnn.allow_tf32 = allow
    del f32_model
    return (dict(batch=n, blocks='pairs' if pair else 'one by one', **out),
            all(v['ok'] for v in out.values()))


def wmsa_cases(dev, gen):
    """K6's check cases: (name, qkv (W, N, 3C) f32, bias (heads, N, N)
    f32, mask (nW, N, N) or None, heads), unit-variance inputs."""
    import torch
    from srcaco2_tpu_torch.models.swinir import shift_attn_mask

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def rand_mask(nw, n):
        return torch.where(torch.rand((nw, n, n), generator=gen) < 0.2,
                           -100.0, 0.0).to(dev)

    qkv, bias = randn(WMSA_W, WMSA_N, 3 * C), randn(HEADS, WMSA_N, WMSA_N)
    shift = torch.as_tensor(shift_attn_mask(LR, LR, WS, WS // 2)).to(dev)
    return [('eval_no_mask', qkv, bias, None, HEADS),
            ('eval_shift_mask', qkv, bias, shift, HEADS),
            ('jax_test_w12', randn(12, 64, 3 * 64), randn(4, 64, 64),
             rand_mask(12, 64), 4),
            # 7x7 windows: odd windows' qkv and output blocks are not
            # 16-byte aligned, rows of the bias and mask not 4-byte
            ('n49', randn(24, 49, 3 * C), randn(HEADS, 49, 49),
             rand_mask(8, 49), HEADS),
            ('hd64', randn(32, 64, 3 * 256), randn(4, 64, 64),
             rand_mask(32, 64), 4),
            # a window block over the mma body's shared-memory budget:
            # the fma body in bf16 too
            ('c512', randn(16, 64, 3 * 512), randn(8, 64, 64), None, 8)]


def wmsa_precision(out, ref, qkv):
    """How close a bf16 K6 output (W, N, C) is to the plain version's
    `ref` on qkv (W, N, 3C), beyond WMSA_TOL: the largest distance in
    bf16 ulps (adjacent bf16 values are one apart), the outputs more
    than one ulp apart, the outputs further apart than one ulp of the
    larger magnitude plus WMSA_VMAX_SHARE of the largest |v| of their
    window and column (none may be), and the share of outputs that
    differ at all (at most WMSA_DIFFER_MAX)."""
    import torch
    o, r = out.float(), ref.float()
    w, n, c3 = qkv.shape
    vmax = qkv.float().reshape(w, n, 3, c3 // 3)[:, :, 2].abs().amax(
        dim=1, keepdim=True)
    _, e = torch.frexp(torch.maximum(o.abs(), r.abs()).clamp_min(2.0 ** -126))
    ulp = torch.exp2((e - 8).float())
    d = (o - r).abs()

    def ordinal(t):         # bf16 bits as integers in the values' order
        b = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(b < 0, -(b & 0x7fff), b)
    ulps = (ordinal(out) - ordinal(ref)).abs()
    beyond = int((d > ulp + WMSA_VMAX_SHARE * vmax).sum())
    share = float((d > 0).float().mean())
    return dict(max_ulps_vs_plain=int(ulps.max()),
                n_over_one_ulp=int((ulps > 1).sum()),
                n_outside_ulp_bound=beyond, share_differ_vs_plain=share,
                vmax_share=WMSA_VMAX_SHARE, differ_max=WMSA_DIFFER_MAX,
                ulp_ok=beyond == 0 and share <= WMSA_DIFFER_MAX)


def wmsa_body_choice(build, shapes):
    """[(n, c, heads, _k6_body's pick, the library's)] for bf16 qkv: the
    wrapper's copy of the mma body's shape rule against the library's
    own (window_attention_mma_smem >= 0)."""
    import ctypes
    import torch
    from srcaco2_tpu_torch.ops import window_attention as wa
    fn = build.library('window_attention').window_attention_mma_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return [(n, c, heads, wa._k6_body(torch.bfloat16, n, c, heads),
             'mma' if fn(n, c, heads) >= 0 else 'fma')
            for n, c, heads in shapes]


def kernel_check_wmsa(dev, gen):
    """K6 against its plain version on every case of wmsa_cases, f32 and
    bf16 (bias in the compute dtype, as the model hands it over), under
    WMSA_TOL: in bf16 both bodies where the mma body takes the shape,
    each also under wmsa_precision, the body window_attention picks
    (_k6_body) recorded and held against the library's own shape rule,
    two calls of the mma body compared bit for bit, and the elements
    where the bodies differ counted; and K6 raises when autograd would
    need its gradient."""
    import torch
    from srcaco2_tpu_torch.ops import build
    from srcaco2_tpu_torch.ops import window_attention as wa
    recs, ok = [], True
    cases = wmsa_cases(dev, gen)
    # the cases' shapes and the edges of the mma body's rule: an odd
    # head width, C = 418 (the largest window block in its budget), 420
    choice = wmsa_body_choice(build, [
        (q.shape[1], q.shape[2] // 3, h) for _, q, _, _, h in cases]
        + [(64, 180, 4), (64, 418, 11), (64, 420, 10), (49, 418, 11)])
    recs.append(dict(case='body_choice_vs_library', shapes=choice,
                     ok=all(a == b for *_, a, b in choice)))
    ok = recs[-1]['ok']
    for name, qkv, bias, mask, heads in cases:
        for dt_name, dt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
            q, b = qkv.to(dt), bias.to(dt)
            w, n, c3 = q.shape
            picked = wa._k6_body(dt, n, c3 // 3, heads)
            out_r = wa.window_attention_ref(q, b, mask, heads)
            outs = {}
            for body in dict.fromkeys((picked, 'fma')):
                wa._check(q, b, mask, heads)
                out_k = wa._run(body, q, b, mask, heads)
                torch.cuda.synchronize()
                diff = (out_k.float() - out_r.float()).abs()
                tol = WMSA_TOL[dt_name]
                bad = int((diff > tol['atol']
                           + tol['rtol'] * out_r.float().abs()).sum())
                finite = bool(torch.isfinite(out_k.float()).all())
                rec = dict(case=name, dtype=dt_name, body=body,
                           picked=body == picked, shape=list(q.shape),
                           heads=heads,
                           n_mask=None if mask is None else mask.shape[0],
                           max_abs_err=float(diff.max()), n_outside=bad,
                           n_differ_vs_plain=int((diff > 0).sum()),
                           finite=finite, ok=bad == 0 and finite, **tol)
                if dt_name == 'bf16':
                    rec.update(wmsa_precision(out_k, out_r, q))
                    rec['ok'] = rec['ok'] and rec['ulp_ok']
                if body == 'mma':
                    rec['bit_identical_twice'] = bit_identical(
                        out_k, wa._run(body, q, b, mask, heads))
                    rec['ok'] = rec['ok'] and rec['bit_identical_twice']
                outs[body] = out_k
                recs.append(rec)
                ok = ok and rec['ok']
            if 'mma' in outs:
                recs[-2]['n_differ_vs_fma'] = int(
                    (outs['mma'] != outs['fma']).sum())
    # bf16 qkv with an f32 bias: the mma body reads the bias in f32
    _, qkv, bias, mask, heads = cases[1]
    q = qkv.to(torch.bfloat16)
    ref = wa.window_attention_ref(q, bias, mask, heads)
    out = wa._run('mma', q, bias, mask, heads)
    diff = (out.float() - ref.float()).abs()
    tol = WMSA_TOL['bf16']
    bad = int((diff > tol['atol'] + tol['rtol'] * ref.float().abs()).sum())
    recs.append(dict(case='eval_shift_mask_f32_bias', dtype='bf16',
                     body='mma', picked=False, max_abs_err=float(diff.max()),
                     n_outside=bad, **tol, **wmsa_precision(out, ref, q)))
    recs[-1]['ok'] = bad == 0 and recs[-1]['ulp_ok']
    ok = ok and recs[-1]['ok']
    q = cases[2][1].clone().requires_grad_(True)
    try:
        wa.window_attention(q, torch.zeros(4, 64, 64, device=dev), None,
                            heads=4)
        raised = False
    except RuntimeError as e:       # the refusal, not any other fault
        raised = 'no backward' in str(e)
    recs.append(dict(case='raises_under_grad', ok=raised))
    return recs, ok and raised


def kernel_time_wmsa(dev, gen):
    """Median ms of K6 (bf16, the eval shape, with the shift mask and
    without) through the body window_attention picks (the mma body) and
    of the fma body (the parent's) through the private body choice, and
    of its plain version, beside the bound; and the library time:
    F.scaled_dot_product_attention on the same q, k, v split into (W,
    heads, N, hd) with the (W, heads, N, N) additive bias + mask built
    beforehand (not timed). Every `ms` is call by call (cuda_ms), as for
    K1-K5, the wrapper's host code included; `graph_ms` replays CUDA
    graphs of the same calls (the device time alone: the mma body takes
    less time than its wrapper's host code). The plain version and the
    library call are timed call by call only (cuBLAS would keep a
    workspace for each stream that graph_ms runs it on)."""
    import torch
    import torch.nn.functional as F
    from srcaco2_tpu_torch.ops import window_attention as wa
    dt = torch.bfloat16
    _, qkv, bias, mask, _ = wmsa_cases(dev, gen)[1]
    q, b = qkv.to(dt), bias.to(dt)
    body = wa._k6_body(dt, WMSA_N, C, HEADS)
    calls = {body: lambda: wa.window_attention(q, b, mask, heads=HEADS),
             'fma': lambda: wa._run('fma', q, b, mask, HEADS)}
    body_ms = {k: cuda_ms(fn) for k, fn in calls.items()}
    body_graph_ms = {k: graph_ms(fn) for k, fn in calls.items()}
    ms = body_ms[body]
    ms_no_mask = cuda_ms(lambda: wa.window_attention(q, b, None,
                                                     heads=HEADS))
    plain_ms = cuda_ms(lambda: wa.window_attention_ref(q, b, mask, HEADS),
                       reps=3, per=3)
    w, n, hd = WMSA_W, WMSA_N, C // HEADS
    qs, ks, vs = (t.contiguous() for t in
                  q.reshape(w, n, 3, HEADS, hd).permute(2, 0, 3, 1, 4))
    win = torch.arange(w, device=dev) % mask.shape[0]
    am = (b.float()[None] + mask[win][:, None]).to(dt).contiguous()
    lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am)
    lib_err = float((lib.permute(0, 2, 1, 3).reshape(w, n, C).float()
                     - wa.window_attention_ref(q, b, mask, HEADS).float())
                    .abs().max())
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=am))
    nbytes = (q.numel() * q.element_size() + w * n * C * q.element_size()
              + b.numel() * b.element_size()
              + mask.numel() * mask.element_size())
    bnd = bound(4 * w * HEADS * n * n * hd, nbytes)
    return dict(kernel='window_attention', dtype='bf16', shape=list(q.shape),
                heads=HEADS, mask='shift 4 of a 64x64 image (nW=64)',
                body=body, ms=ms, graph_ms=body_graph_ms[body],
                ms_no_mask=ms_no_mask, body_ms=body_ms,
                body_graph_ms=body_graph_ms,
                bound_share={k: bnd['bound_ms'] / v
                             for k, v in body_ms.items()},
                bound_share_graph={k: bnd['bound_ms'] / v
                                   for k, v in body_graph_ms.items()},
                plain_ms=plain_ms,
                library='F.scaled_dot_product_attention, prebuilt bf16 '
                '(W, heads, N, N) mask', library_ms=library_ms,
                library_vs_plain_max_abs=lib_err, **bnd,
                tflops=bnd['flops'] / ms / 1e9,
                gbytes_per_s=nbytes / ms / 1e6)


def unfused_flagship(dev, dtype):
    """The x8 flagship with unfused blocks and K6's attention core
    (use_pallas_attn), random weights from seed 0, evaluation mode."""
    import torch
    from srcaco2_tpu_torch.models.swinir import SwinIR
    model = SwinIR(in_chans=1, upscale=SCALE, window_size=WS, embed_dim=C,
                   depths=(6,) * 6, num_heads=(HEADS,) * 6, mlp_ratio=2.0,
                   upsampler='pixelshuffledirect', dtype=dtype,
                   fused_blocks=False, use_pallas_attn=True, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.eval()


def set_attn_op(model, op):
    from srcaco2_tpu_torch.models.swinir import WindowAttention
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.attn_op = op


def eval_unfused(dev, smi, iters=10):
    """make_eval_forward over the unfused flagship (bf16) at batch 8 on
    64x64 LR: a warm-up forward, then `iters` timed forwards with the
    launch counts read around them; the K6 path and the plain path
    against an f32 plain-path reference; the eval metrics (border =
    scale, ROI over thresholds 4..10) of the prediction against a random
    HR batch, on the card and on the CPU."""
    import numpy as np
    import torch
    from srcaco2_tpu_torch import constants
    from srcaco2_tpu_torch.models.swinir import WindowAttention
    from srcaco2_tpu_torch.ops import window_attention as wa
    from srcaco2_tpu_torch.train import evaluator as E
    from srcaco2_tpu_torch.train.steps import make_eval_forward
    model = unfused_flagship(dev, torch.bfloat16)
    n_attn = sum(isinstance(m, WindowAttention) for m in model.modules())
    fwd = make_eval_forward(model, 'SwinIR', SCALE)
    rng = np.random.default_rng(1)
    lr_u8 = rng.integers(0, 256, (BATCH, 1, LR, LR), dtype=np.uint8)
    hr_u8 = rng.integers(0, 256, (BATCH, 1, LR * SCALE, LR * SCALE),
                         dtype=np.uint8)
    batch = {'l_im': torch.from_numpy(lr_u8).to(dev).float() / 255.0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd(None, batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(iters):
        pred = fwd(None, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    bodies = dict(wa.window_attention.body_launches)
    peak = torch.cuda.max_memory_allocated()

    def plain_op(qkv, bias, mask, *, heads):
        return wa.window_attention_ref(qkv, bias, mask, heads)

    with torch.inference_mode():
        y_k = model(batch['l_im'])
        set_attn_op(model, plain_op)
        y_p = model(batch['l_im'])
        set_attn_op(model, wa.window_attention)
        allow = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        ref = unfused_flagship(dev, torch.float32)
        ref.load_state_dict(model.state_dict())
        set_attn_op(ref, plain_op)
        y_32 = ref(batch['l_im'])
        torch.backends.cudnn.allow_tf32 = allow
        del ref
    err_k, err_p = (y_k - y_32).abs(), (y_p - y_32).abs()
    finite = bool(torch.isfinite(y_k).all() and torch.isfinite(y_p).all())
    close = bool(err_k.mean() <= 1.25 * err_p.mean()
                 and err_k.max() <= 2.0 * err_p.max())

    ths = tuple(constants.ROI_THRESH)
    hr = torch.from_numpy(hr_u8).to(dev).float()
    m_card = E.make_metric_fn(SCALE, True, ths)(pred, hr)
    m_cpu = E.make_metric_fn(SCALE, True, ths)(pred.cpu(), hr.cpu())
    tol = {'psnr': 1e-3, 'psnr_y': 1e-3, 'mse': 1e-2, 'nrmse': 1e-6,
           'ssim': 1e-5}
    metrics, metrics_ok = {}, True
    for part in ('full', 'roi'):
        for k, v in m_card[part].items():
            a, c = v.cpu().double(), m_cpu[part][k].double()
            err = float((a - c).abs().max())
            good = (bool(torch.isfinite(a).all())
                    and err <= tol[k] + 1e-5 * float(c.abs().max()))
            metrics[f'{part}_{k}'] = dict(card_mean=float(a.mean()),
                                          cpu_mean=float(c.mean()),
                                          max_abs_diff=err, ok=good)
            metrics_ok = metrics_ok and good
    rec = dict(
        model='SwinIR x8 pixelshuffledirect C=180 6x6 heads 6 ws 8, '
        'unfused blocks, use_pallas_attn (K6), bf16 compute over f32 '
        'params, random weights (seed 0), make_eval_forward',
        batch=BATCH, lr_hw=[LR, LR], iters=iters, warmup_s=warm_s,
        ms_per_batch=1e3 * dt / iters, images_per_s=BATCH * iters / dt,
        max_memory_allocated=peak, attention_layers=n_attn,
        launches=launches,
        launches_per_forward={k: v / iters for k, v in launches.items()},
        wmsa_body_launches=bodies,
        pred_shape=list(pred.shape),
        pred_is_uint8_valued=bool((pred == pred.round()).all()
                                  and pred.min() >= 0 and pred.max() <= 255),
        finite=finite,
        out_kernel_vs_plain_max_abs=float((y_k - y_p).abs().max()),
        out_kernel_vs_f32_mean_abs=float(err_k.mean()),
        out_kernel_vs_f32_max_abs=float(err_k.max()),
        out_plain_vs_f32_mean_abs=float(err_p.mean()),
        out_plain_vs_f32_max_abs=float(err_p.max()),
        kernel_as_close_as_plain=close, metrics=metrics,
        metrics_card_vs_cpu_ok=metrics_ok, nvidia_smi=smi)
    ok = (n_attn == 36 and launches['wmsa'] == n_attn * iters
          and bodies['mma'] == n_attn * iters
          and all(v == 0 for k, v in launches.items() if k != 'wmsa')
          and rec['pred_shape'] == [BATCH, 1, LR * SCALE, LR * SCALE]
          and rec['pred_is_uint8_valued'] and finite and close
          and metrics_ok)
    return rec, ok, (fwd, batch)


def default_x2_args(amp):
    """The default SwinIR of config/defaults.py at full width: x2, C=180,
    6 x 6 blocks of 6 heads, window 8, pixelshuffle, h_size 96 (48x48 LR
    patches), one channel as the entry runs' data; l2 + 5 neg-SSIM(19)."""
    from srcaco2_tpu_torch.config.defaults import get_config
    args = get_config()
    args.update(n_channels=1, amp=amp, l2=True, ssim=True, ssim_lambda=5.0,
                ssim_window_s=19)
    args['netG']['swinir_in_chans'] = 1
    return args


def hold_to_floor(e, floor, own, tol, floor_above):
    """The bf16 rule of windowed_check and zoo_check for one value (a loss
    or a grad), `e` its distance from the CPU's: within `tol`, or else
    held to the CPU's bf16 noise floor (`floor`: the CPU's bf16 value
    against its f32 value of the same weights and batch) over
    `floor_above`, with e within 2 x floor and the card's bf16 value no
    further from the card's f32 value (`own`) than 1.25 x floor + 1e-3.
    The floor is the CPU's alone."""
    return e <= tol or (floor > floor_above and e <= 2 * floor
                        and own <= 1.25 * floor + 1e-3)


def bf16_grads_held(card, cpu, card32, cpu32, tol=3e-2, floor_above=1.5e-2):
    """hold_to_floor over every grad ({name: tensor}, bf16 runs against
    the same device's f32 run): (ok, {name: relative L2 card vs CPU},
    {name: the floor's readings} of the grads over tol)."""
    rel = {k: _rel_l2(card[k], cpu[k]) for k in card}
    floored = {}
    for k, e in rel.items():
        if e > tol:
            floor, own = _rel_l2(cpu[k], cpu32[k]), _rel_l2(card[k], card32[k])
            floored[k] = dict(card_vs_cpu=e, cpu_bf16_vs_f32=floor,
                              card_bf16_vs_f32=own,
                              ok=hold_to_floor(e, floor, own, tol,
                                               floor_above))
    return all(f['ok'] for f in floored.values()), rel, floored


def windowed_check(dev):
    """The windowed path of FusedBlockStack on the card (48x48 LR
    training patches, T = 2304 > 256; an eval forward at 40x40 LR, a
    multiple of 8 and not of 16) against the same on the CPU: one
    training step's loss and grads at batch 8 from the same weights and
    the same batch (its draws made on the card, the batch copied to the
    CPU), f32 with TF32 off and bf16 (amp); no kernel may launch on
    these paths.

    f32: loss within 1e-5 relative, every grad within 1e-4 relative L2.
    bf16: loss within 1e-2, every grad within 3e-2, except a grad over
    3e-2 whose bf16 noise floor is above 1.5e-2 (`floor`: the CPU's bf16
    grad against its f32 grad of the same weights and batch; the
    relative position bias tables, ~6%, whose grads cancel over each
    softmax row and reach them through bf16 autograd): that one within
    2 x floor of the CPU's, and the card's bf16 grad no further from the
    card's f32 grad than 1.25 x floor + 1e-3 (`floored` lists them)."""
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.steps import loss_and_grads
    from srcaco2_tpu_torch.utils import reproducibility as R
    b, h_size, n_img = 8, 96, 16
    gen = torch.Generator(device=dev).manual_seed(1)
    hr = torch.randint(0, 256, (n_img, 192, 192, 1), generator=gen,
                       device=dev, dtype=torch.uint8)
    lr = torch.randint(0, 256, (n_img, 96, 96, 1), generator=gen,
                       device=dev, dtype=torch.uint8)
    cfg = P.PipeConfig(scale=2, h_size=h_size)
    idxs = torch.arange(b, device=dev)
    batch = P.assemble(hr, lr, idxs, P.draw(R.step_generator(0, 0, dev), b,
                                            cfg, (192, 192)), cfg)
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for name, amp in (('f32', False), ('bf16', True)):
        args = default_x2_args(amp)
        master = build_loss(args)
        for d in (dev, torch.device('cpu')):
            model = define_g(args, d, seed=0).train()
            params = dict(model.named_parameters())
            bt = batch if d.type == 'cuda' else batch_cpu
            reset_launches()
            if d.type == 'cuda':
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _, _, grads = loss_and_grads(model, master, 'SwinIR',
                                               params, bt, 0, 1.0)
            if d.type == 'cuda':
                torch.cuda.synchronize()
            runs[name, d.type] = dict(
                loss=float(loss), grads={k: g.cpu() for k, g in grads.items()},
                seconds=time.perf_counter() - t0,
                launches=read_launches(),
                peak=(torch.cuda.max_memory_allocated() if d.type == 'cuda'
                      else None))
            del model, params, grads
    out, ok = {}, True
    for name in ('f32', 'bf16'):
        c, r = runs[name, 'cuda'], runs[name, 'cpu']
        if name == 'f32':
            tol = dict(loss_rtol=1e-5, grad_rel_l2=1e-4)
            rel = {k: _rel_l2(c['grads'][k], r['grads'][k])
                   for k in c['grads']}
            grads_ok, floored = max(rel.values()) <= 1e-4, {}
        else:
            tol = dict(loss_rtol=1e-2, grad_rel_l2=3e-2, floor_above=1.5e-2)
            grads_ok, rel, floored = bf16_grads_held(
                c['grads'], r['grads'], runs['f32', 'cuda']['grads'],
                runs['f32', 'cpu']['grads'])
        worst = max(rel, key=rel.get)
        rec = dict(loss_card=c['loss'], loss_cpu=r['loss'],
                   loss_rel=abs(c['loss'] - r['loss']) / abs(r['loss']),
                   grad_rel_l2_max=rel[worst], worst_param=worst,
                   grad_rel_l2_max_unfloored=max(
                       (v for k, v in rel.items() if k not in floored),
                       default=0.0),
                   floored=floored, n_grads=len(rel),
                   grads_finite=all(bool(torch.isfinite(g).all())
                                    for g in c['grads'].values()),
                   card_seconds=c['seconds'], cpu_seconds=r['seconds'],
                   card_max_memory_allocated=c['peak'],
                   launches=c['launches'], **tol)
        rec['ok'] = (rec['loss_rel'] <= tol['loss_rtol'] and grads_ok
                     and rec['grads_finite']
                     and all(v == 0 for v in c['launches'].values()))
        out[f'train_{name}'] = rec
        ok = ok and rec['ok']
    del runs
    # an f32 evaluation forward at 40x40 LR
    args = default_x2_args(False)
    x = torch.rand((2, 1, 40, 40), generator=torch.Generator().manual_seed(2))
    ys = {}
    reset_launches()
    for d in (dev, torch.device('cpu')):
        model = define_g(args, d, seed=0)
        with torch.inference_mode():
            ys[d.type] = model(x.to(d)).cpu()
        del model
    launches = read_launches()
    err = float((ys['cuda'] - ys['cpu']).abs().max())
    out['eval_f32_40x40'] = dict(
        shape=list(ys['cuda'].shape), max_abs_diff=err, atol=2e-4,
        launches=launches,
        ok=(err <= 2e-4 and list(ys['cuda'].shape) == [2, 1, 80, 80]
            and bool(torch.isfinite(ys['cuda']).all())
            and all(v == 0 for v in launches.values())))
    ok = ok and out['eval_f32_40x40']['ok']
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        allow
    return out, ok


def windowed_profile(dev, smi, steps=5):
    """The default x2 train step (f32 with TF32 off, batch 8 of 48x48 LR
    patches: the windowed path, l2 + 5 neg-SSIM, Adam) in this process:
    one warm-up step, `steps` timed steps (host clock, synchronised),
    then the device time of one step by kernel and the device's busy
    share (profile_device)."""
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.schedule import build_optimizer
    from srcaco2_tpu_torch.train.state import TrainState
    from srcaco2_tpu_torch.train.steps import make_train_step
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = default_x2_args(False)
    model = define_g(args, dev, seed=0).train()
    tx = build_optimizer(args['train'])
    state = TrainState.create(dict(model.named_parameters()), tx)
    cfg = P.PipeConfig(scale=2, h_size=96)
    step = make_train_step(model, build_loss(args), tx, 'SwinIR', cfg,
                           steps_per_epoch=1000)
    gen = torch.Generator(device=dev).manual_seed(3)
    hr = torch.randint(0, 256, (32, 512, 512, 1), generator=gen, device=dev,
                       dtype=torch.uint8)
    lr = torch.randint(0, 256, (32, 256, 256, 1), generator=gen, device=dev,
                       dtype=torch.uint8)

    def inputs():
        idxs = torch.randint(0, 32, (8,), generator=gen, device=dev)
        return idxs, P.draw(gen, 8, cfg, (512, 512))
    state, _, _ = step(state, hr, lr, *inputs())
    batches = [inputs() for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for b in batches:
        state, holder, ok = step(state, hr, lr, *b)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    b = inputs()
    prof = profile_device(lambda: step(state, hr, lr, *b), ms)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        allow
    rec = dict(model='SwinIR x2 pixelshuffle C=180 6x6 heads 6 ws 8 '
               '(config/defaults.py), f32, random weights (seed 0)',
               batch=8, lr_patch=[48, 48], steps=steps, ms_per_step=ms,
               patches_per_s=8e3 / ms, max_memory_allocated=peak,
               loss=float(holder['total']), launches=launches, **prof,
               nvidia_smi=smi)
    ok = (bool(torch.isfinite(holder['total'])) and bool(ok)
          and all(v == 0 for v in swin_launches(launches).values())
          and update_launched(launches, steps))
    return rec, ok


# the zoo (every ported net but SwinIR) at its full default width, x8 on
# 16x16 LR patches (h_size 128), one channel
ZOO = ('DFCAN', 'SRCNN', 'VDSR', 'MSLapSRN', 'SRFBN', 'ENLCN', 'ACT',
       'OmniSR', 'NLSN', 'GRL', 'DRRN', 'MemNet', 'DBPN', 'ProSR',
       'DSRSplines', 'CSRCNN', 'EDSR_LIIF')
# zoo_check's variants of a net: name -> (net, netG over its defaults,
# loss flags over zoo_args'): CSR-CNN's grouped small CNN and its
# segmentation task with the ce loss
ZOO_VARIANTS = {
    'CSRCNN_snet3': ('CSRCNN', dict(csrcnn_net_type='snet_type3'), {}),
    'CSRCNN_seg': ('CSRCNN', dict(net_task='segmentation'), dict(ce=True))}
ZOO_CHECKED = ZOO + tuple(ZOO_VARIANTS)
# zoo_train's timed steps: DFCAN's as bench.py's, the later parts of the
# zoo fewer than the first
ZOO_STEPS = {'DFCAN': 10, 'NLSN': 3, 'GRL': 3, 'DRRN': 3, 'MemNet': 3,
             'DBPN': 3, 'ProSR': 3, 'DSRSplines': 3, 'CSRCNN': 3,
             'EDSR_LIIF': 3}
# zoo_check's depth cuts (full width), which keep the whole script in
# about two thirds of its time limit: at full depth the CPU side and the
# float64 op replay of MemNet (216 block applications at HR size) took
# 538 s, DRRN's (50 convs of 128 channels at HR size) 89 s, GRL's (40
# blocks) 67 s, OmniSR's 62 s, SRFBN's 48 s, NLSN's 37 s, ACT's 33 s
# and ENLCN's 26 s on the card's host. MemNet keeps the recursion (one
# memory block: the same 3-block chain 3 times, each BatchNorm moved 3
# times), DRRN 6 applications of its shared unit, GRL two stages of 4
# blocks (both shifts and stripe kinds), OmniSR 2 of its 5 groups,
# SRFBN its 4 feedback steps over 3 of its 6 groups, NLSN 16 of its 32
# blocks (3 attention layers), ACT 4 of its 12 blocks per group. ENLCN
# keeps its depth: at 16 blocks its bf16 step is gated end to end (the
# control moves no grad) and one bias grad of its third attention layer
# lay 1.4 x the tolerance from the CPU's, with every op within its
# rounding (a run on an NVIDIA H100 80GB HBM3 at 700 W)
ZOO_CHECK_NETG = {
    'MemNet': dict(memnet_num_memory_blocks=1,
                   memnet_num_residual_blocks=3),
    'DRRN': dict(drrn_num_residual_units=6),
    'GRL': dict(grl_depths=[4, 4], grl_num_heads_window=[3, 3],
                grl_num_heads_stripe=[3, 3]),
    'OmniSR': dict(omnisr_res_num=2),
    'SRFBN': dict(srfbn_num_groups=3),
    'NLSN': dict(nlsn_n_resblocks=16),
    'ACT': dict(act_n_resblocks=4),
    # DBPN one of its 3 stages (13 projection blocks), ProSR 1 of the 9
    # dense residual blocks of its first level (and the others' whole)
    'DBPN': dict(dbpn_num_stages=1),
    'ProSR': dict(prosr_level_config={8: [[8], [8] * 3, [8]]})}
# intermediate outputs at x8: SRFBN's 4 steps, MSLapSRN's and ProSR's
# first 2 levels
ZOO_LEVELS = {'SRFBN': 4, 'MSLapSRN': 2, 'ProSR': 2}
# README.md:91-100's batch, and bench.py's DFCAN step (bench.py:221-240)
ZOO_BATCH, DFCAN_BATCH = 64, TRAIN_B
# the nets whose train step zoo_train profiles: bench.py's, the slowest
# steps of each part of the zoo, DBPN (cuDNN's k12 / s8 strided and
# transposed convs) and EDSR-LIIF (the gather and its f32 segment sums)
ZOO_PROFILED = ('DFCAN', 'ACT', 'OmniSR', 'GRL', 'MemNet', 'DBPN',
                'EDSR_LIIF')
# zoo_check's bf16 control: the CPU's step again from weights moved by
# ZOO_JITTER relative; where it moves more than ZOO_NOISE_SHARE of the
# grads beyond the tolerance from the CPU's first run, the per-grad rule
# does not hold that net end to end
ZOO_JITTER, ZOO_NOISE_SHARE = 2.0 ** -20, 0.01


def zoo_args(nt, amp):
    """nt's defaults (config/net_defaults.py) at x8, h_size 128, one
    channel; l2 + 5 neg-SSIM(19), as the README's command."""
    from srcaco2_tpu_torch.config.defaults import get_config
    from srcaco2_tpu_torch.config.net_defaults import init_net_g
    args = get_config(nt)
    args.update(scale=SCALE, n_channels=1, h_size=H_SIZE, amp=amp, l2=True,
                ssim=True, ssim_lambda=5.0, ssim_window_s=19)
    args['netG'] = init_net_g({'net_type': nt}, args)
    return args


def zoo_check_args(name, amp):
    """zoo_args of a net or a variant (ZOO_VARIANTS) with zoo_check's
    depth cut (ZOO_CHECK_NETG)."""
    nt, netg, flags = ZOO_VARIANTS.get(name, (name, {}, {}))
    args = zoo_args(nt, amp)
    args.update(flags)
    args['netG'].update(netg)
    args['netG'].update(ZOO_CHECK_NETG.get(nt, {}))
    return args


def zoo_batch(dev, b, seed):
    """A training batch of b 16x16 LR / 128x128 HR patches (and the
    bicubic pre-upscale) assembled on `dev` from random uint8 images."""
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.utils import reproducibility as R
    gen = torch.Generator(device=dev).manual_seed(seed)
    hr = torch.randint(0, 256, (b, H_SIZE, H_SIZE, 1), generator=gen,
                       device=dev, dtype=torch.uint8)
    lr = torch.randint(0, 256, (b, PATCH, PATCH, 1), generator=gen,
                       device=dev, dtype=torch.uint8)
    cfg = P.PipeConfig(scale=SCALE, h_size=H_SIZE)
    return P.assemble(hr, lr, torch.arange(b, device=dev),
                      P.draw(R.step_generator(seed, 0, dev), b, cfg,
                             (H_SIZE, H_SIZE)), cfg)


# the op replay's tolerance, relative L2 of the card's output against the
# float64 result of the same op on the same inputs, by the card's output
# dtype: f32 (TF32 off) and complex64 within 1e-5, far under TF32's
# ~5e-4; bf16 within 2^-7, four times the output's own rounding (2^-9)
REPLAY_TOL = {'float32': 1e-5, 'complex64': 1e-5, 'bfloat16': 2.0 ** -7,
              'float64': 1e-12}
# ops whose output the replay does not hold: storage without values
# (empty*) and a tensor read out to the host as a number
REPLAY_SKIP = ('aten.empty', 'aten.new_empty', 'aten._local_scalar_dense')
# linear reductions (sums of products): an output that cancels is held to
# the tolerance of the same op on the inputs' absolute values
REPLAY_SUMS = ('aten.sum', 'aten.mean', 'aten.mm', 'aten.bmm', 'aten.addmm',
               'aten.baddbmm', 'aten.convolution')


def op_replay():
    """A dispatch mode that runs every aten op of the code under it (the
    forward and, through autograd, the backward) as usual, and again on
    the CPU in float64 (complex128) from copies of the same inputs, and
    holds each floating output to that result within REPLAY_TOL of its
    dtype (relative L2). Over that, a linear reduction (REPLAY_SUMS)
    passes if its distance is within the tolerance of the float64 result
    on the inputs' absolute values (the sum of the terms' sizes: an
    output that cancels keeps only the f32 sums' absolute error).
    Integer outputs are held equal, except indices beside their values
    (a max pool's: ties; the values are held). Views, random ops and
    storage without values are not held; an op that cannot run on the
    CPU is a failure. Every input is the card's own, so the rounding
    noise of one op does not reach the next: each op is held alone.

    `summary()` gives per op: calls, the distance furthest over (or
    least under) its tolerance, calls held by the absolute values, the
    bf16 outputs and how many of them are not the float64 result
    rounded (`n_off`: a different sum order flips few; a different
    constant or intermediate rounding many), and up to 20 failures."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map

    def wide(x):
        # a float64 (complex128) CPU copy of a tensor argument, made
        # before the op runs (it may write its input); a device argument
        # becomes the CPU
        if isinstance(x, torch.Tensor):
            t = x.detach().to('cpu', copy=True)
            if t.is_complex():
                return t.to(torch.complex128)
            return t.double() if t.is_floating_point() else t
        return torch.device('cpu') if isinstance(x, torch.device) else x

    def norm(t):
        return float(t.abs().square().sum().sqrt())

    def dist(o, r, scale=None):
        n = norm(r if scale is None else scale)
        d = norm(o.detach().cpu().to(r.dtype) - r)
        return d / n if n > 0 else d

    class OpReplay(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.failures, self.skipped = {}, [], {}

        def _fail(self, name, **kw):
            self.ops[name]['failed'] += 1
            if len(self.failures) < 20:
                self.failures.append(dict(op=name, **kw))

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func)
            if (func.is_view or name.startswith(REPLAY_SKIP)
                    or torch.Tag.nondeterministic_seeded in func.tags):
                self.skipped[name] = self.skipped.get(name, 0) + 1
                return func(*args, **kwargs)
            w = tree_map(wide, (args, kwargs))
            out = func(*args, **kwargs)
            rec = self.ops.setdefault(name, dict(
                calls=0, max_over_tol=0.0, rel=None, tol=None,
                via_abs=0, max_rel_of_abs=0.0, int_mismatch=0, failed=0,
                n_out=0, n_off=0))
            rec['calls'] += 1
            try:
                ref = func(*w[0], **w[1])
            except Exception as e:      # noqa: BLE001 - recorded, fails
                self._fail(name, error=repr(e)[:300])
                return out
            outs, refs = tree_flatten(out)[0], tree_flatten(ref)[0]
            abs_outs = None
            for i, (o, r) in enumerate(zip(outs, refs)):
                if not isinstance(o, torch.Tensor):
                    continue
                if not (o.is_floating_point() or o.is_complex()):
                    if any(t.is_floating_point() for t in outs
                           if isinstance(t, torch.Tensor)):
                        continue        # indices beside their values: ties
                    bad = int((o.detach().cpu() != r.to(o.dtype)).sum())
                    rec['int_mismatch'] += bad
                    if bad:
                        self._fail(name, out=i, int_mismatch=bad)
                    continue
                tol = REPLAY_TOL[str(o.dtype).split('.')[-1]]
                if o.dtype == torch.bfloat16:
                    rec['n_out'] += o.numel()
                    rec['n_off'] += int((o.detach().cpu()
                                         != r.to(o.dtype)).sum())
                e = dist(o, r)
                if rec['tol'] is None or e / tol >= rec['max_over_tol']:
                    rec.update(max_over_tol=e / tol, rel=e, tol=tol)
                if e <= tol:
                    continue
                if name.startswith(REPLAY_SUMS):
                    if abs_outs is None:
                        a = tree_map(lambda t: t.abs() if isinstance(
                            t, torch.Tensor) and t.is_floating_point()
                            else t, w)
                        abs_outs = tree_flatten(func(*a[0], **a[1]))[0]
                    e_abs = dist(o, r, abs_outs[i])
                    rec['max_rel_of_abs'] = max(rec['max_rel_of_abs'], e_abs)
                    if e_abs <= tol:
                        rec['via_abs'] += 1
                        continue
                self._fail(name, out=i, rel=e, tol=tol,
                           dtype=str(o.dtype), shape=list(o.shape))
            return out

        def summary(self):
            return dict(
                n_calls=sum(r['calls'] for r in self.ops.values()),
                n_ops=len(self.ops),
                n_failed=sum(r['failed'] for r in self.ops.values()),
                ops=self.ops, failures=self.failures, skipped=self.skipped)

    return OpReplay()


def _as_float64(model):
    """Every module of `model` computing in float64 (the port's modules
    cast to their `dtype` attribute in their forwards): the reference in
    which a pre-activation does not cross a ReLU's kink by rounding."""
    import torch
    for m in model.modules():
        if isinstance(getattr(m, 'dtype', None), torch.dtype):
            m.dtype = torch.float64
    return model


def _levels_check(nt, model, master, batch, loss):
    """The curriculum / progressive dispatch on the card: the number of
    intermediate outputs, and the loss recomputed as the mean of the
    per-level master losses (SRFBN: each step against the target;
    MSLapSRN: the final output, then each level against the target
    resized to it)."""
    import torch
    from srcaco2_tpu_torch.ops.resize import resize2d
    from srcaco2_tpu_torch.train.steps import model_outputs, net_input
    with torch.no_grad():
        outs = model_outputs(model(net_input(nt, batch)))
        inter = outs['intermediate_outs']
        if nt == 'SRFBN':
            parts = [master({**outs, 'out': o}, batch)[0] for o in inter]
        else:
            parts = [master(outs, batch)[0]]
            for o in inter:
                t = torch.clip(resize2d(batch['h_im'], o.shape[-2:],
                                        align_corners=True), 0.0, 1.0)
                parts.append(master({**outs, 'out': o},
                                    {**batch, 'h_im': t})[0])
        mean = float(sum(float(p) for p in parts) / len(parts))
    return dict(levels=len(inter), level_losses=[float(p) for p in parts],
                mean_of_levels=mean,
                ok=(len(inter) == ZOO_LEVELS[nt]
                    and abs(mean - loss) <= 1e-4 * abs(loss)))


def code_probe(model, length, seed=21):
    """The discrete codes a forward computes, to count apart between the
    card and the CPU: a list that they are appended to (CPU copies) as
    the forward runs. For an NLSN its rotations are set to fixed draws
    (one per attention layer, from a CPU generator seeded `seed`, for
    `length` positions), so that both devices hash with the same ones,
    and each layer's hash codes are recorded; for a DSR-Splines the knot
    of each pixel (its masks' argmax). [] and nothing changed for
    another net."""
    import torch
    from srcaco2_tpu_torch.models.dsr_splines import DSRSplines
    from srcaco2_tpu_torch.models.nlsn import NonLocalSparseAttention
    codes = []
    if isinstance(model, DSRSplines):
        def masks(x_up, fn=model.masks):
            m = fn(x_up)
            codes.append(m.argmax(1).cpu())
            return m
        model.masks = masks
        return codes
    layers = [m for m in model.modules()
              if isinstance(m, NonLocalSparseAttention)]
    if not layers:
        return codes
    g = torch.Generator().manual_seed(seed)
    model.rotations = [torch.randn(m.rotation_shape(length), generator=g)
                       for m in layers]
    for m in layers:
        def hash_codes(emb, rot, fn=m.hash_codes):
            c = fn(emb, rot)
            codes.append(c.detach().cpu())
            return c
        m.hash_codes = hash_codes
    return codes


def codes_differ(a, b):
    """(positions whose code differs, positions) over two runs' recorded
    codes (code_probe)."""
    return (sum(int((x != y).sum()) for x, y in zip(a, b)),
            sum(x.numel() for x in a))


def _zoo_step(args, d, batch, f64=False, replay=False, jitter=0.0):
    """One loss_and_grads of the seeded model of `args` on `d`: loss,
    grads (on the CPU, f32), seconds, launches, the model and master
    (for the levels check). f64 runs every module and the batch in
    float64; `replay` runs the step under op_replay (its summary under
    'replay'); `jitter` first scales every parameter by 1 + jitter *
    N(0, 1) (a fixed draw): the same weights to far under a bf16 ulp,
    some of them rounded to bf16 the other way. An NLSN hashes with
    fixed rotations; its hash codes, or a DSR-Splines' knots, are
    recorded under 'hash_codes' (code_probe)."""
    import torch
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.steps import loss_and_grads
    model = define_g(args, d, seed=0).train()
    codes = code_probe(model, PATCH * PATCH)
    if jitter:
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + jitter * torch.randn(p.shape, generator=g)
                       .to(p.device))
    if f64:
        # the batch too: an f32 bicubic of the input (VDSR's pre-upscale,
        # SRFBN's bilinear) differs between the devices by rounding
        _as_float64(model)
        batch = {k: v.double() for k, v in batch.items()}
    master = build_loss(args)
    params = dict(model.named_parameters())
    mode = op_replay() if replay else contextlib.nullcontext()
    reset_launches()
    t0 = time.perf_counter()
    with mode:
        loss, _, _, grads = loss_and_grads(
            model, master, args['netG']['net_type'], params, batch, 0, 1.0,
            args['netG'])
        if d.type == 'cuda':
            torch.cuda.synchronize()
    rec = dict(loss=float(loss),
               grads={k: g.float().cpu() for k, g in grads.items()},
               seconds=time.perf_counter() - t0, launches=read_launches(),
               model=model, master=master, hash_codes=codes)
    if replay:
        rec['replay'] = mode.summary()
    return rec


def _replay_brief(summary):
    """An op replay's summary in brief: calls, failures, the largest
    distance over its tolerance and its op, the op with the largest
    share of bf16 outputs off the rounded float64 result, calls held
    through the absolute values' scale."""
    worst = max(summary['ops'].items(),
                key=lambda kv: kv[1]['max_over_tol'], default=(None, {}))
    off = max(summary['ops'].items(),
              key=lambda kv: kv[1]['n_off'] / max(kv[1]['n_out'], 1),
              default=(None, {'n_off': 0, 'n_out': 1}))
    return dict(n_calls=summary['n_calls'], n_failed=summary['n_failed'],
                worst_op=worst[0], worst_rel=worst[1].get('rel'),
                worst_tol=worst[1].get('tol'), most_off_op=off[0],
                most_off_share=off[1]['n_off'] / max(off[1]['n_out'], 1),
                via_abs=sum(r['via_abs'] for r in summary['ops'].values()))


def _zoo_summary(rec):
    """zoo_check's record without the per-grad and per-op details: per net
    and check, the verdict, the worst values and the op replay in
    brief."""
    keys = ('ok', 'loss_rel', 'grad_rel_l2_max', 'worst_param',
            'grad_rel_l2_max_unfloored', 'median_card_bf16_vs_f32',
            'median_cpu_bf16_vs_f32', 'f64_loss_rel', 'rel_l2',
            'max_abs_diff', 'f64_card_vs_cpu', 'end_to_end_gated',
            'end_to_end_held', 'max_card_over_cpu_f32_vs_f64',
            'hash_codes_differ', 'n_hash_codes')
    out = {}
    for nt, res in rec.items():
        if not isinstance(res, dict):
            out[nt] = res
            continue
        out[nt] = {'ok': res['ok'], 'seconds': res['seconds']}
        for k, v in res.items():
            if isinstance(v, dict):
                fl = v.get('floored', {})
                out[nt][k] = {f: v[f] for f in keys if f in v} | {
                    'n_floored': len(fl),
                    'n_floored_failed': sum(not f.get('ok', True)
                                            for f in fl.values())}
                if 'replay' in v:
                    out[nt][k]['replay'] = _replay_brief(v['replay'])
                if 'control' in v:
                    out[nt][k]['control'] = {
                        f: v['control'][f] for f in ('loss_rel', 'n_moved',
                                                     'moved_share')}
    return out


def zoo_check(dev, nets=ZOO_CHECKED):
    """Each zoo net, and CSR-CNN's variants (ZOO_VARIANTS: its grouped
    snet_type3, its segmentation task with the ce loss), at full width
    (at the depths of ZOO_CHECK_NETG), x8, from the same seeded weights
    on the card and on the CPU: one training step's loss and grads
    (loss_and_grads, batch 4 of 16x16 LR patches, SRCNN and CSR-CNN on
    their 128x128 pre-upscale; l2 + 5 neg-SSIM(19)) in f32 with TF32 off
    and in bf16, and an f32 eval forward at 64x64 LR (batch 1); no
    kernel launch on these paths; SRFBN's 4 steps and MSLapSRN's and
    ProSR's 2 levels present in the loss (`_levels_check`).

    Op by op: the card's f32 and bf16 steps on the batch's first patch
    run under op_replay, which holds every op, forward and backward, to
    the float64 result of the same op on the card's own inputs
    (REPLAY_TOL: f32 1e-5, bf16 2^-7). No op fails in either step. The
    share of bf16 outputs that are not the rounded float64 result is
    recorded per op (`n_off`), not held: CUDA's bf16 tanh and sigmoid
    backward round after each of their operations.

    End to end, f32: loss within 1e-5 relative, every grad within 1e-4
    relative L2. The zoo's nets are ReLU-family nets (ReLU, leaky ReLU,
    PReLU): where a pre-activation lies within rounding of 0, the two
    devices' sums put it on either side of the kink, and the grads
    upstream move by up to ~1e-3 in f32. A grad over 1e-4 is held in
    float64 (`_as_float64`: the same step with every module and the
    batch in float64, on both devices, where no rounding crosses a
    kink): the card's float64 grad within 1e-6 of the CPU's, the float64
    losses within 1e-9. The card's own f32 arithmetic is what op_replay
    holds.

    End to end, bf16: the card's median bf16-vs-f32 distance over all
    grads within 1.25 x the CPU's + 1e-3; the loss (1e-2, floor over
    5e-3) and every grad (3e-2, floor over 1.5e-2) by windowed_check's
    rule (hold_to_floor, the CPU's floor alone) where that rule can
    hold the net. Kink crossings in bf16 move grads by whole multiples
    of the bf16 noise: one more rounding of the same step, on either
    device, puts a grad's bf16 value anywhere within that noise. The
    control measures it without the card: the CPU's bf16 step again from
    weights moved by ZOO_JITTER (2^-20) relative, which rounds some of
    them to bf16 the other way. Where the control's loss lies within
    1e-2 of the CPU's first run and at most ZOO_NOISE_SHARE (1%) of its
    grads further than 3e-2, the card's loss and grads must meet the
    rule (`end_to_end_gated`); elsewhere the rule cannot tell a fault
    from the noise at these weights, the card's verdicts are recorded
    (`end_to_end_held`, `floored`) and op_replay holds the step.

    The eval forward: relative L2 within 1e-5 and max |card - CPU| within
    1e-4 of max |CPU output|, or, over that, the float64 forwards of the
    two devices within 1e-9 relative L2 and the card's f32 output no
    further from its float64 one than 4 x the CPU's + 1e-7 (ACT, whose
    outputs reach ~1e3 at these weights: on an NVIDIA H100 80GB HBM3 at
    700 W its f32 forward lay 2.5 x as far from float64 as the CPU's,
    its float64 forward 1.4e-14 from the CPU's).

    NLSN's hash (argmax over rotated embeddings, then a stable sort) is
    discontinuous: both devices hash with the same injected rotations
    (code_probe) and their codes are counted apart. Where any code
    differs, a rounding difference next to a tie moved whole rows
    between chunks, and the step (f32 or bf16) is held by op_replay
    alone, which holds argmax and the sort equal on the card's own
    inputs; the eval forward then runs once more on the card under
    op_replay, which must pass. The end-to-end values are recorded.
    DSR-Splines' knot masks (floor(255 * the f32 bicubic upscale)) are
    discontinuous alike: a pixel whose upscale lies within an ulp of a
    knot boundary can fall into either knot; their knots are counted
    apart and held the same way.

    The segmentation variant's eval forward: its expectation
    (`expected_pred`) is held as `out` is above, and its argmax levels
    (`out`) equal wherever the CPU's two largest logits lie further
    apart than twice the largest difference between the devices'
    logits (held within 1e-4 of their size)."""
    import statistics as st
    import torch
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.steps import model_outputs, pre_upsampled
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device('cpu')
    batch = zoo_batch(dev, 4, 11)
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    batch_1 = {k: v[:1] for k, v in batch.items()}
    sides = (('card', dev, batch), ('cpu', cpu, batch_cpu))
    x_eval = torch.rand((1, 1, LR, LR),
                        generator=torch.Generator().manual_seed(12))

    def rel(a, b):
        return abs(a - b) / abs(b)

    out, ok_all = {}, True
    for nt in nets:
        t_net = time.perf_counter()
        runs = {}
        for name, amp in (('f32', False), ('bf16', True)):
            args = zoo_check_args(nt, amp)
            for side, d, bt in sides:
                rec = _zoo_step(args, d, bt)
                if side == 'card' and name == 'f32' and nt in ZOO_LEVELS:
                    rec['levels'] = _levels_check(
                        nt, rec['model'], rec['master'], bt, rec['loss'])
                del rec['model'], rec['master']
                runs[name, side] = rec
            rec = _zoo_step(args, dev, batch_1, replay=True)
            runs[name, 'card']['replay'] = rec['replay']
            del rec
        rec = _zoo_step(zoo_check_args(nt, True), cpu, batch_cpu,
                        jitter=ZOO_JITTER)
        del rec['model'], rec['master']
        runs['bf16', 'control'] = rec
        res = {}
        # f32
        c, r = runs['f32', 'card'], runs['f32', 'cpu']
        grel = {k: _rel_l2(c['grads'][k], r['grads'][k]) for k in c['grads']}
        tol = dict(loss_rtol=1e-5, grad_rel_l2=1e-4, f64_grad_rel_l2=1e-6,
                   f64_loss_rtol=1e-9)
        loss_ok = rel(c['loss'], r['loss']) <= tol['loss_rtol']
        floored, extra = {}, {}
        if any(e > tol['grad_rel_l2'] for e in grel.values()):
            for side, d, bt in sides:
                rec = _zoo_step(zoo_check_args(nt, False), d, bt,
                                f64=True)
                del rec['model'], rec['master']
                runs['f64', side] = rec
            c64, r64 = runs['f64', 'card'], runs['f64', 'cpu']
            for k, e in grel.items():
                if e > tol['grad_rel_l2']:
                    f = dict(card_vs_cpu=e,
                             f64_card_vs_cpu=_rel_l2(c64['grads'][k],
                                                     r64['grads'][k]),
                             card_f32_vs_f64=_rel_l2(c['grads'][k],
                                                     c64['grads'][k]),
                             cpu_f32_vs_f64=_rel_l2(r['grads'][k],
                                                    r64['grads'][k]))
                    f['ok'] = f['f64_card_vs_cpu'] <= tol['f64_grad_rel_l2']
                    floored[k] = f
            extra['f64_loss_rel'] = rel(c64['loss'], r64['loss'])
            extra['max_card_over_cpu_f32_vs_f64'] = max(
                f['card_f32_vs_f64'] / max(f['cpu_f32_vs_f64'], 1e-30)
                for f in floored.values())
            loss_ok = loss_ok and extra['f64_loss_rel'] <= tol['f64_loss_rtol']
        # NLSN's hash: a rounding difference between the devices next to a
        # tie flips an argmax and moves whole rows between chunks; where
        # any code differs the step is held op by op (op_replay, argmax
        # and sort equal on their inputs), the end-to-end values recorded
        hashed = {}
        for name in ('f32', 'bf16'):
            if runs[name, 'card']['hash_codes']:
                n_diff, n_codes = codes_differ(
                    runs[name, 'card']['hash_codes'],
                    runs[name, 'cpu']['hash_codes'])
                hashed[name] = dict(hash_codes_differ=n_diff,
                                    n_hash_codes=n_codes)
        res['train_f32'] = dict(
            loss_card=c['loss'], loss_cpu=r['loss'],
            loss_rel=rel(c['loss'], r['loss']), loss_ok=loss_ok,
            grads_ok=all(f['ok'] for f in floored.values()),
            end_to_end_gated=not hashed.get('f32', {}).get(
                'hash_codes_differ'), **hashed.get('f32', {}), **extra)
        # bf16
        c, r = runs['bf16', 'card'], runs['bf16', 'cpu']
        c32, r32 = runs['f32', 'card'], runs['f32', 'cpu']
        k_ = runs['bf16', 'control']
        btol = dict(loss_rtol=1e-2, grad_rel_l2=3e-2, loss_floor_above=5e-3,
                    floor_above=1.5e-2, median_floor_ratio=1.25,
                    control_jitter=ZOO_JITTER,
                    control_noise_share=ZOO_NOISE_SHARE)
        lc, lr_ = rel(c['loss'], c32['loss']), rel(r['loss'], r32['loss'])
        loss_held = hold_to_floor(rel(c['loss'], r['loss']), lr_, lc,
                                  btol['loss_rtol'],
                                  btol['loss_floor_above'])
        grads_held, brel, bfloored = bf16_grads_held(
            c['grads'], r['grads'], c32['grads'], r32['grads'])
        # the control against the CPU's first run
        moved = [k for k in brel if _rel_l2(k_['grads'][k], r['grads'][k])
                 > btol['grad_rel_l2']]
        ctrl = dict(loss=k_['loss'], loss_rel=rel(k_['loss'], r['loss']),
                    n_moved=len(moved), moved_share=len(moved) / len(brel),
                    moved=sorted(moved)[:20])
        fc = [_rel_l2(c['grads'][k], c32['grads'][k]) for k in brel]
        fr = [_rel_l2(r['grads'][k], r32['grads'][k]) for k in brel]
        res['train_bf16'] = dict(
            loss_card=c['loss'], loss_cpu=r['loss'],
            loss_rel=rel(c['loss'], r['loss']),
            loss_card_bf16_vs_f32=lc, loss_cpu_bf16_vs_f32=lr_,
            loss_ok=loss_held, grads_ok=grads_held,
            end_to_end_held=loss_held and grads_held,
            end_to_end_gated=(ctrl['loss_rel'] <= btol['loss_rtol']
                              and ctrl['moved_share']
                              <= btol['control_noise_share']
                              and not hashed.get('bf16', {}).get(
                                  'hash_codes_differ')),
            **hashed.get('bf16', {}),
            control=ctrl,
            median_card_bf16_vs_f32=st.median(fc),
            median_cpu_bf16_vs_f32=st.median(fr), **btol)
        b = res['train_bf16']
        b['median_ok'] = (b['median_card_bf16_vs_f32']
                          <= 1.25 * b['median_cpu_bf16_vs_f32'] + 1e-3)
        for name, grel_, fl, t in (('f32', grel, floored, tol),
                                   ('bf16', brel, bfloored, btol)):
            c = runs[name, 'card']
            worst = max(grel_, key=grel_.get)
            v = res[f'train_{name}']
            v.update(grad_rel_l2_max=grel_[worst], worst_param=worst,
                     grad_rel_l2_max_unfloored=max(
                         (e for k, e in grel_.items() if k not in fl),
                         default=0.0),
                     floored=fl, n_grads=len(grel_),
                     grads_finite=all(bool(torch.isfinite(g).all())
                                      for g in c['grads'].values()),
                     card_seconds=c['seconds'],
                     cpu_seconds=runs[name, 'cpu']['seconds'],
                     launches=c['launches'], replay=c['replay'], **t)
            if 'levels' in c:
                v['levels'] = c['levels']
            held_ = ((v['loss_ok'] and v['grads_ok']
                      or not v['end_to_end_gated']) if name == 'f32'
                     else v['median_ok'] and (v['end_to_end_held']
                                              or not v['end_to_end_gated']))
            v['ok'] = (held_ and v['grads_finite']
                       and c['replay']['n_failed'] == 0
                       and v.get('levels', {}).get('ok', True)
                       and all(n == 0 for n in c['launches'].values()))
        del runs
        # an f32 evaluation forward at 64x64 LR (SRCNN, CSR-CNN: the
        # 512x512 pre-upscale)
        args = zoo_check_args(nt, False)
        x = x_eval
        if pre_upsampled(args['netG']['net_type'], args['netG']):
            from srcaco2_tpu_torch.ops.resize import resize2d
            x = torch.clip(resize2d(x, (LR * SCALE, LR * SCALE)), 0, 1)
        ys, ev_codes, seg = {}, {}, {}

        def forward(side, d, f64=False, replay=None):
            model = define_g(args, d, seed=0)
            codes = code_probe(model, LR * LR)
            xd = x.to(d)
            if f64:
                _as_float64(model)
                xd = xd.double()
            t0 = time.perf_counter()
            with torch.inference_mode(), (replay or contextlib.nullcontext()):
                o = model_outputs(model(xd))
                # the segmentation task: its expectation, the argmax apart
                y = o.get('expected_pred', o['out']).double().cpu()
                if 'raw_segmentation' in o and not f64 and replay is None:
                    # the argmax levels (out * color_max, which the two
                    # devices divide by color_max an f32 ulp apart)
                    seg[side] = (o['raw_segmentation'].float().cpu(),
                                 torch.round(o['out'].double().cpu() * 255))
            ys[side + ('_f64' if f64 else '') + '_s'] = \
                time.perf_counter() - t0
            ev_codes[side + ('_f64' if f64 else '')] = codes
            return y

        reset_launches()
        for side, d, _ in sides:
            ys[side] = forward(side, d)
        launches = read_launches()
        err = float((ys['card'] - ys['cpu']).abs().max())
        scale_ = float(ys['cpu'].abs().max())
        rel_l2 = _rel_l2(ys['card'], ys['cpu'])
        ev = dict(shape=list(ys['card'].shape), rel_l2=rel_l2,
                  max_abs_diff=err, max_abs_out=scale_, rel_l2_tol=1e-5,
                  max_abs_of_max=1e-4, launches=launches,
                  card_seconds=ys['card_s'], cpu_seconds=ys['cpu_s'])
        close = rel_l2 <= 1e-5 and err <= 1e-4 * scale_
        if ev_codes['card']:
            ev['hash_codes_differ'], ev['n_hash_codes'] = codes_differ(
                ev_codes['card'], ev_codes['cpu'])
        if ev.get('hash_codes_differ'):
            # held op by op on the card's own inputs, as the step is
            rep_ = op_replay()
            forward('card', dev, replay=rep_)
            ev['replay'] = rep_.summary()
            close = ev['replay']['n_failed'] == 0
        elif not close:
            for side, d, _ in sides:
                ys[side + '_f64'] = forward(side, d, f64=True)
            ev.update(f64_card_vs_cpu=_rel_l2(ys['card_f64'],
                                              ys['cpu_f64']),
                      card_f32_vs_f64=_rel_l2(ys['card'], ys['card_f64']),
                      cpu_f32_vs_f64=_rel_l2(ys['cpu'], ys['cpu_f64']))
            close = (ev['f64_card_vs_cpu'] <= 1e-9
                     and ev['card_f32_vs_f64']
                     <= 4 * ev['cpu_f32_vs_f64'] + 1e-7)
        if seg:
            (lc, oc), (lr_, or_) = seg['card'], seg['cpu']
            lerr = float((lc - lr_).abs().max())
            top2 = lr_.topk(2, dim=1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * lerr
            ev.update(logits_max_abs_diff=lerr,
                      logits_max_abs=float(lr_.abs().max()),
                      argmax_clear_share=float(clear.float().mean()),
                      argmax_differ=int((oc != or_).sum()),
                      argmax_differ_clear=int(((oc != or_)[:, 0]
                                               & clear).sum()))
            close = (close and ev['argmax_differ_clear'] == 0
                     and lerr <= 1e-4 * ev['logits_max_abs'])
        ev['ok'] = (close
                    and ev['shape'] == [1, 1, LR * SCALE, LR * SCALE]
                    and bool(torch.isfinite(ys['card']).all())
                    and all(v == 0 for v in launches.values()))
        res['eval_f32_64x64'] = ev
        res['seconds'] = time.perf_counter() - t_net
        res['ok'] = all(v['ok'] for k, v in res.items()
                        if isinstance(v, dict))
        out[nt] = res
        ok_all = ok_all and res['ok']
        print(json.dumps({'zoo_check_net': nt,
                          **_zoo_summary({nt: res})[nt]}), flush=True)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        allow
    return out, ok_all


def _zoo_train_one(nt, args, dev, data, b, steps, profile=False):
    """nt's train step on the card from seeded weights: one warm-up
    step, `steps` timed steps (host clock synchronised around them), the
    record of zoo_train; with `profile` the device time of one step."""
    import torch
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.schedule import build_optimizer
    from srcaco2_tpu_torch.train.state import TrainState
    from srcaco2_tpu_torch.train.steps import make_train_step
    hr, lr, inputs, cfg = data
    t_net = time.perf_counter()
    model = define_g(args, dev, seed=0).train()
    tx = build_optimizer(args['train'])
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, build_loss(args), tx, nt, cfg,
                           steps_per_epoch=1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _, _ = step(state, hr, lr, *inputs(b))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    batches = [inputs(b) for _ in range(steps)]
    reset_launches()
    t0 = time.perf_counter()
    for bt in batches:
        state, holder, ok = step(state, hr, lr, *bt)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = read_launches()
    rec = dict(model=f'{nt} x8 (config/net_defaults.py), bf16 over f32 '
               'params, random weights (seed 0)', batch=b,
               lr_patch=[PATCH, PATCH], steps=steps, ms_per_step=ms,
               patches_per_s=b * 1e3 / ms, first_step_seconds=first_s,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               n_params=sum(p.numel() for p in model.parameters()),
               loss=float(holder['total']), flags=float(holder['_flags']),
               launches=launches)
    if profile:
        bt = inputs(b)
        rec['profile'] = profile_device(
            lambda: step(state, hr, lr, *bt), ms,
            groups={'fft': ('fft',)} if nt == 'DFCAN' else None,
            host_ops=False)
    rec['ok'] = (bool(torch.isfinite(holder['total'])) and bool(ok)
                 and all(v == 0 for v in swin_launches(launches).values())
                 and update_launched(launches, steps))
    rec['seconds'] = time.perf_counter() - t_net
    del model, state, step, tx
    torch.cuda.empty_cache()
    return rec


# the remat options zoo_train flips: net -> (its option, the model's
# attribute the option sets)
ZOO_REMAT = {'SRFBN': ('srfbn_remat_steps', 'remat_steps'),
             'DBPN': ('dbpn_remat_blocks', 'remat_blocks')}


def remat_check(nt, dev, data, default):
    """nt with its remat option (ZOO_REMAT) flipped from its default
    (SRFBN's srfbn_remat_steps off -> on, DBPN's dbpn_remat_blocks on ->
    off) at the README's batch: ms/step and peak memory beside the
    default's (`default`, zoo_train's record), the run with the
    checkpoint on holding less memory; and one step's loss and grads
    (loss_and_grads, the same seeded weights and batch, cuDNN's
    deterministic algorithms) with the option on and off, which must be
    bit-equal, with the default step run twice as the control of the
    determinism."""
    import torch
    from srcaco2_tpu_torch.config.net_defaults import NET_OPTIONS
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.steps import loss_and_grads
    flag, attr = ZOO_REMAT[nt]
    on_default = bool(NET_OPTIONS[nt][flag])
    args = zoo_args(nt, True)
    args['netG'][flag] = not on_default
    rec = _zoo_train_one(nt, args, dev, data, ZOO_BATCH, 3)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    batch = zoo_batch(dev, ZOO_BATCH, 17)
    grads = {}
    for name, on in (('default', on_default), ('flipped', not on_default),
                     ('default_again', on_default)):
        a = zoo_args(nt, True)
        a['netG'][flag] = on
        model = define_g(a, dev, seed=0).train()
        built_as_asked = getattr(model, attr) is on
        params = dict(model.named_parameters())
        loss, _, _, g = loss_and_grads(model, build_loss(a), nt, params,
                                       batch, 0, 1.0)
        grads[name] = (loss.float().cpu(),
                       {k: v.float().cpu() for k, v in g.items()},
                       built_as_asked)
        del model, params, g
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = det

    def same(x, y):
        return bool(torch.equal(x[0], y[0]) and all(
            torch.equal(x[1][k], y[1][k]) for k in x[1]))
    on_rec, off_rec = (default, rec) if on_default else (rec, default)
    rec['option'], rec['option_value'] = flag, not on_default
    rec['remat_as_asked'] = all(v[2] for v in grads.values())
    rec.update(
        default_ms_per_step=default['ms_per_step'],
        default_max_memory_allocated=default['max_memory_allocated'],
        memory_ratio=rec['max_memory_allocated']
        / default['max_memory_allocated'],
        time_ratio=rec['ms_per_step'] / default['ms_per_step'],
        bit_equal_to_default=same(grads['flipped'], grads['default']),
        default_bit_equal_twice=same(grads['default_again'],
                                     grads['default']),
        loss=float(grads['flipped'][0]))
    rec['ok'] = (rec['ok'] and rec['bit_equal_to_default']
                 and rec['remat_as_asked']
                 and on_rec['max_memory_allocated']
                 < off_rec['max_memory_allocated'])
    return rec


def zoo_train(dev, smi, nets=ZOO):
    """Each zoo net's train step on the card (bf16 over f32 params, the
    README's amp; random seeded weights; l2 + 5 neg-SSIM(19); Adam) at
    x8 on 16x16 LR patches: DFCAN as bench.py's step at batch 128 with 10
    timed steps, the others at the README's batch 64 with 5 (the later
    parts of the zoo, from NLSN on, with 3: ZOO_STEPS;
    MemNet with its per-pass checkpoint on, as its default is); one
    warm-up step each, host clock synchronised around the timed steps;
    ms/step, patches/s, peak memory, no kernel launch; the device time
    of one step by kernel and the device's busy share (profile_device)
    for ZOO_PROFILED, DFCAN's with the FFT's share (cuFFT's kernels).
    NLSN's steps draw their rotations from per-step generators, as the
    trainer's. Then SRFBN with srfbn_remat_steps and DBPN without
    dbpn_remat_blocks (remat_check), and EDSR-LIIF's gather
    (liif_gather_check)."""
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.utils import reproducibility as R
    cfg = P.PipeConfig(scale=SCALE, h_size=H_SIZE)
    gen = torch.Generator(device=dev).manual_seed(13)
    n_img = 2 * DFCAN_BATCH
    hr = torch.randint(0, 256, (n_img, H_SIZE, H_SIZE, 1), generator=gen,
                       device=dev, dtype=torch.uint8)
    lr = torch.randint(0, 256, (n_img, PATCH, PATCH, 1), generator=gen,
                       device=dev, dtype=torch.uint8)
    drawn = []

    def inputs(b):
        idxs = torch.randint(0, n_img, (b,), generator=gen, device=dev)
        drawn.append(1)
        return idxs, P.draw(gen, b, cfg, (H_SIZE, H_SIZE))._replace(
            lsh=R.lsh_generator(13, len(drawn)))
    data = (hr, lr, inputs, cfg)
    out, ok_all = {}, True
    for nt in nets:
        b = DFCAN_BATCH if nt == 'DFCAN' else ZOO_BATCH
        rec = _zoo_train_one(nt, zoo_args(nt, True), dev, data, b,
                             ZOO_STEPS.get(nt, 5), nt in ZOO_PROFILED)
        rec['nvidia_smi'] = smi
        out[nt] = rec
        ok_all = ok_all and rec['ok']
        print(json.dumps({'zoo_train_net': nt, 'ok': rec['ok'],
                          'ms_per_step': rec['ms_per_step'],
                          'max_memory_allocated':
                          rec['max_memory_allocated']}), flush=True)
    for nt in ZOO_REMAT:
        if nt not in out:
            continue
        rec = remat_check(nt, dev, data, out[nt])
        rec['nvidia_smi'] = smi
        name = f'{nt}_{rec["option"]}_{rec["option_value"]}'
        out[name] = rec
        ok_all = ok_all and rec['ok']
        print(json.dumps({'zoo_train_net': name, **{k: rec[k] for k in (
            'ok', 'ms_per_step', 'max_memory_allocated',
            'default_ms_per_step', 'default_max_memory_allocated',
            'bit_equal_to_default', 'default_bit_equal_twice')}}),
            flush=True)
    if 'EDSR_LIIF' in out:
        rec = liif_gather_check(dev)
        out['EDSR_LIIF_gather'] = rec
        ok_all = ok_all and rec['ok']
        print(json.dumps({'zoo_train_net': 'EDSR_LIIF_gather', **rec}),
              flush=True)
    return out, ok_all


def liif_gather_check(dev):
    """EDSR-LIIF's ensemble gather (models/edsr_liif.ensemble_gather) at
    its shape in zoo_train's step (bf16, batch 64 of 16x16 LR, x8, 256
    channels), each of its 4 branches: the backward (f32 segment sums
    rounded to bf16 after each axis) run twice on the same cotangent,
    which must agree bit for bit, and against the CPU's (the elements
    that differ counted, the largest difference within a bf16 ulp of the
    largest grad); its ms beside the same sums through index_add_ (the
    library's scatter-add, atomics on the card) and whether two of those
    agree."""
    import torch
    from srcaco2_tpu_torch.models import edsr_liif as L
    hl, c, b, bf = PATCH, 256, ZOO_BATCH, torch.bfloat16
    hh = hl * SCALE
    g = torch.Generator(device=dev).manual_seed(19)
    z = torch.randn((b, hl, hl, c), generator=g, device=dev).to(bf)
    cot = torch.randn((b, hh, hh, c), generator=g, device=dev).to(bf)
    z_cpu, cot_cpu = z.cpu(), cot.cpu()

    def bwd(zz, cc, br):
        zz = zz.detach().requires_grad_()
        L.ensemble_gather(zz, br['iy'], br['ix'], br['seg_y'],
                          br['seg_x']).backward(cc)
        return zz.grad

    def index_add(br):
        t = torch.zeros((b, hh, hl, c), device=dev).index_add_(
            2, br['ix'], cot.float()).to(bf)
        return torch.zeros((b, hl, hl, c), device=dev).index_add_(
            1, br['iy'], t.float()).to(bf)

    card, on_cpu = (L._plan_on(hl, hl, SCALE, True, True, str(d))[0]
                    for d in (dev, torch.device('cpu')))
    rec = dict(shape=[b, hl, hl, c], scale=SCALE, branches=[])
    for br, br_cpu in zip(card, on_cpu):
        first, second = bwd(z, cot, br), bwd(z, cot, br)
        ref = bwd(z_cpu, cot_cpu, br_cpu)
        diff = (first.float().cpu() - ref.float()).abs()
        ia = index_add(br)
        rec['branches'].append(dict(
            bit_equal_twice=bool(torch.equal(first, second)),
            cpu_differ=int((diff > 0).sum()),
            cpu_max_abs_diff=float(diff.max()),
            grad_max_abs=float(ref.float().abs().max()),
            index_add_bit_equal_twice=bool(torch.equal(ia, index_add(br))),
            index_add_max_abs_diff=float((ia.float() - first.float())
                                         .abs().max())))
        del first, second, ref, ia
    br = card[0]
    rec['bwd_ms'] = cuda_ms(lambda: bwd(z, cot, br), reps=3, per=5)
    rec['index_add_ms'] = cuda_ms(lambda: index_add(br), reps=3, per=5)
    rec['ok'] = all(r['bit_equal_twice'] and r['cpu_max_abs_diff']
                    <= 2.0 ** -7 * r['grad_max_abs'] for r in rec['branches'])
    del z, cot
    torch.cuda.empty_cache()
    return rec


# the options that are off by default: the loss terms beyond l1 / l2 /
# SSIM / ce (each hist / kde metric apart), as flag sets of build_loss
OPTION_TERMS = [
    ('l2sum', {}), ('charbonnier', {}), ('boundpred', {}),
    ('local_moments', {}), ('img_grad', {}), ('norm_img_grad', {}),
    ('laplace', {}), ('norm_laplace', {}), ('loc_var', {}),
    ('norm_loc_var', {}), ('w_sparsity', {})] + [
    ('hist', {'hist_metric': m}) for m in ('KL', 'BHATTACHARYYA', '1', '2')
] + [('kde', {'kde_metric': m}) for m in ('BHATTACHARYYA', '1', '2')]
OPTION_TOL = {'value_rtol': 1e-5, 'value_atol': 1e-6, 'grad_rtol': 1e-5,
              'grad_atol': 1e-6, 'orth_atol': 1e-4}
# chi-square critical value at p = 1e-3 for 63 degrees of freedom (8 x 8
# coarse bins; scipy.stats.chi2.ppf(0.999, 63))
CHI2_63_P001 = 103.44237731987324
OPTION_AUGS = dict(da_blur=True, da_blur_prob=1.0, da_dot_bin_noise=True,
                   da_dot_bin_noise_prob=1.0, da_add_gaus_noise=True,
                   da_add_gaus_noise_prob=1.0)


def _to(x, dev):
    """A Draws (and its BlockAugs) with every tensor moved to dev."""
    import torch
    if isinstance(x, tuple):
        return type(x)(*(_to(v, dev) for v in x))
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _event_ms(fn, reps=5):
    """Median ms of fn() over reps calls, CUDA events around each."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def options_check(dev, smi):
    """The training options that are off by default, the card against
    the port's CPU path in f32 with TF32 off, at small sizes: each loss
    term (each hist / kde metric) on a (4, 1, 64, 64) prediction, value
    and input grad (w_sparsity: the params' grads); Otsu's threshold and
    the chamfer EDT bit for bit on 8 synthetic 512^2 cell tiles; the
    EDT*ROI origin weights (1e-6 relative); `assemble` with every local
    aug and ppiw at the x8 entry's shapes (batch 64, 128^2 HR patches)
    from draws made on the CPU; the card's EDT*ROI origin draw (200,000
    draws, 8 x 8 bins, chi-square below its p = 1e-3 value); both
    regularizers on the flagship's params (orth within 1e-4, clip
    exactly). Also the card's time for the options' work at the entry's
    shapes. Returns (record, ok)."""
    import numpy as np
    import torch
    from srcaco2_tpu_torch.config.defaults import get_config
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.data import sampling as S
    from srcaco2_tpu_torch.data.synthetic import _cell_image
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train import regularizers as REG
    cpu = torch.device('cpu')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = OPTION_TOL
    rec = dict(tol=tol, terms=[], nvidia_smi=smi)
    ok = True
    r = np.random.default_rng(0)
    p = r.uniform(0, 1, (4, 1, 64, 64)).astype(np.float32)
    y = (np.round(r.uniform(0, 1, p.shape) * 255) / 255).astype(np.float32)
    y[:, :, :8, :8] = 0.5
    par = {'w': r.normal(0, 0.05, (64, 64)).astype(np.float32)}
    for term, extra in OPTION_TERMS:
        master = build_loss({**get_config(), term: True, **extra})
        out = []
        for d in (cpu, dev):
            x = torch.from_numpy(p).to(d).requires_grad_()
            w = {k: torch.from_numpy(v).to(d).requires_grad_()
                 for k, v in par.items()}
            v, _ = master({'out': x}, {'h_im': torch.from_numpy(y).to(d)},
                          w, 0, torch.tensor(1.0, device=d))
            g = torch.autograd.grad(v, [w['w']] if term == 'w_sparsity'
                                    else [x])[0]
            out.append((float(v.detach()), g.detach().cpu()))
        (vc, gc), (vd, gd) = out
        gerr = float((gd - gc).abs().max())
        gref = float(gc.abs().max())
        t_ok = (abs(vd - vc) <= tol['value_atol'] + tol['value_rtol']
                * abs(vc) and gerr <= tol['grad_atol']
                + tol['grad_rtol'] * gref and bool(torch.isfinite(gd).all()))
        rec['terms'].append(dict(term=term, **extra, value_cpu=vc,
                                 value_card=vd, grad_max_abs_err=gerr,
                                 grad_max_abs=gref, ok=t_ok))
        ok &= t_ok
    # Otsu and the chamfer EDT at 512^2
    tiles = np.stack([_cell_image(np.random.default_rng(s), 512)
                      for s in range(8)])
    th = [S.otsu_threshold_device(torch.from_numpy(tiles).to(d)).cpu()
          for d in (cpu, dev)]
    roi = (torch.from_numpy(tiles).float() >= th[0][:, None, None]).float()
    edt = [S.edt_device(roi.to(d)).cpu() for d in (cpu, dev)]
    rec['otsu_equal'] = bool(torch.equal(th[0], th[1]))
    rec['edt_equal'] = bool(torch.equal(edt[0], edt[1]))
    rec['edt_max'] = float(edt[0].max())
    ok &= rec['otsu_equal'] and rec['edt_equal']
    # the x8 entry's pipeline: 16 tiles, batch 64, every option
    cfg = P.PipeConfig(scale=8, h_size=128, sample_tr_patch='edt*roi',
                       ppiw=True, **OPTION_AUGS)
    hr = torch.from_numpy(tiles[:, :, :, None].repeat(2, 0))
    lr = torch.from_numpy(np.ascontiguousarray(
        tiles[:, ::8, ::8, None].repeat(2, 0)))
    table = torch.from_numpy(P.per_color_weights(hr.numpy(), 0.001))
    w_cpu = P.OriginWeights(lr, (512, 512), cfg, cache=True)
    w_dev = P.OriginWeights(lr.to(dev), (512, 512), cfg, cache=True)
    werr = float(((w_dev.maps.cpu() - w_cpu.maps).abs()
                  / w_cpu.maps.abs()).max())
    rec['origin_weights_max_rel_err'] = werr
    ok &= werr <= 1e-6
    idxs = torch.randint(0, 16, (64,), generator=torch.Generator()
                         .manual_seed(1))
    draws = P.draw(torch.Generator().manual_seed(2), 64, cfg, (512, 512),
                   w_cpu.of(idxs))
    bc = P.assemble(hr, lr, idxs, draws, cfg, table)
    bd = P.assemble(hr.to(dev), lr.to(dev), idxs.to(dev), _to(draws, dev),
                    cfg, table.to(dev))
    # uint8 levels: the card divides by 255 as a product with its
    # reciprocal, one ulp off the CPU's quotient for some levels
    def levels(t):
        return torch.round(t.cpu().double() * 255)
    l2h_d = (levels(bd['l_to_h_img']) - levels(bc['l_to_h_img'])).abs()
    rec['assemble'] = dict(
        max_abs_err={k: float((bd[k].cpu() - bc[k]).abs().max())
                     for k in bc},
        h_im_levels_equal=bool(torch.equal(levels(bd['h_im']),
                                           levels(bc['h_im']))),
        l_to_h_max_levels=float(l2h_d.max()),
        l_to_h_exact_share=float((l2h_d == 0).float().mean()))
    a = rec['assemble']
    ok &= (all(v <= 1e-6 for k, v in a['max_abs_err'].items()
               if not k.startswith('l_to_h'))
           and a['h_im_levels_equal'] and a['l_to_h_max_levels'] <= 1.0
           and a['l_to_h_exact_share'] >= 0.999)
    # the card's origin draw against its weights
    n = 200_000
    wmap = w_dev.maps[:1]
    gen = torch.Generator(device=dev).manual_seed(3)
    x0, y0 = S.sample_origin_device(gen, wmap, k=n)
    side = wmap.shape[-1]
    binw = side // 8
    seen = torch.bincount((x0 // binw * 8 + y0 // binw).reshape(-1).cpu(),
                          minlength=64).double()
    mass = wmap[0].reshape(8, binw, 8, binw).sum((1, 3)).double().cpu()
    expected = (mass / mass.sum()).reshape(-1) * n
    chi2 = float(((seen - expected) ** 2 / expected).sum())
    rec['draw'] = dict(n=n, bins=64, chi2=chi2, critical_p001=CHI2_63_P001,
                       inside=bool(int(x0.max()) < side
                                   and int(y0.max()) < side))
    ok &= chi2 <= CHI2_63_P001 and rec['draw']['inside']
    # the regularizers on the flagship's params
    model = define_g(flagship_args(), dev, seed=0)
    twin = define_g(flagship_args(), cpu, seed=0)
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    REG.regularizer_orth(model)
    REG.regularizer_orth(twin)
    orth_err = max(float((pd.detach().cpu() - pc.detach()).abs().max())
                   for pd, pc in zip(model.parameters(), twin.parameters()))
    with torch.no_grad():
        # the same inputs on both devices: the card's orth result, x 40
        twin.load_state_dict({k: v.cpu()
                              for k, v in model.state_dict().items()})
        for m in (model, twin):
            for q in m.parameters():
                q.mul_(40.0)
    REG.regularizer_clip(dict(model.named_parameters()))
    REG.regularizer_clip(dict(twin.named_parameters()))
    clip_equal = all(torch.equal(pd.detach().cpu(), pc.detach())
                     for pd, pc in zip(model.parameters(), twin.parameters()))
    rec['regularizers'] = dict(orth_max_abs_err=orth_err,
                               clip_equal=clip_equal)
    ok &= orth_err <= tol['orth_atol'] and clip_equal
    # the flagship's prediction (bf16-made, random seeded weights, in
    # training mode) on the entry's batch: its zero derivative vectors,
    # where the norm_ terms' grads are NaN (JAX's jnp.linalg.norm too)
    fresh = define_g(flagship_args(), dev, seed=0).train()
    with torch.no_grad():
        fpred = fresh(bd['l_im']).float()
    del fresh
    from srcaco2_tpu_torch.losses import ops as LO
    zeros = {name: int(((op(fpred) ** 2).sum(1) == 0).sum()) for name, op in
             (('img_grad', LO.image_gradient),
              ('laplace', LO.laplacian_filter),
              ('loc_var', LO.local_variation))}
    xg = fpred.clone().requires_grad_()
    nl = build_loss({**get_config(), 'norm_laplace': True})
    g = torch.autograd.grad(nl({'out': xg}, {'h_im': bd['h_im']})[0], xg)[0]
    rec['flagship_prediction'] = dict(
        pixels=fpred.numel(), unique_values=int(fpred.unique().numel()),
        zero_derivative_vectors=zeros,
        norm_laplace_grad_finite=bool(torch.isfinite(g).all()))
    ok &= rec['flagship_prediction']['norm_laplace_grad_finite'] == (
        zeros['laplace'] == 0)
    # the card's time for the options' work at the entry's shapes
    pred = torch.rand(64, 1, 128, 128, device=dev, requires_grad=True)
    tgt = bd['h_im']
    terms = build_loss({**get_config(), 'l1': True, **{
        t: True for t, _ in OPTION_TERMS}, 'hist_metric': 'KL',
        'kde_metric': 'BHATTACHARYYA'})
    mparams = dict(model.named_parameters())

    def loss_pass():
        v, _ = terms({'out': pred}, {'h_im': tgt,
                                     'h_per_pixel_weight':
                                         bd['h_per_pixel_weight']},
                     mparams, 0, torch.tensor(1.0, device=dev))
        torch.autograd.grad(v, pred)
    ddev = _to(draws, dev)
    gdev = torch.Generator(device=dev).manual_seed(4)
    tiles_d = torch.from_numpy(tiles).to(dev).repeat(8, 1, 1)
    rec['ms'] = dict(
        weight_maps_16_images=_event_ms(lambda: P.OriginWeights(
            lr.to(dev), (512, 512), cfg, cache=True), reps=3),
        otsu_64_images=_event_ms(lambda: S.otsu_threshold_device(tiles_d)),
        edt_64_images=_event_ms(lambda: S.edt_device(
            (tiles_d > 40).float()), reps=3),
        draw=_event_ms(lambda: P.draw(gdev, 64, cfg, (512, 512),
                                      w_dev.of(idxs.to(dev)))),
        assemble=_event_ms(lambda: P.assemble(
            hr.to(dev), lr.to(dev), idxs.to(dev), ddev, cfg,
            table.to(dev))),
        loss_terms_fwd_bwd=_event_ms(loss_pass, reps=3),
        hist_fwd_bwd=_event_ms(lambda: torch.autograd.grad(
            build_loss({**get_config(), 'hist': True})(
                {'out': pred}, {'h_im': tgt})[0], pred), reps=3),
        kde_fwd_bwd=_event_ms(lambda: torch.autograd.grad(
            build_loss({**get_config(), 'kde': True})(
                {'out': pred}, {'h_im': tgt})[0], pred), reps=3),
        regularizer_orth=_event_ms(lambda: REG.regularizer_orth(model),
                                   reps=3),
        regularizer_clip=_event_ms(lambda: REG.regularizer_clip(mparams)))
    torch.cuda.reset_peak_memory_stats(dev)
    loss_pass()
    rec['loss_terms_peak_memory_allocated'] = \
        torch.cuda.max_memory_allocated(dev)
    rec['ok'] = bool(ok)
    return rec, bool(ok)


ENTRY_OPT_TERMS = ('l2sum', 'charbonnier', 'boundpred', 'local_moments',
                   'img_grad', 'laplace', 'loc_var', 'norm_loc_var', 'hist',
                   'kde', 'w_sparsity')
# the README's training command (README.md:91-100) with only the dataset
# names, the roots and the epochs changed, and the x2 default run
ENTRY = {
    'entry_x8': dict(
        scale=8, n_train=128, n_val=8, n_test=8, epochs=3, steps=6,
        flags=['--h_size', '128', '--l2', 'True', '--ssim', 'True',
               '--ssim_lambda', '5.', '--ssim_window_s', '19',
               '--eval_over_roi_also', 'True',
               '--eval_over_roi_also_model_select', 'True',
               '--swinir_upsampler', 'pixelshuffledirect', '--amp', 'True',
               '--batch_size', '64']),
    # entry_x8 with every option that is off by default: EDT*ROI
    # sampling, the three local augs always applied, ppiw with l1, the
    # other loss terms at their defaults but norm_img_grad and
    # norm_laplace, both regularizers. Those two are left out: the
    # flagship's prediction, made in bf16, has pixels whose image
    # gradient or Laplacian is exactly 0 (3 and 29 of 1,048,576 at the
    # seeded weights), where the terms' norm has a NaN gradient, JAX's
    # as the port's, so that nearly every step skips with them on
    # (options_check records the counts and the NaN on the card)
    'entry_opts': dict(
        scale=8, n_train=128, n_val=8, n_test=8, epochs=3, steps=6,
        opts=True,
        flags=['--h_size', '128', '--l2', 'True', '--ssim', 'True',
               '--ssim_lambda', '5.', '--ssim_window_s', '19',
               '--eval_over_roi_also', 'True',
               '--eval_over_roi_also_model_select', 'True',
               '--swinir_upsampler', 'pixelshuffledirect', '--amp', 'True',
               '--batch_size', '64', '--sample_tr_patch', 'edt*roi',
               '--da_blur', 'True', '--da_blur_prob', '1.0',
               '--da_dot_bin_noise', 'True', '--da_dot_bin_noise_prob',
               '1.0', '--da_add_gaus_noise', 'True',
               '--da_add_gaus_noise_prob', '1.0', '--ppiw', 'True',
               '--l1', 'True']
        + [f for t in ENTRY_OPT_TERMS for f in (f'--{t}', 'True')]
        + ['--hist_metric', 'KL', '--kde_metric', 'BHATTACHARYYA',
           '--G_regularizer_orthstep', '2', '--G_regularizer_clipstep',
           '3']),
    # entry_x8 under torchrun with --distributed True (NCCL): one rank
    # per card, at most 2 (entry_ddp_nproc); then `eval` in one process
    'entry_ddp': dict(
        scale=8, n_train=128, n_val=8, n_test=8, epochs=3, steps=6,
        ddp=True, flags=['--h_size', '128', '--l2', 'True', '--ssim',
                         'True', '--ssim_lambda', '5.', '--ssim_window_s',
                         '19', '--eval_over_roi_also', 'True',
                         '--eval_over_roi_also_model_select', 'True',
                         '--swinir_upsampler', 'pixelshuffledirect', '--amp',
                         'True', '--batch_size', '64']),
    # entry_x8 as a reconstruct run: the blurred LR -> the LR at scale 1
    # on 16x16 LR patches, the net's upsampler at upscale 1; then the
    # experiment-tree tools on its experiment (reconstruct_tools)
    'entry_reconstruct': dict(
        scale=8, n_train=128, n_val=8, n_test=8, epochs=3, steps=6,
        tools=True,
        flags=['--task', 'reconstruct', '--h_size', '128', '--l2', 'True',
               '--ssim', 'True', '--ssim_lambda', '5.', '--ssim_window_s',
               '19', '--eval_over_roi_also', 'True',
               '--eval_over_roi_also_model_select', 'True',
               '--swinir_upsampler', 'pixelshuffledirect', '--amp', 'True',
               '--batch_size', '64']),
    'entry_x2': dict(
        scale=2, n_train=32, n_val=4, n_test=4, epochs=2, steps=8,
        flags=['--h_size', '96', '--l2', 'True', '--ssim', 'True',
               '--ssim_lambda', '5.', '--ssim_window_s', '19',
               '--eval_over_roi_also', 'True',
               '--eval_over_roi_also_model_select', 'True',
               '--batch_size', '8']),
}


# a sitecustomize for entry_ddp's processes (written at run time, first on
# their PYTHONPATH): it runs the one it shadows, if any, then records in
# <SRCACO2_AUDIT_LOG><RANK or launcher>.txt every path under
# SRCACO2_AUDIT_ROOT that the process opens for writing, creates,
# renames or removes (sys audit events)
AUDIT_SITE = """import importlib.machinery, importlib.util, os, sys
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec('sitecustomize', [
    p for p in sys.path if os.path.abspath(p or os.curdir) != _here])
if _spec is not None:
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
_root = os.environ.get('SRCACO2_AUDIT_ROOT')
if _root:
    _root = os.path.abspath(_root)
    _fd = os.open(os.environ['SRCACO2_AUDIT_LOG']
                  + os.environ.get('RANK', 'launcher') + '.txt',
                  os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    _wr = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND
    _ev = ('os.mkdir', 'os.rename', 'os.replace', 'os.remove',
           'shutil.copyfile', 'shutil.rmtree')

    def _hook(event, args):
        if event == 'open':
            path, mode, flags = args
            w = (isinstance(mode, str) and any(c in mode for c in 'wax+')
                 ) or (isinstance(flags, int) and flags & _wr)
            paths = [path] if w else []
        elif event in _ev:
            paths = [a for a in args[:2]
                     if isinstance(a, (str, bytes, os.PathLike))]
        else:
            return
        for path in paths:
            try:
                path = os.path.abspath(os.fsdecode(path))
            except TypeError:
                continue
            if path == _root or path.startswith(_root + os.sep):
                os.write(_fd, (event + ' ' + path + chr(10)).encode())
    sys.addaudithook(_hook)
"""


# the tools' tolerances: a re-score of the same model on the same card
# against eval's (the same forward and metrics: only a batch's order of
# sums may differ); the floor's PSNR against float64 numpy (the port sums
# each image's squared uint8 differences in f32)
TOOLS_TOL = {'rescore': 1e-6, 'numpy_psnr_db': 1e-4}


def numpy_psnr(e_u8, h_u8, border):
    """Mean over the images (N, H, W, C) of PSNR(e, h) in float64, with
    ops/metrics.py's border crop and its cap for identical images."""
    import numpy as np
    e = e_u8.astype(np.float64)[:, border:-border, border:-border]
    h = h_u8.astype(np.float64)[:, border:-border, border:-border]
    mse = ((e - h) ** 2).reshape(e.shape[0], -1).mean(1)
    psnr = 20.0 * np.log10(255.0 / np.sqrt(np.maximum(mse, 1e-37)))
    return float(np.where(mse < 1e-37, 496.6655, psnr).mean())


def _rows_close(got, want, tol):
    """{ds: {'psnr', 'ssim'}} rows (fast_eval's 'full' or a summary's)
    within tol of want's; the largest difference."""
    worst = max(abs(got[ds][m] - want[ds][m]) for ds in want
                for m in ('psnr', 'ssim'))
    return worst <= tol, worst


def reconstruct_tools(exp, names, n_test, rescored, tmp, out_dir=None,
                      device='cuda'):
    """The experiment-tree tools on entry_reconstruct's experiment (its
    test split of n_test images; eval's rows `rescored`) on `device`, in
    this process (the sweep in a subprocess): see the module's
    docstring. Returns (record, ok)."""
    import io
    import shutil
    import numpy as np
    from srcaco2_tpu_torch.config import yaml_io
    from srcaco2_tpu_torch.data.dataset import load_dataset
    from srcaco2_tpu_torch.inference import reconstruct as IR
    from srcaco2_tpu_torch.inference.super_res import add_roi_noise
    test, floor = names[2], names[2] + '_bicubic'
    args = yaml_io.load(os.path.join(exp, 'config_model.yml'))
    forwards = -(-n_test // int(args['eval_bsize']))
    eval_rows = {ds: {m: rescored[ds][m][0] for m in ('psnr', 'ssim')}
                 for ds in (test, floor)}
    rec, log, seconds = {}, io.StringIO(), {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    with contextlib.redirect_stdout(log):
        reset_launches()
        fake = timed('fake', lambda: IR.reevaluate_reconstruct(
            exp, 'fake', device=device))
        launches = read_launches()
        fake_rows = {ds: fake[ds]['full'] for ds in (test, floor)}
        fake_ok, fake_err = _rows_close(fake_rows, eval_rows,
                                        TOOLS_TOL['rescore'])
        ds = load_dataset(args, test, 'eval')
        floor_np = numpy_psnr(ds.lr, ds.hr, int(args['scale']))
        floor_err = abs(floor_np - fake[floor]['full']['psnr'])
        real = timed('real', lambda: IR.reevaluate_reconstruct(
            exp, 'real', n=2, device=device))
        ds_real = load_dataset({**args, 'reconstruct_input': 'real'}, test,
                               'eval', n=2)
        real_same = bool(np.array_equal(ds_real.lr, ds_real.hr))
        noise = timed('noise_study', lambda: IR.noise_study(
            exp, sigmas=(0, 20), n=4, device=device))
        plain = timed('reevaluate', lambda: IR.reevaluate(
            exp, n=4, device=device))
        noise_ok, noise_err = _rows_close(
            {test: noise[0][test]['full']}, {test: plain[test]['full']},
            TOOLS_TOL['rescore'])
        # the noise reaches the input (a few-step net's output may not
        # move: its pixels sit at 0 or 255)
        lr4 = load_dataset(args, test, 'eval', n=4).lr
        moved = float((add_roi_noise(lr4, 20.0, 7.0) != lr4).mean())
        path = os.path.join(out_dir or tmp, 'entry_reconstruct.png')
        try:
            figure = timed('figure', lambda: IR.reconstruct_figure(
                exp, path, device=device))
        except ImportError as e:
            figure = ('skipped: no matplotlib' if 'matplotlib' in str(e)
                      else f'skipped: {e}')
    sweep = os.path.join(tmp, 'eval_all.json')
    rc, seconds['eval_all'] = _run_entry(
        ['srcaco2_tpu_torch.eval_all', '--exps_root',
         os.path.join(tmp, 'exps'), '--out', sweep, '--device', device],
        tmp,
        os.path.join(tmp, 'eval_all.log'))
    rows = {}
    if rc == 0:
        with open(sweep) as f:
            rows = json.load(f)
    sweep_ok = (len(rows) == 1 and all(
        r['status'] == 'ok' and _rows_close(r['datasets'], eval_rows,
                                            TOOLS_TOL['rescore'])[0]
        for r in rows.values()))
    if out_dir:
        dst = os.path.join(out_dir, 'entry_reconstruct')
        os.makedirs(dst, exist_ok=True)
        with open(os.path.join(dst, 'tools.log'), 'w') as f:
            f.write(log.getvalue())
        for f in (sweep, os.path.join(tmp, 'eval_all.log')):
            if os.path.isfile(f):
                shutil.copy(f, dst)
    rec.update(
        tolerances=TOOLS_TOL, seconds=seconds,
        fake={ds: fake_rows[ds] for ds in fake_rows},
        fake_equals_eval=fake_ok, fake_max_diff=fake_err,
        fake_launches=launches, fake_forwards=forwards,
        floor_numpy_psnr=floor_np, floor_numpy_diff=floor_err,
        real={k: v['full'] for k, v in real.items()},
        real_input_equals_target=real_same,
        noise={str(s): {k: v['full'] for k, v in r.items()}
               for s, r in noise.items()},
        noise_sigma0_equals_reevaluate=noise_ok, noise_sigma0_diff=noise_err,
        noise_sigma20_input_moved_share=moved,
        noise_sigma20_moves_psnr=noise[20][test]['full']['psnr']
        != noise[0][test]['full']['psnr'],
        eval_all_rc=rc, eval_all_rows=rows, eval_all_ok=sweep_ok,
        figure=figure)
    ok = (fake_ok and floor_err <= TOOLS_TOL['numpy_psnr_db']
          and launches['grouped'] == 36 * forwards
          and all(launches[k] == 0 for k in launches if k != 'grouped')
          and real_same and floor in real
          and real[floor]['full']['mse'] == 0.0
          and noise_ok and moved > 0 and sweep_ok)
    return rec, ok


def reconstruct_profile(dev, smi, steps=5, batch=64):
    """The reconstruct task's train step in this process, as
    entry_reconstruct's `main` builds it: the flagship at upscale 1
    (bf16 over f32 params, random seeded weights), the pipeline at
    scale 1 on 16x16 patches, N_IMG LR images of 64x64 and their blur
    chain (data/dataset.py) as the pairs, at the README's batch 64. One
    warm-up step, `steps` timed (ms per step, peak memory, launches:
    36 K1 + 36 K2 per step and nothing else), then the device time of
    one step by kernel and the device's busy share (profile_device).
    Returns (record, ok)."""
    import numpy as np
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.data.dataset import blur_true_lr
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.schedule import build_optimizer
    from srcaco2_tpu_torch.train.state import TrainState
    from srcaco2_tpu_torch.train.steps import make_train_step
    args = flagship_args()
    args['netG']['swinir_upscale'] = 1
    targs, _ = train_config()
    cfg = P.PipeConfig(scale=1, h_size=H_SIZE // SCALE)
    model = define_g(args, dev, seed=0).train()
    tx = build_optimizer(targs['train'])
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, build_loss(targs), tx, 'SwinIR', cfg,
                           steps_per_epoch=1000)
    lr_np = np.random.default_rng(0).integers(
        0, 256, (N_IMG, LR, LR, 1), dtype=np.uint8)
    blurred = np.clip(np.round(blur_true_lr(lr_np) * 255.0), 0,
                      255).astype(np.uint8)
    hr, lr = (torch.from_numpy(a).to(dev) for a in (lr_np, blurred))
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs():
        idxs = torch.randint(0, N_IMG, (batch,), generator=gen, device=dev)
        return idxs, P.draw(gen, batch, cfg, (LR, LR))
    state, holder, _ = step(state, hr, lr, *inputs())
    torch.cuda.synchronize()
    todo = [inputs() for _ in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flags = torch.zeros((), device=dev)
    for idxs, draws in todo:
        state, holder, _ = step(state, hr, lr, idxs, draws)
        flags = flags + holder['_flags']
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    launches = read_launches()
    rec = dict(
        model='SwinIR pixelshuffledirect at upscale 1, C=180 6x6 heads 6 '
        'ws 8, bf16 compute over f32 params, random weights (seed 0)',
        batch=batch, patch=[cfg.h_size, cfg.h_size], steps=steps,
        ms_per_step=ms, patches_per_s=1e3 * batch / ms,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        loss=float(holder['total']), flags_sum=float(flags),
        launches=launches, nvidia_smi=smi)
    idxs, draws = inputs()
    rec['profile'] = profile_device(
        lambda: step(state, hr, lr, idxs, draws), ms, host_ops=False)
    ok = (math.isfinite(rec['loss']) and rec['flags_sum'] == 0
          and launches['fwd'] == launches['bwd'] == 36 * steps
          and all(v == 0 for k, v in swin_launches(launches).items()
                  if k not in ('fwd', 'bwd'))
          and update_launched(launches, steps))
    return rec, ok


def native_check(dev):
    """dense_crf_loss (value and the segmentations' gradient) and
    permutohedral_attention on CUDA tensors against the same calls on
    CPU tensors (the lattice runs on the host either way; only the
    device-side sums and divisions move), their results on the card;
    the ms of a call on the card (host clock, synchronised). Returns
    (record, ok)."""
    import torch
    from srcaco2_tpu_torch import native
    from srcaco2_tpu_torch.losses.crf import dense_crf_loss
    from srcaco2_tpu_torch.ops.pam import permutohedral_attention
    t0 = time.perf_counter()
    native.build_library()
    build_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (2, 1, 128, 128), generator=gen).float()
    seg = torch.softmax(torch.randn(2, 4, 128, 128, generator=gen), 1)
    feats = 3.0 * torch.rand(2, 4096, 3, generator=gen)
    vals = torch.rand(2, 4096, 16, generator=gen)

    def crf(d):
        s = seg.to(d, copy=True).requires_grad_()
        loss = dense_crf_loss(img.to(d), s, 15.0, 80.0)
        loss.backward()
        return loss.detach(), s.grad

    def pam(d):
        return permutohedral_attention(feats.to(d), vals.to(d))

    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    (lc, gc), (lg, gg) = crf('cpu'), crf(dev)
    pc, pg = pam('cpu'), pam(dev)

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())
    rec = dict(build_seconds=build_s, crf_shape=list(seg.shape),
               pam_shape=[list(feats.shape), list(vals.shape)],
               crf_loss=float(lg), crf_loss_rel_err=rel(lg, lc),
               crf_grad_rel_err=rel(gg, gc), pam_rel_err=rel(pg, pc),
               on_card=all(t.device.type == 'cuda' for t in (lg, gg, pg)),
               crf_ms=host_ms(lambda: crf(dev)), pam_ms=host_ms(
                   lambda: pam(dev)), tol=1e-6)
    ok = rec['on_card'] and max(rec['crf_loss_rel_err'],
                                rec['crf_grad_rel_err'],
                                rec['pam_rel_err']) <= 1e-6
    return rec, ok


def entry_ddp_nproc():
    import torch
    return min(2, torch.cuda.device_count())


def _run_entry(cmd, cwd, log, timeout=600, env=None):
    """One entry point in a subprocess of this interpreter, the repo on
    its path (after env's PYTHONPATH, if it has one), `env` added to
    this process's environment; (return code, seconds). Its output goes
    to `log`. At the timeout its whole process group is killed (a
    launcher's workers with it)."""
    extra = dict(env or {})
    paths = (extra.pop('PYTHONPATH', None),
             os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, **extra,
               PYTHONPATH=os.pathsep.join(p for p in paths if p))
    t0 = time.perf_counter()
    with open(log, 'w') as f:
        proc = subprocess.Popen([sys.executable, '-m', *cmd], cwd=cwd,
                                env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = 124
    return rc, time.perf_counter() - t0


def entry_phase(name, out_dir=None, keep_dir=None):
    """Train an experiment with `python -m srcaco2_tpu_torch.main` on a
    synthetic dataset (the port's make_synthetic_dataset, CELL0, 512^2
    HR, blobs, one channel, written with the port's own TIFF codec where
    cv2 is missing), then re-score it with `python -m
    srcaco2_tpu_torch.eval`. Gates: both exit 0; passed.txt; the last
    checkpoint at the expected step; best-models/G-model.pt; validation,
    test and _bicubic test rows in the tracker; eval's test PSNR and SSIM
    equal to the trainer's final test within 1e-6; the kernel launches
    of each phase from the run's run_stats.json (x8: 36 K1 and 36 K2 per
    step; x2: none in training, the windowed path; both: 36 K5 per
    validation / test forward and no other kernel). With `ddp`, main
    runs under torchrun with --distributed True (entry_ddp_nproc ranks,
    NCCL), its processes' writes audited: only rank 0 writes in the
    experiment tree. keep_dir: the final params (models/<step>_G.pt)
    are copied there as <name>.pt."""
    import pickle
    import re
    import shutil
    import tempfile
    import numpy as np
    from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
    from srcaco2_tpu_torch.train import checkpoint as CKPT
    cfg = ENTRY[name]
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f'{name}_') as tmp:
        t0 = time.perf_counter()
        names = make_synthetic_dataset(
            os.path.join(tmp, 'data'), scale=cfg['scale'], cell='CELL0',
            n_train=cfg['n_train'], n_val=cfg['n_val'], n_test=cfg['n_test'],
            size=512, seed=0, style='blobs')
        data_s = time.perf_counter() - t0
        data = os.path.join(tmp, 'data')
        main_cmd = ['srcaco2_tpu_torch.main', '--net_type', 'SwinIR',
                    '--scale', str(cfg['scale']), '--n_channels', '1',
                    '--train_dsets', names[0], '--valid_dsets', names[1],
                    '--test_dsets', names[2], '--data_root', data,
                    '--splits_root', data, *cfg['flags'],
                    '--max_epochs', str(cfg['epochs']),
                    '--checkpoint_eval', '1.0', '--checkpoint_save', '1.0']
        env, audit = None, os.path.join(tmp, 'audit')
        if cfg.get('ddp'):
            os.makedirs(audit)
            with open(os.path.join(audit, 'sitecustomize.py'), 'w') as f:
                f.write(AUDIT_SITE)
            env = dict(PYTHONPATH=audit,
                       SRCACO2_AUDIT_ROOT=os.path.join(tmp, 'exps'),
                       SRCACO2_AUDIT_LOG=os.path.join(audit, 'writes_'))
            main_cmd = ['torch.distributed.run', '--standalone',
                        '--nproc_per_node', str(entry_ddp_nproc()), '-m',
                        *main_cmd, '--distributed', 'True']
        rc_train, train_s = _run_entry(main_cmd, tmp,
                                       os.path.join(tmp, 'main.log'),
                                       env=env)
        done = [os.path.join(d, 'passed.txt') for d, _, f in
                os.walk(os.path.join(tmp, 'exps')) if 'passed.txt' in f]
        exp = os.path.dirname(done[0]) if done else None
        rc_eval, eval_s = (_run_entry(
            ['srcaco2_tpu_torch.eval', '--exp_path', exp], tmp,
            os.path.join(tmp, 'eval.log')) if exp else (None, 0.0))
        rec = dict(dataset=dict(names=names, seconds=data_s,
                                n=[cfg['n_train'], cfg['n_val'],
                                   cfg['n_test']]),
                   main_rc=rc_train, main_seconds=train_s, eval_rc=rc_eval,
                   eval_seconds=eval_s, passed_txt=bool(done))
        if out_dir:
            dst = os.path.join(out_dir, name)
            os.makedirs(dst, exist_ok=True)
            for f in [os.path.join(tmp, 'main.log'),
                      os.path.join(tmp, 'eval.log')] + (
                          [os.path.join(exp, 'run_stats.json')] if exp
                          else []):
                if os.path.isfile(f):
                    shutil.copy(f, dst)
        ok = rc_train == 0 and rc_eval == 0 and bool(done)
        if ok and cfg.get('ddp'):
            writes = {}
            for f in sorted(os.listdir(audit)):
                if f.startswith('writes_'):
                    with open(os.path.join(audit, f)) as fh:
                        writes[f[len('writes_'):-len('.txt')]] = \
                            len(fh.read().splitlines())
            rec.update(nproc=entry_ddp_nproc(), writes_by_process=writes)
            rec['only_rank_0_wrote'] = writes.get('0', 0) > 0 and all(
                v == 0 for k, v in writes.items() if k != '0')
            ok = rec['only_rank_0_wrote']
        if ok:
            rec['last_checkpoint'] = CKPT.find_last_checkpoint(exp)
            if keep_dir:
                shutil.copy(os.path.join(
                    exp, 'models', f"{rec['last_checkpoint']}_G.pt"),
                    os.path.join(keep_dir, f'{name}.pt'))
            rec['best_model'] = os.path.isfile(
                os.path.join(exp, 'best-models', 'G-model.pt'))
            with open(os.path.join(exp, 'tracker.pkl'), 'rb') as f:
                tracker = pickle.load(f)
            with open(os.path.join(exp, 'eval_test_test', 'tracker.pkl'),
                      'rb') as f:
                ev = pickle.load(f)
            with open(os.path.join(exp, 'run_stats.json')) as f:
                stats = json.load(f)
            with open(os.path.join(exp, 'eval_test_test',
                                   'run_stats.json')) as f:
                ev_stats = json.load(f)
            val = tracker['val'][names[1]]['psnr']['vals']
            test = {ds: {m: tracker['test'][ds][m]['vals'][-1:]
                         for m in ('psnr', 'ssim')}
                    for ds in (names[2], names[2] + '_bicubic')}
            rescored = {ds: {m: ev['test'][ds][m]['vals'][-1:]
                             for m in ('psnr', 'ssim')} for ds in test}
            same = all(len(test[ds][m]) == len(rescored[ds][m]) == 1
                       and abs(test[ds][m][0] - rescored[ds][m][0]) <= 1e-6
                       for ds in test for m in ('psnr', 'ssim'))
            steps = stats['train_steps']
            lt, lv = stats['launches']['train'], stats['launches']['val']
            lts = stats['launches']['test']
            fv = stats['model_forwards']['val']
            ft = stats['model_forwards']['test']
            blocks = 36
            k12 = blocks * steps if cfg['scale'] == 8 else 0
            launches_ok = (
                lt['fwd'] == k12 and lt['bwd'] == k12
                and all(lt[k] == 0 for k in swin_launches(lt)
                        if k not in ('fwd', 'bwd'))
                and update_launched(lt, steps)
                and lv['grouped'] == blocks * fv
                and all(lv[k] == 0 for k in lv if k != 'grouped')
                and lts['grouped'] == blocks * ft
                and all(lts[k] == 0 for k in lts if k != 'grouped')
                and ev_stats['launches']['test']['grouped']
                == blocks * ev_stats['model_forwards']['test'])
            windows = stats['train_windows']
            later = windows[1:]
            later_steps = sum(w['steps'] for w in later)
            later_s = sum(w['seconds'] for w in later)
            bs = int(cfg['flags'][cfg['flags'].index('--batch_size') + 1])
            rec.update(
                val_rows=len(val), test_rows=test, rescored=rescored,
                eval_equals_final_test=same, train_steps=steps,
                model_forwards=stats['model_forwards'],
                launches=stats['launches'],
                eval_launches=ev_stats['launches'],
                launches_ok=launches_ok, train_windows=windows,
                # host clock from a chunk's dispatch to its flag read
                # (synchronising); the first window holds the first step
                s_per_step=sum(w['seconds'] for w in windows) / steps,
                ms_per_step_after_first_window=(
                    1e3 * later_s / later_steps if later_steps else None),
                patches_per_s_after_first_window=(
                    bs * later_steps / later_s if later_s else None),
                train_max_memory_allocated=max(
                    w.get('max_memory_allocated') or 0 for w in windows))
            ok = (rec['last_checkpoint'] == cfg['steps'] and rec['best_model']
                  and steps == cfg['steps'] and len(val) >= cfg['epochs']
                  and all(test[ds]['psnr'] for ds in test) and same
                  and launches_ok)
            if cfg.get('opts'):
                # every term finite on the steps that were not skipped;
                # skips counted from the trainer's warnings, and not all
                with open(os.path.join(tmp, 'main.log')) as f:
                    skipped = sorted({int(m) for m in re.findall(
                        r'step (\d+): non-finite', f.read())})
                per_iter = tracker['train']['period_iter']
                kept = [i for i in range(steps) if i not in skipped]
                rec.update(skipped_steps=skipped, terms=sorted(per_iter),
                           terms_finite=all(
                               np.isfinite(per_iter[t][i]) for t in per_iter
                               for i in kept))
                ok = (ok and rec['terms_finite'] and len(kept) > 0
                      and len(per_iter) == len(ENTRY_OPT_TERMS) + 4)
            if ok and cfg.get('tools'):
                rec['tools'], ok = reconstruct_tools(
                    exp, names, cfg['n_test'], rescored, tmp, out_dir)
        rec['wall_seconds'] = time.perf_counter() - t_all
        rec['ok'] = ok
        return rec, ok


# the README's training command for each zoo net: entry_x8's flags but
# SwinIR's upsampler; 1 epoch of 2 steps at batch 64
ZOO_ENTRY_FLAGS = [f for f in ENTRY['entry_x8']['flags']
                   if f not in ('--swinir_upsampler', 'pixelshuffledirect')]
ZOO_ENTRY = dict(scale=8, n_train=2 * ZOO_BATCH, n_val=4, n_test=4,
                 epochs=1, steps=2, workers=6)


# each zoo net's device memory for `main` and `eval` at ZOO_ENTRY's
# size, GB: the larger of the two processes' peaks (entry_zoo's record:
# main_max_memory_allocated, and eval_max_memory_reserved, its upper
# bound), rounded up; SRCNN's and EDSR-LIIF's lie in the validation
# forward of 8 full 512^2 images, the others' in the training step (runs
# on an NVIDIA H100 80GB HBM3 at 700 W)
ZOO_ENTRY_PEAK_GB = {
    'EDSR_LIIF': 45.4, 'MemNet': 36.5, 'SRFBN': 25.6, 'SRCNN': 17.4,
    'DRRN': 15.2, 'DBPN': 13.6, 'ProSR': 9.3, 'GRL': 8.8, 'NLSN': 6.7,
    'OmniSR': 6.2, 'ENLCN': 6.1, 'DSRSplines': 4.9, 'VDSR': 3.1,
    'DFCAN': 2.9, 'CSRCNN': 2.7, 'ACT': 2.6, 'MSLapSRN': 2.5}
# Left to itself each run's caching allocator keeps what it freed, and
# cuDNN sizes a convolution's workspace by the card's free memory, so
# that four concurrent runs filled the card: a run out of memory, and
# near full cuDNN's choice of algorithm, so a forward's bits, moved with
# the workspace it could get (GRL's `eval` missed its final test by
# 1.3e-5 dB). Each run is now held to a share of the card (its peak with
# a margin, zoo_entry_cap_gb) and runs start only while the shares of the
# runs on the card fit in its free memory, so that no run is starved by
# another's cache (runs on an NVIDIA H100 80GB HBM3 at 700 W).
ZOO_ENTRY_ALLOC = 'expandable_segments:True,per_process_memory_fraction:{:.4f}'
# the CUDA context of a process, outside its allocator's share (one for
# each worker), and the free memory left beside the shares, GB
ZOO_ENTRY_CONTEXT_GB, ZOO_ENTRY_SPARE_GB = 0.6, 2.0


def zoo_entry_cap_gb(nt):
    """nt's share of the card for its `main` and `eval` runs, GB: its
    peak with a margin for cuDNN's workspaces."""
    return 1.1 * ZOO_ENTRY_PEAK_GB[nt] + 2.0


def _zoo_entry_run(nt, tmp, data, names, out_dir, total):
    """main then eval for one net in its own working directory, each
    process held to zoo_entry_cap_gb(nt) of the card's `total` bytes; the
    gates of entry_phase, with no kernel launch in any phase."""
    import pickle
    import shutil
    from srcaco2_tpu_torch.train import checkpoint as CKPT
    cfg = ZOO_ENTRY
    cwd = os.path.join(tmp, nt)
    os.makedirs(cwd)
    cap = zoo_entry_cap_gb(nt)
    env = {'PYTORCH_CUDA_ALLOC_CONF': ZOO_ENTRY_ALLOC.format(
        cap * 1e9 / total)}
    rc_train, train_s = _run_entry(
        ['srcaco2_tpu_torch.main', '--net_type', nt, '--scale',
         str(cfg['scale']), '--n_channels', '1', '--train_dsets', names[0],
         '--valid_dsets', names[1], '--test_dsets', names[2],
         '--data_root', data, '--splits_root', data, *ZOO_ENTRY_FLAGS,
         '--max_epochs', str(cfg['epochs']), '--checkpoint_eval', '1.0',
         '--checkpoint_save', '1.0'], cwd, os.path.join(cwd, 'main.log'),
        env=env)
    done = [os.path.join(d, 'passed.txt') for d, _, f in
            os.walk(os.path.join(cwd, 'exps')) if 'passed.txt' in f]
    exp = os.path.dirname(done[0]) if done else None
    rc_eval, eval_s = (_run_entry(
        ['srcaco2_tpu_torch.eval', '--exp_path', exp], cwd,
        os.path.join(cwd, 'eval.log'), env=env) if exp else (None, 0.0))
    rec = dict(main_rc=rc_train, main_seconds=train_s, eval_rc=rc_eval,
               eval_seconds=eval_s, passed_txt=bool(done), exp=exp,
               cap_gb=cap)
    if out_dir:
        dst = os.path.join(out_dir, 'entry_zoo', nt)
        os.makedirs(dst, exist_ok=True)
        for f in [os.path.join(cwd, 'main.log'),
                  os.path.join(cwd, 'eval.log')] + (
                      [os.path.join(exp, 'run_stats.json')] if exp else []):
            if os.path.isfile(f):
                shutil.copy(f, dst)
    ok = rc_train == 0 and rc_eval == 0 and bool(done)
    if ok:
        with open(os.path.join(exp, 'tracker.pkl'), 'rb') as f:
            tracker = pickle.load(f)
        with open(os.path.join(exp, 'eval_test_test', 'tracker.pkl'),
                  'rb') as f:
            ev = pickle.load(f)
        with open(os.path.join(exp, 'run_stats.json')) as f:
            stats = json.load(f)
        with open(os.path.join(exp, 'eval_test_test',
                               'run_stats.json')) as f:
            ev_stats = json.load(f)
        val = tracker['val'][names[1]]['psnr']['vals']
        test = {ds: {m: tracker['test'][ds][m]['vals'][-1:]
                     for m in ('psnr', 'ssim')}
                for ds in (names[2], names[2] + '_bicubic')}
        rescored = {ds: {m: ev['test'][ds][m]['vals'][-1:]
                         for m in ('psnr', 'ssim')} for ds in test}
        same = all(len(test[ds][m]) == len(rescored[ds][m]) == 1
                   and abs(test[ds][m][0] - rescored[ds][m][0]) <= 1e-6
                   for ds in test for m in ('psnr', 'ssim'))
        no_launch = (all(v == 0 for st in (stats, ev_stats)
                         for ph in st['launches'].values()
                         for v in swin_launches(ph).values())
                     and update_launched(stats['launches']['train'],
                                         stats['train_steps']))
        windows = stats['train_windows']
        rec.update(
            last_checkpoint=CKPT.find_last_checkpoint(exp),
            best_model=os.path.isfile(os.path.join(exp, 'best-models',
                                                   'G-model.pt')),
            val_rows=len(val), test_rows=test, rescored=rescored,
            eval_equals_final_test=same, train_steps=stats['train_steps'],
            model_forwards=stats['model_forwards'],
            launches=stats['launches'], no_kernel_launch=no_launch,
            train_windows=windows,
            train_max_memory_allocated=max(
                (w.get('max_memory_allocated') or 0 for w in windows),
                default=0),
            **{f'{proc}_{k}': st.get(k) for proc, st in (('main', stats),
                                                         ('eval', ev_stats))
               for k in ('max_memory_allocated', 'max_memory_reserved')})
        ok = (rec['last_checkpoint'] == cfg['steps'] and rec['best_model']
              and rec['train_steps'] == cfg['steps']
              and len(val) >= cfg['epochs']
              and all(test[ds]['psnr'] for ds in test) and same
              and no_launch)
    rec['ok'] = ok
    return rec


# the LR side each served zoo net takes (its CPU comparison runs the
# same requests: MemNet's 216 block applications on 64x64 LR take ~40 s
# per image on the host)
ZOO_SERVE_LR = {'SRCNN': LR, 'MemNet': 16, 'CSRCNN': LR}


def _serve_zoo(nt, exp, dev):
    """nt's best model served through SRServer on the card: 3 requests
    (11 images: a batch of 8 and a ragged tail of 3 padded to 8; 8; the
    same 8 again, bit for bit), uint8 out, and the tail request's pixels
    against the same server on the CPU. The model computes in bf16, as
    the experiment trained with amp. SRCNN (3 layers): a different f32
    sum order flips a bf16 rounding, one uint8 level at outputs in
    [0.5, 1); 99% within 1 level, none more than 2 apart. MemNet (216
    block applications, each normalised by running statistics) and
    CSR-CNN (its unet, 49 convolutions): the flips travel through the depth, so
    the card's pixels are held to an f32 server of the same weights as
    the `serve` phase holds the kernel path, no further from it than the
    CPU's bf16 pixels are (mean within 1.25 x, max within 2 x); CSR-CNN's
    f32 server on the card is also held to the same f32 server on the
    CPU by SRCNN's rule (99% within 1 level, none more than 2 apart). SRCNN and CSR-CNN take the bicubic
    pre-upscale; MemNet
    the LR batch, normalised with the running statistics the experiment
    saved (the served model in evaluation mode, its buffers the best
    model's)."""
    import numpy as np
    import torch
    from srcaco2_tpu_torch.inference.serve import SRServer
    lr_side = ZOO_SERVE_LR[nt]
    rng = np.random.default_rng(0)
    req_a = rng.integers(0, 256, (11, 1, lr_side, lr_side), dtype=np.uint8)
    req_b = rng.integers(0, 256, (BATCH, 1, lr_side, lr_side),
                         dtype=np.uint8)
    srv = SRServer(exp, batch_size=BATCH, lr_hw=(lr_side, lr_side),
                   device=dev)
    t0 = time.perf_counter()
    out_a = srv(req_a)
    out_b, out_c = srv(req_b), srv(req_b)
    serve_s = time.perf_counter() - t0
    cpu = SRServer(exp, batch_size=3, lr_hw=(lr_side, lr_side),
                   device='cpu')(req_a[8:])
    udiff = np.abs(cpu.astype(np.int16) - out_a[8:].astype(np.int16))
    best = torch.load(os.path.join(exp, 'best-models', 'G-model.pt'),
                      map_location='cpu', weights_only=True)
    bufs = dict(srv.model.named_buffers())
    side = lr_side * SCALE
    s = dict(
        requests=[11, BATCH, BATCH], lr_hw=[lr_side, lr_side],
        serve_seconds=serve_s, setup_seconds=srv.setup_seconds,
        images_per_s=srv.throughput(iters=5),
        pre_upsampled=srv.pre_upsampled, eval_mode=not srv.model.training,
        n_buffers=len(bufs),
        buffers_as_saved=all(torch.equal(b.cpu(), best[k])
                             for k, b in bufs.items()),
        shapes_ok=(out_a.shape == (11, 1, side, side)
                   and out_b.shape == (BATCH, 1, side, side)
                   and out_a.dtype == np.uint8),
        deterministic=bool(np.array_equal(out_b, out_c)),
        tail_vs_cpu_equal_share=float((udiff == 0).mean()),
        tail_vs_cpu_within1_share=float((udiff <= 1).mean()),
        tail_vs_cpu_max_diff=int(udiff.max()),
        out_std=float(out_a.std()))
    if nt == 'SRCNN':
        close = (s['tail_vs_cpu_within1_share'] >= 0.99
                 and s['tail_vs_cpu_max_diff'] <= 2)
    else:
        f32 = dict(args={**srv.args, 'amp': False}, state_dict=best,
                   batch_size=3, lr_hw=(lr_side, lr_side))
        ref = SRServer(**f32, device=dev)(req_a[8:]).astype(np.int16)
        e_card = np.abs(out_a[8:].astype(np.int16) - ref)
        e_cpu = np.abs(cpu.astype(np.int16) - ref)
        s.update(card_vs_f32_mean=float(e_card.mean()),
                 card_vs_f32_max=int(e_card.max()),
                 cpu_vs_f32_mean=float(e_cpu.mean()),
                 cpu_vs_f32_max=int(e_cpu.max()))
        close = (e_card.mean() <= 1.25 * e_cpu.mean()
                 and e_card.max() <= 2 * e_cpu.max())
        if nt in ZOO_SERVED_F32_PIXELS:
            # the f32 server's pixels on the card against the CPU's, by
            # SRCNN's rule
            d32 = np.abs(SRServer(**f32, device='cpu')(req_a[8:])
                         .astype(np.int16) - ref)
            s.update(f32_vs_cpu_f32_within1_share=float((d32 <= 1).mean()),
                     f32_vs_cpu_f32_equal_share=float((d32 == 0).mean()),
                     f32_vs_cpu_f32_max_diff=int(d32.max()))
            close = (close and s['f32_vs_cpu_f32_within1_share'] >= 0.99
                     and s['f32_vs_cpu_f32_max_diff'] <= 2)
    s['ok'] = bool(close and s['shapes_ok'] and s['deterministic']
                   and s['eval_mode'] and s['buffers_as_saved']
                   and s['pre_upsampled'] == (nt in ZOO_SERVED_PRE)
                   and (nt != 'MemNet' or s['n_buffers'] > 0))
    del srv
    return s


# the nets SRServer serves in entry_zoo
ZOO_SERVED = ('SRCNN', 'MemNet', 'CSRCNN')
# the served nets that take the bicubic pre-upscale (SRServer's
# pre_upsampled)
ZOO_SERVED_PRE = ('SRCNN', 'CSRCNN')
# the served nets whose f32 server's pixels on the card are also held to
# the CPU's by SRCNN's rule (their bf16 pixels by MemNet's)
ZOO_SERVED_F32_PIXELS = ('CSRCNN',)


def _within_budget(nets, need, budget, workers, run):
    """{nt: run(nt)} for every net, at most `workers` at a time and the
    needs of the running nets never above `budget` together (a net that
    needs more than the budget runs alone); each free worker takes the
    first waiting net, largest need first, that fits. Also the most
    runs that were on the card at once."""
    import threading
    cond = threading.Condition()
    waiting = sorted(nets, key=lambda nt: -need[nt])
    held, out, errs, most = {}, {}, [], [0]

    def take():
        for nt in waiting:
            if not held or sum(held.values()) + need[nt] <= budget:
                return nt
        return None

    def worker():
        while True:
            with cond:
                while waiting and (nt := take()) is None:
                    cond.wait()
                if not waiting:
                    return
                waiting.remove(nt)
                held[nt] = need[nt]
                most[0] = max(most[0], len(held))
            try:
                out[nt] = run(nt)
            except BaseException as e:      # re-raised once all have run
                errs.append(e)
            finally:
                with cond:
                    del held[nt]
                    cond.notify_all()

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out, most[0]


def entry_zoo(dev, out_dir=None, nets=ZOO):
    """`python -m srcaco2_tpu_torch.main --net_type <NET>` with the
    README's flags, then `python -m srcaco2_tpu_torch.eval`, for each zoo
    net on one synthetic x8 dataset (128 / 4 / 4 images of 512^2; 1 epoch
    of 2 steps at batch 64, a validation, the test), up to six nets at
    a time on the card, each process held to its share of the card and
    the shares of the running nets within its free memory
    (zoo_entry_cap_gb); the gates of entry_phase with no kernel launch.
    Then SRCNN's, MemNet's and CSR-CNN's best models served through
    SRServer on the card (_serve_zoo). Also the card's least free memory
    while the runs ran."""
    import tempfile
    import threading
    import torch
    from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
    cfg = ZOO_ENTRY
    t_all = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix='entry_zoo_') as tmp:
        t0 = time.perf_counter()
        data = os.path.join(tmp, 'data')
        names = make_synthetic_dataset(
            data, scale=cfg['scale'], cell='CELL0', n_train=cfg['n_train'],
            n_val=cfg['n_val'], n_test=cfg['n_test'], size=512, seed=0,
            style='blobs')
        out['dataset'] = dict(names=names, seconds=time.perf_counter() - t0,
                              n=[cfg['n_train'], cfg['n_val'],
                                 cfg['n_test']])
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        budget = (free / 1e9 - ZOO_ENTRY_CONTEXT_GB * cfg['workers']
                  - ZOO_ENTRY_SPARE_GB)
        frees, stop = [], threading.Event()

        def sample():
            while not stop.wait(0.25):
                frees.append(torch.cuda.mem_get_info(dev)[0])

        sampler = threading.Thread(target=sample)
        sampler.start()
        try:
            nets_, most = _within_budget(
                nets, {nt: zoo_entry_cap_gb(nt) for nt in nets}, budget,
                cfg['workers'], lambda nt: _zoo_entry_run(
                    nt, tmp, data, names, out_dir, total))
        finally:
            stop.set()
            sampler.join()
        nets_ = {nt: nets_[nt] for nt in nets}
        out.update(nets=nets_, free_gb_at_start=free / 1e9,
                   budget_gb=budget, most_runs_at_once=most,
                   least_free_gb=min(frees, default=free) / 1e9)
        ok = all(r['ok'] for r in nets_.values())
        for nt in ZOO_SERVED:
            if nt not in nets_:
                continue
            if nets_[nt]['ok']:
                out[f'serve_{nt.lower()}'] = s = _serve_zoo(
                    nt, nets_[nt]['exp'], dev)
                ok = ok and s['ok']
            else:
                ok = False
        for r in nets_.values():
            r.pop('exp', None)
    torch.cuda.empty_cache()
    out['wall_seconds'] = time.perf_counter() - t_all
    out['ok'] = ok
    return out, ok


# ------------------------------------------------------- data parallelism
# ddp_check: two ranks of the port's grid (parallel/mesh.py), over NCCL
# with a card each where the machine has two cards, else as two
# processes on card 0 over gloo (which all-reduces and broadcasts CUDA
# tensors). The backend is an argument of this check's own call of
# mesh.init_process_group; `main --distributed True` takes NCCL on the
# card whatever the card count.
DDP_WORLD = 2
DDP_E_DECAY = 0.999
# f32: only the order of the f32 sums differs (the weight grads' sums
# over 128 patches against two sums over 64 and their all-reduce);
# bf16: bf16_grads_held's tolerance and floor rule against the f32 steps.
# MemNet is held to the larger of these and 3 x its own spread: its
# one-process step on the same batch in reverse order (another order of
# every sum) moves its grads by 4.5e-4 relative L2 and its running
# statistics by 9.5e-7 (an NVIDIA H100 80GB HBM3 at 700 W; 1.9e-4 and
# 1.4e-6 on the CPU): the BatchNorm backward's differences of
# near-equal sums amplify f32 rounding, 21 BatchNorms deep
# In bf16 the params and the EMA are held where the one-process f32
# grad is above DDP_LIVE of its tensor's largest: Adam's first step
# moves a param by +-lr whatever the size of its grad, so a grad within
# bf16 noise of 0 lands on either side (one element of a zero-initialised
# 1,080-element mlp2_bias made 5.9e-2 relative L2 on an NVIDIA H100
# 80GB HBM3 at 700 W); the moments, unmasked, hold the grads
DDP_TOL = {'f32': 1e-5, 'bf16': 3e-2, 'stats': 1e-6}
DDP_LIVE = 1e-2
DDP_MEMNET_B, DDP_STEPS, DDP_TIMEOUT_S = 8, 3, 600


def _tree_rel_l2(a, b):
    """Relative L2 distance of a from b over all their tensors."""
    import torch
    fa = torch.cat([a[k].double().reshape(-1) for k in sorted(b)])
    fb = torch.cat([b[k].double().reshape(-1) for k in sorted(b)])
    return float((fa - fb).norm() / fb.norm().clamp_min(1e-30))


def _ddp_record(model, state, holder, ok):
    """CPU copies of what a step leaves: params, Adam moments, EMA,
    buffers, the holder and the ok flag."""
    def cpu(t):
        return {k: v.detach().float().cpu().clone() for k, v in t.items()}
    adam = state.opt_state['adam']
    return dict(params=cpu(state.params), mu=cpu(adam['mu']),
                nu=cpu(adam['nu']), ema=cpu(state.ema_params or {}),
                buffers=cpu(dict(model.named_buffers())),
                holder={k: float(v) for k, v in holder.items()},
                ok=bool(ok))


def _ddp_flagship(dev, amp, grid, cfg):
    """The x8 flagship (full depth and width, seeded weights, bf16 over
    f32 params or f32), its state with an EMA, and its train step (one
    rank's on `grid`)."""
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.schedule import build_optimizer
    from srcaco2_tpu_torch.train.state import TrainState
    from srcaco2_tpu_torch.train.steps import make_train_step
    targs, _ = train_config()
    model = define_g({**flagship_args(), 'amp': amp}, dev, seed=0).train()
    master, tx = build_loss(targs), build_optimizer(targs['train'])
    state = TrainState.create(dict(model.named_parameters()), tx,
                              DDP_E_DECAY)

    def step_for(pipe):
        return make_train_step(model, master, tx, 'SwinIR', pipe,
                               e_decay=DDP_E_DECAY, steps_per_epoch=1000,
                               grid=grid)
    return model, state, step_for(cfg), step_for


def _ddp_timing(dev, grid, state, step, hr, lr, cfg):
    """This rank's ms per step over DDP_STEPS bf16 steps after a warm-up,
    its kernel launches, peak memory, and the gradient all-reduce alone
    (one flat f32 buffer of every grad): its ms and bytes."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(6)
    inputs = [step_inputs(gen, cfg, TRAIN_B) for _ in range(DDP_STEPS + 1)]
    state, _, _ = step(state, hr, lr, *inputs[0])
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    flags = torch.zeros((), device=dev)
    for idxs, draws in inputs[1:]:
        state, holder, _ = step(state, hr, lr, idxs, draws)
        flags = flags + holder['_flags']
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    grads = {k: torch.ones_like(p) for k, p in state.params.items()}
    grid.all_reduce_grads(grads)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        grid.all_reduce_grads(grads)
    torch.cuda.synchronize(dev)
    ar_ms = 1e3 * (time.perf_counter() - t0) / 10
    return dict(ms_per_step=1e3 * dt / DDP_STEPS, steps=DDP_STEPS,
                patches_per_s_global=TRAIN_B * DDP_STEPS / dt,
                flags_sum=float(flags), launches=launches,
                launches_per_step={k: v / DDP_STEPS
                                   for k, v in launches.items()},
                max_memory_allocated=peak, allreduce_ms=ar_ms,
                allreduce_bytes=4 * sum(g.numel() for g in grads.values()))


def _ddp_nan(dev, grid, state, step_for, hr, lr):
    """One bf16 step whose batch has a NaN in rank 1's shard only (the
    Gaussian-noise aug's field of its first sample): (skipped on this
    rank, params kept)."""
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    cfg = P.PipeConfig(scale=SCALE, h_size=H_SIZE, da_add_gaus_noise=True,
                       da_add_gaus_noise_prob=1.0)
    gen = torch.Generator(device=dev).manual_seed(8)
    idxs, draws = step_inputs(gen, cfg, TRAIN_B)
    if grid.rank == 1:
        field = draws.gaus.field.clone()
        field[grid.rows(TRAIN_B).start] = float('nan')
        draws = draws._replace(gaus=draws.gaus._replace(field=field))
    before = {k: p.detach().clone() for k, p in state.params.items()}
    state, holder, ok = step_for(cfg)(state, hr, lr, idxs, draws)
    return dict(ok=bool(ok), skipped=float(holder['_skipped']),
                params_kept=all(torch.equal(p, before[k])
                                for k, p in state.params.items()))


def _ddp_memnet(dev, grid, reverse=False):
    """MemNet at zoo_check's cut depth (full width), f32, one step at
    global batch DDP_MEMNET_B: its BatchNorms normalise with the global
    batch's statistics and move their running ones alike. `reverse`:
    the batch's samples in reverse order (the spread of the sums'
    order)."""
    import torch
    from srcaco2_tpu_torch.data import pipeline as P
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.schedule import build_optimizer
    from srcaco2_tpu_torch.train.state import TrainState
    from srcaco2_tpu_torch.train.steps import make_train_step
    from srcaco2_tpu_torch.utils import reproducibility as R
    args = zoo_check_args('MemNet', amp=False)
    model = define_g(args, dev, seed=0).train()
    tx = build_optimizer(args['train'])
    state = TrainState.create(dict(model.named_parameters()), tx)
    cfg = P.PipeConfig(scale=SCALE, h_size=H_SIZE)
    step = make_train_step(model, build_loss(args), tx, 'MemNet', cfg,
                           steps_per_epoch=1000, netG=args['netG'],
                           grid=grid)
    b = DDP_MEMNET_B
    gen = torch.Generator(device=dev).manual_seed(7)
    hr = torch.randint(0, 256, (b, H_SIZE, H_SIZE, 1), generator=gen,
                       device=dev, dtype=torch.uint8)
    lr = torch.randint(0, 256, (b, PATCH, PATCH, 1), generator=gen,
                       device=dev, dtype=torch.uint8)
    draws = P.draw(R.step_generator(7, 0, dev), b, cfg, (H_SIZE, H_SIZE))
    idxs = torch.arange(b, device=dev)
    if reverse:
        from srcaco2_tpu_torch.parallel import mesh
        idxs = idxs.flip(0)
        draws = mesh.shard_draws(draws, idxs)
    before = {k: v.clone() for k, v in model.named_buffers()}
    state, holder, ok = step(state, hr, lr, idxs, draws)
    rec = _ddp_record(model, state, holder, ok)
    rec['buffers_moved'] = sum(not torch.equal(v, before[k])
                               for k, v in model.named_buffers())
    return rec


def _ddp_run(dev, grid=None):
    """The steps ddp_check holds: the flagship's f32 and bf16 steps at
    global batch TRAIN_B from the seeded weights on the same draws, and
    MemNet's f32 step; in one process (grid None) or as one rank (then
    also the bf16 timing and the NaN step)."""
    import torch
    hr, lr, _ = train_data(dev)
    _, cfg = train_config()
    gen = torch.Generator(device=dev).manual_seed(5)
    idxs, draws = step_inputs(gen, cfg, TRAIN_B)
    rec = {}
    for name, amp in (('f32', False), ('bf16', True)):
        model, state, step, step_for = _ddp_flagship(dev, amp, grid, cfg)
        state, holder, ok = step(state, hr, lr, idxs, draws)
        rec[name] = _ddp_record(model, state, holder, ok)
        if grid is not None and amp:
            rec['timing'] = _ddp_timing(dev, grid, state, step, hr, lr, cfg)
            rec['nan'] = _ddp_nan(dev, grid, state, step_for, hr, lr)
        del model, state, step, step_for
        torch.cuda.empty_cache()
    rec['memnet'] = _ddp_memnet(dev, grid)
    if grid is None:
        rec['memnet_reversed'] = _ddp_memnet(dev, None, reverse=True)
    return rec


def _ddp_world1(dev):
    """The DP layer's own cost: the bf16 flagship step at batch TRAIN_B
    in this process with a world-of-one NCCL grid against no grid, in
    turns (none, grid, grid, none); ms per step over DDP_STEPS after a
    warm-up, each."""
    import torch
    from srcaco2_tpu_torch.parallel import mesh
    _, cfg = train_config()
    hr, lr, _ = train_data(dev)
    mesh.init_process_group('nccl', 0, 1, '', DDP_TIMEOUT_S, dev)
    out = {'none': [], 'grid': []}
    try:
        grid = mesh.make_mesh(data=1)
        for name in ('none', 'grid', 'grid', 'none'):
            _, state, step, _ = _ddp_flagship(
                dev, True, grid if name == 'grid' else None, cfg)
            gen = torch.Generator(device=dev).manual_seed(6)
            inputs = [step_inputs(gen, cfg, TRAIN_B)
                      for _ in range(DDP_STEPS + 1)]
            state, _, _ = step(state, hr, lr, *inputs[0])
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for idxs, draws in inputs[1:]:
                state, _, _ = step(state, hr, lr, idxs, draws)
            torch.cuda.synchronize(dev)
            out[name].append(1e3 * (time.perf_counter() - t0) / DDP_STEPS)
            del state, step
            torch.cuda.empty_cache()
    finally:
        mesh.destroy_process_group(dev)
    return out


@contextlib.contextmanager
def _true_f32():
    """TF32 off and cuDNN's deterministic algorithms (the entry points'
    settings, train/trainer.py), restored after."""
    import torch
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
           b.cudnn.deterministic)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic = True
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cudnn.deterministic) = old


def _ddp_rank(rank, world, backend, init, out):
    """One rank of ddp_check (a spawned process): its card (its own with
    NCCL, card 0 with gloo), the process group, _ddp_run on the grid;
    its record to out.<rank>."""
    import torch
    from srcaco2_tpu_torch.parallel import mesh
    try:
        dev = torch.device('cuda', rank if backend == 'nccl' else 0)
        torch.cuda.set_device(dev)
        mesh.init_process_group(backend, rank, world, init, DDP_TIMEOUT_S,
                                dev)
        with _true_f32():
            rec = _ddp_run(dev, mesh.make_mesh(data=world))
        rec['device'] = str(dev)
        torch.save(rec, f'{out}.{rank}')
        mesh.destroy_process_group(dev)
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def ddp_check(dev):
    """The data-parallel step of the port on DDP_WORLD ranks against the
    one-process step over the same global batch and draws (this
    process): the flagship (K1 + K2) at batch TRAIN_B in f32 (params,
    Adam moments and EMA within DDP_TOL['f32'] relative L2) and bf16
    (each tensor by bf16_grads_held against the f32 steps), 36 K1 and 36
    K2 launches per step on each rank, MemNet's running statistics
    within DDP_TOL['stats'], a NaN in one rank's shard skipped on both;
    both ranks' params bit-equal. Also the cost of the DP layer alone
    (_ddp_world1). (record, ok)."""
    import multiprocessing as mp
    import tempfile
    import torch
    backend = 'nccl' if torch.cuda.device_count() >= DDP_WORLD else 'gloo'
    t0 = time.perf_counter()
    with _true_f32():
        one = _ddp_run(dev)
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory(prefix='ddp_check_') as tmp:
        out = os.path.join(tmp, 'rank')
        procs = [ctx.Process(target=_ddp_rank, args=(
            r, DDP_WORLD, backend, f'file://{tmp}/store', out))
            for r in range(DDP_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, t0 + DDP_TIMEOUT_S - time.perf_counter()))
        codes = []
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
            codes.append(p.exitcode)
        ranks_s = time.perf_counter() - t0
        recs = [torch.load(f'{out}.{r}', weights_only=False)
                if os.path.isfile(f'{out}.{r}') else None
                for r in range(DDP_WORLD)]
    rec = dict(world=DDP_WORLD, backend=backend,
               cards=torch.cuda.device_count(), exit_codes=codes,
               one_process_seconds=one_s, ranks_seconds=ranks_s)
    if any(c != 0 for c in codes) or any(r is None for r in recs):
        return rec, False
    with _true_f32():
        rec['world1_ms_per_step'] = _ddp_world1(dev)
    return ddp_compare(rec, one, recs)


def ddp_compare(rec, one, recs):
    """ddp_check's gates over the one-process record and the ranks'."""
    import torch
    r0, r1 = recs
    checks, ok = {}, True
    g32 = one['f32']['mu']
    live = {k: g.abs() > DDP_LIVE * g.abs().max() for k, g in g32.items()}
    for part in ('params', 'mu', 'nu', 'ema'):
        e32 = _tree_rel_l2(r0['f32'][part], one['f32'][part])
        pick = (lambda t: {k: v[live[k]] for k, v in t.items()}) \
            if part in ('params', 'ema') else (lambda t: t)
        held, rel, floored = bf16_grads_held(
            pick(r0['bf16'][part]), pick(one['bf16'][part]),
            pick(r0['f32'][part]), pick(one['f32'][part]),
            tol=DDP_TOL['bf16'])
        checks[part] = dict(f32_rel_l2=e32, bf16_max_rel_l2=max(rel.values()),
                            bf16_floored=floored, bf16_held=held)
        ok = ok and e32 <= DDP_TOL['f32'] and held
    checks['bf16_live_share'] = float(sum(m.sum() for m in live.values())
                                      / sum(m.numel() for m in live.values()))
    ranks_equal = all(torch.equal(r0[n]['params'][k], r1[n]['params'][k])
                      for n in ('f32', 'bf16', 'memnet')
                      for k in r0[n]['params'])
    loss = {n: dict(ranks=r0[n]['holder']['total'],
                    one=one[n]['holder']['total']) for n in ('f32', 'bf16')}
    loss_ok = abs(loss['f32']['ranks'] - loss['f32']['one']) <= \
        DDP_TOL['f32'] * abs(loss['f32']['one'])
    mem, mem1, rev = r0['memnet'], one['memnet'], one['memnet_reversed']

    def stats_err(a):
        return max(float((a['buffers'][k] - mem1['buffers'][k]).abs().max())
                   for k in mem1['buffers'])
    memnet = dict(buffers=len(mem1['buffers']),
                  buffers_moved=mem['buffers_moved'],
                  ok=mem['ok'] and mem1['ok'] and rev['ok'])
    memnet_ok = memnet['ok'] and mem['buffers_moved'] == len(
        mem1['buffers']) > 0
    for part, err, tol in (
            ('params', _tree_rel_l2, DDP_TOL['f32']),
            ('mu', _tree_rel_l2, DDP_TOL['f32']),
            ('stats', None, DDP_TOL['stats'])):
        if part == 'stats':
            got, spread = stats_err(mem), stats_err(rev)
        else:
            got = err(mem[part], mem1[part])
            spread = err(rev[part], mem1[part])
        memnet[part] = dict(ranks=got, reversed_order=spread,
                            bound=max(tol, 3 * spread))
        memnet_ok = memnet_ok and got <= memnet[part]['bound']
    timing = [r['timing'] for r in recs]
    launches_ok = all(
        t['launches_per_step']['fwd'] == 36
        and t['launches_per_step']['bwd'] == 36 and t['flags_sum'] == 0
        and all(t['launches'][k] == 0 for k in swin_launches(t['launches'])
                if k not in ('fwd', 'bwd'))
        and update_launched(t['launches'], t['steps'], tables=1)
        for t in timing)
    nan = [r['nan'] for r in recs]
    nan_ok = all(not n['ok'] and n['skipped'] == 1.0 and n['params_kept']
                 for n in nan)
    steps_ok = all(r[n]['ok'] for r in (r0, r1, one)
                   for n in ('f32', 'bf16'))
    rec.update(devices=[r['device'] for r in recs], checks=checks,
               loss=loss, memnet=memnet, ranks_params_equal=ranks_equal,
               nan=nan, timing=timing,
               ms_per_step=[t['ms_per_step'] for t in timing],
               allreduce_ms=[t['allreduce_ms'] for t in timing],
               allreduce_bytes=timing[0]['allreduce_bytes'],
               max_memory_allocated=[t['max_memory_allocated']
                                     for t in timing],
               tol=DDP_TOL)
    rec['gates'] = dict(state=ok, ranks_equal=ranks_equal, loss=loss_ok,
                        memnet=memnet_ok, launches=launches_ok, nan=nan_ok,
                        steps_ok=steps_ok)
    return rec, all(rec['gates'].values())


def entry_ddp_vs_x8(keep):
    """entry_ddp's final params against entry_x8's (the same run in one
    process): bit for bit on one card (a world of one: the all-reduces
    of one rank change no bit), else within DDP_TOL['bf16'] relative L2
    of their change from the seeded weights (both bf16)."""
    import torch
    from srcaco2_tpu_torch.models.registry import define_g
    a = torch.load(os.path.join(keep, 'entry_ddp.pt'), weights_only=True)
    b = torch.load(os.path.join(keep, 'entry_x8.pt'), weights_only=True)
    rec = dict(params_rel_l2=_tree_rel_l2(a, b),
               params_bit_equal=all(torch.equal(a[k], b[k]) for k in b))
    if entry_ddp_nproc() == 1:
        rec['params_ok'] = rec['params_bit_equal']
    else:
        init = define_g(flagship_args(), 'cpu', seed=0).state_dict()
        rec['change_rel_l2'] = _tree_rel_l2(
            {k: a[k] - init[k] for k in b}, {k: b[k] - init[k] for k in b})
        rec['params_ok'] = rec['change_rel_l2'] <= DDP_TOL['bf16']
    return rec


# -------------------------------------------------- diagnosis_check
# the reference SwinIR's leaf names (network_swinir.py) of the fused
# stack's stacked leaves; dense kernels are transposed to torch's (out, in)
SWIN_REF_LEAF = {
    'ln1_weight': 'norm1.weight', 'ln1_bias': 'norm1.bias',
    'rel_pos_table': 'attn.relative_position_bias_table',
    'qkv_kernel': 'attn.qkv.weight', 'qkv_bias': 'attn.qkv.bias',
    'proj_kernel': 'attn.proj.weight', 'proj_bias': 'attn.proj.bias',
    'ln2_weight': 'norm2.weight', 'ln2_bias': 'norm2.bias',
    'mlp1_kernel': 'mlp.fc1.weight', 'mlp1_bias': 'mlp.fc1.bias',
    'mlp2_kernel': 'mlp.fc2.weight', 'mlp2_bias': 'mlp.fc2.bias'}


def swinir_reference_state(state):
    """A fused-layout SwinIR state of the port ({name: tensor}) under the
    reference's names, layouts and order (network_swinir.py:710:
    conv_first, patch_embed.norm, layers.{s}.residual_group.blocks.{b}.
    <leaf>, layers.{s}.conv, norm, conv_after_body,
    conv_before_upsample.0, upsample.{2i} / upsample.0, conv_last), with
    the buffers a reference checkpoint holds beside them
    (relative_position_index, the shifted blocks' attn_mask), which the
    loader drops. CPU tensors."""
    import re
    import torch
    state = {k: v.detach().cpu() for k, v in state.items()}
    out = {}

    def top(mod, ref):
        for leaf in ('weight', 'bias'):
            if f'{mod}.{leaf}' in state:
                out[f'{ref}.{leaf}'] = state[f'{mod}.{leaf}']

    top('conv_first', 'conv_first')
    top('patch_norm', 'patch_embed.norm')
    n_stages = 1 + max(int(re.match(r'stages\.(\d+)\.', k).group(1))
                       for k in state if k.startswith('stages.'))
    for si in range(n_stages):
        pre = f'layers.{si}.residual_group.blocks'
        depth = state[f'stages.{si}.blocks.qkv_kernel'].shape[0]
        for b in range(depth):
            for leaf, ref in SWIN_REF_LEAF.items():
                v = state[f'stages.{si}.blocks.{leaf}'][b]
                out[f'{pre}.{b}.{ref}'] = v.t().contiguous() \
                    if leaf.endswith('_kernel') else v.clone()
                if leaf == 'rel_pos_table':
                    n = int(round(v.shape[0] ** 0.5))
                    out[f'{pre}.{b}.attn.relative_position_index'] = \
                        torch.zeros((n, n), dtype=torch.long)
            if b % 2:
                out[f'{pre}.{b}.attn_mask'] = torch.zeros((4, 64, 64))
        top(f'stages.{si}.convs.0', f'layers.{si}.conv')
    top('norm', 'norm')
    top('conv_after_body', 'conv_after_body')
    top('conv_before_up', 'conv_before_upsample.0')
    i = 0
    while f'upsample.convs.{i}.weight' in state:
        top(f'upsample.convs.{i}', f'upsample.{2 * i}')
        i += 1
    top('upsample.conv', 'upsample.0')
    top('conv_last', 'conv_last')
    want = sum(v.shape[0] if '.blocks.' in k else 1
               for k, v in state.items())
    if sum(v.is_floating_point() and not k.endswith('attn_mask')
           for k, v in out.items()) != want:
        raise KeyError('a SwinIR parameter has no reference name')
    return out


def nearest_flagship(model, gen, trunk=1e-2, noise=1e-3):
    """Known weights for a pixelshuffle SwinIR (the JAX package's default
    head, which the .pth loader builds): the seeded weights, with the
    trunk's branch (conv_after_body) scaled by `trunk` and the head set
    to copy channel 0 of conv_first's output, the input, through every
    upsampling step (nearest-neighbour upscaling) plus `noise` times a
    normal draw on every head weight. Its output is the nearest upscale
    of the input plus a small, seeded perturbation that runs through
    every block: a positive SSIM, where random weights can give a
    negative one, which fast_eval stops on."""
    import torch
    with torch.no_grad():
        model.conv_after_body.weight.mul_(trunk)
        model.conv_after_body.bias.mul_(trunk)
        convs = [model.conv_first, model.conv_before_up,
                 *model.upsample.convs, model.conv_last]
        for conv in convs:
            w = conv.weight
            w.copy_(noise * torch.randn(w.shape, generator=gen))
            conv.bias.zero_()
            c = w.shape[-1] // 2
            outs = range(4) if conv in model.upsample.convs else range(1)
            for o in outs:
                w[o, 0, c, c] += 1.0
    return model


# diagnosis_check's sizes: the x2 study set (HR side, train and test
# images; the dictionary is built from the train images' 3x3 patches),
# the k-NN queries also run on the CPU (all 65,536 would take ~280 s
# there: 1,024 took 3.3-4.4 s on the card's host), the dictionary rows
# per block of the card's blocked run of those queries, the exact-match
# crop, the x8 .pth set's test images
DIAG = dict(size=512, n_train=16, n_test=4, knn_cpu_queries=1024,
            knn_block_rows=100_000, crop=32, pth_n_test=8,
            wiener_balances=(1e-3, 1e-2, 1e-1, 1.0))
# the Wiener study, card against CPU (tests/test_torch_restore.py):
# float output, uint8 off-by-one share, rows relative to max(1, |CPU's|)
DIAG_TOL = {'wiener_float': 2e-5, 'wiener_u8_off_by_one': 0.01,
            'wiener_rows': 1e-4, 'pth_rows': 1e-6}


def _timed(dev, fn):
    """fn() with the host-clock ms (synchronised) and the peak memory
    the call allocated on the card (0 on the CPU)."""
    import torch
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, dict(ms=1e3 * (time.perf_counter() - t),
                     peak_bytes=torch.cuda.max_memory_allocated()
                     if cuda else 0)


def _rows(perf):
    return {sc: {m: float(v) for m, v in perf[sc].items()}
            for sc in ('full', 'roi')}


def _rows_within(got, want):
    """The largest |got - want| / max(1, |want|) over the metric rows."""
    return max(abs(got[sc][m] - want[sc][m]) / max(1.0, abs(want[sc][m]))
               for sc in want for m in want[sc])


def diagnosis_check(dev, smi, tmp, sizes=None):
    """The diagnosis studies and the reference .pth loader on `dev`:
    k-NN restoration (diagnosis/knn_patches) of one x2 test image against
    a dictionary of the train images' 3x3 patches; on an evenly spaced
    subset of its queries the CPU's neighbours (chunked_knn) equal the
    card's, in one block and in blocks of knn_block_rows dictionary rows
    (the merge across blocks), and the restored image holds there the
    atoms the CPU's neighbours draw; exact-match
    restoration with the k-NN fallback (diagnosis/patch_dict) on a crop,
    bit-equal to the CPU; the Wiener study (diagnosis/restore) at the
    four balances against the CPU; a reference-layout .pth of the x8
    flagship (known weights: nearest_flagship) evaluated through
    diagnosis/parity.eval_pretrained_pth, its rows equal to the port's
    own eval of the same weights, 36 K5 launches per forward and no
    other kernel, run under utils/profiling's trace_window, whose Chrome
    trace must hold CUDA kernel events, and the card's peak memory; then
    discovered and evaluated twice in a made-up tree (eval_pth_batch).
    Each step's ms and peak memory. Returns (record, ok); rec['gates']
    names each gate."""
    import shutil
    import numpy as np
    import torch
    from srcaco2_tpu_torch import constants, resolve_device
    from srcaco2_tpu_torch.data import folds, io as dio
    from srcaco2_tpu_torch.data.dataset import load_dataset
    from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
    from srcaco2_tpu_torch.diagnosis import (knn_patches as K, parity as PA,
                                             patch_dict as PD, restore as RS)
    from srcaco2_tpu_torch.models.registry import define_g
    from srcaco2_tpu_torch.train.evaluator import fast_eval
    from srcaco2_tpu_torch.train.steps import make_eval_forward
    from srcaco2_tpu_torch.utils import profiling as PR
    dev = resolve_device(dev)
    cfg = dict(DIAG, **(sizes or {}))
    cpu = torch.device('cpu')
    rec, gates, steps = {'sizes': cfg}, {}, {}
    t0 = time.perf_counter()

    # the x2 study set
    root2 = os.path.join(tmp, 'x2')
    names = make_synthetic_dataset(root2, scale=2, cell='CELL0',
                                   n_train=cfg['n_train'], n_val=1,
                                   n_test=cfg['n_test'], size=cfg['size'])
    img_root = os.path.join(root2, 'caco2')

    def read(ds):
        return [(dio.imread_uint(os.path.join(img_root, l), 1)[..., 0],
                 dio.imread_uint(os.path.join(img_root, h), 1)[..., 0])
                for l, h in folds.get_pairs(root2, ds)[0]]
    train, test = read(names[0]), read(names[2])
    (dictionary, ), steps['build_dict'] = _timed(cpu, lambda: (
        K.build_dict([K.extract_pairs(l, h, 3) for l, h in train], 3),))
    li, hi = test[0]
    rec['knn'] = dict(dict_rows=int(len(dictionary['atoms_l'])),
                      queries=int(li.size),
                      max_atoms=int(dictionary['n'].max()))
    print(f"diagnosis_check: dictionary M = {rec['knn']['dict_rows']}",
          flush=True)

    # k-NN: the restoration; on a query subset the card's neighbours in
    # one block and in blocks of knn_block_rows rows against the CPU's
    # (blocks of 1 GiB there), and the image's atoms at those pixels
    # against the ones the CPU's neighbours draw (knn_draws, seed 0)
    img, steps['knn_restore'] = _timed(dev, lambda: K.knn_restore(
        li, dictionary, k=1, seed=0, device=dev))
    q, _ = K.extract_pairs(li, np.zeros((2 * li.shape[0], 2 * li.shape[1]),
                                        li.dtype), 3)
    sub = np.linspace(0, len(q) - 1, cfg['knn_cpu_queries']).astype(int)
    ring = K.ring_weights(3).reshape(-1)
    nbr_cpu, steps['knn_cpu_subset'] = _timed(cpu, lambda: K.chunked_knn(
        q[sub], dictionary['atoms_l'], ring, device=cpu))
    nbr_one, steps['knn_card_subset'] = _timed(dev, lambda: K.chunked_knn(
        q[sub], dictionary['atoms_l'], ring, device=dev))
    nbr_blk, steps['knn_card_subset_blocks'] = _timed(
        dev, lambda: K.chunked_knn(q[sub], dictionary['atoms_l'], ring,
                                   device=dev, rows=cfg['knn_block_rows']))
    _, u = K.knn_draws(len(q), 1, 0)
    ent = nbr_cpu[:, 0]
    probs = torch.as_tensor(dictionary['probs'])[ent]
    a_i = torch.clamp((u[sub] > probs.double().cumsum(1)).sum(1),
                      max=probs.shape[1] - 1)
    want_atoms = np.clip(dictionary['atoms_h'][ent.numpy(), a_i.numpy()],
                         0, 255).astype(np.uint8)
    ys, xs = np.divmod(sub, li.shape[1])
    got_atoms = np.stack([img[2 * y:2 * y + 2, 2 * x:2 * x + 2].reshape(-1)
                          for y, x in zip(ys, xs)])
    n_blocks = -(-rec['knn']['dict_rows'] // cfg['knn_block_rows'])
    rec['knn'].update(
        cpu_queries=len(sub), card_blocks=n_blocks,
        indices_equal_cpu=bool(torch.equal(nbr_one.cpu(), nbr_cpu)),
        blocked_indices_equal_cpu=bool(torch.equal(nbr_blk.cpu(), nbr_cpu)),
        image_atoms_equal_cpu=bool(np.array_equal(got_atoms, want_atoms)),
        output_shape=list(img.shape),
        psnr_db=numpy_psnr(img[None], hi[None], 2))
    gates['knn_indices_equal_cpu'] = (
        rec['knn']['indices_equal_cpu']
        and rec['knn']['blocked_indices_equal_cpu'] and n_blocks > 1
        and rec['knn']['image_atoms_equal_cpu'] and img.shape == hi.shape)

    # exact match with the k-NN fallback, card against CPU on a central
    # crop (hits and misses)
    c, y0, x0 = cfg['crop'], li.shape[0] // 2, li.shape[1] // 2
    crop = np.ascontiguousarray(li[y0 - c // 2:y0 + c // 2,
                                   x0 - c // 2:x0 + c // 2])
    (got, cov), steps['exact_match_crop'] = _timed(
        dev, lambda: PD.exact_match_restore(crop, dictionary, seed=0,
                                            device=dev))
    want, cov_cpu = PD.exact_match_restore(crop, dictionary, seed=0,
                                           device=cpu)
    rec['exact_match'] = dict(crop=c, coverage=cov,
                              equal_cpu=bool(np.array_equal(got, want)))
    gates['exact_match_equal_cpu'] = rec['exact_match']['equal_cpu'] and \
        cov == cov_cpu < 1.0

    # the Wiener study, card against CPU
    bal = cfg['wiener_balances']
    study, steps['wiener_study'] = _timed(dev, lambda: RS.wiener_study(
        root2, root2, 2, 'CELL0', balances=bal, device=dev))
    study_cpu = RS.wiener_study(root2, root2, 2, 'CELL0', balances=bal,
                                device=cpu)
    up = torch.from_numpy(li.astype(np.float32) / 255.0)[None, None]
    w_dev = RS.wiener_filter(up.to(dev), RS.box_psf(5), bal[0]).cpu()
    w_cpu = RS.wiener_filter(up, RS.box_psf(5), bal[0])

    def u8(x):
        return torch.round(torch.clip(x, 0, 1) * 255.0)
    du8 = (u8(w_dev) - u8(w_cpu)).abs()
    rec['wiener'] = dict(
        rows={str(k): _rows(v) for k, v in study.items()},
        rows_rel_err=max(_rows_within(_rows(study[k]), _rows(study_cpu[k]))
                         for k in study),
        float_max_abs_err=float((w_dev - w_cpu).abs().max()),
        u8_off_by_one_share=float((du8 == 1).float().mean()),
        u8_max_diff=float(du8.max()), tol={
            k: v for k, v in DIAG_TOL.items() if k.startswith('wiener')})
    gates['wiener_within_tol'] = (
        rec['wiener']['rows_rel_err'] <= DIAG_TOL['wiener_rows']
        and rec['wiener']['float_max_abs_err'] <= DIAG_TOL['wiener_float']
        and rec['wiener']['u8_max_diff'] <= 1
        and rec['wiener']['u8_off_by_one_share']
        <= DIAG_TOL['wiener_u8_off_by_one'])

    # the reference .pth of the x8 flagship
    root8 = os.path.join(tmp, 'x8')
    make_synthetic_dataset(root8, scale=8, cell='CELL0', n_train=1, n_val=1,
                           n_test=cfg['pth_n_test'], size=cfg['size'])
    args = PA.pth_eval_args('SwinIR', 8, root8, root8, dev)
    model = nearest_flagship(define_g(args, dev, seed=0),
                             torch.Generator().manual_seed(1))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    pth = os.path.join(tmp, 'G-model.pth')
    torch.save(swinir_reference_state(state), pth)
    # traced (utils/profiling)
    reset_launches()
    (perf, prof), steps['eval_pretrained_pth_traced'] = _timed(
        dev, lambda: _traced(
            PR, os.path.join(tmp, 'trace'), lambda: PA.eval_pretrained_pth(
                pth, 'SwinIR', 8, 'CELL0', root8, root8, device=dev)))
    launches = read_launches()
    events = json.load(open(prof.trace_file))['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)
    # the port's own eval of the same weights
    ds = load_dataset(args, constants.caco2_name(
        constants.TESTSET, 8, 'CELL0'), constants.EVAL_PHASE)
    fwd = make_eval_forward(model, 'SwinIR', 8, netG=args['netG'])
    own = fast_eval(fwd, None, ds, args, 8, constants.TESTSET)
    forwards = -(-cfg['pth_n_test'] // 8)
    blocks = sum(args['netG']['swinir_depths'])
    # two checkpoints in a made-up shared-trained-models tree
    tree = os.path.join(tmp, 'shared-trained-models')
    for i in range(2):
        d = os.path.join(tree, 'super-resolution', 'SwinIR',
                         'caco2_train_X_8_in_64_out_512_cell_CELL0',
                         f'id_{i}-tsk_super-resolution-x_8-netG_SwinIR'
                         '-sd_0', 'best-models')
        os.makedirs(d)
        shutil.copy(pth, os.path.join(d, 'G-model.pth'))
    found = PA.discover_pth_checkpoints(tree)
    results = {}
    batch, steps['eval_pth_batch'] = _timed(dev, lambda: PA.eval_pth_batch(
        tree, root8, root8, results, device=dev))
    batch_rows = results.get(8, {}).get('methods', {}).get(
        'SwinIR (ported .pth)', {}).get('CELL0')
    rec['pth'] = dict(
        model='SwinIR x8 pixelshuffle C=180 6x6 heads 6 ws 8 f32 (the '
        "loader's default config), nearest_flagship weights",
        n_test=cfg['pth_n_test'], rows=_rows(perf), own_eval_rows=_rows(own),
        rows_rel_err=_rows_within(_rows(perf), _rows(own)),
        launches=launches, forwards=forwards, blocks=blocks,
        discovered=len(found), batch_ok=batch['n_ok'],
        batch_failures=batch['failures'],
        batch_rows_rel_err=_rows_within(_rows(batch_rows), _rows(own))
        if batch_rows else None)
    rec['profiling'] = dict(
        trace_bytes=os.path.getsize(prof.trace_file),
        cuda_kernel_events=len(kernels),
        k5_events=sum('swin_block' in e.get('name', '') for e in kernels),
        peak_allocated_bytes=peak)
    gates['pth_rows_equal_eval'] = (
        rec['pth']['rows_rel_err'] <= DIAG_TOL['pth_rows']
        and perf['full'][constants.PSNR_MTR] > 0)
    gates['k5_launches'] = (
        launches['grouped'] == blocks * forwards
        and all(v == 0 for k, v in launches.items() if k != 'grouped'))
    gates['pth_batch'] = (len(found) == 2 and batch['n_ok'] == 2
                          and not batch['failures']
                          and rec['pth']['batch_rows_rel_err'] is not None
                          and rec['pth']['batch_rows_rel_err']
                          <= DIAG_TOL['pth_rows'])
    gates['trace_has_cuda_kernels'] = (dev.type != 'cuda'
                                       or len(kernels) > 0)
    gates['peak_memory'] = dev.type != 'cuda' or peak > 0
    rec.update(steps=steps, gates=gates,
               phase_seconds=time.perf_counter() - t0, nvidia_smi=smi)
    return rec, all(gates.values())


def _traced(PR, logdir, fn):
    with PR.trace_window(logdir) as prof:
        out = fn()
    return out, prof


def flagship_args():
    from srcaco2_tpu_torch.config.net_defaults import init_net_g
    args = {'scale': SCALE, 'n_channels': 1, 'h_size': H_SIZE, 'amp': True}
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
    emit('build', seconds=build_s, built=sorted(logs),
         kernels=ptxas_kernels(logs), smem_bytes=smem_bytes(build))

    gen = torch.Generator().manual_seed(0)
    x, params, groups, gid = block_inputs(dev, gen)
    errs = {}
    for name, dt in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        xd = x.to(dt)
        out_k = sb.fused_swin_block_grouped(xd, params, groups, gid,
                                            heads=HEADS, compute_dtype=dt)
        same = bit_identical(out_k, sb.fused_swin_block_grouped(
            xd, params, groups, gid, heads=HEADS, compute_dtype=dt))
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
                              torch.isfinite(out_k.float()).all()),
                          fwd_bit_identical_twice=same, **tol)
    rec = emit('kernel_check', kernel='swin_block_grouped',
               shape=list(x.shape), heads=HEADS, groups=groups.shape[0],
               **errs)
    if any(e['n_outside'] or not e['finite']
           or not e['fwd_bit_identical_twice'] for e in errs.values()):
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

    train_checks, ok = kernel_check_train(dev, gen)
    emit('kernel_check_train', checks=train_checks, nvidia_smi=smi)
    if not ok:
        print('chip_smoke: kernel_check_train failed', file=sys.stderr)
        return 1
    train_times = emit('kernel_time_train', **kernel_time_train(dev, gen),
                       library_ms=None, nvidia_smi=smi)
    pair_checks, ok = kernel_check_pair(dev, gen)
    emit('kernel_check_pair', checks=pair_checks, nvidia_smi=smi)
    if not ok:
        print('chip_smoke: kernel_check_pair failed', file=sys.stderr)
        return 1
    pair_times = emit('kernel_time_pair', **kernel_time_pair(dev, gen),
                      library_ms=None, nvidia_smi=smi)
    wmsa_checks, ok = kernel_check_wmsa(dev, gen)
    emit('kernel_check_wmsa', checks=wmsa_checks, nvidia_smi=smi)
    if not ok:
        print('chip_smoke: kernel_check_wmsa failed', file=sys.stderr)
        return 1
    wmsa_times = emit('kernel_time_wmsa', **kernel_time_wmsa(dev, gen),
                      nvidia_smi=smi)

    args = flagship_args()
    state = define_g(args, dev, seed=0).state_dict()
    srv = SRServer(args=args, state_dict=state, batch_size=BATCH,
                   lr_hw=(LR, LR), device=dev)
    rng = np.random.default_rng(0)
    req_a = rng.integers(0, 256, (11, 1, LR, LR), dtype=np.uint8)
    req_b = rng.integers(0, 256, (BATCH, 1, LR, LR), dtype=np.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out_a = srv(req_a)          # 2 forwards: 8, then 3 padded to 8
    out_b = srv(req_b)
    out_c = srv(req_b)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = read_launches()
    launches = serve_launches['grouped']
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
        launches_all=serve_launches,
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
            and serve_launches['wmsa'] == 0 and close):
        print('chip_smoke: serve failed', file=sys.stderr)
        return 1
    x_b = torch.from_numpy(req_b).to(dev)
    prof = emit('serve_profile', **profile_device(
        lambda: srv._serve(x_b), serve['ms_per_batch']), nvidia_smi=smi)
    del srv, x_b

    ev, ok, (eval_fwd, eval_batch) = eval_unfused(dev, smi)
    ev = emit('eval_unfused', **ev)
    if not ok:
        print('chip_smoke: eval_unfused failed', file=sys.stderr)
        return 1
    ev_prof = emit('eval_unfused_profile', **profile_device(
        lambda: eval_fwd(None, eval_batch), ev['ms_per_batch']),
        nvidia_smi=smi)
    del eval_fwd, eval_batch

    # the paths are compared from the seeded initial weights, then the
    # same state trains
    ctx = train_setup(dev)
    block_stacks(ctx['model'], pair=False)
    compare, ok = compare_paths(dev, ctx)
    compare = emit('train_compare', **compare, nvidia_smi=smi)
    if not ok:
        print('chip_smoke: train_compare failed', file=sys.stderr)
        return 1
    compare_pair, ok = compare_paths(dev, ctx, pair=True)
    compare_pair = emit('train_compare_pair', **compare_pair, nvidia_smi=smi)
    if not ok:
        print('chip_smoke: train_compare_pair failed', file=sys.stderr)
        return 1
    train, ok = train_phase(ctx, smi)
    train = emit('train', **train)
    if not ok:
        print('chip_smoke: train failed', file=sys.stderr)
        return 1
    upd, ok = update_pass_check(ctx, smi)
    emit('update_pass', **upd)
    if not ok:
        print('chip_smoke: update_pass failed', file=sys.stderr)
        return 1
    step, state = ctx['step'], ctx['state']
    inputs = step_inputs(ctx['gen'], ctx['cfg'], TRAIN_B)
    train_prof = emit('train_profile', **profile_device(
        lambda: step(state, ctx['hr'], ctx['lr'], *inputs),
        train['ms_per_step']), nvidia_smi=smi)

    # the same model and state go on training with every stack's blocks
    # run as pairs
    train_pair, ok = train_phase(ctx, smi, pair=True)
    train_pair = emit('train_pair', **train_pair)
    if not ok:
        print('chip_smoke: train_pair failed', file=sys.stderr)
        return 1
    state = ctx['state']
    pair_prof = emit('train_pair_profile', **profile_device(
        lambda: step(state, ctx['hr'], ctx['lr'], *inputs),
        train_pair['ms_per_step']), nvidia_smi=smi)

    del ctx, step, state, inputs
    torch.cuda.empty_cache()
    windowed, ok = windowed_check(dev)
    windowed = emit('windowed_check', **windowed, nvidia_smi=smi)
    if not ok:
        print('chip_smoke: windowed_check failed', file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    wprof, ok = windowed_profile(dev, smi)
    wprof = emit('windowed_profile', **wprof)
    if not ok:
        print('chip_smoke: windowed_profile failed', file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    opts, ok = options_check(dev, smi)
    opts = emit('options_check', **opts,
                phase_seconds=time.perf_counter() - t0)
    if not ok:
        print('chip_smoke: options_check failed', file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ddp, ok = ddp_check(dev)
    ddp = emit('ddp_check', **ddp, phase_seconds=time.perf_counter() - t0,
               nvidia_smi=smi)
    if not ok:
        print('chip_smoke: ddp_check failed', file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    native, ok = native_check(dev)
    native = emit('native_check', **native, nvidia_smi=smi,
                  phase_seconds=time.perf_counter() - t0)
    if not ok:
        print('chip_smoke: native_check failed', file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    recon, ok = reconstruct_profile(dev, smi)
    recon = emit('reconstruct_profile', **recon,
                 phase_seconds=time.perf_counter() - t0)
    if not ok:
        print('chip_smoke: reconstruct_profile failed', file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    import tempfile
    with tempfile.TemporaryDirectory(prefix='diagnosis_') as tmp:
        diag, ok = diagnosis_check(dev, smi, tmp)
    diag = emit('diagnosis_check', **diag)
    if not ok:
        print('chip_smoke: diagnosis_check failed', file=sys.stderr)
        return 1
    torch.cuda.empty_cache()
    # the entry runs are processes of their own, each far from the
    # card's memory (5.6 GB reserved at x8, 17.7 at x2, on an NVIDIA H100
    # 80GB HBM3 at 700 W), so they run at the same time
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    keep = tempfile.mkdtemp(prefix='entry_params_')
    try:
        with ThreadPoolExecutor(len(ENTRY)) as pool:
            runs = {name: pool.submit(entry_phase, name, out_dir, keep)
                    for name in ENTRY}
            runs = {name: f.result() for name, f in runs.items()}
        if all(ok for _, ok in runs.values()):
            runs['entry_ddp'][0].update(entry_ddp_vs_x8(keep))
            runs['entry_ddp'] = (runs['entry_ddp'][0],
                                 runs['entry_ddp'][0]['params_ok'])
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    entries = {}
    for name, (erec, ok) in runs.items():
        entries[name] = emit(name, **erec, nvidia_smi=smi)
        if not ok:
            print(f'chip_smoke: {name} failed', file=sys.stderr)
            return 1

    # the zoo: no kernel of K1-K6 on its paths (cuDNN, cuFFT, cuBLAS)
    zoo = {}
    for name, fn in (('zoo_check', lambda: zoo_check(dev)),
                     ('zoo_train', lambda: zoo_train(dev, smi)),
                     ('entry_zoo', lambda: entry_zoo(dev, out_dir))):
        t0 = time.perf_counter()
        zrec, ok = fn()
        zrec['phase_seconds'] = time.perf_counter() - t0
        zoo[name] = zrec
        if out_dir:
            with open(os.path.join(out_dir, f'{name}.json'), 'w') as f:
                json.dump(zrec, f, indent=1)
        # the line holds each check's verdict and worst value; the
        # floored grads' details are in the record (--out-dir)
        emit(name, **(_zoo_summary(zrec) if name == 'zoo_check' else zrec),
             nvidia_smi=smi)
        torch.cuda.empty_cache()
        if not ok:
            print(f'chip_smoke: {name} failed', file=sys.stderr)
            return 1

    tpu = 'srcaco2_tpu/ops/pallas/swin_block.py'
    src = 'srcaco2_tpu_torch/ops/csrc'
    bf16_checks = [c for c in train_checks if c['dtype'] == 'bf16']
    kernels = [{
        'name': 'swin_block_grouped', 'route': 'cuda',
        'source': f'{src}/swin_block_grouped.cu',
        'replaces': f'{tpu}:1039',
        'launches': launches, 'max_abs_err': errs['bf16']['max_abs_err'],
        'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by,
        # no single PyTorch call computes a whole Swin block
        'library_ms': None}]
    for name, key, line, err in (('swin_block_fwd', 'fwd', 423, 'out'),
                                 ('swin_block_bwd', 'bwd', 443, 'dx')):
        t = train_times[key]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': f'{src}/{name}.cu',
            'replaces': f'{tpu}:{line}',
            'launches': train['launches'][key],
            'max_abs_err': max(c['errs'][err]['max_abs']
                               for c in bf16_checks),
            'ms': t['ms'], 'plain_ms': t['plain_ms'],
            'bound_ms': t['bound_ms'], 'bound_by': t['bound_by'],
            # no single PyTorch call computes a whole Swin block or its
            # backward
            'library_ms': None})
    bf16_pair = next(c for c in pair_checks if c['dtype'] == 'bf16')
    for name, key, line, err in (('swin_block_pair_fwd', 'fwd', 631, 'out'),
                                 ('swin_block_pair_bwd', 'bwd', 647, 'dx')):
        t = pair_times[key]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': f'{src}/{name}.cu',
            'replaces': f'{tpu}:{line}',
            'launches': train_pair['launches'][f'pair_{key}'],
            'max_abs_err': bf16_pair['errs'][err]['max_abs'],
            'ms': t['ms'], 'plain_ms': t['plain_ms'],
            'bound_ms': t['bound_ms'], 'bound_by': t['bound_by'],
            # no single PyTorch call computes a block pair or its backward
            'library_ms': None})
    bf16_wmsa = [c for c in wmsa_checks if c.get('dtype') == 'bf16'
                 and c['case'].startswith('eval') and c['picked']]
    kernels.append({
        'name': 'window_attention', 'route': 'cuda',
        'source': f'{src}/window_attention.cu',
        'replaces': 'srcaco2_tpu/ops/pallas/window_attention.py:21',
        'launches': ev['launches']['wmsa'],
        'max_abs_err': max(c['max_abs_err'] for c in bf16_wmsa),
        'ms': wmsa_times['ms'], 'plain_ms': wmsa_times['plain_ms'],
        'bound_ms': wmsa_times['bound_ms'],
        'bound_by': wmsa_times['bound_by'],
        'library_ms': wmsa_times['library_ms']})
    emit('kernels', kernels=[
        {'name': 'swin_block_grouped', 'tpu': f'{tpu}:_fwd_kernel_grouped',
         'check_passed': True},
        {'name': 'swin_block_fwd', 'tpu': f'{tpu}:_fwd_kernel',
         'check_passed': True},
        {'name': 'swin_block_bwd', 'tpu': f'{tpu}:_bwd_kernel',
         'check_passed': True},
        {'name': 'swin_block_pair_fwd', 'tpu': f'{tpu}:_fwd_kernel_pair',
         'check_passed': True},
        {'name': 'swin_block_pair_bwd', 'tpu': f'{tpu}:_bwd_kernel_pair',
         'check_passed': True},
        {'name': 'window_attention',
         'tpu': 'srcaco2_tpu/ops/pallas/window_attention.py:_wmsa_kernel',
         'check_passed': True}])
    if out_dir:
        with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as f:
            json.dump({'kernel_check': rec, 'serve': serve,
                       'serve_profile': prof,
                       'kernel_check_train': train_checks,
                       'kernel_time_train': train_times, 'train': train,
                       'train_compare': compare, 'train_profile': train_prof,
                       'kernel_check_pair': pair_checks,
                       'kernel_time_pair': pair_times,
                       'train_compare_pair': compare_pair,
                       'train_pair': train_pair,
                       'train_pair_profile': pair_prof,
                       'kernel_check_wmsa': wmsa_checks,
                       'kernel_time_wmsa': wmsa_times,
                       'eval_unfused': ev, 'eval_unfused_profile': ev_prof,
                       'windowed_check': windowed,
                       'windowed_profile': wprof, 'options_check': opts,
                       'ddp_check': ddp, 'native_check': native,
                       'reconstruct_profile': recon,
                       'diagnosis_check': diag,
                       **entries, **zoo,
                       'kernels': kernels}, f, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
