"""Serving: a uint8 -> uint8 super-resolution endpoint (port of
srcaco2_tpu/inference/serve.py:SRServer).

Fixed batch size and LR shape, uint8 in and out at the device boundary,
optional test modes (train/test_modes.py), and a tail batch padded by
repeating its last image so one shape serves any request size. PyTorch
runs eagerly, so where the JAX server compiled ahead of time this one
builds its kernels and runs one warm-up batch (`setup_seconds`). A
pre-upsampling net (SRCNN; CSR-CNN but its pyramid variant: the rule of
train/steps.py:pre_upsampled) gets the bicubic pre-upscale of the LR
batch, rounded to the uint8 grid as the data pipeline rounds it.
"""
import time
from typing import Optional, Tuple

import numpy as np
import torch

from srcaco2_tpu_torch import exact_f32, resolve_device
from srcaco2_tpu_torch.ops.resize import resize2d
from srcaco2_tpu_torch.train import test_modes as TM
from srcaco2_tpu_torch.train.steps import model_outputs, pre_upsampled
from srcaco2_tpu_torch.utils.profiling import count, span


class SRServer:
    """Super-resolution endpoint for one experiment: either a trained
    exp dir (config_model.yml + best-models/G-model.pt) or a resolved
    config `args` with a `state_dict`."""

    def __init__(self, exp_path: Optional[str] = None, *,
                 args: Optional[dict] = None,
                 state_dict: Optional[dict] = None, batch_size: int = 8,
                 lr_hw: Optional[Tuple[int, int]] = None,
                 test_mode: int = 0, device=None):
        self.device = resolve_device(device)
        if exp_path is not None:
            from srcaco2_tpu_torch.inference.super_res import load_exp
            self.model, self.args = load_exp(exp_path, self.device)
        elif args is not None and state_dict is not None:
            from srcaco2_tpu_torch.models.registry import define_g
            self.args = args
            self.model = define_g(args, self.device)
            self.model.load_state_dict(state_dict)
        else:
            raise ValueError('pass exp_path, or args and state_dict')
        self.scale = int(self.args['scale'])
        self.batch_size = batch_size
        self.test_mode = test_mode
        if lr_hw is None:
            s = 512 // self.scale
            lr_hw = (s, s)
        self.lr_hw = tuple(lr_hw)
        self.in_shape = (self.args['n_channels'], *self.lr_hw)
        netG = self.args['netG']
        self.pre_upsampled = pre_upsampled(netG['net_type'], netG)
        if self.model.dtype == torch.float32:
            exact_f32(self.device)
        t0 = time.perf_counter()
        self._serve(torch.zeros((batch_size, *self.in_shape),
                                dtype=torch.uint8, device=self.device))
        self._sync()
        self.setup_seconds = time.perf_counter() - t0

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _raw_fwd(self, l_im: torch.Tensor) -> torch.Tensor:
        x = l_im
        if self.pre_upsampled:
            h, w = l_im.shape[-2:]
            x = resize2d(l_im, (h * self.scale, w * self.scale))
            x = torch.round(torch.clip(x, 0, 1) * 255.0) / 255.0
        return model_outputs(self.model(x))['out']

    @torch.inference_mode()
    def _serve(self, lr_u8: torch.Tensor) -> torch.Tensor:
        l_im = lr_u8.float() / 255.0
        out = TM.test_mode(self._raw_fwd, l_im, mode=self.test_mode,
                           sf=self.scale)
        return torch.clip(torch.round(torch.clip(out, 0, 1) * 255.0),
                          0, 255).to(torch.uint8)

    def __call__(self, lr_u8: np.ndarray) -> np.ndarray:
        """lr_u8: (N, C, h, w) uint8, any N: batched at the server's
        batch size, the tail padded internally.

        While a profiler records, the call is the span `serve.request`,
        each batch's enqueue `serve.forward` and its blocking copy to the
        host `serve.fetch` (utils/profiling); the counters
        `serve.images` and `serve.slots` add each batch's images and its
        slots, padding included."""
        with span('serve.request'):
            if lr_u8.dtype != np.uint8 or lr_u8.shape[1:] != self.in_shape:
                raise ValueError(f'expected (N, *{self.in_shape}) uint8, '
                                 f'got {lr_u8.shape} {lr_u8.dtype}')
            bs = self.batch_size
            outs = []
            for i in range(0, lr_u8.shape[0], bs):
                chunk = lr_u8[i:i + bs]
                pad = bs - chunk.shape[0]
                count('serve.images', bs - pad)
                count('serve.slots', bs)
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], pad, 0)], 0)
                x = torch.from_numpy(chunk).to(self.device)
                with span('serve.forward'):
                    out = self._serve(x)
                with span('serve.fetch'):
                    out = out.cpu().numpy()
                    outs.append(out[:bs - pad] if pad else out)
            return np.concatenate(outs, 0)

    def throughput(self, iters: int = 10) -> float:
        """Measured images/s at the server's batch size (device-resident
        input, synchronised)."""
        x = torch.zeros((self.batch_size, *self.in_shape),
                        dtype=torch.uint8, device=self.device)
        self._serve(x)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            self._serve(x)
        self._sync()
        return self.batch_size * iters / (time.perf_counter() - t0)
