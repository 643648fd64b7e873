"""Network factory (port of srcaco2_tpu/models/registry.py:define_g).
Only SwinIR is ported; every other net raises NotImplementedError."""
import torch
import torch.nn as nn

from srcaco2_tpu_torch import constants, resolve_device
from srcaco2_tpu_torch.config.net_defaults import safe_str_var


def _p(netG: dict, nt: str, key: str):
    return netG[f'{safe_str_var(nt)}_{key}']


def define_g(args: dict, device=None, seed: int = 0) -> nn.Module:
    """Build the generator from the resolved config on `device` (default
    cuda), with f32 parameters drawn from a torch.Generator seeded with
    `seed`; compute in bf16 when args['amp'] is set. SwinIR's block
    layout follows `swinir_use_fused_blocks` (default False, as in JAX);
    the unfused layout gets the plain attention core
    (use_pallas_attn=False), as JAX's define_g builds it."""
    netG = args['netG']
    nt = netG['net_type']
    dtype = torch.bfloat16 if args.get('amp', False) else torch.float32
    if nt != constants.SWINIR:
        raise NotImplementedError(
            f'{nt}: only SwinIR is ported so far (see ROADMAP.md)')
    from srcaco2_tpu_torch.models.swinir import SwinIR
    model = SwinIR(in_chans=_p(netG, nt, 'in_chans'),
                   upscale=_p(netG, nt, 'upscale'),
                   img_range=_p(netG, nt, 'img_range'),
                   window_size=_p(netG, nt, 'window_size'),
                   embed_dim=_p(netG, nt, 'embed_dim'),
                   depths=tuple(_p(netG, nt, 'depths')),
                   num_heads=tuple(_p(netG, nt, 'num_heads')),
                   mlp_ratio=float(_p(netG, nt, 'mlp_ratio')),
                   upsampler=_p(netG, nt, 'upsampler'),
                   resi_connection=_p(netG, nt, 'resi_connection'),
                   fused_blocks=bool(netG.get(
                       f'{safe_str_var(nt)}_use_fused_blocks', False)),
                   dtype=dtype, device=resolve_device(device))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
