"""Network factory (port of srcaco2_tpu/models/registry.py:define_g) for
every net of the zoo (config/net_defaults.py:PORTED_NETS); another name
raises NotImplementedError."""
import torch
import torch.nn as nn

from srcaco2_tpu_torch import constants, resolve_device
from srcaco2_tpu_torch.config.net_defaults import PORTED_NETS, safe_str_var


def _p(netG: dict, nt: str, key: str):
    return netG[f'{safe_str_var(nt)}_{key}']


def _swinir(netG, nt, kw):
    from srcaco2_tpu_torch.models.swinir import SwinIR
    return SwinIR(in_chans=_p(netG, nt, 'in_chans'),
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
                      f'{safe_str_var(nt)}_use_fused_blocks', False)), **kw)


def _srcnn(netG, nt, kw):
    from srcaco2_tpu_torch.models.cnn_pre import SRCNN
    return SRCNN(in_chans=_p(netG, nt, 'in_chans'), **kw)


def _vdsr(netG, nt, kw):
    from srcaco2_tpu_torch.models.cnn_pre import VDSR
    return VDSR(in_chans=_p(netG, nt, 'in_chans'),
                upscale=_p(netG, nt, 'upscale'), **kw)


def _dfcan(netG, nt, kw):
    from srcaco2_tpu_torch.models.dfcan import DFCAN
    return DFCAN(in_chans=_p(netG, nt, 'in_chans'),
                 upscale=_p(netG, nt, 'upscale'), **kw)


def _enlcn(netG, nt, kw):
    from srcaco2_tpu_torch.models.enlcn import ENLCN
    return ENLCN(in_chans=_p(netG, nt, 'in_chans'),
                 upscale=_p(netG, nt, 'upscale'),
                 n_resblocks=_p(netG, nt, 'n_resblock'),
                 n_feats=_p(netG, nt, 'n_feats'),
                 res_scale=_p(netG, nt, 'res_scale'), **kw)


def _omnisr(netG, nt, kw):
    from srcaco2_tpu_torch.models.omnisr import OmniSR
    return OmniSR(in_chans=_p(netG, nt, 'in_chans'),
                  upscale=_p(netG, nt, 'upscale'),
                  num_feat=_p(netG, nt, 'num_feat'),
                  res_num=_p(netG, nt, 'res_num'),
                  block_num=_p(netG, nt, 'block_num'),
                  window_size=_p(netG, nt, 'window_size'),
                  pe=_p(netG, nt, 'pe'), bias=_p(netG, nt, 'bias'),
                  ffn_bias=_p(netG, nt, 'ffn_bias'), **kw)


def _srfbn(netG, nt, kw):
    from srcaco2_tpu_torch.models.srfbn import SRFBN
    return SRFBN(in_chans=_p(netG, nt, 'in_chans'),
                 upscale=_p(netG, nt, 'upscale'),
                 num_features=_p(netG, nt, 'num_features'),
                 num_steps=_p(netG, nt, 'num_steps'),
                 num_groups=_p(netG, nt, 'num_groups'),
                 remat_steps=bool(netG.get('srfbn_remat_steps', False)),
                 **kw)


def _mslapsr(netG, nt, kw):
    from srcaco2_tpu_torch.models.mslapsr import MSLapSRN
    return MSLapSRN(in_chans=_p(netG, nt, 'in_chans'),
                    upscale=_p(netG, nt, 'upscale'), **kw)


def _act(netG, nt, kw):
    from srcaco2_tpu_torch.models.act import ACT
    return ACT(in_chans=_p(netG, nt, 'in_chans'),
               upscale=_p(netG, nt, 'upscale'),
               n_feats=_p(netG, nt, 'n_feats'),
               n_resgroups=_p(netG, nt, 'n_resgroups'),
               n_resblocks=_p(netG, nt, 'n_resblocks'),
               reduction=_p(netG, nt, 'reduction'),
               n_heads=_p(netG, nt, 'n_heads'),
               n_layers=_p(netG, nt, 'n_layers'),
               n_fusionblocks=_p(netG, nt, 'n_fusionblocks'),
               token_size=_p(netG, nt, 'token_size'),
               expansion_ratio=_p(netG, nt, 'expansion_ratio'), **kw)


def _nlsn(netG, nt, kw):
    from srcaco2_tpu_torch.models.nlsn import NLSN
    return NLSN(in_chans=_p(netG, nt, 'in_chans'),
                upscale=_p(netG, nt, 'upscale'),
                n_resblocks=_p(netG, nt, 'n_resblocks'),
                n_feats=_p(netG, nt, 'n_feats'),
                n_hashes=_p(netG, nt, 'n_hashes'),
                chunk_size=_p(netG, nt, 'chunk_size'),
                res_scale=_p(netG, nt, 'res_scale'), **kw)


def _grl(netG, nt, kw):
    from srcaco2_tpu_torch.models.grl import GRL
    return GRL(in_chans=_p(netG, nt, 'in_chans'),
               upscale=_p(netG, nt, 'upscale'),
               window_size=_p(netG, nt, 'window_size'),
               embed_dim=_p(netG, nt, 'embed_dim'),
               depths=tuple(_p(netG, nt, 'depths')),
               num_heads_window=tuple(_p(netG, nt, 'num_heads_window')),
               num_heads_stripe=tuple(_p(netG, nt, 'num_heads_stripe')),
               mlp_ratio=float(_p(netG, nt, 'mlp_ratio')),
               anchor_window_down_factor=_p(netG, nt,
                                            'anchor_window_down_factor'),
               local_connection=_p(netG, nt, 'local_connection'),
               upsampler=_p(netG, nt, 'upsampler'), **kw)


def _drrn(netG, nt, kw):
    from srcaco2_tpu_torch.models.cnn_pre import DRRN
    return DRRN(in_chans=_p(netG, nt, 'in_chans'),
                upscale=_p(netG, nt, 'upscale'),
                num_residual_units=_p(netG, nt, 'num_residual_units'), **kw)


def _memnet(netG, nt, kw):
    from srcaco2_tpu_torch.models.cnn_pre import MemNet
    return MemNet(in_chans=_p(netG, nt, 'in_chans'),
                  upscale=_p(netG, nt, 'upscale'),
                  num_memory_blocks=_p(netG, nt, 'num_memory_blocks'),
                  num_residual_blocks=_p(netG, nt, 'num_residual_blocks'),
                  remat_passes=bool(netG.get('memnet_remat_passes', True)),
                  **kw)


def _dbpn(netG, nt, kw):
    from srcaco2_tpu_torch.models.dbpn import DBPN
    return DBPN(in_chans=_p(netG, nt, 'in_chans'),
                upscale=_p(netG, nt, 'upscale'),
                base_filter=_p(netG, nt, 'base_filter'),
                feat=_p(netG, nt, 'feat'),
                num_stages=_p(netG, nt, 'num_stages'),
                remat_blocks=bool(netG.get('dbpn_remat_blocks', True)), **kw)


def _prosr(netG, nt, kw):
    from srcaco2_tpu_torch.models.prosr import ProSR
    return ProSR(in_chans=_p(netG, nt, 'in_chans'),
                 upscale=_p(netG, nt, 'upscale'),
                 num_init_features=_p(netG, nt, 'num_init_features'),
                 growth_rate=_p(netG, nt, 'growth_rate'),
                 bn_size=_p(netG, nt, 'bn_size'),
                 max_num_feature=_p(netG, nt, 'max_num_feature'),
                 level_config=_p(netG, nt, 'level_config'),
                 res_factor=_p(netG, nt, 'res_factor'),
                 block_compression=_p(netG, nt, 'block_compression'),
                 ps_woReLU=bool(netG.get(f'{safe_str_var(nt)}_ps_woReLU',
                                         False)), **kw)


def _edsr_liif(netG, nt, kw):
    from srcaco2_tpu_torch.models.edsr_liif import EDSRLIIF
    return EDSRLIIF(in_chans=_p(netG, nt, 'in_chans'),
                    upscale=_p(netG, nt, 'upscale'),
                    n_feats=_p(netG, nt, 'n_feats'),
                    n_resblocks=_p(netG, nt, 'n_resblocks'),
                    res_scale=_p(netG, nt, 'res_scale'),
                    local_ensemble=_p(netG, nt, 'local_ensemble'),
                    feat_unfold=_p(netG, nt, 'feat_unfold'),
                    cell_decode=_p(netG, nt, 'cell_decode'), **kw)


def _dsr_splines(netG, nt, kw):
    from srcaco2_tpu_torch.models.dsr_splines import DSRSplines
    return DSRSplines(in_planes=_p(netG, nt, 'in_planes'),
                      upscale=_p(netG, nt, 'upscale'),
                      in_ksz=_p(netG, nt, 'in_ksz'),
                      splinenet_type=_p(netG, nt, 'splinenet_type'),
                      n_splines_per_color=_p(netG, nt,
                                             'n_splines_per_color'),
                      color_min=_p(netG, nt, 'color_min'),
                      color_max=_p(netG, nt, 'color_max'),
                      use_local_residual=_p(netG, nt, 'use_local_residual'),
                      use_global_residual=_p(netG, nt,
                                             'use_global_residual'), **kw)


def _csrcnn(netG, nt, kw):
    from srcaco2_tpu_torch.models.csrcnn import CSRCNN
    return CSRCNN(in_planes=_p(netG, nt, 'in_planes'),
                  upscale=_p(netG, nt, 'upscale'),
                  net_type=_p(netG, nt, 'net_type'),
                  in_ksz=_p(netG, nt, 'in_ksz'),
                  ngroups=_p(netG, nt, 'ngroups'),
                  inner_channel=_p(netG, nt, 'inner_channel'),
                  norm_groups=_p(netG, nt, 'norm_groups'),
                  channel_mults=_p(netG, nt, 'channel_mults'),
                  res_blocks=_p(netG, nt, 'res_blocks'),
                  dropout=_p(netG, nt, 'dropout'),
                  use_global_residual=_p(netG, nt, 'use_global_residual'),
                  use_local_residual=netG.get(
                      f'{safe_str_var(nt)}_use_local_residual', False),
                  net_task=netG.get('net_task', constants.REGRESSION), **kw)


_BUILD = {constants.SWINIR: _swinir, constants.SRCNN: _srcnn,
          constants.VDSR: _vdsr, constants.DFCAN: _dfcan,
          constants.ENLCN: _enlcn, constants.OMNISR: _omnisr,
          constants.SRFBN: _srfbn, constants.MSLAPSR: _mslapsr,
          constants.ACT: _act, constants.NLSN: _nlsn,
          constants.GRL: _grl, constants.DRRN: _drrn,
          constants.MEMNET: _memnet, constants.DBPN: _dbpn,
          constants.PROSR: _prosr, constants.EDSR_LIIF: _edsr_liif,
          constants.DSRSPLINES: _dsr_splines, constants.CSRCNN: _csrcnn}
assert set(_BUILD) == set(PORTED_NETS)


def define_g(args: dict, device=None, seed: int = 0) -> nn.Module:
    """Build the generator from the resolved config on `device` (default
    cuda), with f32 parameters drawn from a torch.Generator seeded with
    `seed`; compute in bf16 when args['amp'] is set. SwinIR's block
    layout follows `swinir_use_fused_blocks` (default False, as in JAX);
    the unfused layout gets the plain attention core
    (use_pallas_attn=False), as JAX's define_g builds it."""
    netG = args['netG']
    nt = netG['net_type']
    if nt not in _BUILD:
        raise NotImplementedError(
            f'{nt}: no such net (nets: {", ".join(PORTED_NETS)})')
    dtype = torch.bfloat16 if args.get('amp', False) else torch.float32
    model = _BUILD[nt](netG, nt, dict(dtype=dtype,
                                      device=resolve_device(device)))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()
