"""Per-network default hyper-parameters (the branches of
srcaco2_tpu/config/net_defaults.py:init_net_g, one for each net),
keyed as `<net_type_lower>_<param>` inside the `netG` sub-config."""
from copy import deepcopy

from srcaco2_tpu_torch import constants


def safe_str_var(s: str) -> str:
    return s.replace('-', '_').lower()


def _swinir(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                img_size=args['h_size'] // args['scale'], window_size=8,
                img_range=1.0, depths=[6, 6, 6, 6, 6, 6], embed_dim=180,
                num_heads=[6, 6, 6, 6, 6, 6], mlp_ratio=2,
                upsampler=constants.US_PIXEL_SHUFFLE,
                resi_connection=constants.R_CONNECTION_1CONV,
                use_fused_blocks=True)


def _act(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                n_feats=64, img_range=1.0, n_resgroups=4, n_resblocks=12,
                reduction=16, n_heads=8, n_layers=8, n_fusionblocks=4,
                dropout_rate=0.0, token_size=3, expansion_ratio=4)


def _enlcn(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                n_resblock=32, n_feats=256, res_scale=0.1, img_range=1.0)


def _srfbn(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                num_features=64, num_steps=4, num_groups=6, use_cl=True)


def _omnisr(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                num_feat=64, res_num=5, bias=True, window_size=8,
                block_num=4, pe=True, ffn_bias=True)


def _nlsn(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                n_resblocks=32, n_feats=256, n_hashes=4, chunk_size=144,
                res_scale=0.1, img_range=1.0)


def _grl(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                img_size=args['h_size'] // args['scale'], window_size=8,
                embed_dim=180, mlp_ratio=2, img_range=1.0,
                depths=[4, 4, 8, 8, 8, 4, 4],
                num_heads_window=[3, 3, 3, 3, 3, 3, 3],
                num_heads_stripe=[3, 3, 3, 3, 3, 3, 3],
                upsampler=constants.US_PIXEL_SHUFFLE, conv_type='1conv',
                out_proj_type='linear', anchor_window_down_factor=2,
                qkv_proj_type='linear', anchor_proj_type='avgpool',
                local_connection=True)


def _memnet(args):
    # remat_passes: checkpoint each chain pass (the JAX package's default;
    # its R^2 recursion keeps every block's maps at HR size without)
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                num_memory_blocks=6, num_residual_blocks=6,
                remat_passes=True)


def _drrn(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                num_residual_units=25)


def _edsr_liif(args):
    # the LIIF decoder's flags (local ensemble, feature unfolding, cell
    # decoding) all on, as the JAX package sets them
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                n_feats=64, img_range=1.0, res_scale=1., n_resblocks=16,
                local_ensemble=True, feat_unfold=True, cell_decode=True)


def _prosr(args):
    # residual_denseblock, level_compression, max_num_feature and
    # block_compression are set as the JAX package sets them and read
    # by neither package's ProSR
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                residual_denseblock=True, num_init_features=160, bn_size=4,
                growth_rate=40, ps_woReLU=False, level_compression=-1,
                res_factor=0.2, max_num_feature=312, block_compression=0.4,
                level_config={
                    2: [[8, 8, 8, 8, 8, 8, 8, 8, 8]],
                    4: [[8, 8, 8, 8, 8, 8, 8, 8, 8], [8, 8, 8]],
                    8: [[8, 8, 8, 8, 8, 8, 8, 8, 8], [8, 8, 8], [8]],
                })


def _dbpn(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'],
                base_filter=64, feat=256, num_stages=3)


def _dsr_splines(args):
    return dict(upscale=args['scale'], in_planes=args['n_channels'],
                color_min=args['color_min'], color_max=args['color_max'],
                in_ksz=3, splinenet_type=constants.SPLINE_NET_TYPES[0],
                n_splines_per_color=16, use_local_residual=False,
                use_global_residual=False)


def _csrcnn(args):
    return dict(upscale=args['scale'], in_planes=args['n_channels'],
                in_ksz=3, ngroups=16, use_local_residual=False,
                norm_groups=16, channel_mults='1_2_4_8_16_32_32_32',
                dropout=0.0, outksz=3, inner_channel=32, res_blocks=3,
                net_type=constants.NET_TYPE_UNET, use_global_residual=True)


def _upscale_in_chans(args):
    return dict(upscale=args['scale'], in_chans=args['n_channels'])


_DEFAULTS = {
    constants.SWINIR: _swinir,
    constants.ACT: _act,
    constants.ENLCN: _enlcn,
    constants.SRFBN: _srfbn,
    constants.MSLAPSR: _upscale_in_chans,
    constants.DFCAN: _upscale_in_chans,
    constants.OMNISR: _omnisr,
    constants.VDSR: _upscale_in_chans,
    constants.SRCNN: lambda args: dict(in_chans=args['n_channels']),
    constants.NLSN: _nlsn,
    constants.GRL: _grl,
    constants.DRRN: _drrn,
    constants.MEMNET: _memnet,
    constants.EDSR_LIIF: _edsr_liif,
    constants.PROSR: _prosr,
    constants.DBPN: _dbpn,
    constants.DSRSPLINES: _dsr_splines,
    constants.CSRCNN: _csrcnn,
}

# the nets define_g and init_net_g build: every net of constants.MODELS
PORTED_NETS = tuple(_DEFAULTS)
assert set(PORTED_NETS) == set(constants.MODELS)

# options a net reads that init_net_g leaves unset (define_g's default
# applies; the JAX package's defaults do not set them either): each can
# be given on the command line or in a config's netG
NET_OPTIONS = {constants.SRFBN: {'srfbn_remat_steps': False},
               constants.DBPN: {'dbpn_remat_blocks': True}}


def init_net_g(netG: dict, args: dict) -> dict:
    """Fill the defaults of a net and the common init keys; a name that
    is no net raises NotImplementedError."""
    out = deepcopy(netG)
    net_type = netG['net_type']
    if net_type not in _DEFAULTS:
        raise NotImplementedError(
            f'{net_type}: no such net (nets: {", ".join(PORTED_NETS)})')
    nt = safe_str_var(net_type)
    for k, v in _DEFAULTS[net_type](args).items():
        out[f'{nt}_{k}'] = v
    out[f'{nt}_init_type'] = constants.INIT_W_DEFAULT
    out[f'{nt}_init_bn_type'] = constants.INIT_BN_CONSTANT
    out[f'{nt}_init_gain'] = 1.
    return out
