"""Per-network default hyper-parameters (the SwinIR branch of
srcaco2_tpu/config/net_defaults.py:init_net_g), keyed as
`<net_type_lower>_<param>` inside the `netG` sub-config."""
from copy import deepcopy

from srcaco2_tpu_torch import constants


def safe_str_var(s: str) -> str:
    return s.replace('-', '_').lower()


def init_net_g(netG: dict, args: dict) -> dict:
    """Fill the SwinIR defaults; other nets are not ported yet."""
    out = deepcopy(netG)
    net_type = netG['net_type']
    if net_type != constants.SWINIR:
        raise NotImplementedError(
            f'{net_type}: only SwinIR is ported so far (see ROADMAP.md)')
    nt = safe_str_var(net_type)
    out[f'{nt}_upscale'] = args['scale']
    out[f'{nt}_in_chans'] = args['n_channels']
    out[f'{nt}_img_size'] = args['h_size'] // args['scale']
    out[f'{nt}_window_size'] = 8
    out[f'{nt}_img_range'] = 1.0
    out[f'{nt}_depths'] = [6, 6, 6, 6, 6, 6]
    out[f'{nt}_embed_dim'] = 180
    out[f'{nt}_num_heads'] = [6, 6, 6, 6, 6, 6]
    out[f'{nt}_mlp_ratio'] = 2
    out[f'{nt}_upsampler'] = constants.US_PIXEL_SHUFFLE
    out[f'{nt}_resi_connection'] = constants.R_CONNECTION_1CONV
    out[f'{nt}_use_fused_blocks'] = True
    out[f'{nt}_init_type'] = constants.INIT_W_DEFAULT
    out[f'{nt}_init_bn_type'] = constants.INIT_BN_CONSTANT
    out[f'{nt}_init_gain'] = 1.
    return out
