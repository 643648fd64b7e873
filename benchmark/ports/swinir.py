"""SwinIR in the program: its build arguments, and the re-layout of the
reference's parameters into the program's state dict and back.

The program stacks each stage's block parameters over depth and keeps
dense kernels in the (in, out) layout; the reference keeps one tensor per
layer in torch's (out, in) layout. The re-layout moves numbers and
computes none.
"""
import torch

# the reference's per-layer names -> the program's stacked names, and
# whether the dense kernel is transposed
BLOCK = {'norm1.weight': ('ln1_weight', False),
         'norm1.bias': ('ln1_bias', False),
         'attn.relative_position_bias_table': ('rel_pos_table', False),
         'attn.proj.weight': ('proj_kernel', True),
         'attn.proj.bias': ('proj_bias', False),
         'norm2.weight': ('ln2_weight', False),
         'norm2.bias': ('ln2_bias', False),
         'mlp.fc1.weight': ('mlp1_kernel', True),
         'mlp.fc1.bias': ('mlp1_bias', False),
         'mlp.fc2.weight': ('mlp2_kernel', True),
         'mlp.fc2.bias': ('mlp2_bias', False)}
PLAIN = {'conv_first': 'conv_first', 'patch_norm': 'patch_norm',
         'norm': 'norm', 'conv_after_body': 'conv_after_body',
         'upsample.0': 'upsample.conv'}


def net_type(cfg: dict) -> str:
    return 'SwinIR'


def port_args(cfg: dict, h_size: int) -> dict:
    """The resolved arguments that the program's define_g and SRServer
    take for this configuration."""
    from srcaco2_tpu_torch.config.net_defaults import init_net_g
    args = {'scale': cfg['scale'], 'n_channels': cfg['in_chans'],
            'h_size': h_size, 'amp': cfg['compute_dtype'] == 'bfloat16'}
    netG = init_net_g({'net_type': 'SwinIR'}, args)
    netG.update(swinir_embed_dim=cfg['embed_dim'],
                swinir_depths=list(cfg['depths']),
                swinir_num_heads=list(cfg['num_heads']),
                swinir_window_size=cfg['window_size'],
                swinir_mlp_ratio=cfg['mlp_ratio'],
                swinir_img_range=cfg['img_range'],
                swinir_upsampler=cfg['upsampler'],
                swinir_resi_connection=cfg['resi_connection'],
                swinir_use_fused_blocks=True)
    args['netG'] = netG
    return args


def _plain_pairs(cfg):
    for ref, prog in PLAIN.items():
        for leaf in ('weight', 'bias'):
            yield f'{ref}.{leaf}', f'{prog}.{leaf}'
    for i in range(len(cfg['depths'])):
        for leaf in ('weight', 'bias'):
            yield f'layers.{i}.conv.{leaf}', f'stages.{i}.convs.0.{leaf}'


def to_port(ref: dict, cfg: dict) -> dict:
    out = {prog: ref[r].clone() for r, prog in _plain_pairs(cfg)}
    for i, depth in enumerate(cfg['depths']):
        pre = [f'layers.{i}.blocks.{j}.' for j in range(depth)]
        for r, (prog, t) in BLOCK.items():
            leaves = [ref[b + r] for b in pre]
            out[f'stages.{i}.blocks.{prog}'] = torch.stack(
                [x.t() if t else x for x in leaves]).contiguous()
        # the program's qkv product: q, k, v side by side
        out[f'stages.{i}.blocks.qkv_kernel'] = torch.stack([torch.cat(
            [ref[f'{b}attn.{x}.weight'] for x in 'qkv']).t()
            for b in pre]).contiguous()
        out[f'stages.{i}.blocks.qkv_bias'] = torch.stack([torch.cat(
            [ref[f'{b}attn.{x}.bias'] for x in 'qkv']) for b in pre])
    return out


def from_port(prog: dict, cfg: dict) -> dict:
    out = {r: prog[p] for r, p in _plain_pairs(cfg)}
    for i, depth in enumerate(cfg['depths']):
        for r, (name, t) in BLOCK.items():
            stacked = prog[f'stages.{i}.blocks.{name}']
            for j in range(depth):
                out[f'layers.{i}.blocks.{j}.{r}'] = \
                    stacked[j].t() if t else stacked[j]
        c = cfg['embed_dim']
        for j in range(depth):
            w = prog[f'stages.{i}.blocks.qkv_kernel'][j].t()
            b = prog[f'stages.{i}.blocks.qkv_bias'][j]
            for n, x in enumerate('qkv'):
                out[f'layers.{i}.blocks.{j}.attn.{x}.weight'] = \
                    w[n * c:(n + 1) * c]
                out[f'layers.{i}.blocks.{j}.attn.{x}.bias'] = \
                    b[n * c:(n + 1) * c]
    return out
