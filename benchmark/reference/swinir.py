"""Plain SwinIR for single-channel super-resolution, in float32.

Liang et al., "SwinIR: Image Restoration Using Swin Transformer"
(arXiv:2108.10257), classical SR: a 3x3 shallow-feature conv, residual
Swin transformer blocks (RSTB: `depth` Swin layers with windows shifted by
ws/2 on every other layer, then a 3x3 conv and the residual), a LayerNorm,
a 3x3 conv with the long skip, and the 'pixelshuffledirect' upsampler (one
3x3 conv to scale^2 channels, then pixel shuffle). Departures from the
paper's code, where the configuration states them: the MLP's GELU is the
tanh approximation (`"gelu": "tanh"`), and the input mean is 0 for one
channel. Parameters are named as in the paper's code, but the query, key
and value projections are three (a key's bias moves no output, so its
gradient is nought but for rounding, and the check leaves such leaves
out); Linear weights are in torch's (out, in) layout.
"""
import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import Precision, normal_params


def _stages(cfg):
    return list(zip(cfg['depths'], cfg['num_heads']))


def param_shapes(cfg: dict) -> dict:
    c, ws = cfg['embed_dim'], cfg['window_size']
    ch = int(c * cfg['mlp_ratio'])
    cin, r = cfg['in_chans'], cfg['scale']
    s = {'conv_first.weight': (c, cin, 3, 3), 'conv_first.bias': (c,),
         'patch_norm.weight': (c,), 'patch_norm.bias': (c,)}
    for i, (depth, nh) in enumerate(_stages(cfg)):
        for j in range(depth):
            b = f'layers.{i}.blocks.{j}.'
            s.update({
                b + 'norm1.weight': (c,), b + 'norm1.bias': (c,),
                b + 'attn.relative_position_bias_table':
                    ((2 * ws - 1) ** 2, nh),
                b + 'attn.q.weight': (c, c), b + 'attn.q.bias': (c,),
                b + 'attn.k.weight': (c, c), b + 'attn.k.bias': (c,),
                b + 'attn.v.weight': (c, c), b + 'attn.v.bias': (c,),
                b + 'attn.proj.weight': (c, c), b + 'attn.proj.bias': (c,),
                b + 'norm2.weight': (c,), b + 'norm2.bias': (c,),
                b + 'mlp.fc1.weight': (ch, c), b + 'mlp.fc1.bias': (ch,),
                b + 'mlp.fc2.weight': (c, ch), b + 'mlp.fc2.bias': (c,)})
        s[f'layers.{i}.conv.weight'] = (c, c, 3, 3)
        s[f'layers.{i}.conv.bias'] = (c,)
    s.update({'norm.weight': (c,), 'norm.bias': (c,),
              'conv_after_body.weight': (c, c, 3, 3),
              'conv_after_body.bias': (c,),
              'upsample.0.weight': (cin * r * r, c, 3, 3),
              'upsample.0.bias': (cin * r * r,)})
    return s


def init_rules(cfg: dict) -> dict:
    """(mean, std) of every leaf: LayerNorm gains about 1, small biases,
    products at std 1/sqrt(fan_in), position biases at 0.02 (the paper's
    truncated normal's std), and the upsampler's bias at 0.5 so that an
    untrained network's output lies inside the [0, 1] of an image."""
    rules = {}
    for k, shape in param_shapes(cfg).items():
        if 'norm' in k.split('.')[-2]:
            rules[k] = (1.0, 0.02) if k.endswith('weight') else (0.0, 0.02)
        elif k.endswith('relative_position_bias_table'):
            rules[k] = (0.0, 0.02)
        elif k == 'upsample.0.bias':
            rules[k] = (0.5, 0.01)
        elif k.endswith('bias'):
            rules[k] = (0.0, 0.01)
        else:
            fan_in = int(np.prod(shape[1:]))
            gain = 0.1 if k.startswith('upsample') else 1.0
            rules[k] = (0.0, gain / fan_in ** 0.5)
    return rules


def init_params(cfg: dict, gen: torch.Generator, device) -> dict:
    return normal_params(param_shapes(cfg), init_rules(cfg), gen, device)


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing='ij')).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def shift_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, ws*ws, ws*ws) additive mask (0 / -100) of the shifted windows:
    tokens from different regions of the rolled image do not attend to
    each other."""
    img = torch.zeros(h, w)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _reverse(x, ws, b, h, w):
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _swin_layer(x, p, pre, nh, ws, shift, h, w, pr: Precision):
    """One Swin layer over (B, H, W, C)."""
    b, _, _, c = x.shape
    hd = c // nh
    n = ws * ws
    y = pr.q(F.layer_norm(x, (c,), p[pre + 'norm1.weight'],
                          p[pre + 'norm1.bias'], 1e-5))
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    win = _partition(y, ws)
    bw = win.shape[0]
    q, k, v = (pr.linear(win, p[pre + f'attn.{t}.weight'],
                         p[pre + f'attn.{t}.bias'])
               .reshape(bw, n, nh, hd).transpose(1, 2) for t in 'qkv')
    attn = pr.matmul(q * hd ** -0.5, k.transpose(-2, -1))
    idx = relative_position_index(ws).to(x.device).reshape(-1)
    table = p[pre + 'attn.relative_position_bias_table']
    attn = attn + table[idx].reshape(n, n, nh).permute(2, 0, 1)[None]
    if shift:
        mask = shift_mask(h, w, ws, shift).to(x.device)
        nw = mask.shape[0]
        attn = (attn.reshape(bw // nw, nw, nh, n, n)
                + mask[None, :, None]).reshape(bw, nh, n, n)
    out = pr.matmul(torch.softmax(pr.q(attn), -1), v)
    out = out.transpose(1, 2).reshape(bw, n, c)
    out = pr.linear(out, p[pre + 'attn.proj.weight'],
                    p[pre + 'attn.proj.bias'])
    y = _reverse(out, ws, b, h, w)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    x = pr.q(x + y)
    y = pr.q(F.layer_norm(x, (c,), p[pre + 'norm2.weight'],
                          p[pre + 'norm2.bias'], 1e-5))
    y = pr.linear(y, p[pre + 'mlp.fc1.weight'], p[pre + 'mlp.fc1.bias'])
    y = pr.q(F.gelu(y, approximate='tanh'))
    y = pr.linear(y, p[pre + 'mlp.fc2.weight'], p[pre + 'mlp.fc2.bias'])
    return pr.q(x + y)


def forward(p: dict, x: torch.Tensor, cfg: dict,
            pr: Precision = Precision()) -> torch.Tensor:
    """x: (B, C, H, W) in [0, 1], H and W multiples of the window ->
    (B, C, H * scale, W * scale)."""
    ws = cfg['window_size']
    _, _, h, w = x.shape
    if h % ws or w % ws:
        raise ValueError(f'{h}x{w} is not a multiple of the window {ws}')
    x = x * cfg['img_range']
    feat = pr.conv(x, p['conv_first.weight'], p['conv_first.bias'],
                   padding=1)
    c = feat.shape[1]
    body = pr.q(F.layer_norm(feat.permute(0, 2, 3, 1), (c,),
                             p['patch_norm.weight'], p['patch_norm.bias'],
                             1e-5))
    for i, (depth, nh) in enumerate(_stages(cfg)):
        y = body
        for j in range(depth):
            shift = 0 if j % 2 == 0 else ws // 2
            y = _swin_layer(y, p, f'layers.{i}.blocks.{j}.', nh, ws, shift,
                            h, w, pr)
        y = pr.conv(y.permute(0, 3, 1, 2), p[f'layers.{i}.conv.weight'],
                    p[f'layers.{i}.conv.bias'], padding=1)
        body = pr.q(y.permute(0, 2, 3, 1) + body)
    body = pr.q(F.layer_norm(body, (c,), p['norm.weight'], p['norm.bias'],
                             1e-5))
    feat = pr.q(feat + pr.conv(body.permute(0, 3, 1, 2),
                               p['conv_after_body.weight'],
                               p['conv_after_body.bias'], padding=1))
    out = pr.conv(feat, p['upsample.0.weight'], p['upsample.0.bias'],
                  padding=1)
    return F.pixel_shuffle(out, cfg['scale']) / cfg['img_range']
