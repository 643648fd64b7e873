"""Plain DBPN for single-channel super-resolution, in float32.

Haris et al., "Deep Back-Projection Networks for Single Image
Super-resolution" (arXiv:1904.05677), the DBPN-RES-MR64-3 variant as
SR-CACO-2 trains it: feature extraction (3x3 conv to `feat`, 1x1 conv to
`base_filter`), then a dense chain of 7 up- and 6 down-projection units
run `num_stages` times with the same weights, the LR state of one stage
starting the next, and a 3x3 conv over the stages' HR outputs
concatenated. An up-projection maps LR to HR: h0 = up(x), l0 = down(h0),
h1 = up(l0 - x), out h0 + h1; a down-projection the other way. Units
after the second of their kind first compress the dense concatenation
with a 1x1 conv. Every conv and transposed conv is followed by a PReLU
with one learned slope, but the last conv. Projections at x8 use kernel
12, stride 8, padding 2. Transposed-conv weights are in torch's
(in, out, kh, kw) layout.
"""
import torch

from benchmark.reference.common import Precision, normal_params

KSP = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


def units():
    """(name, kind, compress multiple) of the 13 projection units in
    their order in one stage."""
    out = [('up1', 'up', 0), ('down1', 'down', 0), ('up2', 'up', 0)]
    for i in range(2, 7):
        out += [(f'down{i}', 'down', i), (f'up{i + 1}', 'up', i)]
    return out


def param_shapes(cfg: dict) -> dict:
    nf, feat, cin = cfg['base_filter'], cfg['feat'], cfg['in_chans']
    k = KSP[cfg['scale']][0]
    s = {}

    def layer(name, shape, bias_n, act=True):
        s[name + '.weight'] = shape
        s[name + '.bias'] = (bias_n,)
        if act:
            s[name + '.act'] = ()

    layer('feat0', (feat, cin, 3, 3), feat)
    layer('feat1', (nf, feat, 1, 1), nf)
    for name, kind, comp in units():
        if comp:
            layer(f'{name}.compress', (nf, comp * nf, 1, 1), nf)
        # up: deconv, conv, deconv; down: conv, deconv, conv. A conv's
        # weight is (out, in, k, k), a deconv's (in, out, k, k): both
        # (nf, nf, k, k) here
        for j in (1, 2, 3):
            layer(f'{name}.conv{j}', (nf, nf, k, k), nf)
    layer('output', (cin, cfg['num_stages'] * nf, 3, 3), cin, act=False)
    return s


def _is_deconv(key: str) -> bool:
    unit, _, conv = key.partition('.')
    kind = 'up' if unit.startswith('up') else 'down'
    j = conv.split('.')[0]
    return (kind == 'up' and j in ('conv1', 'conv3')) or \
        (kind == 'down' and j == 'conv2')


def init_rules(cfg: dict) -> dict:
    """(mean, std) of every leaf: PReLU slopes about 0.1, small biases,
    convs at std sqrt(1 / fan_in) and transposed convs at std
    sqrt(1 / (2 fan_in)), a transposed conv's fan-in counted over the
    (k / stride)^2 input positions that reach an output pixel, and the
    last conv's bias at 0.5: an untrained network's output then lies
    inside the [0, 1] of an image about 0.5, and the back-projection
    differences (l0 - x) keep clear of cancelling."""
    k, st, _ = KSP[cfg['scale']]
    rules = {}
    for key, shape in param_shapes(cfg).items():
        if key.endswith('.act'):
            rules[key] = (0.1, 0.01)
        elif key == 'output.bias':
            rules[key] = (0.5, 0.01)
        elif key.endswith('.bias'):
            rules[key] = (0.0, 0.01)
        elif key.startswith(('up', 'down')) and _is_deconv(key):
            fan_in = shape[0] * (k / st) ** 2
            rules[key] = (0.0, (0.5 / fan_in) ** 0.5)
        else:
            fan_in = shape[1] * shape[2] * shape[3]
            rules[key] = (0.0, (1.0 / fan_in) ** 0.5)
    return rules


def init_params(cfg: dict, gen: torch.Generator, device) -> dict:
    return normal_params(param_shapes(cfg), init_rules(cfg), gen, device)


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def forward(p: dict, x: torch.Tensor, cfg: dict,
            pr: Precision = Precision()) -> torch.Tensor:
    """x: (B, C, h, w) in [0, 1] -> (B, C, h * scale, w * scale)."""
    k, st, pad = KSP[cfg['scale']]

    def conv(name, z, stride=1, padding=0):
        y = pr.conv(z, p[name + '.weight'], p[name + '.bias'], stride,
                    padding)
        return pr.q(_prelu(y, p[name + '.act']))

    def down(name, z):
        return conv(name, z, st, pad)

    def up(name, z):
        y = pr.conv_t(z, p[name + '.weight'], p[name + '.bias'], st, pad)
        return pr.q(_prelu(y, p[name + '.act']))

    def unit(name, kind, comp, z):
        if comp:
            z = conv(f'{name}.compress', z)
        if kind == 'up':
            h0 = up(f'{name}.conv1', z)
            l0 = down(f'{name}.conv2', h0)
            return pr.q(up(f'{name}.conv3', pr.q(l0 - z)) + h0)
        l0 = down(f'{name}.conv1', z)
        h0 = up(f'{name}.conv2', l0)
        return pr.q(down(f'{name}.conv3', pr.q(h0 - z)) + l0)

    l = conv('feat1', conv('feat0', x, padding=1))
    outs = []
    for _ in range(cfg['num_stages']):
        h1 = unit('up1', 'up', 0, l)
        l1 = unit('down1', 'down', 0, h1)
        h2 = unit('up2', 'up', 0, l1)
        concat_h = torch.cat([h2, h1], 1)
        l = unit('down2', 'down', 2, concat_h)
        concat_l = torch.cat([l, l1], 1)
        h = unit('up3', 'up', 2, concat_l)
        for i in range(3, 7):
            concat_h = torch.cat([h, concat_h], 1)
            l = unit(f'down{i}', 'down', i, concat_h)
            concat_l = torch.cat([l, concat_l], 1)
            h = unit(f'up{i + 1}', 'up', i, concat_l)
        outs.append(h)
    return pr.conv(torch.cat(outs, 1), p['output.weight'], p['output.bias'],
                   padding=1)
