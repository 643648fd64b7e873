"""What the plain references share: the precision of their products, the
batch assembly from the benchmark's draws, the training loss and the
optimizer.

Everything here is plain PyTorch in float32 and imports nothing of the
program. `Precision('f32')` keeps every product in true float32 (TF32 off
for matmuls and cuDNN); `Precision('fp8')` rounds every activation and
every product's operands to float8 with a per-tensor scale, the control
of the benchmark's correctness check (one step below the bfloat16 the
configurations compute in).
"""
import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the float8 `dtype` under a per-tensor scale that maps
    its largest |x| to the format's largest value `top`."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _QuantFP8(torch.autograd.Function):
    """Forward: round to float8 e4m3; backward: round the gradient to
    float8 e5m2 (the formats of float8 training), each under its own
    per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """The rounding of what a network stores: 'f32' (none) or 'fp8',
    where the operands and the output of every product, and (through
    `q`, which the references call after each element-wise step) every
    other activation, are rounded to float8 e4m3 and their gradients to
    e5m2, as a float8 network stores them between its operations; the
    arithmetic inside an operation stays in float32."""

    def __init__(self, name: str = 'f32'):
        if name not in ('f32', 'fp8'):
            raise ValueError(name)
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == 'f32' else _QuantFP8.apply(x)

    def linear(self, x, w, b=None):
        """x @ w.T + b, torch.nn.Linear's layout (w: (out, in))."""
        return self.q(F.linear(self.q(x), self.q(w), b))

    def matmul(self, a, b):
        return self.q(torch.matmul(self.q(a), self.q(b)))

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride=stride,
                               padding=padding))

    def conv_t(self, x, w, b=None, stride=1, padding=0):
        """torch's transposed convolution (w: (in, out, kh, kw))."""
        return self.q(F.conv_transpose2d(self.q(x), self.q(w), b,
                                         stride=stride, padding=padding))


@contextlib.contextmanager
def true_f32():
    """TF32 off for matmuls and cuDNN inside the block (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def dihedral_nhwc(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Dihedral transform `mode` of (B, H, W, C) patches: modes 0-3 turn
    by mode quarter turns from the H axis towards the W axis, modes 4-7
    turn by mode - 4 quarter turns and then flip H."""
    out = torch.rot90(x, k=mode % 4, dims=(1, 2))
    return torch.flip(out, dims=(1,)) if mode >= 4 else out


def crop(stack_u8: torch.Tensor, idxs, r0, c0, side: int, mode):
    """(B, C, side, side) float32 in [0, 1]: for every sample the
    side x side crop of image idxs[i] at (r0[i], c0[i]), the origin
    clamped into the image, then its dihedral transform mode[i]."""
    _, h, w, _ = stack_u8.shape
    r0 = r0.clamp(0, h - side)
    c0 = c0.clamp(0, w - side)
    ar = torch.arange(side, device=stack_u8.device)
    rows = (r0[:, None] + ar)[:, :, None]
    cols = (c0[:, None] + ar)[:, None, :]
    patches = stack_u8[idxs.long()[:, None, None], rows, cols]  # B,s,s,C
    out = torch.empty_like(patches)
    for m in range(8):
        sel = (mode == m).nonzero().flatten()
        if sel.numel():
            out[sel] = dihedral_nhwc(patches[sel], m)
    return out.permute(0, 3, 1, 2).float() / 255.0


def train_batch(hr_u8, lr_u8, idxs, x0, y0, mode, scale: int, h_size: int):
    """The (LR, HR) pair of a training batch: the HR crop at (x0, y0) and
    the LR crop at (x0 // scale, y0 // scale), both turned by the same
    dihedral mode."""
    ls = h_size // scale
    hr = crop(hr_u8, idxs, x0, y0, h_size, mode)
    lr = crop(lr_u8, idxs, x0 // scale, y0 // scale, ls, mode)
    return lr, hr


def gauss_1d(ws: int, sigma: float = 1.5) -> torch.Tensor:
    xs = torch.arange(ws, dtype=torch.float64) - ws // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).float()


def ssim_per_sample(p: torch.Tensor, y: torch.Tensor, ws: int) -> torch.Tensor:
    """SSIM of (B, C, H, W) images under a ws x ws Gaussian window
    (sigma 1.5) with zero padding to the same size, averaged over each
    sample's pixels: (B,)."""
    c = p.shape[1]
    g = gauss_1d(ws).to(p.device)
    kh = g.reshape(1, 1, ws, 1).repeat(c, 1, 1, 1)
    kw = g.reshape(1, 1, 1, ws).repeat(c, 1, 1, 1)
    pad = ws // 2

    def blur(x):
        x = F.conv2d(x, kh, padding=(pad, 0), groups=c)
        return F.conv2d(x, kw, padding=(0, pad), groups=c)

    mu1, mu2 = blur(p), blur(y)
    s1 = blur(p * p) - mu1 * mu1
    s2 = blur(y * y) - mu2 * mu2
    s12 = blur(p * y) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))


def loss_part(pred, hr, loss_cfg: dict, n_total: int) -> tuple:
    """This block of rows' shares of the batch loss's two terms,
    l2_lambda * mean((pred - hr)^2) and -ssim_lambda * mean(SSIM): both
    are means over equal-sized samples, so the shares of the blocks of a
    batch add up to the batch's terms."""
    b = pred.shape[0]
    l2 = ((pred - hr) ** 2).mean() * (b / n_total)
    ssim = ssim_per_sample(pred, hr, int(loss_cfg['ssim_window'])).sum() \
        / n_total
    return (float(loss_cfg['l2_lambda']) * l2,
            -float(loss_cfg['ssim_lambda']) * ssim)


def adam_init(params: dict) -> dict:
    return dict(t=0, m={k: torch.zeros_like(p) for k, p in params.items()},
                v={k: torch.zeros_like(p) for k, p in params.items()})


def adam_update(params: dict, grads: dict, st: dict, opt: dict,
                ok: bool = True) -> None:
    """One step of Adam with L2 weight decay added to the gradient
    (torch.optim.Adam's weight_decay, not AdamW), in place; a step whose
    loss or gradients are not all finite leaves the parameters alone but
    still advances the moments on a zero gradient."""
    lr, wd = float(opt['lr']), float(opt['weight_decay'])
    b1, b2, eps = float(opt['beta1']), float(opt['beta2']), float(opt['eps'])
    ok = ok and all(bool(torch.isfinite(g).all()) for g in grads.values())
    st['t'] += 1
    t = st['t']
    for k, p in params.items():
        g = grads[k] if ok else torch.zeros_like(p)
        u = g + wd * p
        st['m'][k] = b1 * st['m'][k] + (1 - b1) * u
        st['v'][k] = b2 * st['v'][k] + (1 - b2) * u * u
        if ok:
            m_hat = st['m'][k] / (1 - b1 ** t)
            v_hat = st['v'][k] / (1 - b2 ** t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))


def first_grad(st: dict, opt: dict) -> dict:
    """The gradient the optimizer took in its first step (weight decay
    included), worked out from its first moment after that step."""
    return {k: m / (1 - float(opt['beta1'])) for k, m in st['m'].items()}


def normal_params(shapes: dict, rules: dict, gen: torch.Generator,
                  device) -> dict:
    """Parameters from one draw of normals on `device`: leaf k is
    mean + std * z with (mean, std) = rules[k], its slice of the draw."""
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        mean, std = rules[k]
        out[k] = (z[at:at + n] * std + mean).reshape(shape)
        at += n
    return out
