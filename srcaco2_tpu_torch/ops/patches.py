"""Patch (un)folding on NHWC, torch F.unfold / F.fold semantics (port of
srcaco2_tpu/ops/patches.py).

ACT tokenizes with unfold(k=3, s=3) (non-overlapping: a reshape) and
builds cross-scale tokens with unfold(k=6, s=3) / fold(k=6, s=3)
(overlapping; fold is an overlap-add). Tokens are laid out as torch
lays them: channel-major (c, kh, kw) per token, tokens in row-major tile
order. A size that is not a multiple of the stride keeps F.unfold's and
F.fold's semantics: unfold takes the largest token grid that fits
(dropping the bottom / right remainder), fold writes into a zero (h, w)
canvas (the remainder border stays zero).
"""
import torch
import torch.nn.functional as F


def unfold_nonoverlap(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, T, C*k*k), stride k == kernel k;
    T = (H//k) * (W//k)."""
    b, h, w, c = x.shape
    th, tw = h // k, w // k
    y = x[:, :th * k, :tw * k].reshape(b, th, k, tw, k, c)
    y = y.permute(0, 1, 3, 5, 2, 4)            # b, th, tw, c, kh, kw
    return y.reshape(b, th * tw, c * k * k)


def fold_nonoverlap(t: torch.Tensor, k: int, hw) -> torch.Tensor:
    """Inverse of unfold_nonoverlap: (B, T, C*k*k) -> (B, H, W, C), the
    uncovered bottom / right border zero."""
    h, w = hw
    b = t.shape[0]
    th, tw = h // k, w // k
    c = t.shape[-1] // (k * k)
    y = t.reshape(b, th, tw, c, k, k).permute(0, 1, 4, 2, 5, 3)
    y = y.reshape(b, th * k, tw * k, c)
    if th * k != h or tw * k != w:
        y = F.pad(y, (0, 0, 0, w - tw * k, 0, h - th * k))
    return y


def _tiles(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H//s, W//s, C, s, s) tiles, remainder dropped."""
    b, h, w, c = x.shape
    gh, gw = h // s, w // s
    q = x[:, :gh * s, :gw * s].reshape(b, gh, s, gw, s, c)
    return q.permute(0, 1, 3, 5, 2, 4)


def unfold_k2s(x: torch.Tensor, s: int) -> torch.Tensor:
    """unfold with kernel 2s, stride s: (B, H, W, C) -> (B, T, C*2s*2s),
    T = (H//s - 1) * (W//s - 1); token (i, j) covers tiles (i..i+1,
    j..j+1)."""
    q = _tiles(x, s)
    b, gh, gw, c = q.shape[:4]
    top = torch.cat([q[:, :-1, :-1], q[:, :-1, 1:]], dim=5)   # width 2s
    bot = torch.cat([q[:, 1:, :-1], q[:, 1:, 1:]], dim=5)
    tok = torch.cat([top, bot], dim=4)                       # b,th,tw,c,2s,2s
    return tok.reshape(b, (gh - 1) * (gw - 1), c * 4 * s * s)


def fold_k2s(t: torch.Tensor, s: int, hw) -> torch.Tensor:
    """fold with kernel 2s, stride s (overlap-add): (B, T, C*2s*2s) ->
    (B, H, W, C), the uncovered border zero."""
    h, w = hw
    b = t.shape[0]
    gh, gw = h // s, w // s
    th, tw = gh - 1, gw - 1
    c = t.shape[-1] // (4 * s * s)
    tok = t.reshape(b, th, tw, c, 2 * s, 2 * s)
    # each quadrant of a token lands on one tile of the (gh, gw) grid:
    # pad each quadrant grid to (gh, gw) at its offset and add
    grid = (F.pad(tok[..., :s, :s], (0, 0, 0, 0, 0, 0, 0, 1, 0, 1))
            + F.pad(tok[..., :s, s:], (0, 0, 0, 0, 0, 0, 1, 0, 0, 1))
            + F.pad(tok[..., s:, :s], (0, 0, 0, 0, 0, 0, 0, 1, 1, 0))
            + F.pad(tok[..., s:, s:], (0, 0, 0, 0, 0, 0, 1, 0, 1, 0)))
    y = grid.permute(0, 1, 4, 2, 5, 3).reshape(b, gh * s, gw * s, c)
    if gh * s != h or gw * s != w:
        y = F.pad(y, (0, 0, 0, w - gw * s, 0, h - gh * s))
    return y
