"""HAT in plain float32 PyTorch: the yardstick ``models/hat.py`` is held to.

Written from HAT's equations (arXiv:2205.04437; XPixelGroup/HAT
``hat/archs/hat_arch.py`` and its test-time ``pre_process``) the way HAT
computes them: tokens (B, H*W, C), ``torch.roll`` for the cyclic shift, the
window partition and its reverse, Swin's mask (-100 between regions),
``F.unfold`` of the k and v maps for the overlapping cross-attention, the
dense relative-position bias gathered from each table.  Functional: ``P``
maps HAT's state-dict names to float32 tensors (pass tensors that require
grad for gradients).  Products run in full float32 (TF32 off for matmuls
and cuDNN while a forward runs).  It imports no kernel of the port.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# HAT_SRx4_ImageNet-pretrain (options/test/HAT_SRx4_ImageNet-pretrain.yml)
HAT_X4 = dict(embed_dim=180, depths=(6, 6, 6, 6, 6, 6), num_heads=(6, 6, 6, 6, 6, 6),
              window_size=16, compress_ratio=3, squeeze_factor=30, conv_scale=0.01,
              overlap_ratio=0.5, mlp_ratio=2.0, upscale=4, img_range=1.0, num_feat=64)
RGB_MEAN = (0.4488, 0.4371, 0.4040)


@contextmanager
def _full_float32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def calculate_rpi_sa(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def calculate_rpi_oca(ws: int, wse: int) -> torch.Tensor:
    ori = torch.flatten(torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                                   indexing="ij")), 1)
    ext = torch.flatten(torch.stack(torch.meshgrid(torch.arange(wse), torch.arange(wse),
                                                   indexing="ij")), 1)
    rel = (ext[:, None, :] - ori[:, :, None]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - wse + 1
    rel[:, :, 1] += ws - wse + 1
    rel[:, :, 0] *= ws + wse - 1
    return rel.sum(-1)


def calculate_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1), device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for wsl in cuts:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mw.unsqueeze(1) - mw.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def _linear(x, P: Params, name: str):
    return F.linear(x, P[name + ".weight"], P[name + ".bias"])


def _ln(x, P: Params, name: str):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], 1e-5)


def _conv(x, P: Params, name: str, padding: int = 1):
    return F.conv2d(x, P[name + ".weight"], P[name + ".bias"], padding=padding)


def _mlp(x, P: Params, pre: str):
    return _linear(F.gelu(_linear(x, P, pre + "fc1")), P, pre + "fc2")


def _bias(table, index, n: int, m: int):
    return table[index.view(-1)].view(n, m, -1).permute(2, 0, 1).contiguous()


def window_attention(x, P: Params, pre: str, heads: int, ws: int, rpi, mask):
    b_, n, c = x.shape
    d = c // heads
    qkv = _linear(x, P, pre + "qkv").reshape(b_, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
    attn = q @ k.transpose(-2, -1) + _bias(P[pre + "relative_position_bias_table"], rpi,
                                           n, n).unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    x = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(b_, n, c)
    return _linear(x, P, pre + "proj")


def cab(x, P: Params, pre: str):
    """x (B, C, H, W) -> the CAB branch."""
    y = _conv(F.gelu(_conv(x, P, pre + "cab.0")), P, pre + "cab.2")
    s = F.adaptive_avg_pool2d(y, 1)
    s = torch.relu(_conv(s, P, pre + "cab.3.attention.1", 0))
    return y * torch.sigmoid(_conv(s, P, pre + "cab.3.attention.3", 0))


def hab(x, P: Params, pre: str, size: Tuple[int, int], cfg, shift: int, rpi, mask):
    h, w = size
    b, _, c = x.shape
    ws = cfg["window_size"]
    u = _ln(x, P, pre + "norm1").view(b, h, w, c)
    conv_x = cab(u.permute(0, 3, 1, 2), P, pre + "conv_block.").permute(0, 2, 3, 1)
    shifted = torch.roll(u, (-shift, -shift), (1, 2)) if shift else u
    win = window_partition(shifted, ws).view(-1, ws * ws, c)
    out = window_attention(win, P, pre + "attn.", cfg_heads(cfg, pre), ws, rpi,
                           mask if shift else None)
    shifted = window_reverse(out.view(-1, ws, ws, c), ws, h, w)
    attn_x = torch.roll(shifted, (shift, shift), (1, 2)) if shift else shifted
    x = x + attn_x.reshape(b, h * w, c) + conv_x.reshape(b, h * w, c) * cfg["conv_scale"]
    return x + _mlp(_ln(x, P, pre + "norm2"), P, pre + "mlp.")


def ocab(x, P: Params, pre: str, size: Tuple[int, int], cfg, rpi):
    h, w = size
    b, _, c = x.shape
    ws = cfg["window_size"]
    wse = int(ws * cfg["overlap_ratio"]) + ws
    heads = cfg_heads(cfg, pre)
    d = c // heads
    shortcut = x
    u = _ln(x, P, pre + "norm1").view(b, h, w, c)
    qkv = _linear(u, P, pre + "qkv").reshape(b, h, w, 3, c).permute(3, 0, 4, 1, 2)
    q = qkv[0].permute(0, 2, 3, 1)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)
    qw = window_partition(q, ws).view(-1, ws * ws, c)
    kvw = F.unfold(kv, kernel_size=(wse, wse), stride=ws, padding=(wse - ws) // 2)
    nw = kvw.shape[-1]
    # 'b (nc ch owh oww) nw -> nc (b nw) (owh oww) ch'
    kvw = kvw.view(b, 2, c, wse * wse, nw).permute(1, 0, 4, 3, 2).reshape(2, b * nw,
                                                                          wse * wse, c)
    kw, vw = kvw[0], kvw[1]
    b_, nq, _ = qw.shape
    n = kw.shape[1]
    q = qw.reshape(b_, nq, heads, d).permute(0, 2, 1, 3) * d ** -0.5
    k = kw.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    v = vw.reshape(b_, n, heads, d).permute(0, 2, 1, 3)
    attn = q @ k.transpose(-2, -1) + _bias(P[pre + "relative_position_bias_table"], rpi,
                                           nq, n).unsqueeze(0)
    out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(b_, nq, c)
    x = window_reverse(out.view(-1, ws, ws, c), ws, h, w).view(b, h * w, c)
    x = _linear(x, P, pre + "proj") + shortcut
    return x + _mlp(_ln(x, P, pre + "norm2"), P, pre + "mlp.")


def cfg_heads(cfg, pre: str) -> int:
    """The heads of the group a block name ``layers.<i>....`` lies in."""
    return cfg["num_heads"][int(pre.split(".")[1])]


def forward(P: Params, x: torch.Tensor, cfg=None) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, upscale H, upscale W, 3)."""
    cfg = dict(HAT_X4, **(cfg or {}))
    with _full_float32():
        return _forward(P, x.permute(0, 3, 1, 2), cfg).permute(0, 2, 3, 1)


def _forward(P: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    ws, r = cfg["window_size"], cfg["img_range"]
    _, _, h0, w0 = x.shape
    ph, pw = (ws - h0 % ws) % ws, (ws - w0 % ws) % ws
    x = F.pad(x, (0, pw, 0, ph), "reflect")
    b, _, h, w = x.shape
    mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    x = _conv((x - mean) * r, P, "conv_first")
    wse = int(ws * cfg["overlap_ratio"]) + ws
    rpi_sa = calculate_rpi_sa(ws).to(x.device)
    rpi_oca = calculate_rpi_oca(ws, wse).to(x.device)
    mask = calculate_mask(h, w, ws, ws // 2, x.device)
    t = _ln(x.flatten(2).transpose(1, 2), P, "patch_embed.norm")
    for i, depth in enumerate(cfg["depths"]):
        pre = f"layers.{i}.residual_group."
        y = t
        for j in range(depth):
            y = hab(y, P, pre + f"blocks.{j}.", (h, w), cfg, 0 if j % 2 == 0 else ws // 2,
                    rpi_sa, mask)
        y = ocab(y, P, pre + "overlap_attn.", (h, w), cfg, rpi_oca)
        y = _conv(y.transpose(1, 2).view(b, -1, h, w), P, f"layers.{i}.conv")
        t = y.flatten(2).transpose(1, 2) + t
    t = _ln(t, P, "norm").transpose(1, 2).view(b, -1, h, w)
    y = _conv(t, P, "conv_after_body") + x
    y = F.leaky_relu(_conv(y, P, "conv_before_upsample.0"), 0.01)
    for k in range(int(math.log2(cfg["upscale"]))):
        y = F.pixel_shuffle(_conv(y, P, f"upsample.{2 * k}"), 2)
    y = _conv(y, P, "conv_last") / r + mean
    s = cfg["upscale"]
    return y[:, :, :h0 * s, :w0 * s]


def l1_grads(P: Params, lr: torch.Tensor, hr: torch.Tensor, cfg=None):
    """(L1 loss, {name: gradient}) of one training batch, for the entries
    of ``P`` that require grad."""
    names = [k for k, v in P.items() if v.requires_grad]
    loss = (forward(P, lr, cfg) - hr).abs().mean()
    grads = torch.autograd.grad(loss, [P[k] for k in names])
    return loss.detach(), dict(zip(names, grads))
