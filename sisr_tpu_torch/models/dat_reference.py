"""DAT in plain float32 PyTorch: the yardstick ``models/dat.py`` is held to.

Written from DAT's equations (arXiv:2308.03364; zhengchen1999/DAT
``basicsr/archs/dat_arch.py``) the way DAT computes them: tokens
(B, H*W, C) and NCHW maps, ``F.pad`` of q, k and v with zeros to multiples
of max(split_size), ``torch.roll`` for the shift, ``img2windows`` and
``windows2img``, Swin's mask from slices of the padded map (-100 between
regions), the position bias from the ``DynamicPosBias`` MLP gathered by
``relative_position_index``, ``F.normalize`` and the d x d softmax of the
channel attention, ``nn.BatchNorm2d``'s equations (running statistics, or
with ``train`` the batch's, which this file does not write back).
Functional: ``P`` maps DAT's state-dict names to float32 tensors (pass
tensors that require grad for gradients).  Products run in full float32
(TF32 off for matmuls and cuDNN while a forward runs).  It imports no
kernel of the port.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# DAT x4 (options/Test/test_DAT_x4.yml)
DAT_X4 = dict(embed_dim=180, split_size=(8, 32), depth=(6, 6, 6, 6, 6, 6),
              num_heads=(6, 6, 6, 6, 6, 6), expansion_factor=4.0, upscale=4, img_range=1.0,
              num_feat=64)
RGB_MEAN = (0.4488, 0.4371, 0.4040)


@contextmanager
def _full_float32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _lin(P: Params, name: str, x):
    return F.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def _ln(P: Params, name: str, x):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], 1e-5)


def _conv(P: Params, name: str, x, groups: int = 1):
    w = P[name + ".weight"]
    return F.conv2d(x, w, P[name + ".bias"], padding=w.shape[-1] // 2, groups=groups)


def _bn(P: Params, name: str, x, train: bool):
    if train:
        return F.batch_norm(x, None, None, P[name + ".weight"], P[name + ".bias"], True, 0.0,
                            1e-5)
    return F.batch_norm(x, P[name + ".running_mean"], P[name + ".running_var"],
                        P[name + ".weight"], P[name + ".bias"], False, 0.0, 1e-5)


def img2windows(img, hs: int, ws: int):
    b, c, h, w = img.shape
    x = img.view(b, c, h // hs, hs, w // ws, ws)
    return x.permute(0, 2, 4, 3, 5, 1).contiguous().reshape(-1, hs * ws, c)


def windows2img(win, hs: int, ws: int, h: int, w: int):
    b = int(win.shape[0] / (h * w / hs / ws))
    x = win.view(b, h // hs, w // ws, hs, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def calculate_mask(h: int, w: int, split, shift, idx: int):
    """(windows, N, N) mask of branch ``idx`` on an h x w padded map (DAT's
    ``calculate_mask``: the regions from slices, 0 or -100)."""
    s0, s1 = split
    t0, t1 = shift
    if idx == 0:
        hsl, wsl, hs, ws = (s0, t0), (s1, t1), s0, s1
    else:
        hsl, wsl, hs, ws = (s1, t1), (s0, t0), s1, s0
    img = torch.zeros((1, h, w, 1))
    cnt = 0
    for hh in (slice(0, -hsl[0]), slice(-hsl[0], -hsl[1]), slice(-hsl[1], None)):
        for ww in (slice(0, -wsl[0]), slice(-wsl[0], -wsl[1]), slice(-wsl[1], None)):
            img[:, hh, ww, :] = cnt
            cnt += 1
    mw = img.view(1, h // hs, hs, w // ws, ws, 1).permute(0, 1, 3, 2, 4, 5).reshape(-1, hs * ws)
    m = mw.unsqueeze(1) - mw.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


def rpe_biases(hs: int, ws: int):
    bh, bw = torch.arange(1 - hs, hs), torch.arange(1 - ws, ws)
    return torch.stack(torch.meshgrid([bh, bw], indexing="ij")).flatten(1).transpose(0, 1).float()


def relative_position_index(hs: int, ws: int):
    coords = torch.stack(torch.meshgrid([torch.arange(hs), torch.arange(ws)], indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += hs - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def dynamic_pos_bias(P: Params, pre: str, biases):
    pos = _lin(P, pre + "pos_proj", biases)
    for k in (1, 2, 3):
        pos = _lin(P, pre + f"pos{k}.2", torch.relu(_ln(P, pre + f"pos{k}.0", pos)))
    return pos


def spatial_attention(P: Params, pre: str, qkv, h: int, w: int, split, idx: int, heads: int,
                      mask=None):
    """DAT's ``Spatial_Attention.forward``: qkv (3, B, L, C) of one branch on
    the h x w padded map -> (B, h, w, C)."""
    q, k, v = qkv[0], qkv[1], qkv[2]
    b, L, c = q.shape
    hs, ws = (split[0], split[1]) if idx == 0 else (split[1], split[0])
    d = c // heads

    def im2win(x):
        x = x.transpose(-2, -1).contiguous().view(b, c, h, w)
        x = img2windows(x, hs, ws)
        return x.reshape(-1, hs * ws, heads, d).permute(0, 2, 1, 3).contiguous()

    q, k, v = im2win(q) * d ** -0.5, im2win(k), im2win(v)
    attn = q @ k.transpose(-2, -1)
    dev = qkv.device
    pos = dynamic_pos_bias(P, pre + "pos.", rpe_biases(hs, ws).to(dev, qkv.dtype))
    n = hs * ws
    rpb = pos[relative_position_index(hs, ws).to(dev).view(-1)].view(n, n, -1)
    attn = attn + rpb.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    x = (attn @ v).transpose(1, 2).reshape(-1, n, c)
    return windows2img(x, hs, ws, h, w)


def spatial_branches(P: Params, pre: str, qkv, h: int, w: int, split, heads: int,
                     shift=None):
    """DAT's two branches of ``Adaptive_Spatial_Attention`` on qkv (3, B, L, C):
    zero pad, roll, attend, roll back, crop; -> (B, L, C)."""
    _, b, L, c = qkv.shape
    m = max(split)
    pad_r, pad_b = (m - w % m) % m, (m - h % m) % m
    qkv = qkv.reshape(3 * b, h, w, c).permute(0, 3, 1, 2)
    qkv = F.pad(qkv, (0, pad_r, 0, pad_b)).reshape(3, b, c, -1).transpose(-2, -1)
    hp, wp = pad_b + h, pad_r + w
    lp = hp * wp
    if shift is not None:
        qkv = qkv.view(3, b, hp, wp, c)
        q0 = torch.roll(qkv[..., :c // 2], (-shift[0], -shift[1]), (2, 3)).view(3, b, lp, c // 2)
        q1 = torch.roll(qkv[..., c // 2:], (-shift[1], -shift[0]), (2, 3)).view(3, b, lp, c // 2)
        m0 = calculate_mask(hp, wp, split, shift, 0).to(qkv.device)
        m1 = calculate_mask(hp, wp, split, shift, 1).to(qkv.device)
        x1 = spatial_attention(P, pre + "attns.0.", q0, hp, wp, split, 0, heads, m0)
        x2 = spatial_attention(P, pre + "attns.1.", q1, hp, wp, split, 1, heads, m1)
        x1 = torch.roll(x1, (shift[0], shift[1]), (1, 2))
        x2 = torch.roll(x2, (shift[1], shift[0]), (1, 2))
    else:
        x1 = spatial_attention(P, pre + "attns.0.", qkv[..., :c // 2], hp, wp, split, 0, heads)
        x2 = spatial_attention(P, pre + "attns.1.", qkv[..., c // 2:], hp, wp, split, 1, heads)
    x1 = x1[:, :h, :w, :].reshape(b, L, c // 2)
    x2 = x2[:, :h, :w, :].reshape(b, L, c // 2)
    return torch.cat([x1, x2], dim=2)


def _aim_layers(P: Params, pre: str, v_, train: bool):
    return F.gelu(_bn(P, pre + "dwconv.1", _conv(P, pre + "dwconv.0", v_, v_.shape[1]), train))


def _channel_interaction(P: Params, pre: str, x, train: bool):
    s = F.adaptive_avg_pool2d(x, 1)
    s = F.gelu(_bn(P, pre + "channel_interaction.2", _conv(P, pre + "channel_interaction.1", s),
                   train))
    return _conv(P, pre + "channel_interaction.4", s)


def _spatial_interaction(P: Params, pre: str, x, train: bool):
    s = F.gelu(_bn(P, pre + "spatial_interaction.1", _conv(P, pre + "spatial_interaction.0", x),
                   train))
    return _conv(P, pre + "spatial_interaction.3", s)


def adaptive_spatial_attention(P: Params, pre: str, x, h: int, w: int, split, heads: int,
                               shift, train: bool):
    b, L, c = x.shape
    qkv = _lin(P, pre + "qkv", x).reshape(b, -1, 3, c).permute(2, 0, 1, 3)
    v = qkv[2].transpose(-2, -1).contiguous().view(b, c, h, w)
    attened = spatial_branches(P, pre, qkv, h, w, split, heads // 2, shift)
    conv_x = _aim_layers(P, pre, v, train)
    channel_map = _channel_interaction(P, pre, conv_x, train).permute(0, 2, 3, 1).contiguous()
    channel_map = channel_map.view(b, 1, c)
    spatial_map = _spatial_interaction(P, pre, attened.transpose(-2, -1).contiguous().view(
        b, c, h, w), train)
    attened = attened * torch.sigmoid(channel_map)
    conv_x = (torch.sigmoid(spatial_map) * conv_x).permute(0, 2, 3, 1).contiguous().view(b, L, c)
    return _lin(P, pre + "proj", attened + conv_x)


def adaptive_channel_attention(P: Params, pre: str, x, h: int, w: int, heads: int,
                               train: bool, tile: int = 0):
    """``tile`` > 0 plants a fault: the q and k norms and products taken
    over the top-left tile x tile pixels of the image instead of all."""
    b, n, c = x.shape
    qkv = _lin(P, pre + "qkv", x).reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0].transpose(-2, -1), qkv[1].transpose(-2, -1), qkv[2].transpose(-2, -1)
    v_ = v.reshape(b, c, n).contiguous().view(b, c, h, w)
    if tile:
        keep = (torch.arange(n, device=x.device) // w < tile) & (
            torch.arange(n, device=x.device) % w < tile)
        q, k = q[..., keep], k[..., keep]
    q = F.normalize(q, dim=-1)
    k = F.normalize(k, dim=-1)
    attn = torch.softmax((q @ k.transpose(-2, -1)) * P[pre + "temperature"], dim=-1)
    attened = (attn @ v).permute(0, 3, 1, 2).reshape(b, n, c)
    conv_x = _aim_layers(P, pre, v_, train)
    channel_map = _channel_interaction(P, pre, attened.transpose(-2, -1).contiguous().view(
        b, c, h, w), train)
    spatial_map = _spatial_interaction(P, pre, conv_x, train).permute(0, 2, 3, 1).contiguous()
    attened = attened * torch.sigmoid(spatial_map.view(b, n, 1))
    conv_x = (conv_x * torch.sigmoid(channel_map)).permute(0, 2, 3, 1).contiguous().view(b, n, c)
    return _lin(P, pre + "proj", attened + conv_x)


def sgfn(P: Params, pre: str, x, h: int, w: int):
    x = F.gelu(_lin(P, pre + "fc1", x))
    x1, x2 = x.chunk(2, dim=-1)
    b, n, c = x.shape
    x2 = _ln(P, pre + "sg.norm", x2).transpose(1, 2).contiguous().view(b, c // 2, h, w)
    x2 = _conv(P, pre + "sg.conv", x2, c // 2).flatten(2).transpose(-1, -2).contiguous()
    return _lin(P, pre + "fc2", x1 * x2)


def shifted(group: int, block: int) -> bool:
    return (group % 2 == 0 and block > 0 and (block - 2) % 4 == 0) or (
        group % 2 != 0 and block % 4 == 0)


def forward(P: Params, x, cfg=DAT_X4, train: bool = False):
    """(B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3)."""
    with _full_float32():
        c, r, s = cfg["embed_dim"], cfg["img_range"], cfg["upscale"]
        split = tuple(cfg["split_size"])
        shift = (split[0] // 2, split[1] // 2)
        b, h, w, _ = x.shape
        mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        x = (x.permute(0, 3, 1, 2) - mean) * r
        f = _conv(P, "conv_first", x)
        t = _ln(P, "before_RG.1", f.flatten(2).transpose(1, 2))
        for i, (depth, heads) in enumerate(zip(cfg["depth"], cfg["num_heads"])):
            res = t
            for j in range(depth):
                pre = f"layers.{i}.blocks.{j}."
                u = _ln(P, pre + "norm1", t)
                if j % 2 == 0:
                    a = adaptive_spatial_attention(P, pre + "attn.", u, h, w, split, heads,
                                                   shift if shifted(i, j) else None, train)
                else:
                    a = adaptive_channel_attention(P, pre + "attn.", u, h, w, heads, train,
                                                   cfg.get("fault_tile", 0))
                t = t + a
                t = t + sgfn(P, pre + "ffn.", _ln(P, pre + "norm2", t), h, w)
            y = _conv(P, f"layers.{i}.conv", t.transpose(1, 2).reshape(b, c, h, w))
            t = res + y.flatten(2).transpose(1, 2)
        t = _ln(P, "norm", t).transpose(1, 2).reshape(b, c, h, w)
        y = _conv(P, "conv_after_body", t) + f
        y = F.leaky_relu(_conv(P, "conv_before_upsample.0", y), 0.01)
        for k in range(int(math.log2(s))):
            y = F.pixel_shuffle(_conv(P, f"upsample.{2 * k}", y), 2)
        y = _conv(P, "conv_last", y) / r + mean
        return y.permute(0, 2, 3, 1)


def l1_grads(P: Params, lr, hr, cfg=DAT_X4):
    """(L1 loss, {name: gradient}) of one training forward (BatchNorm on the
    batch's statistics) for every tensor of ``P`` that requires grad."""
    loss = (forward(P, lr, cfg, train=True) - hr).abs().mean()
    names = [k for k, v in P.items() if v.requires_grad]
    grads = torch.autograd.grad(loss, [P[k] for k in names])
    return loss.detach(), dict(zip(names, grads))
