"""HiT-SIR-Pro, plain PyTorch: the yardstick the benchmark holds the
program's outputs to.

Written from the model's equations (HiT-SR's hierarchical transformer
blocks with the spatial-channel correlation, ECCV 2024; HiT-SIR-Pro's
multi-size shallow extraction, the SCA in the QKV path and the Fusion
gate), in the reference application's state-dict names, so the
benchmark's seeded weights load into the program and into this file
alike.  Functional: ``P`` maps each name to a float32 tensor.  It imports
nothing of the program and takes nothing the program made.

Every product goes through ``prec`` (``precision.py``), which is the
identity in the reference proper.  Maps are NHWC between layers, NCHW
inside convolutions.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

RGB_MEAN = (0.485, 0.456, 0.4060)
Params = Dict[str, torch.Tensor]


class Ops:
    """Products at one precision."""

    def __init__(self, prec: Precision):
        self.p = prec

    def linear(self, x, P: Params, name: str):
        return self.p(x) @ self.p(P[name + ".weight"]).t() + P[name + ".bias"]

    def conv(self, x, P: Params, name: str, stride: int = 1, padding: int = 1,
             groups: int = 1, weight=None):
        """NCHW conv with the named weight (or ``weight``) and bias, if any."""
        w = P[name + ".weight"] if weight is None else weight
        return F.conv2d(self.p(x), self.p(w), P.get(name + ".bias"), stride=stride,
                        padding=padding, groups=groups)

    def einsum(self, eq: str, a, b):
        return torch.einsum(eq, self.p(a), self.p(b))


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def layer_norm(x, P: Params, name: str):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"], P[name + ".bias"], 1e-5)


def reflect_index(n: int, total: int, device) -> torch.Tensor:
    """Rows of a length-n axis reflect-padded at its end to ``total``
    (numpy's 'reflect', for any pad width)."""
    i = torch.arange(total, device=device)
    if n == 1:
        return torch.zeros_like(i)
    j = i % (2 * n - 2)
    return torch.where(j < n, j, 2 * n - 2 - j)


def pad_to_window(x, win: int):
    """(B, H, W, C) reflect-padded at the bottom and right to multiples of win."""
    _, h, w, _ = x.shape
    hp, wp = -(-h // win) * win, -(-w // win) * win
    if hp != h:
        x = x.index_select(1, reflect_index(h, hp, x.device))
    if wp != w:
        x = x.index_select(2, reflect_index(w, wp, x.device))
    return x


# ----------------------------------------------------------------- blocks

def msce(o: Ops, P: Params, pre: str, x):
    """Multi-size conv extraction: branches k = 3, 5, 7, 9, each gated as
    p * sigmoid(gate * p) + p with gate = conv1x1(x), concatenated and
    projected by a 1x1 conv."""
    xc = nchw(x)
    gate = o.conv(xc, P, pre + "conv_x", padding=0)
    branches = []
    for k in (3, 5, 7, 9):
        p = o.conv(xc, P, pre + f"conv{k}", padding=k // 2)
        branches.append(p * torch.sigmoid(gate * p) + p)
    return nhwc(o.conv(torch.cat(branches, 1), P, pre + "conv_last", padding=0))


def position_bias(o: Ops, P: Params, pre: str, win: int, base: int, heads: int):
    """(win*win, heads, lb) bias of the spatial branch: the dynamic position
    MLP over every relative offset (query minus key), averaged over the
    keys of each base cell."""
    dev = P[pre + "pos_proj.weight"].device
    r = torch.arange(1 - win, win, dtype=P[pre + "pos_proj.weight"].dtype, device=dev)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    g = o.linear(coords, P, pre + "pos_proj")
    for i in (1, 2, 3):
        g = torch.relu(layer_norm(g, P, pre + f"pos{i}.0"))
        g = o.linear(g, P, pre + f"pos{i}.2")
    g = g.reshape(2 * win - 1, 2 * win - 1, heads).permute(2, 0, 1)
    bh = min(win, base)
    rh = win // bh
    # mean over a key block: avg over offsets (y - by*rh - a), a < rh
    g = F.avg_pool2d(g[None], rh, stride=1)[0]          # (heads, 2win-rh, 2win-rh)
    y = torch.arange(win, device=dev)
    b = torch.arange(bh, device=dev)
    idx = y[:, None] - b[None, :] * rh + win - rh        # (win, bh)
    g = g[:, idx][:, :, :, idx]                          # (heads, y, by, x, bx)
    return g.permute(1, 3, 0, 2, 4).reshape(win * win, heads, bh * bh)


def sca(o: Ops, P: Params, pre: str, x):
    """Spatial-channel attention in the QKV path: 3x3 convs (1 -> C) of the
    channel-mean and channel-max maps, each LeakyReLU(0.2) and scaled by a
    two-layer squeeze-excite vector of the spatial mean or max."""
    mean_map = x.mean(-1)[:, None]
    max_map = x.amax(-1)[:, None]
    ca = F.leaky_relu(nhwc(o.conv(mean_map, P, pre + "linear1")), 0.2)
    cm = F.leaky_relu(nhwc(o.conv(max_map, P, pre + "linear2")), 0.2)
    s1 = o.linear(o.linear(x.mean((1, 2)), P, pre + "linear1_first"), P, pre + "linear1_second")
    s2 = o.linear(o.linear(x.amax((1, 2)), P, pre + "linear2_first"), P, pre + "linear2_second")
    return (ca * s1[:, None, None] + cm * s2[:, None, None]) / 2.0 + x


def scc(o: Ops, P: Params, pre: str, x, win: int, base: int, heads: int):
    """Spatial-channel correlation of a window-padded (B, Hp, Wp, C) map."""
    b, hp, wp, c = x.shape
    half = c // 2
    d = half // heads
    bh = min(win, base)
    rh = win // bh
    lb = bh * bh
    qkv = sca(o, P, pre + "qkv.", x)
    t = qkv.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    t = t.reshape(-1, win, win, c)                        # (nw, win, win, C)
    nw = t.shape[0]
    q, v = t[..., :half], t[..., half:]
    qh = q.reshape(nw, win, win, heads, d)
    vh = v.reshape(nw, win, win, heads, d)
    k = (o.linear(qh, P, pre + "k_generate1") + o.linear(vh, P, pre + "k_generate2")) / 2.0

    # learned pooling of each rh x rh block to one base cell
    pw = P[pre + "spatial_linear.weight"].reshape(rh, rh)
    pb = P[pre + "spatial_linear.bias"]

    def pool(u):
        u = u.reshape(nw, bh, rh, bh, rh, heads, d)
        return o.einsum("nyaxbhd,ab->nyxhd", u, pw).reshape(nw, lb, heads, d) + pb

    kp, vp = pool(k), pool(vh)
    ql = qh.reshape(nw, win * win, heads, d)
    bias = position_bias(o, P, pre + "pos.", win, base, heads)
    corr = o.einsum("nlhd,nmhd->nlhm", ql, kp) / float(d) + bias
    out_s = o.einsum("nlhm,nmhd->nlhd", corr, vp).reshape(nw, win * win, half)

    kl = k.reshape(nw, win * win, half)
    vl = v.reshape(nw, win * win, half)
    gram = o.einsum("nlc,nle->nce", q.reshape(nw, win * win, half), kl) / float(win * win)
    out_c = o.einsum("nle,nce->nlc", vl, gram)

    out = torch.cat([out_s, out_c], -1).reshape(b, hp // win, wp // win, win, win, c)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    return o.linear(out, P, pre + "proj")


def htb(o: Ops, P: Params, pre: str, x, win: int, base: int, heads: int):
    """Post-norm block: x + LN(SCC(x)), then x + LN(ConvFFN(x)); the FFN is
    fc1, GELU, + GELU(5x5 depthwise conv), fc2."""
    _, h, w, _ = x.shape
    attn = scc(o, P, pre + "correlation.", pad_to_window(x, win), win, base, heads)
    x = x + layer_norm(attn[:, :h, :w], P, pre + "norm1")
    hid = F.gelu(o.linear(x, P, pre + "mlp.fc1"))
    dw = pre + "mlp.dwconv.depthwise_conv.0"
    hid = hid + F.gelu(nhwc(o.conv(nchw(hid), P, dw, padding=2, groups=hid.shape[-1])))
    y = o.linear(hid, P, pre + "mlp.fc2")
    return x + layer_norm(y, P, pre + "norm2")


def union_attention(o: Ops, P: Params, pre: str, s):
    """Joint C/H/W attention of an NCHW map: 3x3 convs (2 -> 1) of the
    [mean, max] pools over C (grid H x W), over H (grid C x W) and over W
    (grid C x H), broadcast, summed, then a 3x3 conv (C -> C)."""
    cp = torch.stack([s.mean(1), s.amax(1)], 1)
    hp = torch.stack([s.mean(2), s.amax(2)], 1)
    wp = torch.stack([s.mean(3), s.amax(3)], 1)
    c_att = o.conv(cp, P, pre + "conv1")                       # (B, 1, H, W)
    h_att = o.conv(hp, P, pre + "conv2").permute(0, 2, 1, 3)   # (B, C, 1, W)
    w_att = o.conv(wp, P, pre + "conv3")[:, 0, :, :, None]     # (B, C, H, 1)
    return o.conv(c_att + h_att + w_att, P, pre + "conv_last")


def fusion(o: Ops, P: Params, deep, shallow):
    a, b = nchw(deep), nchw(shallow)
    gate = torch.sigmoid(union_attention(o, P, "fusion.union_attention2.", a + b))
    out = (a * torch.sigmoid(union_attention(o, P, "fusion.union_attention1.", a) * gate)
           + b * torch.sigmoid(union_attention(o, P, "fusion.union_attention3.", b)
                               * (1.0 - gate)))
    return nhwc(out)


def windows(cfg) -> List[int]:
    base = cfg["base_win_size"][0]
    return [int(base * r) for r in cfg["hier_win_ratios"]]


def features(o: Ops, P: Params, cfg, x):
    """(B, H, W, 3) in [0, 1] -> the (B, H, W, num_feat) map after
    conv_before_upsample (LeakyReLU 0.01)."""
    mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
    x = x - mean
    shallow = msce(o, P, "conv_first.", x)
    feat = layer_norm(shallow, P, "patch_embed.norm")
    base, wins = cfg["base_win_size"][0], windows(cfg)
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        y = feat
        for j in range(depth):
            y = htb(o, P, f"layers.{i}.residual_group.blocks.{j}.", y, wins[j], base, heads)
        feat = feat + nhwc(o.conv(nchw(y), P, f"layers.{i}.conv"))
    feat = layer_norm(feat, P, "norm")
    deep = nhwc(o.conv(nchw(feat), P, "conv_after_body"))
    y = fusion(o, P, deep, shallow)
    return nhwc(F.leaky_relu(o.conv(nchw(y), P, "conv_before_upsample.0"), 0.01))


def head(o: Ops, P: Params, y):
    """x4 nearest+conv head of a (B, h, w, F) feature map, plus the mean."""
    y = nchw(y)
    y = F.leaky_relu(o.conv(F.interpolate(y, scale_factor=2, mode="nearest"), P, "conv_up1"),
                     0.2)
    y = F.leaky_relu(o.conv(F.interpolate(y, scale_factor=2, mode="nearest"), P, "conv_up2"),
                     0.2)
    y = F.leaky_relu(o.conv(y, P, "conv_hr"), 0.2)
    y = nhwc(o.conv(y, P, "conv_last"))
    return y + torch.tensor(RGB_MEAN, dtype=y.dtype, device=y.device)


HEAD_HALO = 4      # LR rows; the head's receptive radius is under 2


def forward(P: Params, cfg, x, prec: Precision = None, head_rows: int = 0):
    """(B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3).  ``head_rows`` > 0 runs
    the head over bands of that many LR rows (each with a halo of
    ``HEAD_HALO`` rows), which bounds the memory of its x4 maps and leaves
    every value as the whole head gives it."""
    o = Ops(prec or Precision())
    y = features(o, P, cfg, x)
    h = y.shape[1]
    if head_rows <= 0 or head_rows >= h:
        return head(o, P, y)
    s = 4
    out = []
    for r in range(0, h, head_rows):
        lo, hi = max(0, r - HEAD_HALO), min(h, r + head_rows + HEAD_HALO)
        band = head(o, P, y[:, lo:hi])
        out.append(band[:, s * (r - lo):s * (min(h, r + head_rows) - lo)])
    return torch.cat(out, 1)


# ----------------------------------------------------------------- manifest

def manifest(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every (name, shape) of the state dict, in the reference's names."""
    c, nf, cin = cfg["embed_dim"], cfg["num_feat"], 3
    base = cfg["base_win_size"][0]
    hidden = int(c * cfg["mlp_ratio"])
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def conv(name, co, ci, k, bias=True):
        out.append((name + ".weight", (co, ci, k, k)))
        if bias:
            out.append((name + ".bias", (co,)))

    def lin(name, co, ci):
        out.append((name + ".weight", (co, ci)))
        out.append((name + ".bias", (co,)))

    def norm(name, n):
        out.append((name + ".weight", (n,)))
        out.append((name + ".bias", (n,)))

    for k in (3, 5, 7, 9):
        conv(f"conv_first.conv{k}", c, cin, k)
    conv("conv_first.conv_x", c, cin, 1)
    norm("conv_first.norm", c)          # declared by the reference, unused
    conv("conv_first.conv_last", c, 4 * c, 1)
    for i in (1, 2, 3):
        pre = f"fusion.union_attention{i}."
        for j in (1, 2, 3):
            conv(pre + f"conv{j}", 1, 2, 3)
        conv(pre + "conv_last", c, c, 3)
    norm("patch_embed.norm", c)
    wins = windows(cfg)
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            pre = f"layers.{i}.residual_group.blocks.{j}."
            win = wins[j]
            rh = win // min(win, base)
            d = c // (2 * heads)
            pos = c // 4 // 4
            norm(pre + "norm1", c)
            q = pre + "correlation.qkv."
            conv(q + "linear1", c, 1, 3)
            conv(q + "linear2", c, 1, 3)
            lin(q + "linear1_first", c // 10, c)
            lin(q + "linear1_second", c, c // 10)
            lin(q + "linear2_first", c // 10, c)
            lin(q + "linear2_second", c, c // 10)
            lin(pre + "correlation.proj", c, c)
            lin(pre + "correlation.spatial_linear", 1, rh * rh)
            lin(pre + "correlation.k_generate1", d, d)
            lin(pre + "correlation.k_generate2", d, d)
            p = pre + "correlation.pos."
            lin(p + "pos_proj", pos, 2)
            for k in (1, 2, 3):
                norm(p + f"pos{k}.0", pos)
                lin(p + f"pos{k}.2", heads if k == 3 else pos, pos)
            norm(pre + "norm2", c)
            lin(pre + "mlp.fc1", hidden, c)
            conv(pre + "mlp.dwconv.depthwise_conv.0", hidden, 1, 5)
            lin(pre + "mlp.fc2", c, hidden)
        conv(f"layers.{i}.conv", c, c, 3)
    norm("norm", c)
    conv("conv_after_body", c, c, 3)
    conv("conv_before_upsample.0", nf, c, 3)
    for name in ("conv_up1", "conv_up2", "conv_hr"):
        conv(name, nf, nf, 3)
    conv("conv_last", cin, nf, 3)
    return out


def n_params(cfg) -> int:
    return sum(math.prod(s) for _, s in manifest(cfg))
