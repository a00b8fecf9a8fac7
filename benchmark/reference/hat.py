"""HAT x4, plain PyTorch: the yardstick the benchmark holds the program's
HAT frames to.

Written from HAT's equations (Chen et al., arXiv:2205.04437;
XPixelGroup/HAT ``hat/archs/hat_arch.py`` and its test-time reflect pad to
multiples of the window), in HAT's state-dict names, so the benchmark's
seeded weights load into the program and into this file alike.  Functional:
``P`` maps each name to a float32 tensor.  It imports nothing of the program
and takes nothing the program made.

Every product goes through ``prec`` (``precision.py``), the identity in the
reference proper.  Maps are NHWC between layers, NCHW inside convolutions.
The attention runs a chunk of windows at a time (``CHUNK_ELEMS`` scores),
so that a 1080p frame fits: a window's queries and keys are gathered by
index from the map (rolled for a shifted block; zero-padded by (wk - ws) / 2
for the overlapping cross-attention, whose edge keys are zeros with a
logit of the bias alone).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.hitsir import Ops, Params, layer_norm, nchw, nhwc, pad_to_window
from benchmark.reference.precision import Precision

RGB_MEAN = (0.4488, 0.4371, 0.4040)
MASK = -100.0
# score elements of one chunk of windows (float32: 512 MiB)
CHUNK_ELEMS = 1 << 27


def key_window(cfg) -> int:
    return int(cfg["window_size"] * cfg["overlap_ratio"]) + cfg["window_size"]


def rpi_sa(ws: int, device) -> torch.Tensor:
    """(ws^2, ws^2) rows of the (2ws - 1)^2 table (HAT's calculate_rpi_sa)."""
    y, x = (t.flatten() for t in torch.meshgrid(torch.arange(ws, device=device),
                                                torch.arange(ws, device=device),
                                                indexing="ij"))
    return (y[:, None] - y[None, :] + ws - 1) * (2 * ws - 1) + x[:, None] - x[None, :] + ws - 1


def rpi_oca(ws: int, wk: int, device) -> torch.Tensor:
    """(ws^2, wk^2) rows of the (ws + wk - 1)^2 table (HAT's
    calculate_rpi_oca: negative where the key lies above or left of the
    query by more than wk - ws - 1, wrapped by indexing)."""
    r = lambda n: (t.flatten() for t in torch.meshgrid(torch.arange(n, device=device),
                                                       torch.arange(n, device=device),
                                                       indexing="ij"))
    yo, xo = r(ws)
    ye, xe = r(wk)
    off = ws - wk + 1
    return ((ye[None, :] - yo[:, None] + off) * (ws + wk - 1)
            + xe[None, :] - xo[:, None] + off)


def region_ids(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    """(h, w) region of every pixel of the rolled map (Swin's mask)."""
    def axis(n):
        r = torch.zeros(n, dtype=torch.long, device=device)
        r[n - ws:] = 1
        r[n - shift:] = 2
        return r
    return axis(h)[:, None] * 3 + axis(w)[None, :]


def attention(o: Ops, qkv, table, index, heads: int, ws: int, shift: int = 0, wk: int = 0):
    """softmax(q k^T d^-0.5 + bias (+ mask)) v for every (window, head) of
    qkv (B, H, W, 3C); the result (B, H, W, C), un-rolled."""
    wk = wk or ws
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    if shift:
        qkv = torch.roll(qkv, (-shift, -shift), (1, 2))
    q, k, v = qkv.split(c, -1)
    pad = (wk - ws) // 2
    if pad:
        k = F.pad(k, (0, 0, pad, pad, pad, pad))
        v = F.pad(v, (0, 0, pad, pad, pad, pad))
    n, m = ws * ws, wk * wk
    bias = table[index.reshape(-1)].reshape(n, m, heads).permute(2, 0, 1)
    nh, nw = h // ws, w // ws
    dev = qkv.device
    iy, ix = (t.flatten() for t in torch.meshgrid(torch.arange(ws, device=dev),
                                                  torch.arange(ws, device=dev), indexing="ij"))
    jy, jx = (t.flatten() for t in torch.meshgrid(torch.arange(wk, device=dev),
                                                  torch.arange(wk, device=dev), indexing="ij"))
    regions = region_ids(h, w, ws, shift, dev) if shift else None
    wins = [(bi, y, x) for bi in range(b) for y in range(nh) for x in range(nw)]
    step = max(1, CHUNK_ELEMS // (heads * n * m))
    out = torch.empty(b, h, w, c, dtype=qkv.dtype, device=dev)
    for s in range(0, len(wins), step):
        chunk = torch.tensor(wins[s:s + step], device=dev)
        bi, wy, wx = chunk[:, 0], chunk[:, 1] * ws, chunk[:, 2] * ws
        qy, qx = wy[:, None] + iy, wx[:, None] + ix                    # (k, n)
        ky, kx = wy[:, None] + jy, wx[:, None] + jx                    # (k, m), padded coords
        split = lambda t, cnt: t.reshape(len(chunk), cnt, heads, d).transpose(1, 2)
        qw = split(q[bi[:, None], qy, qx], n)
        kw = split(k[bi[:, None], ky, kx], m)
        vw = split(v[bi[:, None], ky, kx], m)
        scores = o.p(qw) @ o.p(kw).transpose(-1, -2) * d ** -0.5 + bias
        if regions is not None:
            rq = regions[qy, qx]
            scores = scores + torch.where(rq[:, :, None] != rq[:, None, :], MASK, 0.0)[:, None]
        att = o.p(torch.softmax(scores, -1)) @ o.p(vw)                  # (k, heads, n, d)
        out[bi[:, None], qy, qx] = att.transpose(1, 2).reshape(len(chunk), n, c)
    if shift:
        out = torch.roll(out, (shift, shift), (1, 2))
    return out


def mlp(o: Ops, P: Params, pre: str, x):
    return o.linear(F.gelu(o.linear(x, P, pre + "fc1")), P, pre + "fc2")


def cab(o: Ops, P: Params, pre: str, u):
    """The channel-attention branch of a HAB on u (B, H, W, C)."""
    y = o.conv(F.gelu(o.conv(nchw(u), P, pre + "cab.0")), P, pre + "cab.2")
    s = y.mean(dim=(2, 3), keepdim=True)
    s = torch.relu(o.conv(s, P, pre + "cab.3.attention.1", padding=0))
    return nhwc(y * torch.sigmoid(o.conv(s, P, pre + "cab.3.attention.3", padding=0)))


def hab(o: Ops, P: Params, pre: str, t, heads: int, ws: int, shift: int, conv_scale: float):
    u = layer_norm(t, P, pre + "norm1")
    c = cab(o, P, pre + "conv_block.", u)
    a = attention(o, o.linear(u, P, pre + "attn.qkv"),
                  P[pre + "attn.relative_position_bias_table"], rpi_sa(ws, t.device), heads,
                  ws, shift)
    t = t + o.linear(a, P, pre + "attn.proj") + conv_scale * c
    return t + mlp(o, P, pre + "mlp.", layer_norm(t, P, pre + "norm2"))


def ocab(o: Ops, P: Params, pre: str, t, heads: int, ws: int, wk: int):
    u = layer_norm(t, P, pre + "norm1")
    a = attention(o, o.linear(u, P, pre + "qkv"), P[pre + "relative_position_bias_table"],
                  rpi_oca(ws, wk, t.device), heads, ws, 0, wk)
    t = o.linear(a, P, pre + "proj") + t
    return t + mlp(o, P, pre + "mlp.", layer_norm(t, P, pre + "norm2"))


def forward(P: Params, cfg, x, prec: Precision = None):
    """(B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3)."""
    o = Ops(prec or Precision())
    ws, r, s = cfg["window_size"], cfg["img_range"], cfg["upscale"]
    _, h0, w0, _ = x.shape
    x = pad_to_window(x, ws)
    mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
    shallow = nhwc(o.conv(nchw((x - mean) * r), P, "conv_first"))
    t = layer_norm(shallow, P, "patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        pre = f"layers.{i}.residual_group."
        y = t
        for j in range(depth):
            y = hab(o, P, pre + f"blocks.{j}.", y, heads, ws, 0 if j % 2 == 0 else ws // 2,
                    cfg["conv_scale"])
        y = ocab(o, P, pre + "overlap_attn.", y, heads, ws, key_window(cfg))
        t = nhwc(o.conv(nchw(y), P, f"layers.{i}.conv")) + t
    t = layer_norm(t, P, "norm")
    y = o.conv(nchw(t), P, "conv_after_body") + nchw(shallow)
    y = F.leaky_relu(o.conv(y, P, "conv_before_upsample.0"), 0.01)
    for k in range(int(math.log2(s))):
        y = F.pixel_shuffle(o.conv(y, P, f"upsample.{2 * k}"), 2)
    y = nhwc(o.conv(y, P, "conv_last")) / r + mean
    return y[:, :h0 * s, :w0 * s]


def manifest(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every (name, shape) of HAT's parameters (its two index buffers are
    not weights)."""
    c, nf, cin = cfg["embed_dim"], cfg["num_feat"], 3
    ws, wk = cfg["window_size"], key_window(cfg)
    hidden = int(c * cfg["mlp_ratio"])
    cc, cs = c // cfg["compress_ratio"], c // cfg["squeeze_factor"]
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def conv(name, co, ci, k):
        out.extend([(name + ".weight", (co, ci, k, k)), (name + ".bias", (co,))])

    def lin(name, co, ci):
        out.extend([(name + ".weight", (co, ci)), (name + ".bias", (co,))])

    def norm(name):
        out.extend([(name + ".weight", (c,)), (name + ".bias", (c,))])

    conv("conv_first", c, cin, 3)
    norm("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        pre = f"layers.{i}.residual_group."
        for j in range(depth):
            b = pre + f"blocks.{j}."
            norm(b + "norm1")
            out.append((b + "attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads)))
            lin(b + "attn.qkv", 3 * c, c)
            lin(b + "attn.proj", c, c)
            conv(b + "conv_block.cab.0", cc, c, 3)
            conv(b + "conv_block.cab.2", c, cc, 3)
            conv(b + "conv_block.cab.3.attention.1", cs, c, 1)
            conv(b + "conv_block.cab.3.attention.3", c, cs, 1)
            norm(b + "norm2")
            lin(b + "mlp.fc1", hidden, c)
            lin(b + "mlp.fc2", c, hidden)
        b = pre + "overlap_attn."
        norm(b + "norm1")
        lin(b + "qkv", 3 * c, c)
        out.append((b + "relative_position_bias_table", ((ws + wk - 1) ** 2, heads)))
        lin(b + "proj", c, c)
        norm(b + "norm2")
        lin(b + "mlp.fc1", hidden, c)
        lin(b + "mlp.fc2", c, hidden)
        conv(f"layers.{i}.conv", c, c, 3)
    norm("norm")
    conv("conv_after_body", c, c, 3)
    conv("conv_before_upsample.0", nf, c, 3)
    for k in range(int(math.log2(cfg["upscale"]))):
        conv(f"upsample.{2 * k}", 4 * nf, nf, 3)
    conv("conv_last", cin, nf, 3)
    return out


def n_params(cfg) -> int:
    return sum(math.prod(s) for _, s in manifest(cfg))
