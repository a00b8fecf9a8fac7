"""DAT x4, plain PyTorch: the yardstick the benchmark holds the program's
DAT frames to.

Written from DAT's equations (Chen et al., arXiv:2308.03364;
zhengchen1999/DAT ``basicsr/archs/dat_arch.py``), in DAT's state-dict
names, so the benchmark's seeded weights load into the program and into
this file alike.  Functional: ``P`` maps each name to a float32 tensor,
the BatchNorms' running statistics among them (inference: every BatchNorm
on its running statistics).  It imports nothing of the program and takes
nothing the program made.

Every product goes through ``prec`` (``precision.py``), the identity in the
reference proper.  Maps are NHWC between layers, NCHW inside convolutions.
The spatial attention zero-pads q, k and v to multiples of max(split_size),
rolls each branch's map by half its window in a shifted block, and runs a
chunk of windows at a time (``CHUNK_ELEMS`` scores) so that a 1080p frame
fits, each window's pixels gathered by index; Swin's mask (-100 between
regions of the rolled padded map) from region ids; padded keys are zeros,
not masked.  The channel attention normalises q and k over every pixel of
the image (``F.normalize``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.hitsir import Ops, Params, layer_norm, nchw, nhwc
from benchmark.reference.precision import Precision

RGB_MEAN = (0.4488, 0.4371, 0.4040)
MASK = -100.0
BN_EPS = 1e-5
# score elements of one chunk of windows (float32: 512 MiB)
CHUNK_ELEMS = 1 << 27


def shifted(group: int, block: int) -> bool:
    """DAT's rule for a spatial block's shift."""
    return (group % 2 == 0 and block > 0 and (block - 2) % 4 == 0) or (
        group % 2 == 1 and block % 4 == 0)


def position_bias(o: Ops, P: Params, pre: str, hs: int, ws: int, device):
    """(heads, N, N) bias of an hs x ws window from the branch's position
    MLP: rows (dy, dx) row-major through Linear(2, p) and three [LayerNorm,
    ReLU, Linear], gathered at (yi - yj + hs - 1)(2ws - 1) + xi - xj + ws - 1."""
    dy, dx = torch.meshgrid(torch.arange(1 - hs, hs, device=device),
                            torch.arange(1 - ws, ws, device=device), indexing="ij")
    pos = o.linear(torch.stack([dy.flatten(), dx.flatten()], 1).float(), P, pre + "pos_proj")
    for k in (1, 2, 3):
        pos = o.linear(torch.relu(layer_norm(pos, P, pre + f"pos{k}.0")), P, pre + f"pos{k}.2")
    y, x = (t.flatten() for t in torch.meshgrid(torch.arange(hs, device=device),
                                                torch.arange(ws, device=device), indexing="ij"))
    index = (y[:, None] - y[None, :] + hs - 1) * (2 * ws - 1) + x[:, None] - x[None, :] + ws - 1
    n = hs * ws
    return pos[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)


def regions(n: int, win: int, shift: int, device) -> torch.Tensor:
    r = torch.zeros(n, dtype=torch.long, device=device)
    r[n - win:] = 1
    r[n - shift:] = 2
    return r


def branch_attention(o: Ops, q, k, v, bias, heads: int, hs: int, ws: int, sh: int, sw: int,
                     fault: str = ""):
    """One branch on the zero-padded maps q, k, v (B, Hp, Wp, c): softmax(q
    k^T d^-0.5 + bias (+ mask)) v in hs x ws windows of the map rolled by
    -(sh, sw); the result (B, Hp, Wp, c), rolled back.  ``fault``
    'pad_masked' plants one: the padded keys masked out of the softmax
    (``pad`` marks them), 'no_mask' another: the shift mask left out."""
    b, hp, wp, c = q.shape
    d = c // heads
    dev = q.device
    pad = None
    if isinstance(fault, tuple):
        fault, pad = fault
    if sh or sw:
        q, k, v = (torch.roll(t, (-sh, -sw), (1, 2)) for t in (q, k, v))
        if pad is not None:
            pad = torch.roll(pad, (-sh, -sw), (0, 1))
    n = hs * ws
    nh, nw = hp // hs, wp // ws
    iy, ix = (t.flatten() for t in torch.meshgrid(torch.arange(hs, device=dev),
                                                  torch.arange(ws, device=dev), indexing="ij"))
    reg = None
    if (sh or sw) and fault != "no_mask":
        reg = regions(hp, hs, sh, dev)[:, None] * 3 + regions(wp, ws, sw, dev)[None, :]
    wins = [(bi, y, x) for bi in range(b) for y in range(nh) for x in range(nw)]
    step = max(1, CHUNK_ELEMS // (heads * n * n))
    out = torch.empty(b, hp, wp, c, dtype=q.dtype, device=dev)
    split = lambda t, cnt: t.reshape(t.shape[0], cnt, heads, d).transpose(1, 2)
    for s in range(0, len(wins), step):
        chunk = torch.tensor(wins[s:s + step], device=dev)
        bi, wy, wx = chunk[:, 0], chunk[:, 1] * hs, chunk[:, 2] * ws
        py, px = wy[:, None] + iy, wx[:, None] + ix                       # (k, n)
        qw = split(q[bi[:, None], py, px], n)
        kw = split(k[bi[:, None], py, px], n)
        vw = split(v[bi[:, None], py, px], n)
        scores = o.p(qw) @ o.p(kw).transpose(-1, -2) * d ** -0.5 + bias
        if reg is not None:
            r = reg[py, px]
            scores = scores + torch.where(r[:, :, None] != r[:, None, :], MASK, 0.0)[:, None]
        if fault == "pad_masked":
            scores = scores.masked_fill(pad[py, px][:, None, None, :], float("-inf"))
        att = o.p(torch.softmax(scores, -1)) @ o.p(vw)
        out[bi[:, None], py, px] = att.transpose(1, 2).reshape(len(chunk), n, c)
    if sh or sw:
        out = torch.roll(out, (sh, sw), (1, 2))
    return out


def spatial(o: Ops, qkv, biases, heads: int, split, shift: bool, fault: str = ""):
    """Both branches of a spatial block's attention on qkv (B, H, W, 3C),
    with the branches' (heads / 2, N, N) ``biases`` -> (B, H, W, C).
    ``fault`` plants one of ``branch_attention``'s, or 'axes_swapped': the
    second branch rolled by the first's shift."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    m = max(split)
    hp, wp = -(-h // m) * m, -(-w // m) * m
    qkv = F.pad(qkv, (0, 0, 0, wp - w, 0, hp - h))
    pad = torch.ones(hp, wp, dtype=torch.bool, device=qkv.device)
    pad[:h, :w] = False
    s0, s1 = (split[0] // 2, split[1] // 2) if shift else (0, 0)
    outs = []
    for i, ((hs, ws), (sh, sw)) in enumerate((((split[0], split[1]), (s0, s1)),
                                              ((split[1], split[0]), (s1, s0)))):
        if fault == "axes_swapped" and i == 1:
            sh, sw = s0, s1
        part = slice(i * c // 2, (i + 1) * c // 2)
        q, k, v = (qkv[..., j * c:(j + 1) * c][..., part] for j in range(3))
        outs.append(branch_attention(o, q, k, v, biases[i], heads // 2, hs, ws, sh, sw,
                                     (fault, pad) if fault == "pad_masked" else fault))
    return torch.cat(outs, -1)[:, :h, :w]


def channel(o: Ops, P: Params, pre: str, qkv, heads: int):
    """The channel attention on qkv (B, H, W, 3C) -> (B, H, W, C): per head,
    softmax over the channels of q and k normalised over every pixel, times
    the temperature, applied to v."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    t = qkv.reshape(b, h * w, 3, heads, d)
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]                         # (B, N, heads, d)
    qn, kn = F.normalize(q, dim=1), F.normalize(k, dim=1)
    attn = torch.softmax(o.einsum("bphi,bphj->bhij", qn, kn) * P[pre + "temperature"], -1)
    return o.einsum("bhij,bphj->bphi", attn, v).reshape(b, h, w, c)


def bn(P: Params, name: str, x):
    """BatchNorm on the running statistics, channels last."""
    scale = P[name + ".weight"] / torch.sqrt(P[name + ".running_var"] + BN_EPS)
    return (x - P[name + ".running_mean"]) * scale + P[name + ".bias"]


def conv_branch(o: Ops, P: Params, pre: str, v):
    c = v.shape[-1]
    y = nhwc(o.conv(nchw(v), P, pre + "dwconv.0", groups=c))
    return F.gelu(bn(P, pre + "dwconv.1", y))


def channel_map(o: Ops, P: Params, pre: str, x):
    s = x.mean(dim=(1, 2))
    s = F.gelu(bn(P, pre + "channel_interaction.2",
                  o.p(s) @ o.p(P[pre + "channel_interaction.1.weight"].flatten(1)).t()
                  + P[pre + "channel_interaction.1.bias"]))
    return (o.p(s) @ o.p(P[pre + "channel_interaction.4.weight"].flatten(1)).t()
            + P[pre + "channel_interaction.4.bias"])[:, None, None, :]


def spatial_map(o: Ops, P: Params, pre: str, x):
    y = (o.p(x) @ o.p(P[pre + "spatial_interaction.0.weight"].flatten(1)).t()
         + P[pre + "spatial_interaction.0.bias"])
    y = F.gelu(bn(P, pre + "spatial_interaction.1", y))
    return (o.p(y) @ o.p(P[pre + "spatial_interaction.3.weight"].flatten(1)).t()
            + P[pre + "spatial_interaction.3.bias"])


def block(o: Ops, P: Params, pre: str, t, cfg, group: int, j: int):
    c, heads = cfg["embed_dim"], cfg["num_heads"][group]
    u = layer_norm(t, P, pre + "norm1")
    a = pre + "attn."
    qkv = o.linear(u, P, a + "qkv")
    v = qkv[..., 2 * c:]
    conv = conv_branch(o, P, a, v)
    if j % 2 == 0:
        split = cfg["split_size"]
        biases = [position_bias(o, P, a + f"attns.{i}.pos.", *win, t.device)
                  for i, win in enumerate(((split[0], split[1]), (split[1], split[0])))]
        att = spatial(o, qkv, biases, heads, split, shifted(group, j))
        x = att * torch.sigmoid(channel_map(o, P, a, conv)) + conv * torch.sigmoid(
            spatial_map(o, P, a, att))
    else:
        att = channel(o, P, a, qkv, heads)
        x = att * torch.sigmoid(spatial_map(o, P, a, conv)) + conv * torch.sigmoid(
            channel_map(o, P, a, att))
    t = t + o.linear(x, P, a + "proj")
    f = pre + "ffn."
    g1, g2 = F.gelu(o.linear(layer_norm(t, P, pre + "norm2"), P, f + "fc1")).chunk(2, -1)
    g2 = nhwc(o.conv(nchw(layer_norm(g2, P, f + "sg.norm")), P, f + "sg.conv",
                     groups=g2.shape[-1]))
    return t + o.linear(g1 * g2, P, f + "fc2")


def forward(P: Params, cfg, x, prec: Precision = None):
    """(B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3)."""
    o = Ops(prec or Precision())
    r, s = cfg["img_range"], cfg["upscale"]
    mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
    f = nhwc(o.conv(nchw((x - mean) * r), P, "conv_first"))
    t = layer_norm(f, P, "before_RG.1")
    for i, depth in enumerate(cfg["depth"]):
        y = t
        for j in range(depth):
            y = block(o, P, f"layers.{i}.blocks.{j}.", y, cfg, i, j)
        t = nhwc(o.conv(nchw(y), P, f"layers.{i}.conv")) + t
    t = layer_norm(t, P, "norm")
    y = o.conv(nchw(t), P, "conv_after_body") + nchw(f)
    y = F.leaky_relu(o.conv(y, P, "conv_before_upsample.0"), 0.01)
    for k in range(int(math.log2(s))):
        y = F.pixel_shuffle(o.conv(y, P, f"upsample.{2 * k}"), 2)
    return nhwc(o.conv(y, P, "conv_last")) / r + mean


def manifest(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every (name, shape) of DAT's parameters and of its BatchNorms'
    running statistics (the position buffers are the model's own)."""
    c, nf, cin = cfg["embed_dim"], cfg["num_feat"], 3
    hidden = int(c * cfg["expansion_factor"])
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def conv(name, co, ci, k):
        out.extend([(name + ".weight", (co, ci, k, k)), (name + ".bias", (co,))])

    def lin(name, co, ci):
        out.extend([(name + ".weight", (co, ci)), (name + ".bias", (co,))])

    def norm(name, n):
        out.extend([(name + ".weight", (n,)), (name + ".bias", (n,))])

    def batch_norm(name, n):
        norm(name, n)
        out.extend([(name + ".running_mean", (n,)), (name + ".running_var", (n,))])

    conv("conv_first", c, cin, 3)
    norm("before_RG.1", c)
    for i, (depth, heads) in enumerate(zip(cfg["depth"], cfg["num_heads"])):
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}."
            a = b + "attn."
            norm(b + "norm1", c)
            lin(a + "qkv", 3 * c, c)
            lin(a + "proj", c, c)
            if j % 2 == 0:
                p = (c // 2 // 4) // 4
                for k in (0, 1):
                    pre = a + f"attns.{k}.pos."
                    lin(pre + "pos_proj", p, 2)
                    for m in (1, 2, 3):
                        norm(pre + f"pos{m}.0", p)
                        lin(pre + f"pos{m}.2", heads // 2 if m == 3 else p, p)
            else:
                out.append((a + "temperature", (heads, 1, 1)))
            out.append((a + "dwconv.0.weight", (c, 1, 3, 3)))
            out.append((a + "dwconv.0.bias", (c,)))
            batch_norm(a + "dwconv.1", c)
            conv(a + "channel_interaction.1", c // 8, c, 1)
            batch_norm(a + "channel_interaction.2", c // 8)
            conv(a + "channel_interaction.4", c, c // 8, 1)
            conv(a + "spatial_interaction.0", c // 16, c, 1)
            batch_norm(a + "spatial_interaction.1", c // 16)
            conv(a + "spatial_interaction.3", 1, c // 16, 1)
            norm(b + "norm2", c)
            lin(b + "ffn.fc1", hidden, c)
            norm(b + "ffn.sg.norm", hidden // 2)
            out.append((b + "ffn.sg.conv.weight", (hidden // 2, 1, 3, 3)))
            out.append((b + "ffn.sg.conv.bias", (hidden // 2,)))
            lin(b + "ffn.fc2", c, hidden // 2)
        conv(f"layers.{i}.conv", c, c, 3)
    norm("norm", c)
    conv("conv_after_body", c, c, 3)
    conv("conv_before_upsample.0", nf, c, 3)
    for k in range(int(math.log2(cfg["upscale"]))):
        conv(f"upsample.{2 * k}", 4 * nf, nf, 3)
    conv("conv_last", cin, nf, 3)
    return out


def seeded(P: Params) -> Params:
    """The benchmark's seeded draw (``harness/synth.py``, 1 + 0.05 z for a
    vector) turned into DAT's: BatchNorm means 0.2 z and variances
    exp(0.4 z), away from 0 and 1 so that no BatchNorm is the identity, and
    temperatures 1 + 0.25 z (DAT starts them at 1)."""
    out: Dict[str, torch.Tensor] = {}
    for k, t in P.items():
        if k.endswith("running_mean"):
            t = 4.0 * (t - 1.0)
        elif k.endswith("running_var"):
            t = torch.exp(8.0 * (t - 1.0))
        elif k.endswith("temperature"):
            t = 1.0 + 0.25 * t
        out[k] = t
    return out


def n_params(cfg) -> int:
    return sum(math.prod(s) for k, s in manifest(cfg) if not k.endswith(("running_mean",
                                                                          "running_var")))
