"""Work of HiT-SIR-Pro's layers, counted from shapes: operations (2 per
multiply-add) and bytes.  Frozen here so that a later change to the
program cannot change its own yardstick.

The SCC block's count is a copy of ``chip_smoke.py::_scc_work`` (the
kernel's normal form: the block-diagonal k synthesis and the pooling as
the products the kernel runs); the HTB tail's, of its ``htb_cases``
(fc1, the 5x5 depthwise conv, fc2).  A block's map is counted unpadded:
window padding is not useful work.
"""

from __future__ import annotations

from typing import Dict, List


def windows(cfg) -> List[int]:
    base = cfg["base_win_size"][0]
    return [int(base * r) for r in cfg["hier_win_ratios"]]


def scc_work(h: int, w: int, win: int, base: int = 8, c: int = 180, heads: int = 6,
             es: int = 2):
    """(bytes, operations) of one SCC block (SCA, correlation, projection)
    on an h x w map, ``es`` bytes an activation element."""
    half, d = c // 2, c // (2 * heads)
    lb, big_l = min(win, base) ** 2, win * win
    elems = (2 * h * w * c + h * w * 18 + big_l * heads * lb + c * half + c * c + 40 * c
             + big_l * lb)
    per_token = (18 * c + c * half + half * half + 2 * lb * half
                 + half * half + lb * half + half * half + c * c)
    return es * elems, 2.0 * h * w * per_token + 2.0 * (h * w // big_l) * lb * half * d


def tail_work(h: int, w: int, c: int = 180, ch: int = 360, es: int = 2, stats: bool = False):
    """(bytes, operations) of one HTB tail: LN1 residual, fc1, GELU, the
    5x5 depthwise conv, fc2, LN2 residual; attn and shortcut read once,
    the output written once, the weights read once; with ``stats`` the
    next block's float32 pool statistics written too."""
    weights = 2 * c * ch + 25 * ch + 2 * ch + 6 * c
    nbytes = es * (3 * h * w * c + weights) + (4 * (2 * h * w + 2 * c) if stats else 0)
    return nbytes, 2.0 * h * w * (2 * c * ch + 25 * ch)


def conv_ops(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * h * w * k * k * cin * cout


def body_blocks(cfg):
    """[(window, emits stats), ...] for every HTB in order; in evaluation
    each block but the last of a group emits the next one's statistics."""
    wins = windows(cfg)
    out = []
    for depth in cfg["depths"]:
        out += [(wins[j], j + 1 < depth) for j in range(depth)]
    return out


def layer_ops(cfg, h: int, w: int) -> Dict[str, float]:
    """Operations of one whole forward of an h x w LR image, by layer."""
    c, nf = cfg["embed_dim"], cfg["num_feat"]
    ch = int(c * cfg["mlp_ratio"])
    base = cfg["base_win_size"][0]
    heads = cfg["num_heads"][0]
    px = h * w
    ops = {
        "msce": 2.0 * px * (81 * 3 * 4 * c + 3 * c + 4 * c * c),
        "scc_block": sum(scc_work(h, w, win, base, c, heads)[1] for win, _ in body_blocks(cfg)),
        "htb_tail": len(body_blocks(cfg)) * tail_work(h, w, c, ch)[1],
        "conv3x3": (len(cfg["depths"]) + 1) * conv_ops(h, w, c, c) + conv_ops(h, w, c, nf),
        # three union attentions: conv_last (C -> C) and the three 2 -> 1
        # convs over the H x W, C x W and C x H pool grids
        "fusion": 3 * (conv_ops(h, w, c, c) + 36.0 * (px + c * w + c * h)),
        "head": (4 + 16 + 16) * conv_ops(h, w, nf, nf) + 16 * conv_ops(h, w, nf, 3),
    }
    return ops


def forward_ops(cfg, h: int, w: int) -> float:
    """Operations of one whole forward of an h x w LR image."""
    return sum(layer_ops(cfg, h, w).values())

