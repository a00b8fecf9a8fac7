"""Work of DAT's layers, counted from shapes: operations (2 per
multiply-add) and bytes, on the unpadded LR map (window padding is not
work).  A spatial block's window attention counts its QK^T and its product
with v over the 256 keys of each query's window, both branches; a channel
block's attention its whole-image Gram (a d x d product a head a pixel)
and its product with v (the same), as DAT defines them, not the 6x of the
block-diagonal matmul that applies them.  LayerNorms, BatchNorms,
activations, the gates' elementwise products and the residual adds are
left out; the depthwise convs and the 1x1 spatial gate are in (`aim`,
`sgfn`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from benchmark.work.hat import attention_work


def counts(cfg) -> Tuple[int, int]:
    """(spatial blocks, channel blocks) of a forward."""
    spatial = sum((d + 1) // 2 for d in cfg["depth"])
    return spatial, sum(cfg["depth"]) - spatial


def window_keys(cfg) -> int:
    return cfg["split_size"][0] * cfg["split_size"][1]


def chan_attn_work(h: int, w: int, c: int, d: int, es: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one channel attention's whole-image sums on
    an h x w map: q and k read once, ``es`` bytes an element; the Gram and
    both squared norms."""
    return es * 2 * h * w * c, 2.0 * h * w * (c * d + 2 * c)


def layer_ops(cfg, h: int, w: int) -> Dict[str, float]:
    """Operations of one whole forward of an h x w LR image, by layer."""
    c, nf = cfg["embed_dim"], cfg["num_feat"]
    hidden = int(c * cfg["expansion_factor"])
    blocks = sum(cfg["depth"])
    spatial, channel = counts(cfg)
    d = c // cfg["num_heads"][0]
    px = h * w
    s = cfg["upscale"]
    ups = sum(4 ** k * 9 * nf * 4 * nf for k in range(int(math.log2(s))))
    return {
        "conv_first": 2.0 * px * 9 * 3 * c,
        "linears": 2.0 * px * (3 * c * c + c * c + c * hidden + hidden // 2 * c) * blocks,
        "win_attn": spatial * attention_work(h, w, c, window_keys(cfg))[1],
        "chan_attn": channel * 2.0 * px * 2 * c * d,
        "aim": 2.0 * px * (9 * c + c * (c // 16) + c // 16) * blocks,
        "sgfn_dwconv": 2.0 * px * 9 * (hidden // 2) * blocks,
        "conv3x3": 2.0 * px * 9 * c * (c * (len(cfg["depth"]) + 1) + nf),
        "head": 2.0 * px * (ups + s * s * 9 * nf * 3),
    }


def forward_ops(cfg, h: int, w: int) -> float:
    """Operations of one whole forward of an h x w LR image."""
    return sum(layer_ops(cfg, h, w).values())
