"""Work of HAT's layers, counted from shapes: operations (2 per
multiply-add) and bytes, on the unpadded LR map (window padding is not
work).  A window attention counts its QK^T and its product with v over
every key the model defines: the window's own for a HAB, the overlapping
square's (zero keys at the edge included) for an OCAB.  LayerNorms,
activations, the channel attention's pooled 1x1 convs and the residual adds
are left out (under 0.1% of the operations).
"""

from __future__ import annotations

import math
from typing import Dict

from benchmark.reference.hat import key_window


def attention_work(h: int, w: int, c: int, keys: int, es: int = 2):
    """(bytes, operations) of one window attention over an h x w map with
    ``keys`` keys a query: q, k and v read once and the output written once,
    ``es`` bytes an element; QK^T and the product with v."""
    return es * 4 * h * w * c, 2.0 * 2 * h * w * keys * c


def layer_ops(cfg, h: int, w: int) -> Dict[str, float]:
    """Operations of one whole forward of an h x w LR image, by layer."""
    c, nf = cfg["embed_dim"], cfg["num_feat"]
    hidden = int(c * cfg["mlp_ratio"])
    cc = c // cfg["compress_ratio"]
    ws, wk = cfg["window_size"], key_window(cfg)
    habs, ocabs = sum(cfg["depths"]), len(cfg["depths"])       # an OCAB and a conv a group
    px = h * w
    linears = 3 * c * c + c * c + 2 * c * hidden              # qkv, proj, fc1, fc2
    s = cfg["upscale"]
    ups = sum(4 ** k * 9 * nf * 4 * nf for k in range(int(math.log2(s))))
    return {
        "conv_first": 2.0 * px * 9 * 3 * c,
        "linears": 2.0 * px * linears * (habs + ocabs),
        "win_attn": (habs * attention_work(h, w, c, ws * ws)[1]
                     + ocabs * attention_work(h, w, c, wk * wk)[1]),
        "cab": 2.0 * px * 2 * 9 * c * cc * habs,
        "conv3x3": 2.0 * px * 9 * c * (c * (ocabs + 1) + nf),
        "head": 2.0 * px * (ups + s * s * 9 * nf * 3),
    }


def forward_ops(cfg, h: int, w: int) -> float:
    """Operations of one whole forward of an h x w LR image."""
    return sum(layer_ops(cfg, h, w).values())
