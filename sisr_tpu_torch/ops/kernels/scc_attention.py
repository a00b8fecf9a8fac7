"""Spatial-Channel Correlation in its algebraic normal form: the plain
reference and the parameter builders of
``sisr_tpu/ops/pallas/scc_attention.py``.

Every step is a plain matmul: block-diagonal k-generation, a pooling matrix
with one nonzero per column, head-tiled and masked K/V, and the channel
gram.  The kernel that runs it is ``scc_block.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sisr_tpu_torch.ops import dropout as drop
from sisr_tpu_torch.utils.constants import device_constant


def scc_reference(x, w1, w2, bb, pmat, pb, mask, bias, heads: int,
                  value_drop: float = 0.0, rng: drop.Rng = None):
    """Plain reference of the window attention.

    x:    (B, nWh, wh, nWw, ww, C)  [pure reshape of NHWC input]
    w1/w2:(C/2, C/2) block-diagonal k-gen weights (already halved)
    bb:   (1, C/2) combined k-gen bias (already halved)
    pmat: (l_base, L) learned-pooling matrix (weights only)
    pb:   (1, 1) float32 pooling bias, added to every pooled entry
    mask: (heads*l_base, C/2) 0/1 block-diagonal head mask
    bias: (L, heads*l_base) relative-position bias
    value_drop: dropout on the pooled values of the spatial branch and on
          the values of the channel branch (training with the reference's
          ``value_drop_rate``, JAX ``_reference_with_dropout``), its
          masks drawn from ``rng`` (``ops/dropout.py``) with the batch
          leading, as a rank's slice of the global batch's masks
    returns (B, nWh, wh, nWw, ww, C) float32 concat [S-SC | C-SC]: the
    float32 ``pb`` promotes the spatial branch to float32, as in JAX.
    """
    b, nwh, wh, nww, ww, c = x.shape
    half = c // 2
    l_full = wh * ww
    d = half // heads
    f32 = torch.float32

    xw = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, l_full, c)
    q, v = xw[..., :half], xw[..., half:]
    k = q @ w1 + v @ w2 + bb
    pbs = pb.reshape(()).to(f32)
    k_pool = torch.einsum("ml,blc->bmc", pmat, k).to(f32) + pbs
    v_pool = torch.einsum("ml,blc->bmc", pmat, v).to(f32) + pbs
    if value_drop:
        v_pool = drop.dropout(v_pool.reshape(b, -1, *v_pool.shape[1:]), value_drop,
                              rng).reshape(v_pool.shape)

    def big(t):  # (nwb, l_base, half) -> masked head-tiled (nwb, heads*l_base, half)
        return t.repeat(1, heads, 1) * mask.to(f32)

    corr = (torch.einsum("blc,bmc->blm", q.to(f32), big(k_pool)) / float(d)
            + bias.to(f32))
    out_s = torch.einsum("blm,bmc->blc", corr, big(v_pool))

    gram = torch.einsum("blc,bld->bcd", q, k) / float(l_full)
    if value_drop:
        v = drop.dropout(v.reshape(b, -1, *v.shape[1:]), value_drop, rng).reshape(v.shape)
    out_c = torch.einsum("bld,bcd->blc", v, gram)

    out = torch.cat([out_s, out_c.to(f32)], dim=-1)
    return out.reshape(b, nwh, nww, wh, ww, c).permute(0, 1, 3, 2, 4, 5)


def blockdiag_kgen(k1_kernel, k1_bias, k2_kernel, k2_bias, heads: int):
    """(d,d)+(d,) per-head k-gen params (flax (in, out) layout) -> halved
    block-diagonal (C/2, C/2) weights + combined (1, C/2) bias for
    ``k = (k1(q) + k2(v)) / 2``."""
    d = k1_kernel.shape[0]
    eye = torch.eye(heads, dtype=k1_kernel.dtype, device=k1_kernel.device)

    def expand(kk):
        return torch.einsum("de,hg->hdge", kk, eye).reshape(heads * d, heads * d)

    w1 = expand(k1_kernel) * 0.5
    w2 = expand(k2_kernel) * 0.5
    bb = (k1_bias.repeat(heads) + k2_bias.repeat(heads)) * 0.5
    return w1, w2, bb.reshape(1, heads * d)


@functools.lru_cache(maxsize=64)
def _pool_structure(wh: int, ww: int, bh: int, bw: int):
    """Constant one-hot structure of the pooling matrix: ``sel`` (L, rh*rw)
    picks pixel l's in-block offset; ``oh`` (l_base, L) marks pixel l's base
    cell.  Callers must not write to the returned arrays."""
    rh, rw = wh // bh, ww // bw
    y, x = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    by, bx = y // rh, x // rw
    ry, rx = y % rh, x % rw
    m_of_l = (by * bw + bx).reshape(-1)
    r_of_l = (ry * rw + rx).reshape(-1)
    l_full = wh * ww
    sel = np.zeros((l_full, rh * rw), np.float32)
    sel[np.arange(l_full), r_of_l] = 1.0
    oh = np.zeros((bh * bw, l_full), np.float32)
    oh[m_of_l, np.arange(l_full)] = 1.0
    return sel, oh


def _pool_select(wh: int, ww: int, bh: int, bw: int) -> np.ndarray:
    return _pool_structure(wh, ww, bh, bw)[0]


def _pool_onehot(wh: int, ww: int, bh: int, bw: int) -> np.ndarray:
    return _pool_structure(wh, ww, bh, bw)[1]


def pooling_matrix(pool_kernel, pool_bias, wh, ww, bh, bw, dtype):
    """Learned pooling as a (l_base, L) matrix + (1, 1) float32 bias.

    Column l has a single nonzero: the learned pool weight of pixel l's
    in-block offset.  ``pool_kernel`` is (rh*rw, 1) in flax layout."""
    dev = pool_kernel.device
    sel, oh = (device_constant(fn, (wh, ww, bh, bw), dtype, dev)
               for fn in (_pool_select, _pool_onehot))
    weights = (sel * pool_kernel.reshape(-1).to(dtype)[None, :]).sum(-1)
    pmat = oh * weights[None, :]
    return pmat, pool_bias.reshape(1, 1).to(torch.float32)


def _head_mask(heads: int, l_base: int, half: int) -> np.ndarray:
    d = half // heads
    m = np.zeros((heads, l_base, heads, d), np.float32)
    for h in range(heads):
        m[h, :, h, :] = 1.0
    return m.reshape(heads * l_base, half)


def head_mask(heads: int, l_base: int, half: int, dtype, device=None):
    """(heads*l_base, C/2) 0/1 block-diagonal mask (shared: callers must
    not write to it)."""
    return device_constant(_head_mask, (heads, l_base, half), dtype,
                           torch.device(device or "cpu"))
