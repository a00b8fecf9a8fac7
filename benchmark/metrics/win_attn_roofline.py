"""The window attention's share of its roofline: the least time for the
work of every HAT attention the model calls ran (``work/hat.py``: q, k and
v read once and the output written once at the memory's rate, or QK^T and
the product with v at the dtype's peak, whichever is larger, per call at
the call's unpadded map size), over the device time of the kernels whose
name holds ``PATTERN``.  None when no such kernel ran."""

from benchmark.harness.peaks import least_seconds
from benchmark.work.hat import attention_work, key_window

PATTERN = "::win_attn_"


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.device_seconds(PATTERN)
    if device_s <= 0.0:
        return None
    cfg, dtype = ctx.cell.config, ctx.cell.traffic["dtype"]
    es = 2 if dtype == "bfloat16" else 4
    c, ws, wk = cfg["embed_dim"], cfg["window_size"], key_window(cfg)
    least = 0.0
    for b, h, w, _ in ctx.entry.spans.model_calls:
        least += b * sum(cfg["depths"]) * least_seconds(*attention_work(h, w, c, ws * ws, es),
                                                        dtype)
        least += b * len(cfg["depths"]) * least_seconds(*attention_work(h, w, c, wk * wk, es),
                                                        dtype)
    return 100.0 * least / device_s
