"""The window attention's share of its roofline in DAT's frames: the least
time for the work of every spatial block's attention the model calls ran
(``work/dat.py``: both branches, 256 keys a query, over the call's
unpadded map; q, k and v read once and the output written once at the
memory's rate, or QK^T and the product with v at the dtype's peak,
whichever is larger), over the device time of the kernels whose name holds
``PATTERN``.  None when no such kernel ran."""

from benchmark.harness.peaks import least_seconds
from benchmark.work.dat import counts, window_keys
from benchmark.work.hat import attention_work

PATTERN = "::win_attn_"


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.device_seconds(PATTERN)
    if device_s <= 0.0:
        return None
    cfg, dtype = ctx.cell.config, ctx.cell.traffic["dtype"]
    es = 2 if dtype == "bfloat16" else 4
    spatial, _ = counts(cfg)
    least = sum(b * spatial * least_seconds(*attention_work(h, w, cfg["embed_dim"],
                                                            window_keys(cfg), es), dtype)
                for b, h, w, _ in ctx.entry.spans.model_calls)
    return 100.0 * least / device_s
