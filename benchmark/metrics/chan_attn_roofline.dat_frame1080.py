"""The channel attention's sums' share of their roofline in DAT's frames:
the least time for every channel block's whole-image sums the model calls
ran (``work/dat.py``: q and k read once at the memory's rate, or the Gram
and the norms at the dtype's peak, whichever is larger: the bytes), over
the device time of the kernels whose name holds ``PATTERN`` (the reduce
and the sum of the slots).  The product with v runs on ``torch.matmul``
and is not counted.  None when no such kernel ran."""

from benchmark.harness.peaks import least_seconds
from benchmark.work.dat import chan_attn_work, counts

PATTERN = "::chan_attn_"


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.device_seconds(PATTERN)
    if device_s <= 0.0:
        return None
    cfg, dtype = ctx.cell.config, ctx.cell.traffic["dtype"]
    es = 2 if dtype == "bfloat16" else 4
    c = cfg["embed_dim"]
    _, channel = counts(cfg)
    least = sum(b * channel * least_seconds(*chan_attn_work(h, w, c, c // cfg["num_heads"][0],
                                                            es), dtype)
                for b, h, w, _ in ctx.entry.spans.model_calls)
    return 100.0 * least / device_s
