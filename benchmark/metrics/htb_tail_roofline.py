"""The HTB tails' share of their roofline: the least time for the work of
every HTB tail the model calls ran (``work/hitsir.py::tail_work`` per
block at the call's map size: each byte read or written once at the
memory's rate, or the operations at the dtype's peak, whichever is
larger), over the device time of the kernels whose name holds
``PATTERN``.  None when no such kernel ran (renamed or fused away)."""

from benchmark.harness.peaks import least_seconds
from benchmark.work.hitsir import body_blocks, tail_work

PATTERN = "::htb_tail_"


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.device_seconds(PATTERN)
    if device_s <= 0.0:
        return None
    cfg, dtype = ctx.cell.config, ctx.cell.traffic["dtype"]
    es = 2 if dtype == "bfloat16" else 4
    c = cfg["embed_dim"]
    least = 0.0
    for b, h, w, stage in ctx.entry.spans.model_calls:
        if stage == "head":
            continue
        for _, stats in body_blocks(cfg):
            least += b * least_seconds(*tail_work(h, w, c, int(c * cfg["mlp_ratio"]), es,
                                                  stats), dtype)
    return 100.0 * least / device_s
