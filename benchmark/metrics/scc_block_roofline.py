"""The SCC blocks' share of their roofline: the least time for the work of
every SCC block the model calls ran (``work/hitsir.py::scc_work`` per
block at the call's map size: bytes at the memory's rate or operations
at the dtype's peak, whichever is larger), over the device time of the
kernels whose name holds ``PATTERN``.  None when no such kernel ran."""

from benchmark.harness.peaks import least_seconds
from benchmark.work.hitsir import body_blocks, scc_work

PATTERN = "::scc_"


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.device_seconds(PATTERN)
    if device_s <= 0.0:
        return None
    cfg, dtype = ctx.cell.config, ctx.cell.traffic["dtype"]
    es = 2 if dtype == "bfloat16" else 4
    base, heads = cfg["base_win_size"][0], cfg["num_heads"][0]
    least = 0.0
    for b, h, w, stage in ctx.entry.spans.model_calls:
        if stage == "head":
            continue
        for win, _ in body_blocks(cfg):
            least += b * least_seconds(*scc_work(h, w, win, base, cfg["embed_dim"], heads, es),
                                       dtype)
    return 100.0 * least / device_s
