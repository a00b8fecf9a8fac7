"""Small bookkeeping utilities (reference utils/utils.py:95-116, :308-323;
a copy of ``sisr_tpu/utils/meters.py``).  The experiment's text logs are
parsed back on resume, so ``format_str`` must format byte for byte as the
reference does; it is given Python numbers only."""

from __future__ import annotations


class AverageMeter:
    """Tracks value / running sum / count / mean of a streamed statistic."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def format_str(num, digit: int = 18, padding: str = "0") -> str:
    """Right-pad the string form of ``num`` to ``digit`` characters.

    Log-file formatting parity with the reference (fixed-width numeric
    columns parsed back by resume)."""
    s = str(num)
    if len(s) >= digit:
        return s
    return (s + padding * digit)[:digit]
