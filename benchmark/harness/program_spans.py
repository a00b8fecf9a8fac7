"""The program's own spans in the traced window: ``record_function`` ranges
named ``sisr.<layer>`` that ``sisr_tpu_torch`` opens while a profiler is on
(``sisr_tpu_torch/utils/profiling.py``).  A program without them yields
nothing here, and each reader of these numbers then returns None.

- ``self_time``: a span's duration less its direct ``sisr.*`` children on
  the same thread (``sisr.tiler`` less its ``sisr.tiler.model`` calls);
  ``Trace.host_seconds`` sums every range whose name starts with a prefix,
  so nested spans would count twice there.
- ``idle_in_self``: the device-idle time whose gaps fall, at their middle,
  inside a span's self time: the rule the breakdown labels gaps by.
- ``covered``: the time in which some span of a family is open, per thread
  (a kernel's recompute may nest another's: the HTB tail's runs dwconv5x5's).
- ``duration``: the summed durations of the spans of one name.

Times are the trace's ns; results are seconds.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

PREFIX = "sisr."

Interval = Tuple[int, int]


def _spans(trace) -> List[Tuple[str, int, int, int, List[Interval]]]:
    """Every ``sisr.*`` host range as (name, start, end, thread, direct
    children's intervals), the children found by nesting on one thread."""
    by_thread: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    for n, s, e, tid in trace.host:
        if n.startswith(PREFIX):
            by_thread[tid].append((s, -e, n))
    out = []
    for tid, evs in by_thread.items():
        evs.sort()
        stack: List[int] = []
        for s, neg_e, n in evs:
            e = -neg_e
            while stack and out[stack[-1]][2] <= s:
                stack.pop()
            if stack:
                parent = out[stack[-1]]
                parent[4].append((s, min(e, parent[2])))
            out.append((n, s, e, tid, []))
            stack.append(len(out) - 1)
    return out


def _matcher(name: str) -> Callable[[str], bool]:
    """``name`` exactly, or every name under it when it ends in a dot."""
    if name.endswith("."):
        return lambda n: n.startswith(name)
    return lambda n: n == name


def _self_intervals(s: int, e: int, children: List[Interval]) -> List[Interval]:
    out, cursor = [], s
    for cs, ce in sorted(children):
        if cs > cursor:
            out.append((cursor, cs))
        cursor = max(cursor, ce)
    if cursor < e:
        out.append((cursor, e))
    return out


def self_intervals(trace, name: str) -> Tuple[List[Interval], int]:
    """(the self-time intervals of every span matching ``name``, the
    number of such spans)."""
    match = _matcher(name)
    out, count = [], 0
    for n, s, e, _, children in _spans(trace):
        if match(n):
            out.extend(_self_intervals(s, e, children))
            count += 1
    return out, count


def self_time(trace, name: str) -> Tuple[float, int]:
    """(self seconds summed over the spans matching ``name``, their count)."""
    intervals, count = self_intervals(trace, name)
    return sum(e - s for s, e in intervals) / 1e9, count


def idle_in_self(trace, name: str) -> Tuple[float, int]:
    """(device-idle seconds of the gaps whose middle lies in the self time
    of a span matching ``name``, the number of such spans)."""
    spans, count = self_intervals(trace, name)
    intervals: List[List[int]] = []          # merged: spans of two threads may overlap
    for s, e in sorted(spans):
        if intervals and s <= intervals[-1][1]:
            intervals[-1][1] = max(intervals[-1][1], e)
        else:
            intervals.append([s, e])
    starts = [s for s, _ in intervals]
    busy = trace.busy_intervals()
    idle = 0
    for (_, gs), (ge, _) in zip(busy, busy[1:]):
        mid = (gs + ge) // 2
        k = bisect_right(starts, mid) - 1
        if ge > gs and k >= 0 and mid < intervals[k][1]:
            idle += ge - gs
    return idle / 1e9, count


def covered(trace, name: str) -> Tuple[float, int]:
    """(seconds in which a span matching ``name`` is open, summed over
    threads, the number of such spans)."""
    match = _matcher(name)
    by_thread: Dict[int, List[Interval]] = defaultdict(list)
    for n, s, e, tid in trace.host:
        if n.startswith(PREFIX) and match(n):
            by_thread[tid].append((s, e))
    total = count = 0
    for spans in by_thread.values():
        spans.sort()
        count += len(spans)
        end = None
        for s, e in spans:
            if end is None or s >= end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
    return total / 1e9, count


def duration(trace, name: str) -> Tuple[float, int]:
    """(summed seconds of the spans matching ``name``, their count)."""
    match = _matcher(name)
    spans = [e - s for n, s, e, _ in trace.host if n.startswith(PREFIX) and match(n)]
    return sum(spans) / 1e9, len(spans)
