"""The traced window: torch.profiler over CPU and CUDA, reduced to what
the per-layer metrics and the breakdown read.

``Trace.from_profiler`` takes the profiler's raw events once (the kineto
events, without building PyTorch's event tree) into plain tuples:

- device events (kernels, copies, sets; not the device-side copies of the
  host's annotations, which span idle time): name, start, end in ns,
  whether a kernel;
- host events (operators, the benchmark's ``record_function`` spans,
  library ranges such as ``Optimizer.step#Adam.step``): name, start, end,
  thread.

Busy time is the union of the device events' intervals; an idle gap is a
stretch between two of them, labelled by the innermost benchmark span and
the innermost operator running on the host across its middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

# host events that say nothing of what the host was doing: CUDA runtime
# and driver calls, the profiler's own markers
_SKIP_PREFIXES = ("cuda", "cu", "ProfilerStep", "[memory]")
_SKIP_ACTIVITIES = ("cuda_runtime", "cuda_driver")
BENCH_SPAN = "bench."


def _activity(e):
    """The event's kineto activity type ('kernel', 'gpu_user_annotation',
    ...), or None where this PyTorch's events do not carry it."""
    fn = getattr(e, "activity_type", None)
    return fn() if fn is not None else None


def _ns(e, attr: str) -> int:
    fn = getattr(e, attr + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, attr + "_us")() * 1000)


class Trace:
    def __init__(self, device: List[Tuple[str, int, int, bool]],
                 host: List[Tuple[str, int, int, int]]):
        self.device = sorted(device, key=lambda t: t[1])
        self.host = host
        self._busy = None

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        dev_events, host = [], []
        for e in events:
            name = e.name()
            start, end = _ns(e, "start"), _ns(e, "end")
            if e.device_type() == DeviceType.CUDA:
                dev_events.append((name, start, end, _activity(e)))
            elif _activity(e) not in _SKIP_ACTIVITIES and not name.startswith(_SKIP_PREFIXES):
                host.append((name, start, end, int(e.start_thread_id())))
        # the device-side copy of a host range (a record_function) carries
        # the range's name; where the event has no activity type, that name
        # tells it from a kernel
        host_names = {n for n, _, _, _ in host}
        device = []
        for name, start, end, act in dev_events:
            if act is None:
                if name in host_names:
                    continue
                kernel = not name.startswith(("Memcpy", "Memset"))
            elif "annotation" in act:
                continue
            else:
                kernel = act == "kernel"
            device.append((name, start, end, kernel))
        return cls(device, host)

    # ------------------------------------------------------------ device

    def kernels(self) -> int:
        """The number of device events that are kernels (not copies or sets)."""
        return sum(1 for e in self.device if e[3])

    def busy_intervals(self) -> List[Tuple[int, int]]:
        if self._busy is None:
            merged: List[List[int]] = []
            for _, s, e, _ in self.device:
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._busy = [(s, e) for s, e in merged]
        return self._busy

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name holds ``pattern``."""
        return sum(e - s for n, s, e, _ in self.device if pattern in n) / 1e9

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for n, s, e, _ in self.device:
            by[n] += e - s
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:200], ns / 1e9] for n, ns in rows]

    # -------------------------------------------------------------- host

    def host_seconds(self, prefix: str) -> Tuple[float, int]:
        """(seconds, count) of the host ranges whose name starts with ``prefix``."""
        spans = [(s, e) for n, s, e, _ in self.host if n.startswith(prefix)]
        return sum(e - s for s, e in spans) / 1e9, len(spans)

    def _labels(self, points: List[int]) -> List[str]:
        """For each time in ``points`` (sorted), the innermost benchmark span
        and the innermost other host range covering it, on any thread."""
        by_thread: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
        for n, s, e, tid in self.host:
            by_thread[tid].append((s, -e, n))
        inner: List[List[Tuple[int, str]]] = [[] for _ in points]   # (start, name)
        spans: List[List[Tuple[int, str]]] = [[] for _ in points]
        for evs in by_thread.values():
            evs.sort()
            # ranges on one thread nest: sweep events and points in time
            # order with a stack of the ranges open at the current time
            stack: List[Tuple[int, int, str]] = []
            i = 0
            for k, p in enumerate(points):
                while i < len(evs) and evs[i][0] <= p:
                    s, neg_e, n = evs[i]
                    while stack and stack[-1][1] < s:
                        stack.pop()
                    stack.append((s, -neg_e, n))
                    i += 1
                while stack and stack[-1][1] < p:
                    stack.pop()
                seen_op = seen_span = False
                for s, e, n in reversed(stack):
                    if e < p:
                        continue
                    if n.startswith(BENCH_SPAN):
                        if not seen_span:
                            spans[k].append((s, n))
                            seen_span = True
                    elif not seen_op:
                        inner[k].append((s, n))
                        seen_op = True
                    if seen_op and seen_span:
                        break
        out = []
        for a, b in zip(spans, inner):
            span = max(a)[1] if a else "no span"
            op = max(b)[1] if b else "no op"
            out.append(f"{span} / {op}")
        return out

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds summed by label, largest first: the gaps between
        device activity, each labelled at its middle."""
        busy = self.busy_intervals()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        if not gaps:
            return []
        # the longest gaps carry nearly all idle time; label those
        gaps.sort(key=lambda g: g[0] - g[1])
        gaps = gaps[:20000]
        gaps.sort()
        labels = self._labels([(s + e) // 2 for s, e in gaps])
        by: Dict[str, int] = defaultdict(int)
        for (s, e), lab in zip(gaps, labels):
            by[lab] += e - s
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:200], ns / 1e9] for n, ns in rows]


def profile():
    """A profiler over CPU and CUDA (where there is a card), without shapes
    or stacks."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return _profile(activities=acts)
