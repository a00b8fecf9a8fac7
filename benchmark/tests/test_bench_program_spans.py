"""The readers of the program's ``sisr.*`` spans (``harness/program_spans.py``
and the metrics that use it).

- On a hand-built ``Trace(device, host)`` with nested spans on two threads:
  self time less direct children, idle gaps attributed by their middle to a
  span's self time, the open time of a family counted once where its spans
  nest, plain durations.
- Traced tiny runs on the CPU report what the spans allow there: in the
  photos cell ``tiler_ms``; in the training cells ``forward_ms``,
  ``backward_ms`` and ``derive_ms``.  Absent on the CPU, by design:
  ``tiler_idle_ms`` (no device event ran, so no gap to attribute),
  ``kernel_host_us`` and ``recompute_ms`` (CPU tensors run the plain
  versions: no kernel wrapper, no ``KernelFunction``).
- A trace without the program's spans (the program before them) gives
  None from every reader.
"""

import pytest

import benchmark.run as bench_run
from benchmark.harness import program_spans as ps
from benchmark.harness.spec import load_module
from benchmark.harness.trace import Trace
from benchmark.tests.tiny import tiny_cell

MS = 1_000_000     # ns

# thread 1: a request [0, 100) ms with model calls [10, 40) and [60, 70), a
# kernel wrapper [20, 25) inside the first; thread 2: a vjp [30, 50) with a
# nested vjp [35, 45), and a derive [80, 90)
HOST = [
    ("sisr.tiler", 0, 100 * MS, 1),
    ("sisr.tiler.model", 10 * MS, 40 * MS, 1),
    ("sisr.kernel.conv3x3", 20 * MS, 25 * MS, 1),
    ("aten::add", 21 * MS, 22 * MS, 1),
    ("sisr.tiler.model", 60 * MS, 70 * MS, 1),
    ("sisr.vjp.htb_tail", 30 * MS, 50 * MS, 2),
    ("sisr.vjp.dwconv5x5", 35 * MS, 45 * MS, 2),
    ("sisr.derive.conv", 80 * MS, 90 * MS, 2),
    ("bench.request", 0, 100 * MS, 1),
]
# busy [0, 4), [8, 12), [30, 34), [50, 56), [72, 76) ms: gaps with middles
# at 6 (the request's self time), 21 (the kernel wrapper), 42 (self), 64 (a
# model call); nothing after the last busy interval is a gap
DEVICE = [("k", s * MS, e * MS, True) for s, e in
          ((0, 4), (8, 12), (30, 34), (50, 56), (72, 76))]


def _trace():
    return Trace(DEVICE, HOST)


def test_self_time_less_direct_children():
    tr = _trace()
    # 100 less the two model calls (30 + 10); the kernel is a grandchild
    assert ps.self_time(tr, "sisr.tiler") == (pytest.approx(0.060), 1)
    # each model call less its kernel wrapper: 25 + 10
    assert ps.self_time(tr, "sisr.tiler.model") == (pytest.approx(0.035), 2)
    assert ps.self_time(tr, "sisr.kernel.") == (pytest.approx(0.005), 1)
    # the outer vjp less the nested one, on the second thread
    assert ps.self_time(tr, "sisr.vjp.htb_tail") == (pytest.approx(0.010), 1)
    assert ps.self_time(tr, "sisr.missing") == (0.0, 0)


def test_idle_attributed_by_the_gaps_middle():
    tr = _trace()
    # gaps (4, 8) mid 6 in self; (12, 30) mid 21 in a model call; (34, 50)
    # mid 42 in self; (56, 72) mid 64 in a model call
    assert ps.idle_in_self(tr, "sisr.tiler") == (pytest.approx(0.020), 1)
    # 21 lies in the kernel wrapper inside the first model call: not its self
    assert ps.idle_in_self(tr, "sisr.tiler.model") == (pytest.approx(0.016), 2)
    # the derive span [80, 90) lies after the last busy interval: no gap
    assert ps.idle_in_self(tr, "sisr.derive.") == (0.0, 1)


def test_covered_counts_nested_spans_once():
    tr = _trace()
    assert ps.covered(tr, "sisr.vjp.") == (pytest.approx(0.020), 2)
    assert ps.covered(tr, "sisr.tiler.model") == (pytest.approx(0.040), 2)
    # the family's spans of both threads summed
    assert ps.covered(tr, "sisr.") == (pytest.approx(0.100 + 0.020 + 0.010), 7)


def test_duration_by_exact_name():
    tr = _trace()
    assert ps.duration(tr, "sisr.tiler") == (pytest.approx(0.100), 1)
    assert ps.duration(tr, "sisr.tiler.model") == (pytest.approx(0.040), 2)


class _Window:
    seconds, count, steps = 1.0, 2, 2


class _Ctx:
    def __init__(self, trace):
        self.trace, self.window = trace, _Window()


NEW = ("tiler_ms.photos", "tiler_idle_ms.photos", "kernel_host_us.photos",
       "forward_ms.train.psnr", "backward_ms.train.psnr", "recompute_ms.train.psnr",
       "derive_ms.train.psnr")


def test_readers_on_the_hand_built_trace():
    ctx = _Ctx(_trace())
    got = {n: load_module("metrics", n).read(ctx) for n in NEW}
    assert got["tiler_ms.photos"] == pytest.approx(30.0)        # 60 ms over 2 requests
    assert got["tiler_idle_ms.photos"] == pytest.approx(10.0)
    assert got["kernel_host_us.photos"] == pytest.approx(5000.0)
    assert got["recompute_ms.train.psnr"] == pytest.approx(10.0)
    assert got["derive_ms.train.psnr"] == pytest.approx(5.0)
    assert got["forward_ms.train.psnr"] is None                 # no such span
    assert got["backward_ms.train.psnr"] is None


def test_readers_without_the_programs_spans_return_none():
    bare = Trace(DEVICE, [h for h in HOST if not h[0].startswith("sisr.")])
    for n in NEW:
        assert load_module("metrics", n).read(_Ctx(bare)) is None, n
        assert load_module("metrics", n).read(_Ctx(None)) is None, n


CPU_SPANS = {
    "hitsir_pro.photos.bf16": {"tiler_ms.photos"},
    "hitsir_pro.train.f32": {"forward_ms.train.psnr", "backward_ms.train.psnr",
                             "derive_ms.train.psnr"},
    "hitsir_pro_gan.train.f32": {"forward_ms.train.gan", "backward_ms.train.gan",
                                 "derive_ms.train.gan"},
}
CPU_ABSENT = {
    "hitsir_pro.photos.bf16": {"tiler_idle_ms.photos", "kernel_host_us.photos"},
    "hitsir_pro.train.f32": {"recompute_ms.train.psnr"},
    "hitsir_pro_gan.train.f32": {"recompute_ms.train.gan"},
}


@pytest.mark.parametrize("name", sorted(CPU_SPANS))
def test_traced_tiny_run_reports_the_span_metrics_the_cpu_allows(name):
    res = bench_run.run(name, 2**31 + 91, 2.0, True, device="cpu", require_device=False,
                        cell=tiny_cell(name))
    assert res["correct"] is True, res["checks"]
    got = res["metrics"]
    assert CPU_SPANS[name] <= set(got)
    assert not CPU_ABSENT[name] & set(got)
    assert all(got[n]["value"] > 0 for n in CPU_SPANS[name])
    if "train" in name:
        v = lambda m: got[f"{m}.train.{'gan' if 'gan' in name else 'psnr'}"]["value"]
        step_ms = res["device"]["window_s"] / res["attempted"] * 1e3
        assert v("forward_ms") + v("backward_ms") < step_ms
        assert v("derive_ms") < v("forward_ms")
