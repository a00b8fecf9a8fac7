"""Tracing (port of ``sisr_tpu/utils/profiling.py``).

The reference's only observability is wall-clock bookkeeping in text logs
(experiments/experiment.py:398-402,540-547).  Here:

* ``trace(logdir)``  context manager around ``torch.profiler`` (CPU and,
  where a card is present, CUDA activity); writes a Chrome trace to
  ``logdir/trace.json`` and returns the profiler for ``key_averages()``.
  Wrap any run in it: the program's ``sisr.*`` spans lie on the host
  timeline beside the kernels they launch, on one clock.
* ``span(name)``     a ``record_function`` range named ``sisr.<name>``
  while a profiler is on, else a shared no-op context: with tracing off a
  span costs one check of the profiler's state (under a microsecond) and
  builds no ``record_function``.

The spans and what each bounds:

* ``sisr.tiler``: one ``TiledSR`` request (pad, tile plan, weight map and
  its copy to the device, canvas, blend, crop);
  ``sisr.tiler.model``: one chunk of tiles through the model.
* ``sisr.kernel.<name>``: a hand-written kernel's Python wrapper (checks,
  casts, buffers, the launch), with ``build.launches[name]`` counted on the
  same boundary (``ops/kernels/build.py::launched``).
* ``sisr.step.forward``: a training step's generator forward and its
  losses (in GAN mode with the VGG19 and discriminator forwards of the
  generator's loss); ``sisr.step.backward``: its ``loss.backward()``.
* ``sisr.vjp.<name>``: one kernel's backward through ``KernelFunction``
  (the plain forward recomputed and differentiated, or the kernel's own
  vjp), on the autograd engine's thread.
* ``sisr.replay.<name>``: inside ``sisr.vjp.<name>``, the plain recompute
  replayed as its signature's CUDA graph (the copies in, the replay, the
  copies out); ``sisr.recompute.<name>``: inside it, the plain recompute
  run eager (a signature's first sighting, its capture, a fallback, or
  CPU tensors).  ``ops/kernels/autograd.py`` says which runs when.
* ``sisr.forward.replay``: a model's forward inside
  ``replayed_forwards()`` (``TiledSR``'s tiles, so inside
  ``sisr.tiler.model``) replayed as its signature's CUDA graph (the copy
  in, the replay, the copy out); ``sisr.forward.eager``: any other forward
  under that switch (a signature's first sighting, its capture, a
  fallback, CPU tensors).  ``ops/kernels/autograd.py::replayed_forward``
  says which runs when.
* ``sisr.derive.<kind>``: derived weights or weight packs made anew
  (``arch_util.derived`` under grad or on a miss, ``build.cached`` on a
  miss).
* ``sisr.hat.cab``: a HAT block's channel-attention branch (its two convs
  and the gate); ``sisr.hat.pad``: HAT's reflect pad of the input to
  multiples of its window, and the crop of the output.
* ``sisr.dat.aim``: a DAT block's Adaptive Interaction Module (the depthwise
  conv branch and both gates, after the attention); ``sisr.dat.sgfn``: a DAT
  block's spatial-gate feed-forward network (fc1 to fc2).
* ``sisr.loader.wait``: the runner waiting for its next train batch
  (``Experiment.train_steps``, the interval ``train_wait_s`` times);
  ``sisr.ckpt.save``: one checkpoint written (``save_model_weights``).

The ``bench.`` prefix is the benchmark's own.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch._C._autograd import _profiler_enabled

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function("sisr." + name)`` while a profiler is on, else a
    shared no-op context."""
    if _profiler_enabled():
        return torch.autograd.profiler.record_function("sisr." + name)
    return _OFF


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
