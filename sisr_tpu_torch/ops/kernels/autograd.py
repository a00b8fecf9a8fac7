"""Gradients through the hand-written kernels, as the JAX package's
``jax.custom_vjp``s give them.

``KernelFunction(name, kernel, plain)`` is a callable with ``plain``'s
signature.  Its forward runs ``kernel`` and saves the *inputs* (no
activations); its backward recomputes ``plain`` from them under autograd and
returns ``torch.autograd.grad`` of it for the inputs that need one: the vjp
of the plain version, as each JAX backward is ``jax.vjp`` of its reference.
A kernel with a backward kernel of its own (``dwconv.py``) passes ``vjp``.
The backward runs inside a ``sisr.vjp.<name>`` span (on the autograd
engine's thread).

On a card the plain recompute is replayed as a CUDA graph, one per input
signature (the kernel, each leaf's shape, stride, dtype and device, which
inputs need a gradient, the non-tensor arguments, each cotangent's shape,
stride and dtype, the TF32 and determinism settings): the host then launches one graph in place of walking
hundreds of small ops under autograd.  The first sighting of a signature
runs eager (it makes the library handles, workspaces and device constants
that a capture must not create).  The second copies its tensors into
static buffers, runs eager on them on the capture stream (torch's warm-up
before a capture; its gradients are this call's) and captures
``_plain_vjp`` on them.  Later ones copy in, replay and copy the gradients
out: a replay overwrites its outputs, and one signature runs many times in
one backward.  The same ops run in the same order, so the gradients are
the eager ones.  ``build.launches`` credits a replay with the wrapper
calls its capture recorded (the HTB tail's recompute runs ``dwconv5x5``),
so that it keeps counting the kernels that ran.  A signature whose capture
raises stays eager, with one warning.  At most ``MAX_SIGNATURES``
signatures are remembered, least recently used dropped first; a graph
holds static copies of its call's inputs, cotangents and gradients, and
the graphs of a device share one memory pool, as large as the largest
recompute's working set (the flagship's float32 step at batch 2, LR 64x64:
15 graphs, 0.48 GiB more allocated and 0.87 GiB more reserved on an H100,
0.6-0.85 s of captures).  CPU tensors and a kernel's own ``vjp`` run as they are.  Inside
``sisr.vjp.<name>`` a replay is traced as ``sisr.replay.<name>``, an eager
recompute (first sighting, capture or fallback) as
``sisr.recompute.<name>``.

A model's whole forward replays the same way (``replayed_forward``), where
its caller declares that calls repeat: inside ``replayed_forwards()``, which
``TiledSR`` holds around every tile, a forward with grad off, on a card, not
in training, is captured per signature (the model itself, the attributes its
forward reads, the input's place, every parameter's and buffer's storage
and version counter, the library settings, the plain versions' switch) on
the same rule, shares the LRU bound, the capture stream and the memory
pool, and returns each answer in a tensor of its own.  A replay is traced
as ``sisr.forward.replay``, any other forward under the switch as
``sisr.forward.eager``.  The model keeps its ``__call__``, so its forward
hooks fire on every call; its submodules' hooks fire only when it runs
eager.

Arguments may nest tensors in tuples (``scc_block``'s ``sca``,
``fused_fusion``'s ``raws``): they are flattened into the Function's inputs
and rebuilt for each call.  Non-tensor arguments (an activation name, heads,
a window) and ``None``s get no gradient.  ``kernel`` casts what it launches
on itself, so gradients land on the tensors the caller passed.  When no
input needs a gradient the kernel runs as it is, with no Function around it.
``with_kernel`` swaps the kernel, so that the CPU tests can hold the wiring
with the plain version standing in.

``KernelFunction`` alone decides which implementation runs.  A CUDA kernel
(``card_only``) runs for tensors on a card; other tensors, and every call
inside ``plain_versions()``, run the plain version (the yardstick on the
card).  The switch is thread-local, as grad mode is: the autograd engine's
and the data loader's threads keep the default.  A stand-in kernel runs on
any device.
"""

from __future__ import annotations

import contextlib
import operator
import threading
import warnings
import weakref
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from sisr_tpu_torch.ops.kernels import build
from sisr_tpu_torch.utils.constants import kept_alive
from sisr_tpu_torch.utils.profiling import span


class _Leaf:
    """The place of the i-th tensor in a flattened argument tree."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _flatten(arg, leaves: List[torch.Tensor]):
    if isinstance(arg, torch.Tensor):
        leaves.append(arg)
        return _Leaf(len(leaves) - 1)
    if isinstance(arg, (tuple, list)):
        return type(arg)(_flatten(a, leaves) for a in arg)
    return arg


def _rebuild(spec, leaves: Sequence[torch.Tensor]):
    if isinstance(spec, _Leaf):
        return leaves[spec.i]
    if isinstance(spec, (tuple, list)):
        return type(spec)(_rebuild(s, leaves) for s in spec)
    return spec


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _tensors(o)]


def needs_grad(*args) -> bool:
    """Whether autograd records a call on ``args``: grad mode is on and a
    tensor among them (nested in tuples) requires grad."""
    if not torch.is_grad_enabled():
        return False
    leaves: List[torch.Tensor] = []
    _flatten(args, leaves)
    return any(t.requires_grad for t in leaves)


def _plain_vjp(plain: Callable, spec, leaves: Sequence[torch.Tensor],
               need: Sequence[bool], grads) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``plain`` rebuilt from ``leaves``, for the leaves in
    ``need``, against output cotangents ``grads``."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(leaves, need)]
        outs = _tensors(plain(*_rebuild(spec, inputs)))
        got = iter(torch.autograd.grad(outs, [t for t, n in zip(inputs, need) if n], grads,
                                       allow_unused=True))
    return tuple(next(got) if n else None for n in need)


# signatures remembered (seen once, or with a graph), each graph's static
# buffers live until its signature is dropped
MAX_SIGNATURES = 64
_SEEN = object()
_lock = threading.Lock()
_signatures: "OrderedDict[tuple, object]" = OrderedDict()   # least recent first
_failed: set = set()
_capture_on: dict = {}  # device -> (the capture stream, the graphs' shared memory pool)


def _frozen(spec):
    """``spec`` as a hashable value: tensors by place, other leaves as they are."""
    if isinstance(spec, _Leaf):
        return _Leaf
    if isinstance(spec, (tuple, list)):
        return type(spec), tuple(_frozen(s) for s in spec)
    return spec


def _modes() -> tuple:
    """The process-wide settings by which cuBLAS and cuDNN pick their
    kernels: a graph keeps the ones it was captured under (``exact_mode``'s
    TF32 off among them)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (torch.get_float32_matmul_precision(), cudnn.enabled, cudnn.allow_tf32,
            cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
            matmul.allow_fp16_reduced_precision_reduction,
            matmul.allow_bf16_reduced_precision_reduction)


def _key(fn, spec, leaves, need, grads) -> Optional[tuple]:
    """The call's signature, or None where an argument cannot be hashed."""
    key = (fn.name, fn.plain, _frozen(spec), tuple(need),
           tuple((t.shape, t.stride(), t.dtype, t.device) for t in leaves),
           tuple(None if g is None else (g.shape, g.stride(), g.dtype) for g in grads),
           _modes())
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _signature(fn, spec, leaves, need, grads) -> Optional[tuple]:
    """The key of a plain recompute that may replay as a CUDA graph, or None
    where it runs eager: a leaf off the card or on another card than the
    first, an argument that cannot be hashed."""
    if not leaves or not leaves[0].is_cuda:
        return None
    dev = leaves[0].device
    if any(t.device != dev for t in leaves) or any(
            g is not None and g.device != dev for g in grads):
        return None
    return _key(fn, spec, leaves, need, grads)


def _sighting(key):
    """None (run eager: a first sighting, or a capture that failed), ``_SEEN``
    (capture) or the signature's graph (replay)."""
    with _lock:
        if key in _failed:
            return None
        entry = _signatures.get(key)
        if entry is None:
            _signatures[key] = _SEEN
            while len(_signatures) > MAX_SIGNATURES:
                _, old = _signatures.popitem(last=False)
                if isinstance(old, _Graph):
                    # no replay of it may still be queued when it is freed
                    torch.cuda.synchronize(old.device)
            return None
        _signatures.move_to_end(key)
        return entry


def drop_graphs() -> None:
    """Forget every signature, so that the next calls run eager and capture
    anew: a graph replays the code it captured, so code that swaps what a
    recompute runs (a planted fault) drops them before and after."""
    with _lock:
        for entry in _signatures.values():
            if isinstance(entry, _Graph):
                torch.cuda.synchronize(entry.device)
        _signatures.clear()
        _failed.clear()


class _Graph:
    """``run(*ins)``, a tuple of tensors and Nones, captured as a CUDA graph on
    static copies of ``ins``; ``first`` holds the warm-up's result (the
    capturing call's answer) until taken.  The device constants the capture
    reads are held as long as the graph (``utils/constants.py::kept_alive``)."""

    def __init__(self, run: Callable, ins: Sequence[torch.Tensor]):
        dev = self.device = ins[0].device
        # plain tensors, so that a graph captured under inference_mode loads outside it
        with torch.inference_mode(False):
            self.static = [torch.empty_like(t) for t in ins]
        self._load(ins)
        if dev not in _capture_on:
            _capture_on[dev] = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle()
        (stream, pool), current = _capture_on[dev], torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.first = run(*self.static)
        current.wait_stream(stream)
        for t in self.first:
            if t is not None:
                t.record_stream(current)
        counted = dict(build.launches)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with kept_alive() as self.constants, torch.cuda.graph(
                    self.graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                self.outs = run(*self.static)
        except BaseException:
            torch.cuda.set_stream(current)  # an end of capture that raises leaves it unset
            raise
        finally:
            # a capture launches nothing: its wrapper calls count at each replay
            self.launches = {k: v - counted[k] for k, v in build.launches.items()
                             if v != counted[k]}
            build.launches.update(counted)

    @torch.no_grad()
    def _load(self, ins):
        torch._foreach_copy_(self.static, list(ins))

    @torch.no_grad()
    def replay(self, ins):
        """This call's result, in tensors of its own."""
        self._load(ins)
        self.graph.replay()
        for k, v in self.launches.items():
            build.launches[k] += v
        outs = [t for t in self.outs if t is not None]
        fresh = [torch.empty_like(t) for t in outs]
        if outs:
            torch._foreach_copy_(fresh, outs)
        got = iter(fresh)
        return tuple(None if t is None else next(got) for t in self.outs)


class _VjpGraph(_Graph):
    """``_plain_vjp`` of one signature captured on static buffers: ``ins``
    for the leaves, ``cots`` for the cotangents (None where one is)."""

    def __init__(self, plain, spec, leaves, need, grads):
        n, given = len(leaves), [g is not None for g in grads]

        def run(*ins):
            cots = iter(ins[n:])
            return _plain_vjp(plain, spec, ins[:n], need,
                              [next(cots) if g else None for g in given])

        super().__init__(run, _vjp_ins(leaves, grads))
        cots = iter(self.static[n:])
        self.ins, self.cots = self.static[:n], [next(cots) if g else None for g in given]

    def replay(self, leaves, grads):
        return super().replay(_vjp_ins(leaves, grads))


def _vjp_ins(leaves, grads) -> list:
    return list(leaves) + [g for g in grads if g is not None]


def _capture(make: Callable, key, what: str):
    """The capturing call's answer, with the graph ``make()`` builds kept for
    the signature's later sightings; None, and eager for good, where the
    capture raises."""
    try:
        graph = make()
    except Exception as err:        # noqa: BLE001 - any failure leaves the call eager
        with _lock:
            _failed.add(key)
            _signatures.pop(key, None)
        warnings.warn(f"{what} could not be captured as a CUDA graph "
                      f"({type(err).__name__}: {err}); this signature runs eager")
        return None
    with _lock:
        if key in _signatures:
            _signatures[key] = graph
    got, graph.first = graph.first, None
    return got


def _recompute(fn, spec, leaves, need, grads):
    """``fn``'s plain vjp: replayed where its signature has a graph, else
    eager (and captured on the signature's second sighting)."""
    key = _signature(fn, spec, leaves, need, grads)
    entry = None if key is None else _sighting(key)
    if isinstance(entry, _VjpGraph):
        with span("replay." + fn.name):
            return entry.replay(leaves, grads)
    with span("recompute." + fn.name):
        if entry is _SEEN:
            got = _capture(lambda: _VjpGraph(fn.plain, spec, leaves, need, grads), key,
                           f"{fn.name}: the recomputed backward")
            if got is not None:
                return got
        return _plain_vjp(fn.plain, spec, leaves, need, grads)


class _ForwardGraph(_Graph):
    """A module's forward of one signature captured on a static input."""

    def __init__(self, run: Callable, x: torch.Tensor):
        super().__init__(lambda t: (run(t),), [x])
        self.first, = self.first

    def replay(self, x: torch.Tensor) -> torch.Tensor:
        return super().replay([x])[0]


# the devices whose forwards are captured
GRAPH_DEVICES = ("cuda",)
_version = operator.attrgetter("_version")


def _forward_key(module: torch.nn.Module, x: torch.Tensor, attrs: tuple) -> Optional[tuple]:
    """The forward's signature: the module itself (not a copy of it), the
    ``attrs`` its forward reads, the input's place, each parameter's and
    buffer's storage and version counter (a ``load_state_dict`` or an
    optimizer's step makes a new one), the library settings and the plain
    versions' switch.  None where a parameter or buffer was made under
    inference_mode: it has no version counter to follow.  The list of
    parameters and buffers is taken once (walking the modules costs more
    than a tile's launches), so a Parameter object assigned later is not
    followed, as by ``arch_util.derived``."""
    tensors = module.__dict__.get("_graph_tensors")
    if tensors is None:
        tensors = module.__dict__["_graph_tensors"] = [*module.parameters(), *module.buffers()]
    try:
        versions = tuple(map(_version, tensors))
    except RuntimeError:        # an inference tensor
        return None
    return ("forward", weakref.ref(module), attrs, x.shape, x.stride(), x.dtype, x.device,
            tuple(map(torch.Tensor.data_ptr, tensors)), versions, _modes(), _switch.on)


def _forward_signature(module, x, attrs, deterministic: bool) -> Optional[tuple]:
    """The key of a forward that may replay as a CUDA graph, or None where it
    runs eager: outside ``replayed_forwards()``, with grad on, in training
    (``deterministic`` False), off a card, or ``_forward_key``'s None."""
    if (not (_switch.replay and deterministic) or torch.is_grad_enabled()
            or x.device.type not in GRAPH_DEVICES):
        return None
    return _forward_key(module, x, attrs)


def replayed_forward(module: torch.nn.Module, run: Callable, x: torch.Tensor, attrs: tuple,
                     deterministic: bool = True) -> torch.Tensor:
    """``run(x)``, ``module``'s forward of ``x``; inside ``replayed_forwards()``
    replayed as a CUDA graph per signature (``_forward_key``) where
    ``_forward_signature`` allows, as the recompute is: the first sighting
    eager, the second captured, later ones replayed, each answer a tensor of
    its own.  Under the switch a replay is traced as ``sisr.forward.replay``,
    any other forward as ``sisr.forward.eager``."""
    if not _switch.replay:
        return run(x)
    key = _forward_signature(module, x, attrs, deterministic)
    entry = None if key is None else _sighting(key)
    if isinstance(entry, _ForwardGraph):
        with span("forward.replay"):
            return entry.replay(x)
    with span("forward.eager"):
        if entry is _SEEN:
            got = _capture(lambda: _ForwardGraph(run, x), key,
                           f"{type(module).__name__}: the forward")
            if got is not None:
                return got
        return run(x)


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, spec, *leaves):
        ctx.fn, ctx.spec = fn, spec
        ctx.save_for_backward(*leaves)
        return fn.kernel(*_rebuild(spec, leaves))

    @staticmethod
    def backward(ctx, *grads):
        fn, leaves = ctx.fn, ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with span("vjp." + fn.name):
            if fn.vjp is not None:
                got = fn.vjp(fn.kernel, leaves, need, grads)
            else:
                got = _recompute(fn, ctx.spec, leaves, need, grads)
        return (None, None) + tuple(got)


class _Switch(threading.local):
    on = False          # plain_versions()
    replay = False      # replayed_forwards()


_switch = _Switch()


@contextlib.contextmanager
def plain_versions():
    """Inside it, every kernel function of this thread runs its plain version."""
    before, _switch.on = _switch.on, True
    try:
        yield
    finally:
        _switch.on = before


def in_plain_versions() -> bool:
    """Whether this thread is inside ``plain_versions()``."""
    return _switch.on


@contextlib.contextmanager
def replayed_forwards():
    """Inside it, this thread's model forwards that may replay as CUDA graphs
    do (``replayed_forward``): ``TiledSR`` runs every tile inside it, since
    its tiles repeat one signature."""
    before, _switch.replay = _switch.replay, True
    try:
        yield
    finally:
        _switch.replay = before


def in_replayed_forwards() -> bool:
    """Whether this thread is inside ``replayed_forwards()``."""
    return _switch.replay


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a CUDA kernel's call on ``t`` runs the plain version: inside
    ``plain_versions()``, or ``t`` off a card."""
    return _switch.on or not t.is_cuda


class KernelFunction:
    """``kernel`` forward, ``plain``'s vjp (or ``vjp``) backward, traced as
    ``sisr.vjp.<name>``; see the module docstring.  ``vjp(kernel, leaves,
    need, grads)`` returns one gradient (or None) per flattened input.
    ``card_only``: ``kernel`` takes CUDA tensors only, so a call whose first
    argument is off a card runs ``plain``."""

    def __init__(self, name: str, kernel: Callable, plain: Callable,
                 vjp: Optional[Callable] = None, card_only: bool = False):
        self.name, self.kernel, self.plain, self.vjp = name, kernel, plain, vjp
        self.card_only = card_only

    def with_kernel(self, kernel: Callable) -> "KernelFunction":
        return KernelFunction(self.name, kernel, self.plain, self.vjp)

    def __call__(self, *args):
        if _switch.on or (self.card_only and not args[0].is_cuda):
            return self.plain(*args)
        if not needs_grad(*args):
            return self.kernel(*args)
        leaves: List[torch.Tensor] = []
        spec = _flatten(args, leaves)
        return _Apply.apply(self, spec, *leaves)
