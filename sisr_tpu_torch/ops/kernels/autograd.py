"""Gradients through the hand-written kernels, as the JAX package's
``jax.custom_vjp``s give them.

``KernelFunction(kernel, plain)`` is a callable with ``plain``'s signature.
Its forward runs ``kernel`` and saves the *inputs* (no activations); its
backward recomputes ``plain`` from them under autograd and returns
``torch.autograd.grad`` of it for the inputs that need one: the vjp of the
plain version, as each JAX backward is ``jax.vjp`` of its reference.  A
kernel with a backward kernel of its own (``dwconv.py``) passes ``vjp``.

Arguments may nest tensors in tuples (``scc_block``'s ``sca``,
``fused_fusion``'s ``raws``): they are flattened into the Function's inputs
and rebuilt for each call.  Non-tensor arguments (an activation name, heads,
a window) and ``None``s get no gradient.  ``kernel`` casts what it launches
on itself, so gradients land on the tensors the caller passed.  When no
input needs a gradient the kernel runs as it is, with no Function around it.
``with_kernel`` swaps the kernel, so that the CPU tests can hold the wiring
with the plain version standing in.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch


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
        if fn.vjp is not None:
            got = fn.vjp(fn.kernel, leaves, need, grads)
        else:
            got = _plain_vjp(fn.plain, ctx.spec, leaves, need, grads)
        return (None, None) + tuple(got)


class KernelFunction:
    """``kernel`` forward, ``plain``'s vjp (or ``vjp``) backward; see the
    module docstring.  ``vjp(kernel, leaves, need, grads)`` returns one
    gradient (or None) per flattened input."""

    def __init__(self, kernel: Callable, plain: Callable, vjp: Optional[Callable] = None):
        self.kernel, self.plain, self.vjp = kernel, plain, vjp

    def with_kernel(self, kernel: Callable) -> "KernelFunction":
        return KernelFunction(kernel, self.plain, self.vjp)

    def __call__(self, *args):
        if not needs_grad(*args):
            return self.kernel(*args)
        leaves: List[torch.Tensor] = []
        spec = _flatten(args, leaves)
        return _Apply.apply(self, spec, *leaves)
