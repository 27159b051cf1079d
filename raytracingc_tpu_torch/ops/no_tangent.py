"""Functions with no derivative that run on plain tensors under every autograd mode.

A search returns integer winners and distances through which no derivative
flows: ``ops/intersect.py::resolve_hit`` recomputes the hit differentiably
from the winner's index, as the JAX package does. The CUDA wrappers hand
``tensor.data_ptr()`` to the kernel library, and under ``torch.func.jvp``
every tensor is a functorch wrapper with no storage, whose ``data_ptr()``
raises (and so do the collectives of a gloo group on CUDA tensors, which
copy through the tensor's storage). :func:`no_tangent` runs such a function
inside a ``torch.autograd.Function`` instead: functorch calls its
``forward`` on the plain tensors underneath, ``torch.autograd.forward_ad``
and reverse mode see outputs marked non-differentiable, and the body
(kernel launch, launch count, or the plain version on a CPU tensor; a
collective) runs exactly as without a transform: the same bits, no host
sync.
"""

from __future__ import annotations

import functools
import inspect

import torch


class _NoTangent(torch.autograd.Function):
    """``fn(*args)`` (a tensor or a tuple of tensors) with every output
    non-differentiable."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n_inputs = len(inputs)
        ctx.outputs = len(output) if isinstance(output, tuple) else None
        ctx.mark_non_differentiable(
            *(output if isinstance(output, tuple) else (output,)))

    @staticmethod
    def jvp(ctx, *tangents):
        return None if ctx.outputs is None else (None,) * ctx.outputs

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * ctx.n_inputs


def no_tangent(fn):
    """Decorate a function returning a tensor or a tuple of tensors (a
    search wrapper's ``(dst, idx)``) so that it runs on plain tensors under
    ``torch.func.jvp``, ``torch.autograd.forward_ad`` and reverse mode, its
    outputs carrying no derivative. Keyword arguments are bound to their
    positions first (``autograd.Function.apply`` takes positions only)."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return _NoTangent.apply(fn, *bound.args)

    return wrapper
