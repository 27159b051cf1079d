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
sync. A call that no transform, forward-AD level or gradient can see (the
production render) runs the body directly, at the cost of a plain call.

Under ``torch.func.vmap`` (and ``torch.func.jacfwd``, a ``vmap`` of
``jvp``) the body runs by :func:`vmap_by_element`: once, unbatched, when no
input carries the batch (under ``jacfwd`` only the tangents do), else once
per batch element. The integrator's live-lane loop selects lanes with
``torch.nonzero``, whose output shape depends on the data, so ``vmap``
cannot batch it: :func:`live_lanes` gives the lanes live in ANY element of
the batch, and says whether it did, so that the caller masks the lanes that
are dead in some elements; :func:`lane_count` counts per element.
"""

from __future__ import annotations

import functools
import inspect

import torch
from torch.autograd import forward_ad


def vmap_by_element(apply, info, in_dims, *args):
    """A ``vmap`` staticmethod's body for a function that cannot be batched:
    ``(outputs, out_dims)`` of ``apply(*args)`` (the Function's own
    ``apply``, so that an outer transform gets its rule in turn). With no
    input batched it runs once and nothing is batched; else it runs on each
    batch element and the results are stacked along dimension 0. Each result
    is ``apply``'s own on that element (a contiguous copy where the batch
    dimension is not the first), bit for bit."""
    if all(d is None for d in in_dims):
        out = apply(*args)
        return out, (None,) * len(out) if isinstance(out, tuple) else None
    outs = [apply(*(a if d is None else a.select(d, b).contiguous()
                    for a, d in zip(args, in_dims)))
            for b in range(info.batch_size)]
    if not isinstance(outs[0], tuple):
        return torch.stack(outs), 0
    return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])


class _Constant(torch.autograd.Function):
    """A function of tensors whose every output is non-differentiable."""

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


class _NoTangent(_Constant):
    """``fn(*args)`` (a tensor or a tuple of tensors) with every output
    non-differentiable."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_by_element(_NoTangent.apply, info, in_dims, *args)


class _AnyLanes(_Constant):
    """Indices of the lanes of a bool ``[R]`` mask that are True; under
    ``vmap``, True in any element of the batch (not batched)."""

    @staticmethod
    def forward(mask):
        return torch.nonzero(mask).squeeze(1)

    @staticmethod
    def vmap(info, in_dims, mask):
        d = in_dims[0]
        return _AnyLanes.apply(mask if d is None else mask.any(d)), None


class _Batched(_Constant):
    """A bool scalar on the CPU: whether the input carries a ``vmap`` batch
    at some level (not batched itself)."""

    @staticmethod
    def forward(t):
        return torch.zeros((), dtype=torch.bool)

    @staticmethod
    def vmap(info, in_dims, t):
        if in_dims[0] is not None:
            return torch.ones((), dtype=torch.bool), None
        return _Batched.apply(t), None


def _batched(t: torch.Tensor) -> bool:
    """Whether ``t`` carries a ``torch.func.vmap`` batch (no device sync)."""
    return bool(_Batched.apply(t))


def live_lanes(mask: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``(indices, union)``: the True lanes of a bool ``[R]`` mask, in order
    (a host sync). ``union`` is True iff the mask carries a ``vmap`` batch:
    the indices are then those of the lanes True in any element, and some
    of them may be False in a given element. With no functorch transform
    active (the production render) no ``autograd.Function`` is applied."""
    if not torch._C._are_functorch_transforms_active():
        return torch.nonzero(mask).squeeze(1), False
    return _AnyLanes.apply(mask), _batched(mask)


def lane_count(mask: torch.Tensor):
    """The number of True lanes of a bool mask: an exact Python int (a host
    sync), or under a ``vmap`` batch that the mask carries, an int64 tensor
    per element."""
    if torch._C._are_functorch_transforms_active() and _batched(mask):
        return mask.sum()
    return int(mask.sum())


def _plain_call(args, kwargs) -> bool:
    """Whether a call can run its body directly: no functorch transform is
    active, no forward-AD level is open, and no tensor argument requires
    grad while grad mode is on. Then no input carries a derivative, the
    body's outputs carry none, and the Function would change nothing."""
    if (torch._C._are_functorch_transforms_active()
            or forward_ad._current_level >= 0):
        return False
    if not torch.is_grad_enabled():
        return True
    return not any(isinstance(a, torch.Tensor) and a.requires_grad
                   for a in (*args, *kwargs.values()))


def no_tangent(fn):
    """Decorate a function returning a tensor or a tuple of tensors (a
    search wrapper's ``(dst, idx)``) so that it runs on plain tensors under
    ``torch.func.jvp``, ``torch.autograd.forward_ad``, reverse mode and
    ``torch.func.vmap``, its outputs carrying no derivative. A call that
    needs none of that (:func:`_plain_call`: the production render) runs
    the body directly, with no Function and no argument binding. Otherwise
    keyword arguments are bound to their positions first
    (``autograd.Function.apply`` takes positions only)."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _plain_call(args, kwargs):
            return fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return _NoTangent.apply(fn, *bound.args)

    return wrapper
