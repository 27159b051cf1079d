"""Tree checkpointing: atomic ``.npz`` snapshots of nested tensors.

Counterpart of ``raytracingc_tpu/utils/checkpoint.py``, with its file
format: one ``.npz`` holding the flattened leaves as ``leaf_0`` ..
``leaf_{n-1}`` and, when given, the step counter as ``__step__``, written to
a temporary file in the target's directory and ``os.replace``-d over it, so
a crash mid-write never corrupts the latest checkpoint. The tree's structure
is not saved: :func:`load_pytree` takes a template of the same structure.

A tree is built from these nodes, flattened depth first in this order:

* a ``torch.Tensor`` is a leaf;
* ``None`` is a node without leaves;
* a tuple or list: its items in order;
* a dict: its values in sorted key order (the JAX package's rule), so the
  keys of one dict must compare with each other (all ``str``, or all
  ``int`` as in an optimizer's ``state_dict()["state"]``);
* a dataclass instance (``Scene``, its ``Triangles``, ``Spheres``,
  ``EnvParams`` and ``TriangleAccel``, a ``Camera``): its fields in
  declaration order.

Any other value (an ``int`` such as ``Scene.n_triangles``, a float, a
string, a bool) is static: it is not saved, and a load keeps the
template's. So a torch optimizer's ``state_dict()`` round-trips: its
per-parameter tensors (Adam's ``step``, ``exp_avg``, ``exp_avg_sq``) are
leaves and its hyperparameters come from the template.

Tensors are copied to the host on save; a load restores each leaf with the
template leaf's dtype and device. A ``(acc, count)`` pair flattens to
``[acc, count]`` in both packages, so the progressive renderer's checkpoints
load across them; a ``Scene``'s leaf order is each package's own.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable

import numpy as np
import torch


def _map(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """Rebuild ``tree`` with ``fn`` applied to every leaf, in the module's
    flattening order."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(x, fn) for x in tree)
    if isinstance(tree, dict):
        mapped = {k: _map(tree[k], fn) for k in sorted(tree)}
        return {k: mapped[k] for k in tree}  # the template's key order
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)
        })
    return tree


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of ``tree`` in the module's flattening order."""
    leaves: list[torch.Tensor] = []

    def collect(t: torch.Tensor) -> torch.Tensor:
        leaves.append(t)
        return t

    _map(tree, collect)
    return leaves


def save_pytree(path: str, tree: Any, step: int | None = None) -> None:
    """Atomically write ``tree``'s leaves (and optional step counter) to .npz."""
    payload = {f"leaf_{i}": x.detach().cpu().numpy()
               for i, x in enumerate(tree_leaves(tree))}
    if step is not None:
        payload["__step__"] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, template: Any) -> tuple[Any, int | None]:
    """Restore a tree saved by :func:`save_pytree` (either package's).

    ``template`` supplies the structure, the static values, and each leaf's
    dtype, device and shape; a file whose leaf count or shapes differ raises
    ``ValueError``. Returns ``(tree, step)``; ``step`` is ``None`` if none
    was saved.
    """
    n = len(tree_leaves(template))
    with np.load(path) as data:
        step = int(data["__step__"]) if "__step__" in data else None
        saved = sum(1 for k in data.files if k.startswith("leaf_"))
        if saved != n:
            raise ValueError(f"{path}: {saved} leaves, the template has {n}")
        loaded = iter([data[f"leaf_{i}"] for i in range(n)])

    def restore(t: torch.Tensor) -> torch.Tensor:
        x = next(loaded)
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"{path}: a leaf of shape {tuple(x.shape)} where "
                             f"the template has {tuple(t.shape)}")
        return torch.as_tensor(x).to(dtype=t.dtype, device=t.device)

    return _map(template, restore), step
