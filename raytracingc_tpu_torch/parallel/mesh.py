"""Process groups and the ``(px, spp)`` device mesh.

Counterpart of ``raytracingc_tpu/parallel/mesh.py``. The JAX package drives
every device from one process through ``shard_map``; here each rank is a
process of its own over ``torch.distributed``, and the collectives are
written out and run on groups named by mesh dimension:

* ``px``, the pixel dimension: ranks trace disjoint blocks of the image's
  rays (or, for a block-sharded scene, disjoint slices of its triangles);
* ``spp``, the sample dimension: ranks trace disjoint ranges of sample ids.

The backend is chosen by the caller and passed to ``init_process_group``
explicitly: NCCL between cards, gloo on the CPU. NCCL refuses two ranks on
one card, so several ranks sharing a card run over gloo, which takes CUDA
tensors for the collectives used here (``all_reduce``, ``all_gather``).

A rank's device: ``cuda:(local_rank % torch.cuda.device_count())``, where
``local_rank`` is the ``LOCAL_RANK`` environment variable a launcher sets,
else the global rank (one host), or the CPU for a CPU mesh.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DIMS = ("px", "spp")
# Collectives that wait longer than this raise instead of hanging a run.
TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device_type: str) -> str:
    """``"nccl"`` for a CUDA mesh, ``"gloo"`` for a CPU one."""
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(device_type: str) -> torch.device:
    """This rank's device (module docstring)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type={device_type!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device; none is available "
                           "(pass device_type='cpu' for a CPU mesh)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_distributed(coordinator: str | None, num_processes: int | None,
                           process_id: int | None, backend: str | None = None
                           ) -> None:
    """Join a world of ``num_processes`` ranks as rank ``process_id``, its
    store served by rank 0 at ``coordinator`` (``host:port``).

    ``backend`` defaults to NCCL when a CUDA device is available and gloo
    otherwise; pass ``"gloo"`` for several ranks on one card. A no-op for at
    most one process, like the JAX package's (``jax.distributed`` discovers
    a pod's processes; ``torch.distributed`` needs all three values).
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "(host:port of rank 0) and a process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} outside [0, {num_processes})")
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available() else "cpu")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


# The world _ensure_world started, if any, and the meshes built on the
# current world: (device_type, px, spp) -> (world, mesh).
_IMPLICIT = None
_MESHES: dict = {}


def _ensure_world(device_type: str) -> None:
    """A world of one rank (in-process store) when none is initialised, so
    that a one-rank sharded render still runs its collectives, as
    ``shard_map`` does on one device. It gives each device type its own
    backend (gloo for CPU tensors, NCCL for CUDA ones), so a CUDA mesh on it
    never runs over gloo; where torch has no NCCL a CUDA mesh on it raises.
    """
    global _IMPLICIT
    if not dist.is_initialized():
        backend = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
        _IMPLICIT = dist.group.WORLD
    if (device_type == "cuda" and dist.group.WORLD is _IMPLICIT
            and not dist.is_nccl_available()):
        raise RuntimeError("a CUDA mesh on the implicit one-rank world needs "
                           "NCCL, which this torch lacks; start a world with "
                           "initialize_distributed(..., backend='gloo')")


def world_size(device_type: str = "cuda") -> int:
    """Ranks in the world, initialising a one-rank world when none is."""
    if device_type == "cuda":
        rank_device("cuda")  # raises without a card
    _ensure_world(device_type)
    return dist.get_world_size()


def make_mesh(px: int | None = None, spp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of shape ``(px, spp)`` named ``("px", "spp")`` over
    every rank of the world, rank-major: rank ``r`` sits at ``(r // spp, r %
    spp)``, as the JAX package reshapes its device list. ``px=None`` takes
    every rank the ``spp`` dimension leaves. The mesh spans the whole world
    (JAX's may take a prefix of the devices). ``device_type`` ``"cuda"`` (the
    default; each rank on :func:`rank_device`) or ``"cpu"``. A mesh is built
    once per world and shape, so repeated calls (``render_sharded`` without
    a mesh) add no process groups.
    """
    n = world_size(device_type)
    if px is None:
        if n % spp:
            raise ValueError(f"{n} ranks not divisible by spp={spp}")
        px = n // spp
    if px * spp != n:
        raise ValueError(f"mesh {px}x{spp} does not cover the world's {n} ranks")
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    key = (device_type, px, spp)
    world, mesh = _MESHES.get(key, (None, None))
    if world is not dist.group.WORLD:
        if any(w is not dist.group.WORLD for w, _ in _MESHES.values()):
            _MESHES.clear()  # meshes of a destroyed world
        mesh = DeviceMesh(device_type, torch.arange(n).reshape(px, spp),
                          mesh_dim_names=DIMS)
        _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def mesh_shape(mesh: DeviceMesh) -> tuple[int, int]:
    """``(px, spp)`` of a mesh from :func:`make_mesh`; raises on another."""
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != DIMS:
        raise TypeError(f"expected a DeviceMesh with dims {DIMS} (make_mesh), "
                        f"got {mesh!r}")
    return tuple(mesh.mesh.shape)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on a mesh from :func:`make_mesh` (raises on
    another object)."""
    mesh_shape(mesh)
    return rank_device(mesh.device_type)


def mesh_coords(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's ``(px, spp)`` coordinates in the mesh."""
    return mesh.get_local_rank("px"), mesh.get_local_rank("spp")
