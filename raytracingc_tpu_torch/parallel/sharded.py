"""Sharded rendering and the sharded training step over ``torch.distributed``.

Counterpart of ``raytracingc_tpu/parallel/sharded.py``, with its contract
and one process per rank in place of ``shard_map``:

* **Pixels** (``px``): the primary rays, padded with dead rays to a multiple
  of the ``px`` size, split into contiguous blocks (as ``P("px")`` splits
  them); each rank traces its block through ``render.renderer.trace_rays``'s
  pixel chunks, and the image is gathered over ``px``, so every rank returns
  the whole image. A lane's radiance depends on neither its block nor its
  chunk, so the image equals the single-device render bit for bit.
* **Samples** (``spp``): rank ``k`` of the ``spp`` group traces sample ids
  ``sample_offset + k * spp_per`` onwards; the per-rank means are summed
  over ``spp`` and divided by its size (the JAX package's ``pmean``). That
  associates the sample sum as a mean of means: equal to the sum of
  ``render(spp=spp_per, sample_offset=k * spp_per)`` over ``k`` divided by
  the size, not to one render of every sample.
* A replicated-scene render differentiates in forward mode
  (``torch.func.jvp``, ``forward_ad``, ``torch.func.jacfwd``): the spp
  mean's tangent is the mean of the ranks' tangents and the px gather
  gathers them, as JAX's ``pmean`` and ``all_gather`` differentiate, so
  every rank holds the tangent of the whole image (under ``jacfwd``, one
  collective per tangent direction, in the same order on every rank).
  Reverse mode through it raises; :func:`make_train_step` trains.
* The traced-ray count is summed over both dimensions (exact integers; a
  padding ray is never counted).
* **Blocks** (``scene_sharding="blocks"``): each ``px`` rank holds a
  contiguous 1/px slice of every triangle buffer and traces every ray; the
  search and resolve merge across ``px`` (``ops/intersect.py``), so the
  image equals the replicated render bit for bit. The count sums over
  ``spp`` only: every ``px`` rank traced the same rays.
* **Training** (:func:`make_train_step`): the loss averages radiance over
  ``spp`` inside the differentiated function, and loss and gradients are
  combined over the whole mesh before the optimizer's update, so every rank
  applies the same update to its replica of the parameters.

Every rank of the mesh must make the same calls with the same arguments.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from raytracingc_tpu_torch.camera import Camera, primary_rays
from raytracingc_tpu_torch.ops.accel import BLOCK, TriangleAccel, refresh_accel
from raytracingc_tpu_torch.ops.no_tangent import no_tangent, vmap_by_element
from raytracingc_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_coords,
    mesh_device,
    mesh_shape,
    world_size,
)
from raytracingc_tpu_torch.render.integrator import trace_accumulate
from raytracingc_tpu_torch.render.renderer import pad_rays, trace_rays
from raytracingc_tpu_torch.scene.types import Scene, ShardSpec, Triangles, with_leaves
from raytracingc_tpu_torch.utils.profiling import trace_annotation


def strategy_spp_dim(strategy: str, n_devices: int) -> int:
    """The ``spp`` mesh dimension a strategy resolves to on ``n_devices``
    ranks: the single source of truth for the strategy → mesh mapping, which
    :func:`mesh_for_strategy`, ``render_progressive``'s batch validation and
    the CLI's block padding all consult."""
    if strategy == "pixels":
        return 1
    if strategy == "samples":
        return n_devices
    if strategy == "both":
        return 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    raise ValueError(f"unknown strategy {strategy!r}")


def mesh_for_strategy(strategy: str, n_devices: int | None = None,
                      device_type: str = "cuda") -> DeviceMesh:
    """The ``(px, spp)`` mesh a strategy implies over ``n_devices`` ranks
    (default: the world's)."""
    n = world_size(device_type) if n_devices is None else n_devices
    spp_dim = strategy_spp_dim(strategy, n)
    return make_mesh(px=n // spp_dim, spp=spp_dim, device_type=device_type)


def _spp_split(spp: int, n_spp: int) -> int:
    if spp % n_spp:
        raise ValueError(f"spp={spp} not divisible by the mesh's spp={n_spp}")
    return spp // n_spp


@no_tangent
def _spp_mean(radiance: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The mean of the ``spp`` ranks' radiances (sum, then divide), with no
    derivative (:class:`_SppMean` gives it one); ``radiance`` is summed in
    place."""
    dist.all_reduce(radiance, group=mesh.get_group("spp"))
    return radiance / float(mesh_shape(mesh)[1])


@no_tangent
def _px_gather(radiance: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The ``px`` ranks' blocks of rows, gathered in rank order, with no
    derivative (:class:`_PxGather` gives it one)."""
    parts = [torch.empty_like(radiance) for _ in range(mesh_shape(mesh)[0])]
    dist.all_gather(parts, radiance.contiguous(), group=mesh.get_group("px"))
    return torch.cat(parts)


@no_tangent
def _summed(count: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce`` (sum) of a copy of ``count`` over ``group``, on the
    plain tensor under ``torch.func.jvp`` too (a tensor made inside the
    transform is a functorch wrapper)."""
    count = count.clone()
    dist.all_reduce(count, group=group)
    return count


def _sum_count(count: int, device, group=None) -> int:
    """``count`` summed over ``group`` (default: the world, which the mesh
    spans), exactly, as int64."""
    return int(_summed(torch.tensor([count], dtype=torch.int64, device=device),
                       group).item())


def render_sharded(scene: Scene, camera: Camera, width: int, height: int,
                   spp: int, max_bounce: int, seed: int = 0,
                   backend: str = "auto", strategy: str = "pixels",
                   mesh: DeviceMesh | None = None, early_exit: bool = True,
                   sample_offset: int = 0, compact: bool = True,
                   sample_group=1, scene_sharding: str = "replicated",
                   pixel_chunk: int | None = None):
    """Render across the mesh's ranks: ``(image [H, W, 3], rays_traced)`` on
    every rank, on this rank's device (``parallel.mesh.rank_device``).

    ``strategy``: ``"pixels"`` shards the image's rays, ``"samples"`` the
    sample ids, ``"both"`` splits the ranks between the two; an explicit
    ``mesh`` overrides it (without one, a mesh of the world's ranks on the
    scene's device type is built for this call). ``scene_sharding``:
    ``"replicated"`` (every rank holds the scene) or ``"blocks"``
    (:func:`render_sharded_blocks`). ``sample_offset`` shifts every rank's
    sample ids (progressive batches). The other keywords are ``render``'s.
    """
    if mesh is None:
        mesh = mesh_for_strategy(strategy, device_type=scene.device.type)
    kw = dict(seed=seed, backend=backend, mesh=mesh, early_exit=early_exit,
              sample_offset=sample_offset, compact=compact,
              sample_group=sample_group, pixel_chunk=pixel_chunk)
    if scene_sharding == "blocks":
        return render_sharded_blocks(scene, camera, width, height, spp,
                                     max_bounce, **kw)
    if scene_sharding != "replicated":
        raise ValueError(f"scene_sharding={scene_sharding!r}: expected "
                         "'replicated' or 'blocks'")
    return _render_replicated(scene, camera, width, height, spp, max_bounce, **kw)


def _render_replicated(scene, camera, width, height, spp, max_bounce, *, seed,
                       backend, mesh, early_exit, sample_offset, compact,
                       sample_group, pixel_chunk):
    px, n_spp = mesh_shape(mesh)
    spp_per = _spp_split(spp, n_spp)
    p, s = mesh_coords(mesh)
    dev = mesh_device(mesh)
    scene, camera = scene.to(dev), camera.to(dev)
    n_pix = width * height
    origins, dirs = primary_rays(camera, width, height)
    ray_ids = torch.arange(n_pix, dtype=torch.int64, device=dev)
    origins, dirs, ray_ids, active = pad_rays(origins, dirs, ray_ids, px)
    per = origins.shape[0] // px
    block = slice(p * per, (p + 1) * per)
    radiance, count = trace_rays(
        scene, origins[block], dirs[block], ray_ids[block], spp_per, max_bounce,
        active=active[block], seed=seed, backend=backend, pixel_chunk=pixel_chunk,
        early_exit=early_exit, sample_offset=sample_offset + s * spp_per,
        compact=compact, sample_group=sample_group,
    )
    radiance = _PxGather.apply(_SppMean.apply(radiance, mesh), mesh)
    image = radiance[:n_pix].reshape(height, width, 3)
    return image, _sum_count(count, dev)


# -----------------------------------------------------------------------------
# Block-sharded scenes: each px rank holds 1/px of the triangle buffers.
# -----------------------------------------------------------------------------


def pad_scene_for_blocks(scene: Scene, n: int) -> Scene:
    """The scene padded so that its triangle buffers split into ``n`` equal
    slices of whole 128-triangle blocks.

    The count rounds up to blocks, then the blocks up to a multiple of ``n``
    (both ceilings: a count that is no multiple of 128 must round up). The
    pad rows are all-zero (a zero normal fails the backface test, as the
    builders' padding), ``n_triangles`` stays the live count, and an
    attached accel is rebuilt: the live triangles keep their Morton order
    and blocks, the padding rides at the tail in never-hit blocks, so a
    render of the padded scene equals the original's bit for bit.
    """
    t0 = scene.triangles.count
    blocks = max(-(-t0 // BLOCK), 1)
    t1 = -(-blocks // n) * n * BLOCK
    if t1 == t0:
        return scene
    tris = Triangles(**{
        f.name: torch.cat([x, x.new_zeros((t1 - t0,) + x.shape[1:])])
        for f in dataclasses.fields(Triangles)
        for x in (getattr(scene.triangles, f.name),)
    })
    out = dataclasses.replace(scene, triangles=tris, accel=None, resolve_perm=None)
    return out.with_accel() if scene.accel is not None else out


def shard_scene(scene: Scene, rank: int, size: int, group, device) -> Scene:
    """Rank ``rank``'s slice of a scene whose triangle count divides into
    ``size`` equal slices of whole blocks, copied to ``device``: rows
    ``[rank * T / size, (rank + 1) * T / size)`` of the original-order
    triangles (the resolve's table) and of every accel table along its
    triangle or block dimension (the ``(12, T)`` plane along dim 1), as the
    JAX package's ``_scene_block_specs`` splits them. The accel's
    ``orig_idx`` stay global. ``perm_of_orig`` and ``mxu_coeffs`` are
    dropped: a slice of either means nothing (a sharded scene never takes
    the permuted resolve or the mxu route). Spheres and the environment are
    replicated."""

    def take(x, dim=0):
        n = x.shape[dim] // size
        return x.narrow(dim, rank * n, n).to(device, copy=True).contiguous()

    def tris(t: Triangles) -> Triangles:
        return Triangles(**{f.name: take(getattr(t, f.name))
                            for f in dataclasses.fields(Triangles)})

    accel = scene.accel
    if accel is not None:
        accel = TriangleAccel(
            triangles=tris(accel.triangles), orig_idx=take(accel.orig_idx),
            aabb_lo=take(accel.aabb_lo), aabb_hi=take(accel.aabb_hi),
            packed_plane=(None if accel.packed_plane is None
                          else take(accel.packed_plane, dim=1)),
        )
    return Scene(
        triangles=tris(scene.triangles), spheres=scene.spheres.to(device),
        env=scene.env.to(device), n_triangles=scene.n_triangles,
        n_spheres=scene.n_spheres, accel=accel,
        shard=ShardSpec(group=group, rank=rank, size=size),
    )


def render_sharded_blocks(scene: Scene, camera: Camera, width: int,
                          height: int, spp: int, max_bounce: int,
                          seed: int = 0, backend: str = "auto",
                          mesh: DeviceMesh | None = None,
                          early_exit: bool = True, sample_offset: int = 0,
                          compact: bool = True, sample_group=1,
                          pixel_chunk: int | None = None):
    """Render with the triangle buffers block-sharded over ``px``:
    ``(image [H, W, 3], rays_traced)`` on every rank.

    Each ``px`` rank keeps its contiguous slice (:func:`shard_scene`, taken
    from ``scene`` wherever it lies, so a scene kept on the host never lands
    whole on the card) and traces every ray; per bounce the ranks' winners
    merge across ``px`` by the kernels' own (distance, lowest index) rule
    and the winner's row is summed from the rank that owns it, so the image
    equals the replicated render bit for bit. The search takes the
    accel-table routes (``ops.search.search_triangles(packet_only=True)``).
    ``spp`` shards samples as in the replicated mode. The triangle count
    must divide into ``px * 128``: :func:`pad_scene_for_blocks` first.
    """
    if mesh is None:
        mesh = mesh_for_strategy("pixels", device_type=scene.device.type)
    px, n_spp = mesh_shape(mesh)
    spp_per = _spp_split(spp, n_spp)
    t = scene.triangles.count
    if t % (px * BLOCK):
        raise ValueError(
            f"block sharding needs triangle padding {t} divisible by "
            f"px*128={px * BLOCK}; run pad_scene_for_blocks(scene, {px}) first")
    p, s = mesh_coords(mesh)
    dev = mesh_device(mesh)
    local = shard_scene(scene, p, px, mesh.get_group("px"), dev)
    origins, dirs = primary_rays(camera.to(dev), width, height)
    ray_ids = torch.arange(width * height, dtype=torch.int64, device=dev)
    radiance, count = trace_rays(
        local, origins, dirs, ray_ids, spp_per, max_bounce, seed=seed,
        backend=backend, pixel_chunk=pixel_chunk, early_exit=early_exit,
        sample_offset=sample_offset + s * spp_per, compact=compact,
        sample_group=sample_group,
    )
    radiance = _spp_mean(radiance, mesh)
    count = _sum_count(count, dev, group=mesh.get_group("spp"))
    return radiance.reshape(height, width, 3), count


# -----------------------------------------------------------------------------
# The training step: replicated parameters, rays and samples sharded.
# -----------------------------------------------------------------------------


class _SppMean(torch.autograd.Function):
    """The mean of the ``spp`` ranks' radiances, differentiable in both
    modes.

    Forward mode: the tangent of the mean is the mean of the ranks'
    tangents, one ``all_reduce`` on the tangent (JAX's ``pmean``), so every
    rank holds the tangent of the whole sample-sharded image.

    Reverse mode: every rank of an ``spp`` group holds the same loss of the
    same mean, so the cotangent of the mean is the same on each; the
    backward passes it on unchanged as the cotangent of the rank's own
    radiance, and no collective runs. The gradients are then summed over
    the mesh and divided by the ``spp`` size (:func:`make_train_step`),
    which gives the true gradient: the mean's Jacobian 1/n_spp is applied
    there, once. (``torch.distributed.nn.functional.all_reduce`` would sum
    the cotangents in its backward instead; with that sum and a division by
    the whole mesh's size the result is the same.)
    """

    @staticmethod
    def forward(radiance, mesh):
        return _spp_mean(radiance.clone(), mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def jvp(ctx, tangent, _):
        return None if tangent is None else _spp_mean(tangent.clone(), ctx.mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def vmap(info, in_dims, radiance, mesh):
        return vmap_by_element(_SppMean.apply, info, in_dims, radiance, mesh)


class _PxGather(torch.autograd.Function):
    """The ``px`` ranks' radiance blocks gathered in rank order,
    differentiable in forward mode: the tangent is the gathered tangents
    (JAX's ``all_gather``). Reverse mode through :func:`render_sharded`
    raises: its gradients would be per rank and in
    :func:`make_train_step`'s convention (summed over the mesh, then
    divided by the spp size), which a caller's ``backward`` does not apply;
    :func:`make_train_step` is the reverse-mode path."""

    @staticmethod
    def forward(radiance, mesh):
        return _px_gather(radiance, mesh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def jvp(ctx, tangent, _):
        return None if tangent is None else _px_gather(tangent, ctx.mesh)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError("render_sharded has no reverse mode: train through "
                           "make_train_step (or fit_scene(mesh=)); forward mode "
                           "(torch.func.jvp, forward_ad, torch.func.jacfwd) "
                           "works")

    @staticmethod
    def vmap(info, in_dims, radiance, mesh):
        return vmap_by_element(_PxGather.apply, info, in_dims, radiance, mesh)


def make_train_step(mesh: DeviceMesh | None, optimizer: torch.optim.Optimizer,
                    spp: int, max_bounce: int, backend: str = "auto",
                    seed: int = 0, param_filter=None,
                    geometry_trainable: bool = True):
    """A training step for inverse rendering over ``mesh`` (``None``: one
    device, no collectives; ``fit_scene``'s step).

    Returns ``step(scene, params, origins, dirs, ray_ids, target) ->
    (scene, loss)``. ``params`` is ``{leaf name: tensor}``
    (``scene_types.LEAF_PATHS`` names; those with ``requires_grad`` train)
    and ``optimizer`` a torch optimizer over its trained tensors, updated in
    place; ``scene`` gives everything else (counts, accel). Every rank
    passes the same whole arrays: ``origins``, ``dirs`` ``[R, 3]``,
    ``ray_ids [R]``, ``target`` ``[R, 3]`` linear radiance. The step traces
    this rank's ``px`` block of the rays (padded with dead rays to a
    multiple of ``px``) and its ``spp`` share of the samples through the
    differentiable fast forward, averages radiance over ``spp`` inside the
    loss (:class:`_SppMean`), takes its block's share of the L2 loss
    ``sum((radiance - target)^2) / (3 R)``, and sums loss and gradients over
    the mesh divided by the ``spp`` size: the loss and gradient of the whole
    image, the same on every rank. Every trained leaf gets a gradient (zero
    where the loss does not reach it); ``param_filter({name: grad})`` may
    change them before the update; afterwards each trained tensor's
    ``.grad`` holds what the update used. Returns the scene with the updated
    leaves and the loss (a float).

    With ``geometry_trainable`` and an accel carrying its Morton
    permutation, the loss searches against ``refresh_accel`` of the current
    triangles, and the returned scene carries the accel refreshed against
    the updated ones (``refresh_accel`` packs no ``mxu_coeffs``: the JAX
    step strips them up front for the same reason). A scene passed back with
    the accel the previous call returned, its ``params`` untouched since,
    skips the refresh before the loss: that accel is already the refresh of
    the current triangles (the same bits). A geometry-trainable scene
    without that permutation trains without an accel; with
    ``geometry_trainable=False`` the accel stays frozen.

    Spans: each call is one ``rtc.train.step`` holding ``rtc.train.forward``
    (render and loss), ``rtc.train.backward``, ``rtc.train.update``
    (gradients, their all-reduce, ``param_filter``, the optimizer) and an
    ``rtc.train.refresh`` for each ``refresh_accel``.
    """
    if mesh is None:
        px, n_spp, p, s = 1, 1, 0, 0
    else:
        px, n_spp = mesh_shape(mesh)
        p, s = mesh_coords(mesh)
    spp_per = _spp_split(spp, n_spp)
    # The accel the last call returned and its params' versions then.
    fresh = {"accel": None, "versions": None}

    def versions(params):
        return tuple(t._version for t in params.values())

    def step(scene: Scene, params: dict, origins, dirs, ray_ids, target):
        with trace_annotation("rtc.train.step"):
            return _step(scene, params, origins, dirs, ray_ids, target)

    def _step(scene: Scene, params: dict, origins, dirs, ray_ids, target):
        accel = scene.accel
        refresh = (geometry_trainable and accel is not None
                   and accel.perm_of_orig is not None)
        is_fresh = (refresh and accel is fresh["accel"]
                    and versions(params) == fresh["versions"])
        loss_accel = None if geometry_trainable else accel
        n = origins.shape[0]
        o, d, ids, active = pad_rays(origins, dirs, ray_ids, px)
        per = o.shape[0] // px
        block = slice(p * per, (p + 1) * per)
        n_real = min(max(n - p * per, 0), per)
        tgt = target.reshape(-1, 3)[p * per:p * per + n_real]

        current = with_leaves(scene, params)
        if is_fresh:
            loss_accel = accel
        elif refresh:
            with torch.no_grad(), trace_annotation("rtc.train.refresh"):
                loss_accel = refresh_accel(accel, current.triangles,
                                           scene.n_triangles)
        with trace_annotation("rtc.train.forward"):
            radiance, _ = trace_accumulate(
                o[block], d[block], dataclasses.replace(current, accel=loss_accel),
                ids[block], seed=seed, spp=spp_per, max_bounce=max_bounce,
                backend=backend, sample_offset=s * spp_per, active=active[block],
            )
            if mesh is not None:
                radiance = _SppMean.apply(radiance, mesh)
            loss = ((radiance[:n_real] - tgt) ** 2).sum() / (3 * n)
        with trace_annotation("rtc.train.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with trace_annotation("rtc.train.update"):
            # Every trained leaf gets a gradient, zero where the loss does not
            # reach it (as jax.grad gives), so that the optimizer's state covers
            # every trained leaf from the first step on and a checkpoint's
            # structure never changes.
            trained = [k for k, t in params.items() if t.requires_grad]
            grads = {k: params[k].grad if params[k].grad is not None
                     else torch.zeros_like(params[k]) for k in trained}
            loss = loss.detach()
            if mesh is not None:
                flat = torch.cat([g.reshape(-1) for g in grads.values()]
                                 + [loss.reshape(1)])
                dist.all_reduce(flat)
                flat = flat / float(n_spp)
                parts = flat.split([g.numel() for g in grads.values()] + [1])
                grads = {k: v.reshape(grads[k].shape) for k, v in zip(grads, parts)}
                loss = parts[-1][0]
            if param_filter is not None:
                grads = param_filter(grads)
            for k in trained:
                params[k].grad = grads[k]
            optimizer.step()
        updated = with_leaves(scene, {k: t.detach() for k, t in params.items()})
        if refresh:
            with torch.no_grad(), trace_annotation("rtc.train.refresh"):
                loss_accel = refresh_accel(accel, updated.triangles,
                                           scene.n_triangles)
            fresh.update(accel=loss_accel, versions=versions(params))
        return dataclasses.replace(updated, accel=loss_accel), float(loss)

    return step
