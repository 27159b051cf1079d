"""Camera: look-at basis and primary-ray generation.

Counterpart of ``raytracingc_tpu/camera.py``. The world is y-DOWN:
``ez = normalize(look_at - origin)``, ``up = (0, -1, 0)``,
``ex = normalize(cross(ez, up))``, ``ey = normalize(cross(ez, ex))``. Pixel
``(x, y)`` (row-major, y = 0 at the top) gets
``dx = (x - W//2) / (H//2)``, ``dy = (y - H//2) / (H//2)`` with the reference's
C integer divisions, and ``dir = normalize(dx*ex + dy*ey + fov*ez)``.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_ORIGIN = (-4.75, -1.5, -4.75)
DEFAULT_LOOK_AT = (0.9, -1.2, 1.0)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, summed in component order."""
    x, y, z = v.unbind(-1)
    return torch.sqrt(x * x + y * y + z * z)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / _norm(v).unsqueeze(-1)


def look_at_basis(origin: torch.Tensor, target: torch.Tensor):
    """y-down look-at basis. Returns ``(ex, ey, ez)``."""
    ez = _normalize(target - origin)
    up = torch.tensor([0.0, -1.0, 0.0], dtype=torch.float32, device=origin.device)
    ex = _normalize(torch.linalg.cross(ez, up))
    ey = _normalize(torch.linalg.cross(ez, ex))
    return ex, ey, ez


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera pose: ``origin``, basis ``ex/ey/ez`` (``[3]`` each), ``fov``
    (a focal-length scalar: bigger is narrower)."""

    origin: torch.Tensor
    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    fov: torch.Tensor

    @classmethod
    def look_at(cls, origin=DEFAULT_ORIGIN, target=DEFAULT_LOOK_AT,
                fov: float = 1.0, device="cpu") -> "Camera":
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        origin, target = f32(origin), f32(target)
        ex, ey, ez = look_at_basis(origin, target)
        return cls(origin=origin, ex=ex, ey=ey, ez=ez, fov=f32(fov))

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)}
        )


def primary_rays(camera: Camera, width: int, height: int):
    """``(origins [H*W, 3], dirs [H*W, 3])``, row-major, y = 0 at the top."""
    dev = camera.origin.device
    half_w = width // 2  # C integer division
    # The C code divides by height/2 unguarded; a 1-pixel-high image would
    # divide by zero there, so clamp to 1 as the JAX package does.
    half_h = max(height // 2, 1)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) - half_w) / half_h
    ys = (torch.arange(height, dtype=torch.float32, device=dev) - half_h) / half_h
    dx = xs.repeat(height)  # [H*W], row-major
    dy = ys.repeat_interleave(width)
    dirs = (
        dx[:, None] * camera.ex[None, :]
        + dy[:, None] * camera.ey[None, :]
        + camera.fov * camera.ez[None, :]
    )
    dirs = _normalize(dirs)
    origins = camera.origin.expand_as(dirs).contiguous()
    return origins, dirs
