"""Procedural sky/sun environment light (y-DOWN world).

Counterpart of ``raytracingc_tpu/ops/env_light.py``:

* ``sky_t = smoothstep(0, 0.74, -dir.y) ** 0.35``
* ``sky = lerp(sky_horizon, sky_zenith, sky_t)``
* ``sun = max(0, dot(dir, sun_direction)) ** sun_focus * sun_intensity``,
  only for rays pointing up (``dir.y < 0``)
* ``ground_t = smoothstep(-0.01, 0, -dir.y)``
* result ``= lerp(ground, sky, ground_t) + sun``
"""

from __future__ import annotations

import torch

from raytracingc_tpu_torch.rng import lanewise
from raytracingc_tpu_torch.scene.types import EnvParams


def smoothstep(lo: float, hi: float, x: torch.Tensor) -> torch.Tensor:
    """Hermite smoothstep with clamped input."""
    t = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _pow(x: torch.Tensor, p) -> torch.Tensor:
    """``x ** p`` whose value per element does not depend on its position
    (torch's CPU pow rounds differently in its vector and scalar loops)."""
    return lanewise(lambda t: t.pow(p), x)


def _safe_pow(x: torch.Tensor, p) -> torch.Tensor:
    """``x ** p`` for ``x >= 0``, 0 where ``x == 0``, with finite gradients
    there (the double-where form of the JAX package)."""
    pos = x > 0
    safe = torch.where(pos, x, 1.0)
    return torch.where(pos, _pow(safe, p), 0.0)


def environment_light(dirs: torch.Tensor, env: EnvParams) -> torch.Tensor:
    """Environment radiance for ray directions ``dirs [..., 3]`` → ``[..., 3]``."""
    up = -dirs[..., 1]  # how much the ray points toward the sky (y-down)
    sky_t = _safe_pow(smoothstep(0.0, 0.74, up), 0.35)[..., None]
    sky = (1.0 - sky_t) * env.sky_horizon + sky_t * env.sky_zenith
    sd = env.sun_direction
    cos_sun = torch.clamp_min(
        dirs[..., 0] * sd[0] + dirs[..., 1] * sd[1] + dirs[..., 2] * sd[2], 0.0
    )
    sun = _safe_pow(cos_sun, env.sun_focus) * env.sun_intensity
    sun = torch.where(dirs[..., 1] < 0, sun, 0.0)
    ground_t = smoothstep(-0.01, 0.0, up)[..., None]
    return (1.0 - ground_t) * env.ground + ground_t * sky + sun[..., None]
